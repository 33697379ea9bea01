"""Segmented stable argsort and int32 searchsorted over flat numpy
arrays."""

from __future__ import annotations

import numpy as np


def seg_argsort(keys: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """(N,) global indices: per segment ``[offsets[s], offsets[s+1])``, a
    stable argsort of its ``keys`` — one lexsort over (segment, key)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    seg_of_elem = np.repeat(
        np.arange(offsets.size - 1, dtype=np.int64), np.diff(offsets)
    )
    return np.lexsort((keys, seg_of_elem))


def searchsorted_right_i32(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """``np.searchsorted(keys, queries, side='right')`` over int32 arrays
    (keys ascending)."""
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    queries = np.ascontiguousarray(queries, dtype=np.int32)
    return np.searchsorted(keys, queries, side="right")
