"""Segmented stable argsort over flat numpy arrays."""

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
