"""Segmented stable argsort and int32 searchsorted over flat numpy arrays,
on the host library's threads (``ops/csrc/segsort.cpp``, built by
``ops/_build.load_host``; ctypes releases the interpreter lock for the
call, so pack workers sort in parallel).

``seg_argsort_plain`` and ``searchsorted_right_i32_plain`` are the numpy
versions the tests hold the library to: identical permutations and
results, ties included.  Nothing on the main path calls them."""

from __future__ import annotations

import ctypes

import numpy as np

from specpride_tpu_torch.ops import _build

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)


def _check_offsets(offsets: np.ndarray, n: int) -> None:
    if offsets.ndim != 1 or offsets.size == 0:
        raise ValueError("offsets must be a 1-D array of at least one entry")
    if offsets[0] != 0 or offsets[-1] != n:
        raise ValueError(f"offsets must run from 0 to the {n} keys, got "
                         f"{offsets[0]}..{offsets[-1]}")
    if (np.diff(offsets) < 0).any():
        raise ValueError("offsets must be non-decreasing")


def seg_argsort(keys: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """(N,) int64 global indices: per segment ``[offsets[s],
    offsets[s+1])``, a stable argsort of its ``keys`` (int64), offset by
    the segment's start."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    _check_offsets(offsets, keys.size)
    order = np.empty(keys.size, dtype=np.int64)
    rc = _build.load_host().seg_argsort_i64(
        keys.ctypes.data_as(_P64), offsets.ctypes.data_as(_P64),
        offsets.size - 1, order.ctypes.data_as(_P64), 0,
    )
    if rc != 0:
        raise RuntimeError(f"seg_argsort_i64 failed ({rc})")
    return order


def seg_argsort_plain(keys: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """numpy version of ``seg_argsort``: one lexsort over (segment, key)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    seg_of_elem = np.repeat(
        np.arange(offsets.size - 1, dtype=np.int64), np.diff(offsets)
    )
    return np.lexsort((keys, seg_of_elem))


def searchsorted_right_i32(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """(Q,) int64: ``np.searchsorted(keys, queries, side='right')`` over
    int32 arrays, ``keys`` ascending."""
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    queries = np.ascontiguousarray(queries, dtype=np.int32)
    if keys.ndim != 1 or queries.ndim != 1:
        raise ValueError("keys and queries must be 1-D")
    out = np.empty(queries.size, dtype=np.int64)
    rc = _build.load_host().searchsorted_right_i32(
        keys.ctypes.data_as(_P32), keys.size,
        queries.ctypes.data_as(_P32), queries.size,
        out.ctypes.data_as(_P64), 0,
    )
    if rc != 0:
        raise RuntimeError(f"searchsorted_right_i32 failed ({rc})")
    return out


def searchsorted_right_i32_plain(keys: np.ndarray,
                                 queries: np.ndarray) -> np.ndarray:
    """numpy version of ``searchsorted_right_i32``."""
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    queries = np.ascontiguousarray(queries, dtype=np.int32)
    return np.searchsorted(keys, queries, side="right").astype(np.int64)
