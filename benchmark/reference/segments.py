"""Segment helpers of the references: runs of equal keys in a sorted
array, their sums, and offsets from counts."""

from __future__ import annotations

import numpy as np


def offsets_of(counts: np.ndarray) -> np.ndarray:
    """(n + 1,) int64 starts of ``counts``-long segments."""
    off = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def run_starts(keys: np.ndarray) -> np.ndarray:
    """Start index of each run of equal values in ``keys``."""
    if keys.size == 0:
        return np.zeros(0, dtype=np.int64)
    return np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])


def run_sums(values: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Sum of ``values`` over each run that begins at ``starts``."""
    if starts.size == 0:
        return np.zeros(0, dtype=np.float64)
    return np.add.reduceat(values, starts)
