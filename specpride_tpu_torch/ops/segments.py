"""Run structure of sorted flat keys, as torch ops."""

from __future__ import annotations

import torch


def run_starts(keys: torch.Tensor) -> torch.Tensor:
    """(N,) bool: element begins a new run of equal adjacent ``keys``."""
    starts = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    starts[1:] = keys[1:] != keys[:-1]
    return starts


def run_starts2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,) bool: element begins a new run of the composite key (a, b),
    without materialising a wider composite key."""
    starts = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    starts[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    return starts


def run_ends(starts: torch.Tensor) -> torch.Tensor:
    """(N,) bool: element is the last of its run."""
    ends = torch.ones_like(starts)
    ends[:-1] = starts[1:]
    return ends


def run_end_positions(starts: torch.Tensor, rcap: int) -> torch.Tensor:
    """(rcap,) int64 position of each run's last element, in run order.

    ``rcap`` must be >= the run count; surplus entries hold ``n - 1`` and
    are masked by the caller."""
    n = starts.numel()
    (endpos,) = torch.nonzero(run_ends(starts), as_tuple=True)
    out = torch.full((rcap,), n - 1, dtype=torch.int64, device=starts.device)
    k = min(rcap, endpos.numel())
    out[:k] = endpos[:k]
    return out


def run_starts2d(keys: torch.Tensor) -> torch.Tensor:
    """(B, K) bool: element begins a new run within its ROW (keys sorted
    per row; column 0 always starts one)."""
    starts = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    starts[:, 1:] = keys[:, 1:] != keys[:, :-1]
    return starts


def run_starts2d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, K) bool: element begins a new run of the composite key (a, b)
    within its row (column 0 always starts one)."""
    starts = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    starts[:, 1:] = (a[:, 1:] != a[:, :-1]) | (b[:, 1:] != b[:, :-1])
    return starts


def run_ends2d(starts: torch.Tensor) -> torch.Tensor:
    """(B, K) bool: element is the last of its within-row run."""
    ends = torch.ones_like(starts)
    ends[:, :-1] = starts[:, 1:]
    return ends


def seg_scan2d(
    starts: torch.Tensor, values: tuple[torch.Tensor, ...]
) -> tuple[torch.Tensor, ...]:
    """Row-local segmented inclusive prefix sums of 1 to 3 (B, K) float32
    channels: one ``kernels.seg_scan`` on head flags over the row-major
    flattened batch.  ``starts`` comes from ``run_starts2d``, which marks
    column 0, so every row begins a run and no sum crosses a row; the JAX
    package's windowed scan (``segments.py::seg_scan``) needs no window
    here, the kernel being exact for any run length."""
    from specpride_tpu_torch.ops import kernels

    shape = starts.shape
    flat = kernels.seg_scan(starts.reshape(-1),
                            *(v.contiguous().reshape(-1) for v in values))
    return tuple(f.view(shape) for f in flat)
