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
