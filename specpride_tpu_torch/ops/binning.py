"""Binned-mean consensus on the card: per-run intensity means over the
flat (row, bin)-sorted peak axis, compacted by a host-computed keep mask.

The host keeps everything it computes exactly from its own sorted pass:
per-run counts, the integer quorum, the m/z means and the per-row output
counts.  The card runs the one heavy reduction, the per-run intensity
means over millions of peaks, through the ``seg_mean`` kernel (f32) or
the ``seg_mean_heads`` kernel (bf16 and int8 codes).
"""

from __future__ import annotations

import torch

from specpride_tpu_torch.data.packed import SENTINEL
from specpride_tpu_torch.ops import kernels
from specpride_tpu_torch.ops import segments as sg


def bin_mean_flat_intensity(
    intensity: torch.Tensor,  # (N,) f32, sorted by (row, bin)
    gbin: torch.Tensor,  # (N,) i32 row*(n_bins+1)+bin, SENTINEL = padding
    keep_runs: torch.Tensor,  # (rcap,) bool host quorum keep, in run order;
    #   False past the real runs (incl. any sentinel tail run)
    total_cap: int,
    rcap: int,  # >= run count incl. any sentinel tail run
) -> torch.Tensor:
    """Kept per-run intensity means, packed to the front of one
    ``(total_cap,)`` f32 tensor (zeros past the kept count)."""
    w = (gbin != SENTINEL).to(torch.float32)
    inten_mean = kernels.seg_mean(gbin, w, intensity)[1]
    inten_mean = inten_mean[sg.run_end_positions(sg.run_starts(gbin), rcap)]
    return _compact(inten_mean, keep_runs, total_cap)


def bin_mean_flat_q(
    codes: torch.Tensor,  # (N,) bf16 | int8 intensity codes, (row, bin) order
    run_start: torch.Tensor,  # (N,) uint8 | bool, nonzero at each run start
    keep_runs: torch.Tensor,  # (rcap,) bool host quorum keep, in run order
    total_cap: int,
    rcap: int,  # >= run count
) -> torch.Tensor:
    """Reduced-precision twin of ``bin_mean_flat_intensity``: the int32
    composite key becomes a 1-byte run-start mask (the kernel only needs
    run boundaries, which the host's sorted pass knows) and intensity
    arrives as bf16 or int8 codes, so 3 B (bf16) or 2 B (int8) per peak
    cross to the card instead of 8.  Returns the kept per-run means of the
    codes, packed to the front of ``(total_cap,)`` f32; int8 means are
    rescaled by the host, per cluster."""
    inten_mean = kernels.seg_mean_heads(run_start, codes)[1]
    starts = run_start != 0
    starts[:1] = True
    inten_mean = inten_mean[sg.run_end_positions(starts, rcap)]
    return _compact(inten_mean, keep_runs, total_cap)


def _compact(run_means, keep_runs, total_cap: int) -> torch.Tensor:
    """The kept runs' means, packed to the front of ``(total_cap,)`` f32
    (zeros past the kept count)."""
    (idx,) = torch.nonzero(keep_runs, as_tuple=True)
    k = min(total_cap, idx.numel())
    out = torch.zeros(total_cap, dtype=torch.float32,
                      device=run_means.device)
    out[:k] = run_means[idx[:k]]
    return out
