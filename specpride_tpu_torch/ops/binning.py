"""Binned-mean consensus on the card: per-run intensity means over the
flat (row, bin)-sorted peak axis, compacted by a host-computed keep mask.

The host keeps everything it computes exactly from its own sorted pass:
per-run counts, the integer quorum, the m/z means and the per-row output
counts.  The card runs the one heavy reduction, the per-run intensity
means over millions of peaks, through the ``seg_mean`` kernel.
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
    (idx,) = torch.nonzero(keep_runs, as_tuple=True)
    k = min(total_cap, idx.numel())
    out = torch.zeros(total_cap, dtype=torch.float32, device=intensity.device)
    out[:k] = inten_mean[idx[:k]]
    return out
