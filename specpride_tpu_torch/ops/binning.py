"""Binned-mean consensus on the card: per-run intensity means over the
flat (row, bin)-sorted peak axis, compacted by a host-computed keep mask.

The host keeps everything it computes exactly from its own sorted pass:
per-run counts, the integer quorum, the m/z means and the per-row output
counts.  The card runs the one heavy reduction, the per-run intensity
means over millions of peaks, through the ``seg_mean`` kernel (f32) or
the ``seg_mean_heads`` kernel (bf16 and int8 codes).

The bucketized (B, K) layout (``bin_mean_deduped_compact``) keeps the
JAX package's device semantics instead: the card takes each (row, bin)
run's count and its m/z and intensity means in one ``seg_mean_heads``
launch over the flattened rows, and decides the quorum in float32.
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


def device_quorum(n_members: torch.Tensor, fraction: float,
                  apply: bool = True) -> torch.Tensor:
    """(B,) float32 quorum of the bucketized binned mean, in float32 on
    whatever device holds ``n_members``: ``floor(f32(n) * f32(fraction))
    + 1`` (the JAX package's ``binning.py:65-70``), or 1 without a
    quorum.  It is not the flat path's float64 host quorum
    ``int(n * fraction) + 1``; the two can differ where the product lies
    within a float32 rounding of an integer."""
    if not apply:
        return torch.ones(n_members.shape, dtype=torch.float32,
                          device=n_members.device)
    frac = torch.tensor(fraction, dtype=torch.float32,
                        device=n_members.device)
    return torch.floor(n_members.to(torch.float32) * frac) + 1.0


def bin_mean_deduped_stats(
    mz: torch.Tensor,  # (B, K) f32 | bf16, rows sorted by bin
    intensity: torch.Tensor,  # (B, K) f32 | bf16 | int8 codes, same order
    bins: torch.Tensor,  # (B, K) i32 non-decreasing, n_bins = padding
    quorum: torch.Tensor,  # (B,) f32 ``device_quorum``
    n_bins: int,
):
    """Per (row, bin) run, at the run's last element: ``(mz mean,
    intensity mean, keep)``, each (B, K), the counterpart of the JAX
    package's ``ops/binning.py::_bin_mean_deduped_stats``.

    One ``seg_mean_heads`` launch over the flattened rows gives each run's
    count and both means: the heads are ``run_starts2d(bins)``, which marks
    column 0, so no run crosses a row, and the padding (sentinel bin, last
    in its row) is a run of its own that ``keep`` drops.  Head flags, not
    ``row * (n_bins + 1) + bin`` keys: those overflow int32 at 20,000 rows
    of a fine grid."""
    b, k = bins.shape
    starts = sg.run_starts2d(bins)
    cnt, mz_mean, int_mean = kernels.seg_mean_heads(
        starts.reshape(-1), mz.reshape(-1), intensity.reshape(-1))
    cnt = cnt.view(b, k)
    keep = (sg.run_ends2d(starts) & (bins < n_bins)
            & (cnt >= quorum[:, None]))
    return mz_mean.view(b, k), int_mean.view(b, k), keep


def compact_rows(mz: torch.Tensor, intensity: torch.Tensor,
                 keep: torch.Tensor, total_cap: int) -> torch.Tensor:
    """The kept elements of (B, K) ``mz`` and ``intensity``, row-major,
    in one float32 tensor ``[flat_mz (total_cap) | flat_intensity
    (total_cap) | n_out (B)]`` (zeros past the kept count), the JAX
    package's compacted output.  ``total_cap`` bounds the kept count."""
    b = keep.shape[0]
    (idx,) = torch.nonzero(keep.reshape(-1), as_tuple=True)
    n = min(total_cap, idx.numel())
    idx = idx[:n]
    out = torch.zeros(2 * total_cap + b, dtype=torch.float32,
                      device=mz.device)
    out[:n] = mz.reshape(-1)[idx]
    out[total_cap : total_cap + n] = intensity.reshape(-1)[idx]
    out[2 * total_cap :] = keep.sum(dim=1).to(torch.float32)
    return out


def bin_mean_deduped_compact(
    mz: torch.Tensor,  # (B, K) f32 | bf16
    intensity: torch.Tensor,  # (B, K) f32 | bf16 | int8 codes
    bins: torch.Tensor,  # (B, K) i32, rows sorted, n_bins = padding
    n_members: torch.Tensor,  # (B,) i32
    n_bins: int,
    quorum_fraction: float,
    apply_quorum: bool,
    total_cap: int,  # >= the kept (row, bin) count: the distinct bins
) -> torch.Tensor:
    """The bucketized binned mean of one (B, K) chunk, compacted
    (``compact_rows``): the counterpart of the JAX package's
    ``ops/binning.py::_bin_mean_deduped_compact``."""
    quorum = device_quorum(n_members, quorum_fraction, apply_quorum)
    mz_mean, int_mean, keep = bin_mean_deduped_stats(
        mz, intensity, bins, quorum, n_bins)
    return compact_rows(mz_mean, int_mean, keep, total_cap)
