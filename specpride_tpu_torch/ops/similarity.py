"""Similarity on the card: the medoid's pairwise shared-bin counts and the
QC cosine.

Medoid: per (B, K) chunk of host-sorted global bins and member ids, a
scatter of ones builds each cluster's 0/1 (run × member) occupancy and one
batched matrix product gives every member pair's shared occupied-bin
count (``shared_bins_packed``); the host finalizes the pick in float64
(``medoid_finalize``).

QC cosine: each representative's mean binned cosine to its cluster's
members, over one flat peak axis for a whole chunk.  The host ships
per-peak composite keys, edge-gated intensities, spectrum ids and
rep-lookup positions outright (``TorchBackend._dispatch_cosine_flat``
builds them); the card runs five segmented scans through the ``seg_scan``
kernel, plus gathers and elementwise torch ops, and returns one float per
cluster.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from specpride_tpu_torch.data.packed import SENTINEL
from specpride_tpu_torch.ops import kernels
from specpride_tpu_torch.ops import segments as sg
from specpride_tpu_torch.ops.quantize import MEDOID_SENTINEL


@contextlib.contextmanager
def _tf32_matmul():
    """TF32 tensor-core matrix products inside the block, the process
    setting restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def shared_bins_packed(
    bins: torch.Tensor,  # (B, K) int32 global bins, or int16 narrowed; each
    #   row sorted by (bin, member), padding (MEDOID_SENTINEL or 2^15 - 1)
    #   last
    member_id: torch.Tensor,  # (B, K) int32 or int16 in [0, m], same
    #   order; padding = m
    m: int,
    runs: int,  # R: at least the largest number of (row, bin) runs in any
    #   row, padding's run included
) -> torch.Tensor:
    """(B, M, M) int32 shared occupied-bin counts of every member pair: the
    counterpart of the JAX package's ``ops/similarity.py::
    _shared_bins_packed`` on the same sorted arguments.

    Where the JAX function builds each run's member set by a segmented
    OR-scan of bitmasks (every TPU scatter serialized), this one scatters
    ones into a zeroed (B, R, M) float32 occupancy, at the first element
    of each (run, member) pair, and takes the gram ``O^T O`` with one
    ``torch.bmm``.  The run axis is R, the chunk's largest run count
    (the host knows it from its sort), not K: the same counts from a
    smaller tensor.  The counts are exact: the occupancy is 0/1, exact in
    float32, TF32 and bf16, so every product is exact, and a sum of ones
    is exact in float32 below 2^24 (a count never exceeds a member's peak
    count, which the caller holds below 2^16); so the TF32 tensor cores
    give the integers."""
    bins = bins.to(torch.int32)
    member = member_id.to(torch.int32)
    b = bins.shape[0]
    ok = (member < m) & (bins < MEDOID_SENTINEL)
    starts = torch.ones_like(ok)
    starts[:, 1:] = bins[:, 1:] != bins[:, :-1]
    first_of_mb = starts.clone()
    first_of_mb[:, 1:] |= member[:, 1:] != member[:, :-1]
    contrib = ok & first_of_mb
    run = torch.cumsum(starts, dim=1) - 1  # within-row run index
    if int(run[:, -1].max()) >= runs:
        raise ValueError(f"shared_bins_packed: a row holds more than "
                         f"runs={runs} runs")
    row = torch.arange(b, device=bins.device).unsqueeze(1)
    flat = (row * runs + run) * m + member.clamp(max=m - 1)
    occ = torch.zeros(b * runs * m, dtype=torch.float32, device=bins.device)
    occ.index_put_((flat[contrib],), torch.ones((), device=bins.device))
    occ = occ.view(b, runs, m)
    with _tf32_matmul():
        shared = torch.bmm(occ.transpose(1, 2), occ)
    return shared.to(torch.int32)


def medoid_finalize(
    shared: np.ndarray,  # (B, M, M) int
    n_peaks: np.ndarray,  # (B, M) int raw peak counts
    member_mask: np.ndarray,  # (B, M) bool
    n_members: np.ndarray,  # (B,) int
) -> np.ndarray:
    """Host float64 finalize: prescore = shared / min(raw counts),
    distance = 1 - prescore, total = row sum + diagonal (the triangular
    fill's double-counted self-distance, ref
    src/most_similar_representative.py:88-100), lowest-index argmin."""
    n = n_peaks.astype(np.float64)
    min_n = np.minimum(n[:, :, None], n[:, None, :])
    with np.errstate(invalid="ignore", divide="ignore"):
        prescore = np.where(
            min_n > 0, shared.astype(np.float64) / np.maximum(min_n, 1.0), 0.0
        )
    dist = 1.0 - prescore
    pair_ok = member_mask[:, :, None] & member_mask[:, None, :]
    dist = np.where(pair_ok, dist, 0.0)
    diag = np.einsum("bii->bi", dist)
    total = (dist.sum(axis=2) + diag) / np.maximum(
        n_members.astype(np.float64)[:, None], 1.0
    )
    total = np.where(member_mask, total, np.inf)
    return np.argmin(total, axis=1).astype(np.int32)


def cosine_flat(
    rkey: torch.Tensor,  # (Nr,) i32 row*shift+bin, ascending; sentinel tail
    rint: torch.Tensor,  # (Nr,) f32, same order
    mkey: torch.Tensor,  # (N,) i32 row*shift+bin per member peak, sorted by
    #   (row, member, bin); sentinel tail
    mint: torch.Tensor,  # (N,) f32, already 0 where the peak fails the
    #   pair's edge cutoff (the host gates it)
    spec_elem: torch.Tensor,  # (N,) i32 chunk-local spectrum id per peak,
    #   non-decreasing; a padding tail maps to a fill spectrum
    pos: torch.Tensor,  # (N,) i32 host searchsorted(rkey, mkey, right) - 1:
    #   the LAST element of the matching rep run (or a non-matching element
    #   when the bin is absent); -1 is clipped here
    spec_offsets: torch.Tensor,  # (S + 1,) i32 peak extents per spectrum
    spec_row: torch.Tensor,  # (S,) i32 chunk-local row per spectrum,
    #   non-decreasing
    npos: torch.Tensor,  # (S,) i32 host searchsorted of each spectrum's
    #   rep-norm cutoff key into rkey
    rep_offsets: torch.Tensor,  # (rows + 1,) i32 rep extents per row
    row_spec_offsets: torch.Tensor,  # (rows + 1,) i32 spectrum extents/row
    n_members: torch.Tensor,  # (rows,) i32
    shift: int,
) -> torch.Tensor:
    """(rows,) f32 mean binned cosine of each row's representative to its
    members: the counterpart of the JAX package's
    ``ops/similarity.py::_cosine_flat``, taking the same twelve arrays.

    Every segmented sum goes through ``kernels.seg_scan`` on head flags,
    which is exact for any run length, so the JAX function's scan windows
    (``l_rep`` .. ``l_members``) have no counterpart; the two differ only
    inside sentinel runs, which are masked out below.  Totals are read at
    run ends of within-run prefixes, never as differences of a global
    prefix: per-spectrum and per-row scans keep fp error at the scale of
    the spectrum or row (rows of very different intensity scale share the
    axis)."""
    nr = rkey.shape[0]
    n = mkey.shape[0]
    rows_cap = n_members.shape[0]
    s_pad = spec_row.shape[0]

    # --- rep side: per-bin run totals, then the per-row prefix of their
    # squares (segmented per ROW)
    rvalid = rkey != SENTINEL
    r_starts = sg.run_starts(rkey)
    (r_scan,) = kernels.seg_scan(r_starts, torch.where(rvalid, rint, 0.0))
    r_sq = torch.where(sg.run_ends(r_starts) & rvalid, r_scan * r_scan, 0.0)
    row_of_rep = torch.clamp(
        torch.div(rkey, shift, rounding_mode="floor"), 0, rows_cap - 1
    )
    row_starts_r = sg.run_starts(torch.where(rvalid, row_of_rep, rows_cap))
    (r_sq_scan,) = kernels.seg_scan(row_starts_r, r_sq)

    # --- member side: (spectrum, bin) runs over host-shipped channels
    valid = mkey != SENTINEL
    m_starts = sg.run_starts2(spec_elem, mkey)
    (m_scan,) = kernels.seg_scan(m_starts, mint)

    # rep per-bin total for each member peak, read at the last element of
    # the matching rep run, where the scan holds the run's total
    pos_c = torch.clamp(pos, 0, nr - 1).long()
    rep_hit = (rkey[pos_c] == mkey) & valid
    rep_val = torch.where(rep_hit, r_scan[pos_c], 0.0)

    # per-spectrum dot and norm: contributions at member-run ends, summed
    # by a spectrum-segmented scan, read at each spectrum's last element
    run_sum_at_end = torch.where(sg.run_ends(m_starts), m_scan, 0.0)
    dot_scan, norm_scan = kernels.seg_scan(
        sg.run_starts(spec_elem),
        run_sum_at_end * rep_val,
        run_sum_at_end * run_sum_at_end,
    )
    spec_last = torch.clamp(spec_offsets[1:] - 1, 0, n - 1).long()
    nonempty = spec_offsets[1:] > spec_offsets[:-1]
    dots = torch.where(nonempty, dot_scan[spec_last], 0.0)
    norms = torch.where(nonempty, norm_scan[spec_last], 0.0)

    # rep norm per spectrum: the row-segmented squared prefix at the cutoff
    row_start = rep_offsets[spec_row.long()]
    has_prefix = npos > row_start
    rep_norm = torch.where(
        has_prefix, r_sq_scan[torch.clamp(npos - 1, 0, nr - 1).long()], 0.0
    )

    okc = (norms > 0) & (rep_norm > 0)
    cos = torch.where(
        okc, dots / torch.sqrt(torch.clamp(norms * rep_norm, min=1e-30)), 0.0
    )

    # per-row mean over the spectrum axis (spectra sorted by row; member
    # count from the host, so zero-peak members still weigh the mean)
    (cos_scan,) = kernels.seg_scan(sg.run_starts(spec_row), cos)
    row_last = torch.clamp(row_spec_offsets[1:] - 1, 0, s_pad - 1).long()
    row_has = row_spec_offsets[1:] > row_spec_offsets[:-1]
    row_sum = torch.where(row_has, cos_scan[row_last], 0.0)
    return row_sum / torch.clamp(n_members.to(torch.float32), min=1.0)
