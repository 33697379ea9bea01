"""QC cosine on the card: each representative's mean binned cosine to its
cluster's members, over one flat peak axis for a whole chunk.

The host ships per-peak composite keys, edge-gated intensities, spectrum
ids and rep-lookup positions outright (``TorchBackend._dispatch_cosine_flat``
builds them); the card runs five segmented scans through the ``seg_scan``
kernel, plus gathers and elementwise torch ops, and returns one float per
cluster.
"""

from __future__ import annotations

import torch

from specpride_tpu_torch.data.packed import SENTINEL
from specpride_tpu_torch.ops import kernels
from specpride_tpu_torch.ops import segments as sg


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
