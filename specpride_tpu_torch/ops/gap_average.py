"""Gap-clustered average consensus on the card (ref
src/average_spectrum_clustering.py:26-103).

The host sorts each cluster's peaks and decides the groups in float64
(``data.packed.gap_global_segments``: the 0.01 Da gap threshold is finer
than float32 resolves at high m/z), including the reference's final-gap
merge and the integer quorum.  The card receives the sorted peaks with a
1-byte group-start flag and computes the group means through the
``seg_mean_heads`` kernel, the quorum and the per-cluster dynamic-range
floor, and compacts the kept groups.

Semantics, as the JAX package's Pallas branch computes them
(``specpride_tpu/ops/gap_average.py:100-136``): group m/z = the group's
mean m/z; group intensity = its intensity sum over n_members (ref
:76-77), taken as ``mean * size / max(n_members, 1)``; a group is kept
when its size reaches the cluster's quorum and its intensity the floor
``max kept intensity / dyn_range`` (ref :95-98), both in float32.
"""

from __future__ import annotations

import torch

from specpride_tpu_torch.ops import kernels
from specpride_tpu_torch.ops import segments as sg


def gap_average_compact(
    mz: torch.Tensor,  # (N,) f32 | bf16, sorted by (row, m/z)
    intensity: torch.Tensor,  # (N,) f32 | bf16 | int8 codes, same order
    group_start: torch.Tensor,  # (N,) uint8, nonzero where a group begins
    quorum: torch.Tensor,  # (rows,) i32 host-f64 ceil(min_fraction * n)
    n_members: torch.Tensor,  # (rows,) i32
    n_groups: torch.Tensor,  # (rows,) i64 groups per row, sum = total_cap
    dyn_range: float,
    total_cap: int,  # the chunk's group count
) -> torch.Tensor:
    """Globally compacted gap average: one f32 tensor ``[flat_mz
    (total_cap) | flat_intensity (total_cap) | n_out (rows)]``, the kept
    groups row-major (cluster order, ascending m/z within a cluster, input
    order for singletons), zeros past the kept count."""
    dev = mz.device
    rows = n_members.numel()
    cnt, mean_mz, mean_int = kernels.seg_mean_heads(group_start, mz,
                                                    intensity)
    starts = group_start != 0
    starts[:1] = True
    ends = sg.run_end_positions(starts, total_cap)[:total_cap]
    sizes = cnt[ends]
    grow = torch.repeat_interleave(
        torch.arange(rows, device=dev), n_groups, output_size=total_cap
    )
    nm = torch.clamp(n_members.to(torch.float32), min=1.0)[grow]
    group_mz = mean_mz[ends]
    group_int = mean_int[ends] * sizes / nm
    keep = sizes >= quorum.to(torch.float32)[grow]
    kept_max = torch.full((rows,), -torch.inf, device=dev).scatter_reduce(
        0, grow, torch.where(keep, group_int, -torch.inf), "amax"
    )
    keep &= group_int >= (kept_max / dyn_range)[grow]

    (idx,) = torch.nonzero(keep, as_tuple=True)
    k = idx.numel()
    out = torch.zeros(2 * total_cap + rows, dtype=torch.float32, device=dev)
    out[:k] = group_mz[idx]
    out[total_cap : total_cap + k] = group_int[idx]
    out[2 * total_cap :] = torch.bincount(grow[idx], minlength=rows).to(
        torch.float32
    )
    return out
