"""The gap-average consensus (ref ``src/average_spectrum_clustering.py``),
in float64.

Per cluster of two or more members: all member peaks, stably sorted by
m/z, split where neighbours lie ``mz_accuracy`` or more apart, except
that with two or more such gaps the last one is ignored (the reference
loops over ``ind_list[1:-1]``, ``tail_mode`` "reference"); a group's m/z
is its mean, its intensity its sum over the member count, and it is kept
when it holds at least ``min_fraction`` of the member count in peaks.  A
single member's peaks pass through, each its own group.  Then the
groups below ``max / dyn_range`` of the cluster's largest intensity go.
The precursor is the member of lower-median neutral mass (its m/z,
re-charged, its charge and its RT: ``pepmass`` "lower_median")."""

from __future__ import annotations

import numpy as np

from benchmark.reference.result import Reps
from benchmark.reference.segments import offsets_of, run_sums

PROTON_MASS = 1.00727646677


def _precursors(w) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pepmass, charge, rt) of each cluster from its lower-median-mass
    member (rank (n - 1) // 2 of the neutral masses)."""
    z = w.charge.astype(np.float64)
    mass = w.precursor_mz * z - z * PROTON_MASS
    cluster = w.cluster_of_member()
    order = np.lexsort((mass, cluster))
    n = np.diff(w.member_offsets)
    pick = order[w.member_offsets[:-1] + (n - 1) // 2]
    zi = w.charge[pick]
    return (mass[pick] + zi * PROTON_MASS) / zi, zi, w.rt[pick]


def consensus(w, method: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                         dict]:
    """(rep offsets, m/z, intensity, sizes) of every cluster."""
    if method.get("tail_mode", "reference") != "reference":
        raise ValueError("the reference follows tail_mode 'reference'")
    n_members = np.diff(w.member_offsets)
    peak_cluster = w.cluster_of_member()[w.member_of_peak()]
    single = n_members[peak_cluster] == 1
    # a multi-member cluster's peaks sorted by m/z (stable); a single
    # member's stay in file order, each its own group
    order = np.lexsort((np.where(single, 0.0, w.mz), peak_cluster))
    mz, inten = w.mz[order], w.intensity[order]
    cl, single = peak_cluster[order], single[order]
    new_cluster = np.r_[True, cl[1:] != cl[:-1]]
    gap = np.r_[False, np.diff(mz) >= float(method["mz_accuracy"])]
    gap &= ~new_cluster
    # with two or more gaps in a cluster, its last gap is ignored
    gap_pos = np.flatnonzero(gap)
    gap_cl = cl[gap_pos]
    n_gaps = np.bincount(gap_cl, minlength=w.n_clusters)
    last_of_cl = np.r_[gap_cl[1:] != gap_cl[:-1], True] if gap_pos.size \
        else np.zeros(0, dtype=bool)
    drop = gap_pos[last_of_cl & (n_gaps[gap_cl] >= 2)]
    gap[drop] = False
    head = new_cluster | gap | single
    starts = np.flatnonzero(head)
    g_size = np.diff(np.r_[starts, mz.size])
    g_cl = cl[starts]
    g_mz = run_sums(mz, starts) / g_size
    g_int = run_sums(inten, starts) / n_members[g_cl]
    keep = (g_size >= float(method["min_fraction"]) * n_members[g_cl]) | \
        (n_members[g_cl] == 1)
    top = np.zeros(w.n_clusters)
    np.maximum.at(top, g_cl[keep], g_int[keep])
    keep &= g_int >= top[g_cl] / float(method["dyn_range"])
    rep_off = offsets_of(np.bincount(g_cl[keep], minlength=w.n_clusters))
    sizes = {
        "clusters": w.n_clusters, "members": w.n_spectra,
        "peaks": w.n_peaks, "groups": int(starts.size),
        "kept_groups": int(keep.sum()),
        "single_peaks": int(single.sum()),
    }
    return rep_off, g_mz[keep], g_int[keep], sizes


def run(w, config: dict) -> Reps:
    rep_off, mz, inten, sizes = consensus(w, config["method"])
    if config["method"].get("pepmass", "lower_median") != "lower_median":
        raise ValueError("the reference follows pepmass 'lower_median'")
    pepmass, charge, rt = _precursors(w)
    return Reps(offsets=rep_off, mz=mz, intensity=inten, pepmass=pepmass,
                charge=charge, rt=rt, cosines=None, sizes=sizes)

