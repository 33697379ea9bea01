"""The QC cosine (ref ``src/benchmark.py:11-38``) of every member to its
cluster's representative, all pairs at once.

For a pair, the grid is ``arange(-space/2, max_mz, space)`` with
``max_mz`` the larger last m/z of the two; a peak lands in bin
``floor((mz + space/2) / space)``, peaks past the last edge drop, and a
peak on the last edge joins the last bin (scipy's ``binned_statistic``).
The cosine is the binned vectors' dot product over their norms, 0 where
either is empty; a cluster's score is the mean over its members."""

from __future__ import annotations

import numpy as np

from benchmark.reference.segments import run_starts, run_sums

KEY_BITS = 21  # bins per pair below 2**21: m/z below 10,000 at 0.005 Da


def _binned(pair: np.ndarray, mz: np.ndarray, weight: np.ndarray,
            space: float, n_edges: np.ndarray):
    """Each pair's nonzero bins as (sorted keys pair << KEY_BITS | bin,
    sums); ``pair`` and ``mz`` ascending within each pair."""
    last_edge = -space / 2.0 + (n_edges[pair] - 1) * space
    ok = (mz >= -space / 2.0) & (mz <= last_edge) & (n_edges[pair] >= 2)
    idx = np.floor((mz[ok] + space / 2.0) / space).astype(np.int64)
    top = n_edges[pair[ok]] - 1
    idx = np.where(idx == top, top - 1, idx)
    keys = (pair[ok] << KEY_BITS) | idx
    starts = run_starts(keys)
    return keys[starts], run_sums(weight[ok], starts)


def mean_cosines(member_of_cluster_off: np.ndarray, peak_off: np.ndarray,
                 mz: np.ndarray, intensity: np.ndarray,
                 rep_off: np.ndarray, rep_mz: np.ndarray,
                 rep_int: np.ndarray, config: dict) -> tuple[np.ndarray,
                                                             dict]:
    """(C,) mean cosine of each cluster's members to its representative,
    and the sizes the QC's work model counts.

    ``member_of_cluster_off`` (C + 1) gives each cluster's members,
    ``peak_off`` (M + 1) each member's peaks in ``mz``/``intensity``;
    ``rep_off`` (C + 1) each representative's peaks."""
    space = float(config["mz_unit"]) * float(config["mz_space_factor"])
    if config.get("normalization", "none") != "none":
        raise ValueError("the reference computes the raw-intensity cosine")
    n_clusters = member_of_cluster_off.size - 1
    n_members = np.diff(member_of_cluster_off)
    n_pairs = int(member_of_cluster_off[-1])
    cluster = np.repeat(np.arange(n_clusters), n_members)
    m_len = np.diff(peak_off)
    r_len = np.diff(rep_off)[cluster]
    m_last = np.where(m_len > 0, mz[np.maximum(peak_off[1:] - 1, 0)],
                      -np.inf)
    r_last_c = np.where(np.diff(rep_off) > 0,
                        rep_mz[np.maximum(rep_off[1:] - 1, 0)], -np.inf)
    r_last = r_last_c[cluster]
    max_mz = np.maximum(m_last, r_last)
    # len(arange(start, stop, step)) = ceil((stop - start) / step)
    n_edges = np.where(
        (m_len > 0) & (r_len > 0),
        np.ceil((max_mz + space / 2.0) / space), 0).astype(np.int64)
    pairs = np.arange(n_pairs, dtype=np.int64)
    m_keys, m_vals = _binned(np.repeat(pairs, m_len), mz, intensity, space,
                             n_edges)
    # each pair's copy of its cluster's representative
    r_first = rep_off[:-1][cluster]
    r_pair = np.repeat(pairs, r_len)
    r_idx = (np.arange(int(r_len.sum())) - np.repeat(
        np.cumsum(r_len) - r_len, r_len) + np.repeat(r_first, r_len))
    r_keys, r_vals = _binned(r_pair, rep_mz[r_idx], rep_int[r_idx], space,
                             n_edges)
    if m_keys.size:
        pos = np.minimum(np.searchsorted(m_keys, r_keys), m_keys.size - 1)
        hit = m_keys[pos] == r_keys
    else:
        pos = np.zeros(r_keys.size, dtype=np.int64)
        hit = np.zeros(r_keys.size, dtype=bool)
    dot = np.bincount(r_keys[hit] >> KEY_BITS,
                      weights=r_vals[hit] * m_vals[pos[hit]],
                      minlength=n_pairs)
    nm = np.bincount(m_keys >> KEY_BITS, weights=m_vals * m_vals,
                     minlength=n_pairs)
    nr = np.bincount(r_keys >> KEY_BITS, weights=r_vals * r_vals,
                     minlength=n_pairs)
    ok = (nm > 0) & (nr > 0)
    cos = np.zeros(n_pairs)
    cos[ok] = dot[ok] / np.sqrt(nm[ok] * nr[ok])
    sums = np.bincount(cluster, weights=cos, minlength=n_clusters)
    mean = np.where(n_members > 0, sums / np.maximum(n_members, 1), 0.0)
    sizes = {"qc_pairs": n_pairs, "qc_member_bins": int(m_keys.size),
             "qc_rep_bins": _rep_bins(rep_off, rep_mz, space),
             "qc_member_peaks": int(m_len.sum())}
    return mean, sizes


def _rep_bins(rep_off: np.ndarray, rep_mz: np.ndarray, space: float) -> int:
    """Nonzero bins of the representatives' own vectors (each counted
    once, on its own grid)."""
    n = np.diff(rep_off)
    owner = np.repeat(np.arange(n.size, dtype=np.int64), n)
    keys = (owner << KEY_BITS) | np.floor(
        (rep_mz + space / 2.0) / space).astype(np.int64)
    return int(run_starts(keys).size)
