"""The binned-mean consensus (ref ``src/binning.py:170-231``) and its QC
cosine (ref ``src/benchmark.py:31-38``), in float64.

Per cluster: each member's peaks in [min_mz, max_mz) fall into bins
``int((mz - min_mz) / bin_size)``; a member with several peaks in one bin
gives only its last (the reference's buffered ``+=``); a bin is kept when
at least ``int(n_members * quorum_fraction) + 1`` members gave it a peak;
its m/z and intensity are the means over those members, the m/z summed
in float32 in member order as the reference's accumulators are (the
intensity in float64).  The precursor
m/z is the members' mean, the charge theirs (one per cluster), the title
the cluster id, and the record carries no RT."""

from __future__ import annotations

import numpy as np

from benchmark.reference.cosine import mean_cosines
from benchmark.reference.result import Reps
from benchmark.reference.segments import offsets_of, run_starts, run_sums


def consensus(w, method: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                         dict]:
    """(rep offsets, m/z, intensity, sizes) of every cluster."""
    lo, hi = float(method["min_mz"]), float(method["max_mz"])
    size = float(method["bin_size"])
    n_bins = int((hi - lo) / size) + 1
    member = w.member_of_peak()
    cluster = w.cluster_of_member()[member]
    ok = (w.mz >= lo) & (w.mz < hi)
    bins = ((w.mz[ok] - lo) / size).astype(np.int64)
    member, cluster = member[ok], cluster[ok]
    mz, inten = w.mz[ok], w.intensity[ok]
    # a member's peaks are sorted, so its equal bins are adjacent: keep
    # the last of each (member, bin) run
    last = np.r_[(member[1:] != member[:-1]) | (bins[1:] != bins[:-1]),
                 True]
    key = cluster[last] * (n_bins + 1) + bins[last]
    order = np.argsort(key, kind="stable")
    key = key[order]
    starts = run_starts(key)
    counts = np.diff(np.r_[starts, key.size])
    # float32 sums, as the reference's accumulators (one float32 ulp of a
    # representative's m/z moves it across a QC cosine bin now and then)
    mz_sum = np.add.reduceat(mz[last][order].astype(np.float32),
                             starts).astype(np.float64) if starts.size \
        else np.zeros(0)
    int_sum = run_sums(inten[last][order], starts)
    run_cluster = key[starts] // (n_bins + 1)
    n_members = np.diff(w.member_offsets)
    quorum = (np.floor(n_members * float(method["quorum_fraction"]))
              .astype(np.int64) + 1 if method["apply_peak_quorum"]
              else np.ones_like(n_members))
    keep = counts >= quorum[run_cluster]
    rep_off = offsets_of(np.bincount(run_cluster[keep],
                                     minlength=w.n_clusters))
    sizes = {
        "clusters": w.n_clusters, "members": w.n_spectra,
        "peaks": w.n_peaks, "peaks_in_range": int(ok.sum()),
        "member_bins": int(last.sum()), "runs": int(starts.size),
        "kept_runs": int(keep.sum()),
    }
    return (rep_off, mz_sum[keep] / counts[keep],
            int_sum[keep] / counts[keep], sizes)


def run(w, config: dict) -> Reps:
    rep_off, mz, inten, sizes = consensus(w, config["method"])
    member_off = w.member_offsets
    n_members = np.diff(member_off)
    pepmass = (np.bincount(w.cluster_of_member(), weights=w.precursor_mz,
                           minlength=w.n_clusters)
               / np.maximum(n_members, 1))
    cosines = None
    if config.get("qc") is not None:
        cosines, qc_sizes = mean_cosines(member_off, w.offsets, w.mz,
                                         w.intensity, rep_off, mz, inten,
                                         config["qc"])
        sizes.update(qc_sizes)
    return Reps(offsets=rep_off, mz=mz, intensity=inten, pepmass=pepmass,
                charge=w.charge[member_off[:-1]],
                rt=np.zeros(w.n_clusters), cosines=cosines, sizes=sizes)
