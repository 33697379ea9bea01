"""Each work model's bytes on a two-cluster job counted by hand."""

from __future__ import annotations

import numpy as np

from benchmark import generate, spec
from conftest import ROOT


def job(peaks: list[list[float]], members: list[int]) -> generate.Workload:
    """Clusters of ``members`` spectra with the given peaks, intensity 100
    each."""
    mz = np.array([p for spectrum in peaks for p in spectrum])
    offsets = np.cumsum([0] + [len(p) for p in peaks])
    n = len(peaks)
    return generate.Workload(
        cluster_ids=[f"c{i}" for i in range(len(members))],
        member_offsets=np.cumsum([0] + members), offsets=offsets, mz=mz,
        intensity=np.full(mz.size, 100.0),
        precursor_mz=np.full(n, 400.0), charge=np.full(n, 2),
        rt=np.zeros(n), scans=np.arange(n),
        mz_code=np.zeros(mz.size, dtype=np.int64),
        intensity_code=np.zeros(mz.size, dtype=np.int64), decimals={})


def model_bytes(cell: str, w) -> tuple[dict, int]:
    c = spec.Cell(cell, ROOT)
    sizes = c.reference().run(w, c.config).sizes
    return sizes, c.work_model()(sizes, "f32")["bytes"]


def test_bin_mean_with_qc():
    # cluster 0: two members, cluster 1: one
    w = job([[200.001, 200.011, 300.0], [200.005, 400.0], [500.0, 600.0]],
            [2, 1])
    sizes, got = model_bytes("binmean_qc.run8k", w)
    # member bins: member 0 has two peaks in bin 5000 (one counts), a
    # bin at 300; member 1 two bins; member 2 two: 6; runs of (cluster,
    # bin): 200, 300, 400 and 500, 600: 5, every one kept (quorum 1)
    assert (sizes["member_bins"], sizes["kept_runs"]) == (6, 5)
    mean = 6 * (4 + 1) + 5 * 4
    # QC grid: each pair drops the peak at its own largest m/z (past the
    # grid's last edge): member 0 keeps 3 bins, member 1 one (400 goes),
    # member 2 one (600 goes); the representatives' own bins: 3 + 2
    assert (sizes["qc_member_bins"], sizes["qc_rep_bins"],
            sizes["qc_pairs"]) == (5, 5, 3)
    qc = (5 + 5) * 8 + 3 * 4
    assert got == mean + qc == 142


def test_gap_average():
    # cluster 0: 200.0, 200.005 | 300.0, 300.004 (one gap: two groups);
    # cluster 1, one member: each peak its own group
    w = job([[200.0, 300.0], [200.005, 300.004], [500.0, 600.0]], [2, 1])
    sizes, got = model_bytes("gap.run8k", w)
    assert (sizes["peaks"], sizes["groups"]) == (6, 4)
    assert got == 6 * (4 + 1) + 4 * (4 + 1) == 50
