"""The plain reference against tiny port runs on the CPU: the
configuration's float32 passes every limit, and the control (the port's
``--precision bf16``, and int8 below it) fails one."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import check, control, generate, spec
from benchmark.reference import bin_mean_qc, gap_average


@pytest.mark.parametrize("cell", ["binmean_qc.run8k", "gap.run8k"])
def test_f32_passes_and_the_controls_fail(tiny_root, cell):
    c = spec.Cell(cell, tiny_root)
    limits = c.config["check"]["limits"]
    rows = control.readings(c, ["f32", "bf16", "int8"], [2**31 + 11],
                            device="cpu")
    by = {r["precision"]: r for r in rows}
    assert all(r["ok"] for r in rows)
    assert check.judge(by["f32"], limits)
    assert not check.judge(by["bf16"], limits)
    assert not check.judge(by["int8"], limits)
    assert by["f32"]["mismatched_reps"] == 0


def test_a_singleton_passes_through_the_gap_average():
    traffic = {"clusters": 3, "law_seed": 0,
               "members": {"shape": 2.0, "scale": 2.5, "offset": 1,
                           "max": 1},
               "peaks": {"low": 5, "high": 6},
               "mz": {"low": 120.0, "high": 1900.0, "jitter": 0.003},
               "intensity": {"low": 10.0, "high": 10000.0},
               "precursor_mz": {"low": 300.0, "high": 900.0},
               "charges": [2], "decimals": {"mz": 12, "intensity": 11,
                                            "precursor": 6}}
    w = generate.make_workload(traffic, 3)
    ref = gap_average.run(w, {"method": {"mz_accuracy": 0.01,
                                          "dyn_range": 1000.0,
                                          "min_fraction": 0.5}})
    assert np.array_equal(ref.offsets, w.offsets)
    assert np.array_equal(ref.mz, w.mz)
    assert np.array_equal(ref.intensity, w.intensity)


def test_bin_mean_keeps_a_members_last_peak_in_a_bin():
    w = generate.Workload(
        cluster_ids=["c0"], member_offsets=np.array([0, 2]),
        offsets=np.array([0, 2, 3]),
        mz=np.array([500.001, 500.011, 500.005]),
        intensity=np.array([10.0, 30.0, 50.0]),
        precursor_mz=np.array([400.0, 402.0]), charge=np.array([2, 2]),
        rt=np.zeros(2), scans=np.arange(2), mz_code=np.zeros(3, int),
        intensity_code=np.zeros(3, int), decimals={})
    ref = bin_mean_qc.run(w, {"method": {
        "min_mz": 100.0, "max_mz": 2000.0, "bin_size": 0.02,
        "quorum_fraction": 0.25, "apply_peak_quorum": True}})
    # one bin: member 0 gives its last peak (30), member 1 its only (50)
    assert ref.offsets.tolist() == [0, 1]
    assert ref.intensity.tolist() == [40.0]
    assert ref.mz[0] == pytest.approx((500.011 + 500.005) / 2, rel=1e-7)
    assert ref.pepmass.tolist() == [401.0]
