"""The per-layer readers on hand-made runs: what each reads, and that a
reader with nothing to read returns nothing."""

from __future__ import annotations

import pytest

from benchmark import spec
from conftest import ROOT

JOB = {"phases_s": {"parse": 0.5}, "backend": {"h2d_bytes": {"h2d": 900,
                                                            "qc_h2d": 100}},
       "pipeline": {"device_idle_s": 1.0, "wall_s": 4.0,
                    "pack_busy_s": [1.5, 2.5], "write_busy_s": 0.5}}
RUN = {"jobs": [JOB, JOB], "spectra": 1000, "import_s": 7.5,
       "config": {"precision": "f32"},
       "device": {"busy_s": 0.5, "window_s": 10.0},
       "work": {"bytes": 3.35e9, "flops": 0}}


def read(name: str, run: dict):
    return spec.Cell("binmean_qc.run8k", ROOT).reader(name)(run)


@pytest.mark.parametrize("name, want", [
    ("import_s", 7.5),
    ("dispatch_wait_share", 0.25),
    ("pack_ms_per_kspectra", 4000.0),  # 8 s of lanes over 2,000 spectra
    ("mgf_io_ms_per_kspectra", 1000.0),  # 2 s of parse and write
    ("h2d_bytes_per_spectrum", 1.0),
    ("device_roofline", 0.4),  # 1 ms at 3.35 TB/s, twice, over 0.5 s
    ("device_idle_share", 0.95),
])
def test_reader(name, want):
    assert read(name, RUN) == pytest.approx(want)


@pytest.mark.parametrize("name", ["dispatch_wait_share",
                                  "pack_ms_per_kspectra",
                                  "device_roofline", "device_idle_share"])
def test_nothing_to_read(name):
    run = {**RUN, "jobs": [{"phases_s": {}, "backend": JOB["backend"]}],
           "device": None}
    assert read(name, run) is None
