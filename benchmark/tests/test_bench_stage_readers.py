"""The readers of the host's stages on hand-made runs: the streamed
window parse and the process's CPU, what each reads, and that a run
summary without their keys (a port before they were counted) gives
nothing."""

from __future__ import annotations

import pytest

from benchmark import spec
from conftest import ROOT

JOB = {"phases_s": {"parse": 0.5, "window_parse": 0.25, "pack": 1.0},
       "phases_cpu_s": {"parse": [0.25, 0.25], "window_parse": [0.2, 0.05],
                        "pack": [0.75, 0.25]},
       "cpu_s": {"user": 3.0, "sys": 1.0}}
RUN = {"jobs": [JOB, JOB], "spectra": 1000}
OLD_JOB = {"phases_s": {"parse": 0.5, "pack": 1.25}}


def read(name: str, run: dict):
    return spec.Cell("binmean_qc.run8k", ROOT).reader(name)(run)


@pytest.mark.parametrize("name, want", [
    ("window_parse_ms_per_kspectra", 250.0),  # 0.5 s over 2,000 spectra
    ("host_cpu_ms_per_kspectra", 4000.0),  # 8 CPU s over 2,000 spectra
    ("host_sys_share", 0.25),
])
def test_stage_reader(name, want):
    assert read(name, RUN) == pytest.approx(want)


@pytest.mark.parametrize("name", ["window_parse_ms_per_kspectra",
                                  "host_cpu_ms_per_kspectra",
                                  "host_sys_share"])
@pytest.mark.parametrize("jobs", [[OLD_JOB, OLD_JOB], [JOB, OLD_JOB], []],
                         ids=["parent", "mixed", "no-job"])
def test_missing_key_reads_nothing(name, jobs):
    assert read(name, {**RUN, "jobs": jobs}) is None


def test_no_cpu_counted_gives_no_share():
    job = {**JOB, "cpu_s": {"user": 0.0, "sys": 0.0}}
    assert read("host_sys_share", {**RUN, "jobs": [job]}) is None
