"""The device trace's reduction on a hand-made trace: the clock tie, the
merged busy time, the idle gaps and their labels."""

from __future__ import annotations

import json

import pytest

from benchmark import devtrace


def test_busy_idle_and_labels(tmp_path):
    us = 1e6
    events = [
        # the jobs' ranges: the trace clock is perf_counter - 9 s
        {"name": devtrace.JOB_RANGE, "cat": "user_annotation", "ts": 1 * us,
         "dur": 2 * us},
        {"name": devtrace.JOB_RANGE, "cat": "user_annotation", "ts": 3 * us,
         "dur": 2 * us},
        {"name": "seg_mean", "cat": "kernel", "ts": 1.5 * us,
         "dur": 0.2 * us},
        {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 1.6 * us,
         "dur": 0.2 * us},
        {"name": "aten::add", "cat": "cpu_op", "ts": 2 * us, "dur": us},
    ]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    journal = tmp_path / "job.jsonl"
    journal.write_text("\n".join(json.dumps(e) for e in [
        {"event": "span", "name": "pack", "mono": 12.5, "dur_s": 2.0,
         "depth": 1, "tid": 1},
        {"event": "span", "name": "chunk", "mono": 12.5, "dur_s": 2.0,
         "depth": 0, "tid": 1},
        {"event": "run_end"},
    ]) + "\n")
    got = devtrace.summarize(str(trace), [str(journal)], [10.0, 12.0],
                             10.0, 14.0)
    assert got["window_s"] == pytest.approx(4.0)
    assert got["busy_s"] == pytest.approx(0.3)
    ops = dict(got["breakdown"]["device_ops"])
    assert ops == pytest.approx({"seg_mean": 0.2, "Memcpy HtoD": 0.2})
    idle = dict(got["breakdown"]["idle_gaps"])
    # 1.0-1.5 s on the trace's clock: nothing open; 1.8-5.0: the pack
    # span (the deepest on its lane) was open at the gap's middle
    assert idle == pytest.approx({"(no span)": 0.5, "pack": 3.2})


def test_no_device_operation_reads_nothing(tmp_path):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"name": devtrace.JOB_RANGE, "cat": "user_annotation", "ts": 0,
         "dur": 10}]}))
    assert devtrace.summarize(str(trace), [], [0.0], 0.0, 1.0) is None
