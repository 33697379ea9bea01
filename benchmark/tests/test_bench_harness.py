"""The harness's job loop, comparison and metric readers on a tiny cell,
through their functions, on the CPU; the command without a
card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types

from benchmark import run, spec
from conftest import ROOT


def tiny_run(root: str, cell: str, trace: bool, seed: int = 2**31 + 7):
    r = run.Run(spec.Cell(cell, root), seed, 0.5, trace, device="cpu",
                t_start=time.perf_counter())
    return r.execute()


def test_untraced_run_reports_the_end_to_end_metrics(tiny_root):
    res = tiny_run(tiny_root, "binmean_qc.run8k", trace=False)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"peak_rss_gib", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "check"
    assert res["check"]["mismatched_reps"]["value"] == 0
    for c in res["check"].values():
        assert c["value"] <= c["limit"]


def test_traced_run_reads_the_per_layer_metrics(tiny_root):
    res = tiny_run(tiny_root, "binmean_qc.run8k", trace=True)
    assert res["correct"] is True
    got = set(res["metrics"])
    # two chunks (the pipelined executor); the CPU has no device trace,
    # so its two readers find nothing to read
    assert {"import_s", "dispatch_wait_share", "pack_ms_per_kspectra",
            "mgf_io_ms_per_kspectra", "h2d_bytes_per_spectrum",
            "traced_spectra_per_s"} <= got
    assert not got & {"device_roofline", "device_idle_share"}
    assert 0.0 <= res["metrics"]["dispatch_wait_share"]["value"] <= 1.0


def test_gap_cell_runs_and_checks(tiny_root):
    res = tiny_run(tiny_root, "gap.run8k", trace=False)
    assert res["correct"] is True
    assert set(res["check"]) == {"mismatched_reps", "peak_gap"}


def test_command_arguments_are_exactly_four():
    args = run.command_args(["--workload", "a.b", "--seed", "4294967311",
                            "--seconds", "30", "--trace", "1"])
    assert args == {"workload": "a.b", "seed": 4294967311, "seconds": 30.0,
                    "trace": True}
    for bad in (["--workload", "a"], ["--workload", "a", "--seed", "1",
                                      "--seconds", "3", "--trace", "0",
                                      "--x", "1"]):
        try:
            run.command_args(bad)
        except SystemExit:
            continue
        raise AssertionError(bad)


def test_without_a_card_the_command_prints_no_result(tiny_root, tmp_path):
    env = {**os.environ, "TMPDIR": str(tmp_path), "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "binmean_qc.run8k", "--seed", "5", "--seconds", "1", "--trace",
         "0"], cwd=tiny_root, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
    assert "peak_rss_gib" not in proc.stdout
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith("specpride-bench-")]


def test_result_line_is_last_on_stdout_and_checks_last_on_stderr(capsys):
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "check": {"peak_gap": {"value": 1e-7,
                                                   "limit": 1e-5}}}
    run.report(result)
    out, err = capsys.readouterr()
    assert json.loads(out.splitlines()[-1]) == result
    assert err.splitlines()[-1] == "check peak_gap 1e-07 limit 1e-05"


def test_every_job_output_is_checked(tiny_root, monkeypatch):
    """A fault in any one job's output shows, also in a later job's, and
    an output that cannot be read matches no cluster."""
    clock = iter(range(10**6))
    monkeypatch.setattr(run, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(clock))))
    r = run.Run(spec.Cell("gap.run8k", tiny_root), 2**31 + 9, 6.5, False,
                device="cpu", t_start=0.0)
    try:
        torch, cli = r.setup()
        win = r.window(torch, cli)
        assert len(win["starts"]) == 4  # one clock tick a reading
        paths = [out for out, _ in win["outputs"]]
        assert len(set(paths)) == 4  # one output a job, none overwritten
        assert not os.listdir(r.work)  # held in memory, none on disk
        numbers, _ = r.verify(win)
        assert numbers["mismatched_reps"] == 0
        third = paths[2]
        with open(third, "rb") as fh:
            text = fh.read()
        with open(third, "wb") as fh:
            fh.write(text.replace(b"END IONS", b"", 1))
        numbers, _ = r.verify(win)
        assert numbers["mismatched_reps"] == r.cell.traffic["clusters"]
    finally:
        shutil.rmtree(r.work, ignore_errors=True)
