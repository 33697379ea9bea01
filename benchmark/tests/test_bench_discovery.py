"""A traffic mix, a per-layer metric, a configuration and a work model
dropped into a copy of the benchmark as files, with their entries, are
found by name: nothing already there is edited."""

from __future__ import annotations

import json
import os

from benchmark import spec


def add_files(root: str) -> None:
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", "run8k.json")) as fh:
        traffic = json.load(fh)
    traffic["clusters"] = 16
    with open(os.path.join(bench, "traffic", "tiny16.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(bench, "metrics", "jobs_in_window.py"),
              "w") as fh:
        fh.write("def read(run):\n    return float(len(run['jobs']))\n")
    with open(os.path.join(bench, "configs",
                           "pxd004732-binmean-qc.json")) as fh:
        config = json.load(fh)
    config["name"] = "pxd004732-binmean-noqc"
    config["argv"] = config["argv"][:5]
    config.pop("qc")
    config["check"]["limits"].pop("cosine_gap")
    with open(os.path.join(bench, "configs",
                           "pxd004732-binmean-noqc.json"), "w") as fh:
        json.dump(config, fh)
    with open(os.path.join(bench, "work", "pxd004732-binmean-noqc.py"),
              "w") as fh:
        fh.write("def work(sizes, precision):\n"
                 "    return {'bytes': 7 * sizes['peaks'], 'flops': 0}\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench_json = json.load(fh)
    bench_json["configs"].append({
        "name": "pxd004732-binmean-noqc", "source": "test", "reduced": [],
        "file": "benchmark/configs/pxd004732-binmean-noqc.json",
        "why": "test"})
    bench_json["workloads"].append({
        "name": "noqc.tiny16", "config": "pxd004732-binmean-noqc",
        "traffic": "tiny16", "chips": 1, "why": "test"})
    bench_json["per_layer"].append({
        "name": "jobs_in_window", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "executor",
        "moves": "spectra_per_s", "workloads": ["noqc.tiny16"]})
    with open(path, "w") as fh:
        json.dump(bench_json, fh)


def test_new_files_are_found_by_name(tiny_root):
    add_files(tiny_root)
    cell = spec.Cell("noqc.tiny16", tiny_root)
    assert cell.traffic["clusters"] == 16
    assert cell.config["name"] == "pxd004732-binmean-noqc"
    assert [m["name"] for m in cell.per_layer] == ["jobs_in_window"]
    assert cell.reader("jobs_in_window")({"jobs": [{}, {}]}) == 2.0
    assert cell.work_model()({"peaks": 3}, "f32")["bytes"] == 21
    assert cell.reference().__name__ == "benchmark.reference.bin_mean_qc"
    # the cells already there are unchanged
    old = spec.Cell("binmean_qc.run8k", tiny_root)
    assert "jobs_in_window" not in [m["name"] for m in old.per_layer]


def test_a_new_cell_runs_end_to_end(tiny_root):
    import time

    from benchmark import run

    add_files(tiny_root)
    cell = spec.Cell("noqc.tiny16", tiny_root)
    res = run.Run(cell, 9, 0.2, True, device="cpu",
                  t_start=time.perf_counter()).execute()
    assert res["correct"] is True
    assert res["metrics"] == {"jobs_in_window": {
        "value": float(res["attempted"]), "unit": "jobs"}}
