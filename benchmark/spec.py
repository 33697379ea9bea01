"""What a cell is made of, found by name: ``BENCHMARK.json``'s entries,
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``work/<config>.py`` and
``reference/<reference>.py``.  A later change adds a file and an entry;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """The module in ``path`` under ``name``; a file name may hold ``-``
    or ``.``, so it is loaded by path, not imported by name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One ``workloads`` entry with its configuration, its traffic mix
    and the metric entries it reports."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        bench_dir = os.path.join(root, "benchmark")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have: {', '.join(sorted(cells))})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic_path = os.path.join(
            bench_dir, "traffic", self.entry["traffic"] + ".json")
        self.traffic = load_json(self.traffic_path)
        self.chips = int(self.entry["chips"])
        self.bench_dir = bench_dir

    def _reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    @property
    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self._reports(m)]

    @property
    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self._reports(m)]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read(run)``."""
        return load_module(
            os.path.join(self.bench_dir, "metrics", metric + ".py"),
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        ).read

    def work_model(self):
        """``work/<config>.py``'s ``work(sizes, precision)``."""
        name = self.entry["config"]
        return load_module(
            os.path.join(self.bench_dir, "work", name + ".py"),
            "benchmark_work_" + name.replace(".", "_").replace("-", "_"),
        ).work

    def reference(self):
        """``reference/<name>.py``, the plain reference the configuration
        names under ``reference``."""
        return importlib.import_module(
            "benchmark.reference." + self.config["reference"])
