"""Fixtures of the benchmark's tests: a copy of the benchmark whose
traffic mixes are cut to a few hundred clusters, and the card check of
the tests marked ``cuda`` (made inside a fixture, never at import)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CLUSTERS = {"run8k": 600}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def copy_benchmark(dst: str, clusters: dict | None = None) -> str:
    """``BENCHMARK.json`` and ``benchmark/`` under ``dst``, each traffic
    mix cut to ``clusters`` (by name) and a short warm-up."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, n in (clusters or {}).items():
        path = os.path.join(dst, "benchmark", "traffic", name + ".json")
        with open(path, encoding="utf-8") as fh:
            traffic = json.load(fh)
        traffic["clusters"] = n
        traffic["warmup_clusters"] = 8
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(traffic, fh)
    return dst


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A copy of the benchmark at a few hundred clusters a job; runs'
    scratch goes under the test's own temporary directory."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return copy_benchmark(str(tmp_path), TINY_CLUSTERS)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the harness's card path runs on "
                    "the chip")
    return torch.cuda.get_device_name(0)
