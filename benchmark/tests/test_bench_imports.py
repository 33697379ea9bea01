"""No module under ``benchmark/`` imports JAX or the JAX package, and
the reference imports nothing of the port; top-level module names are
compared whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
NEVER = {"jax", "jaxlib", "flax", "specpride_tpu"}


def imported_roots(path: str) -> set[str]:
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def python_files(top: str) -> list[str]:
    return [os.path.join(d, f) for d, _, files in os.walk(top)
            for f in files if f.endswith(".py")]


def test_nothing_imports_jax_or_the_jax_package():
    files = python_files(BENCH)
    assert len(files) > 20
    bad = {f: imported_roots(f) & NEVER for f in files}
    assert not {f: r for f, r in bad.items() if r}


def test_the_reference_imports_nothing_of_the_port():
    files = python_files(os.path.join(BENCH, "reference"))
    assert files
    for f in files:
        roots = imported_roots(f)
        assert "specpride_tpu_torch" not in roots, f
        assert roots <= {"__future__", "dataclasses", "numpy",
                         "benchmark"}, (f, roots)


def test_the_port_name_is_not_the_jax_package_name():
    assert "specpride_tpu_torch".split(".")[0] not in NEVER


def test_a_jax_module_loaded_after_the_window_gives_no_result(
        tiny_root, monkeypatch):
    """The last look at ``sys.modules`` comes after the reference, the
    readers and the work model have been loaded."""
    import sys
    import time
    import types

    from benchmark import run, spec

    cell = spec.Cell("gap.run8k", tiny_root)
    real = cell.reference

    def reference_that_loads_the_jax_package():
        monkeypatch.setitem(sys.modules, "specpride_tpu.ops",
                            types.ModuleType("specpride_tpu.ops"))
        return real()

    monkeypatch.setattr(cell, "reference",
                        reference_that_loads_the_jax_package)
    r = run.Run(cell, 11, 0.2, False, device="cpu",
                t_start=time.perf_counter())
    try:
        r.execute()
    except RuntimeError as exc:
        assert "specpride_tpu" in str(exc)
    else:
        raise AssertionError("a result despite the JAX package loaded")
