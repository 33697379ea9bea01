"""The port's command line, MGF I/O and import hygiene.

The golden comparison: header lines identical; m/z equal to the JAX
package's flat path bit for bit and within the JAX package's own
device-vs-golden tolerance of the oracle's golden bytes (rtol 1e-5 /
atol 1e-3: the oracle sums m/z in another float32 order); intensity
within rtol 1e-4 / atol 1e-3."""

import ast
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from specpride_tpu import cli as jcli
from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.data.peaks import group_into_clusters as jax_group
from specpride_tpu.io import mgf as jmgf
from specpride_tpu_torch.io import mgf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
PKG = os.path.join(REPO, "specpride_tpu_torch")


def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _headers(path):
    with open(path) as fh:
        return [ln for ln in fh if not ln[:1].isdigit()]


def test_cli_reproduces_golden_bin_mean(tmp_path):
    out = tmp_path / "out.mgf"
    proc = _run(
        "-m", "specpride_tpu_torch", "consensus",
        os.path.join(DATA, "golden_clustered.mgf"), str(out),
        "--device", "cpu",
    )
    assert proc.returncode == 0, proc.stderr
    golden = os.path.join(DATA, "golden_bin_mean.mgf")
    assert _headers(out) == _headers(golden)
    got = mgf.read_mgf(out)
    want = mgf.read_mgf(golden)
    jax_reps = TpuBackend(layout="flat").run_bin_mean(jax_group(
        jmgf.read_mgf(os.path.join(DATA, "golden_clustered.mgf"),
                      use_native=False)
    ))
    assert len(got) == len(want) == len(jax_reps) == 3
    for g, w, j in zip(got, want, jax_reps):
        np.testing.assert_array_equal(g.mz, j.mz)
        np.testing.assert_allclose(g.mz, w.mz, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(
            g.intensity, w.intensity, rtol=1e-4, atol=1e-3
        )


def test_cli_qc_report_matches_jax_flat(tmp_path):
    """``--qc-report``: the same spectra as without it, and a report with
    the JAX package's keys, ids and member counts whose cosines match its
    flat run within rtol 1e-5 / atol 1e-6; the singleton scores 1."""
    src = os.path.join(DATA, "golden_clustered.mgf")
    out, plain_out = tmp_path / "out.mgf", tmp_path / "plain.mgf"
    qc = tmp_path / "qc.json"
    proc = _run("-m", "specpride_tpu_torch", "consensus", src, str(out),
                "--device", "cpu", "--qc-report", str(qc))
    assert proc.returncode == 0, proc.stderr
    proc = _run("-m", "specpride_tpu_torch", "consensus", src,
                str(plain_out), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == plain_out.read_bytes()

    clusters = jax_group(jmgf.read_mgf(src, use_native=False))
    _, cosines = TpuBackend(layout="flat").run_bin_mean_with_cosines(
        clusters
    )
    rows = []
    jcli._append_qc_rows(rows, clusters, cosines)
    jax_qc = tmp_path / "jax_qc.json"
    jcli._write_qc_report(
        types.SimpleNamespace(qc_report=str(jax_qc), output=str(out)),
        None, clusters, rows, None, set(),
    )
    got = json.loads(qc.read_text())
    want = json.loads(jax_qc.read_text())
    assert list(got) == list(want)
    assert list(got["summary"]) == list(want["summary"])
    for key in ("n_clusters", "n_input_clusters", "n_method_failed",
                "n_qc_failed"):
        assert got["summary"][key] == want["summary"][key]
    for key in ("mean_cosine", "median_cosine"):
        np.testing.assert_allclose(got["summary"][key],
                                   want["summary"][key], rtol=1e-5, atol=1e-6)
    assert [(r["cluster_id"], r["n_members"]) for r in got["clusters"]] == [
        (r["cluster_id"], r["n_members"]) for r in want["clusters"]
    ]
    assert [list(r) for r in got["clusters"]] == [
        list(r) for r in want["clusters"]
    ]
    np.testing.assert_allclose(
        [r["avg_cosine"] for r in got["clusters"]],
        [r["avg_cosine"] for r in want["clusters"]], rtol=1e-5, atol=1e-6,
    )
    singles = [r for r in got["clusters"] if r["n_members"] == 1]
    assert singles and all(r["avg_cosine"] == pytest.approx(1.0, rel=1e-6)
                           for r in singles)


@pytest.mark.parametrize("name", [
    "golden_clustered.mgf", "golden_bin_mean.mgf", "golden_gap_average.mgf",
])
def test_mgf_read_write_match_jax(name, tmp_path):
    path = os.path.join(DATA, name)
    got = mgf.read_mgf(path)
    want = jmgf.read_mgf(path, use_native=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mz, w.mz)
        np.testing.assert_array_equal(g.intensity, w.intensity)
        assert (g.title, g.precursor_mz, g.precursor_charge, g.rt,
                g.extra) == (w.title, w.precursor_mz, w.precursor_charge,
                             w.rt, w.extra)
    mgf.write_mgf(got, tmp_path / "port.mgf")
    jmgf.write_mgf(want, tmp_path / "jax.mgf")
    assert (tmp_path / "port.mgf").read_bytes() == (
        tmp_path / "jax.mgf"
    ).read_bytes()


def test_import_and_help_load_no_jax():
    code = (
        "import sys, specpride_tpu_torch\n"
        "import specpride_tpu_torch.backends.torch_backend\n"
        "import specpride_tpu_torch.ops.similarity\n"
        "from specpride_tpu_torch.cli import main\n"
        "try:\n"
        "    main(['consensus', '--help'])\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'specpride_tpu.'))\n"
        "             or m == 'specpride_tpu')\n"
        "print('LOADED', bad)\n"
    )
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--qc-report" in proc.stdout
    assert "LOADED []" in proc.stdout


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_package_source_imports_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    bad = [
        (os.path.relpath(f, REPO), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "specpride_tpu")
    ]
    assert bad == []
    assert len(files) > 10


def test_cli_without_cuda_refuses_default_device(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from specpride_tpu_torch.cli import main\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )
    out = tmp_path / "out.mgf"
    proc = _run("-c", code, "consensus",
                os.path.join(DATA, "golden_clustered.mgf"), str(out))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not out.exists()
