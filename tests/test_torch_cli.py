"""The port's command line, MGF I/O and import hygiene.

The golden comparison: header lines identical; m/z equal to the JAX
package's flat path bit for bit and within the JAX package's own
device-vs-golden tolerance of the oracle's golden bytes (rtol 1e-5 /
atol 1e-3: the oracle sums m/z in another float32 order); intensity
within rtol 1e-4 / atol 1e-3."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

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
    assert "--device" in proc.stdout
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
