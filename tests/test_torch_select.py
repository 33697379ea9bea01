"""``select --method best|medoid`` in the port against the JAX package: the
score readers, the best-spectrum join, and the CLI's bytes and QC report
against the golden files and the JAX CLI run with the same flags.

The golden ``golden_medoid.mgf`` and ``golden_best.mgf`` are the JAX CLI's
bytes as well (``test_cli_select_writes_golden_bytes`` checks both), so
the port's output is held to both at once.  QC cosines: rtol 1e-5 / atol
1e-6 (float32 on the card path, the JAX CLI's host path in float64)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from specpride_tpu.backends import numpy_backend as jnb
from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.data.peaks import Cluster as JCluster
from specpride_tpu.data.peaks import Spectrum as JSpectrum
from specpride_tpu.data.peaks import group_into_clusters as jax_group
from specpride_tpu.io import maxquant as jmaxquant
from specpride_tpu.io import mgf as jmgf
from specpride_tpu_torch import cli
from specpride_tpu_torch.backends import numpy_backend
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BestSpectrumConfig
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.data.peaks import group_into_clusters
from specpride_tpu_torch.io import maxquant, mgf
from specpride_tpu_torch.ops import quantize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
SRC = os.path.join(DATA, "golden_clustered.mgf")
MSMS = os.path.join(DATA, "golden_msms.txt")


def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _port_select(*args):
    return _run("-m", "specpride_tpu_torch", "select", *args,
                "--device", "cpu")


def _jax_select(*args):
    return _run("-m", "specpride_tpu", "select", *args)


def _trimmed_msms(tmp_path):
    """golden_msms.txt without cluster-2's scans (17552-17554): cluster-2
    has no scored member."""
    path = tmp_path / "trimmed_msms.txt"
    with open(MSMS) as fh:
        lines = [ln for ln in fh
                 if not any(f"\t{s}\t" in ln for s in (17552, 17553, 17554))]
    path.write_text("".join(lines))
    return str(path)


# --- score sources ---------------------------------------------------------

@pytest.mark.parametrize("px", ["PXD004732", "PXD000001"])
def test_read_msms_scores_matches_jax(px):
    got = maxquant.read_msms_scores(MSMS, px)
    assert got == jmaxquant.read_msms_scores(MSMS, px)
    assert len(got) == 8


@pytest.mark.parametrize("raw_name", [None, "run7.raw", "run7"])
def test_read_percolator_scores_matches_jax(raw_name, tmp_path):
    path = tmp_path / "perc.target.psms.txt"
    path.write_text(
        "file\tscan\tcharge\tpercolator score\tsequence\n"
        "/data/run7.mzML\t100\t2\t1.5\tPEPTIDE\n"
        "/data/run7.mzML\t101\t2\t-0.5\tPEPTIDE\n"
        "/data/run7.mzML\t100\t2\t2.5\tPEPTIDER\n"
    )
    got = maxquant.read_percolator_scores(path, raw_name=raw_name)
    assert got == jmaxquant.read_percolator_scores(path, raw_name=raw_name)
    assert got["mzspec:PXD004732:run7.raw::scan:100"] == 2.5


def test_read_percolator_scores_refuses_unknown_header(tmp_path):
    path = tmp_path / "native.tsv"
    path.write_text("PSMId\tscore\tq-value\nx_1_2\t0.5\t0.01\n")
    with pytest.raises(ValueError, match="missing column") as got:
        maxquant.read_percolator_scores(path)
    with pytest.raises(ValueError, match="missing column") as want:
        jmaxquant.read_percolator_scores(path)
    assert str(got.value) == str(want.value)
    empty = tmp_path / "empty.tsv"
    empty.write_text("file\tscan\tpercolator score\n")
    assert maxquant.read_percolator_scores(empty) == {}


# --- best spectrum -----------------------------------------------------------

def _members(titles):
    return [Spectrum(np.array([100.0]), np.array([1.0]), title=t)
            for t in titles]


BEST_CASES = {
    "highest": (["c;usi:a", "c;usi:b", "c;usi:c"],
                {"usi:a": 1.0, "usi:b": 9.0, "usi:c": 5.0}),
    "tie": (["c;usi:c", "c;usi:b", "c;usi:a"],
            {"usi:c": 9.0, "usi:b": 9.0, "usi:a": 1.0}),
    "join": (["c;mzspec:PXD1:run1.raw:scan:10:PEP/2",
              "c;mzspec:PXD1:run1.raw:scan:11"],
             {"mzspec:PXD1:run1.raw::scan:10": 5.0,
              "mzspec:PXD1:run1.raw::scan:11": 50.0}),
}


@pytest.mark.parametrize("case", sorted(BEST_CASES))
def test_best_spectrum_index_matches_jax(case):
    titles, scores = BEST_CASES[case]
    got = numpy_backend.best_spectrum_index(_members(titles), scores)
    want = jnb.best_spectrum_index(
        [JSpectrum(np.array([100.0]), np.array([1.0]), title=t)
         for t in titles], scores)
    assert got == want
    if case == "tie":  # the lexicographically smallest USI of the tied
        assert got == 1
    with pytest.raises(ValueError, match="No scores"):
        numpy_backend.best_spectrum_index(_members(titles), {"x": 1.0})


def test_run_best_spectrum_matches_jax_golden():
    clusters = group_into_clusters(mgf.read_mgf(SRC))
    jclusters = jax_group(jmgf.read_mgf(SRC, use_native=False))
    scores = maxquant.read_msms_scores(MSMS)
    got = TorchBackend(device="cpu").run_best_spectrum(clusters, scores)
    want = TpuBackend().run_best_spectrum(jclusters, scores)
    assert numpy_backend.run_best_spectrum(clusters, scores) == got
    assert [s.title for s in got] == [s.title for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mz, w.mz)
        np.testing.assert_array_equal(g.intensity, w.intensity)


def test_scoreless_cluster_is_dropped():
    clusters = [Cluster("c1", _members(["c1;usi:a", "c1;usi:b"])),
                Cluster("c2", _members(["c2;usi:x"])),
                Cluster("c3", _members(["c3;usi:y", "c3;usi:z"]))]
    scores = {"usi:b": 2.0, "usi:a": 1.0, "usi:z": 0.5}
    got = TorchBackend(device="cpu").run_best_spectrum(
        clusters, scores, BestSpectrumConfig())
    assert [s.title for s in got] == ["c1;usi:b", "c3;usi:z"]
    want = jnb.run_best_spectrum(
        [JCluster(c.cluster_id, [JSpectrum(s.mz, s.intensity, title=s.title)
                                 for s in c.members]) for c in clusters],
        scores)
    assert [s.title for s in want] == [s.title for s in got]


# --- CLI -----------------------------------------------------------------

@pytest.mark.parametrize("method", ["medoid", "best"])
def test_cli_select_writes_golden_bytes(method, tmp_path):
    extra = ("--msms", MSMS) if method == "best" else ()
    out, jax_out = tmp_path / "port.mgf", tmp_path / "jax.mgf"
    proc = _port_select(SRC, str(out), "--method", method, *extra)
    assert proc.returncode == 0, proc.stderr
    golden = os.path.join(DATA, f"golden_{method}.mgf")
    assert out.read_bytes() == open(golden, "rb").read()
    proc = _jax_select(SRC, str(jax_out), "--method", method, *extra)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("case", ["medoid", "best", "best-dropped"])
def test_cli_select_qc_report_matches_jax_cli(case, tmp_path):
    method = case.split("-")[0]
    extra = ()
    if method == "best":
        msms = _trimmed_msms(tmp_path) if case.endswith("dropped") else MSMS
        extra = ("--msms", msms)
    out, qc = tmp_path / "port.mgf", tmp_path / "port.qc.json"
    jax_out, jax_qc = tmp_path / "jax.mgf", tmp_path / "jax.qc.json"
    proc = _port_select(SRC, str(out), "--method", method, *extra,
                        "--qc-report", str(qc))
    assert proc.returncode == 0, proc.stderr
    proc = _jax_select(SRC, str(jax_out), "--method", method, *extra,
                       "--qc-report", str(jax_qc))
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == jax_out.read_bytes()
    got, want = json.loads(qc.read_text()), json.loads(jax_qc.read_text())
    assert list(got) == list(want)
    assert list(got["summary"]) == list(want["summary"])
    for key in ("n_clusters", "n_input_clusters", "n_method_failed",
                "n_qc_failed"):
        assert got["summary"][key] == want["summary"][key], key
    for key in ("mean_cosine", "median_cosine"):
        np.testing.assert_allclose(got["summary"][key],
                                   want["summary"][key], rtol=1e-5, atol=1e-6)
    assert [list(r) for r in got["clusters"]] == [
        list(r) for r in want["clusters"]]
    assert [(r["cluster_id"], r["n_members"]) for r in got["clusters"]] == [
        (r["cluster_id"], r["n_members"]) for r in want["clusters"]]
    np.testing.assert_allclose(
        [r["avg_cosine"] for r in got["clusters"]],
        [r["avg_cosine"] for r in want["clusters"]], rtol=1e-5, atol=1e-6)
    if case == "best-dropped":
        assert got["summary"]["n_clusters"] == 2
        assert got["summary"]["n_input_clusters"] == 3
        assert "cluster-2" not in [r["cluster_id"] for r in got["clusters"]]


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_cli_select_medoid_reduced_precision_passes_gate(precision,
                                                         tmp_path):
    a, b = tmp_path / "f32.mgf", tmp_path / "red.mgf"
    assert _port_select(SRC, str(a)).returncode == 0
    proc = _port_select(SRC, str(b), "--precision", precision)
    assert proc.returncode == 0, proc.stderr
    assert a.read_bytes() == b.read_bytes()


def test_cli_select_medoid_gate_breach_exits_nonzero(tmp_path, monkeypatch):
    """With the tolerance above 1 even identical picks (cosine 1) fail:
    the run writes its output, then exits non-zero with the message."""
    monkeypatch.setitem(quantize.PRECISION_MIN_COSINE, ("medoid", "bf16"),
                        1.5)
    out = tmp_path / "out.mgf"
    args = ["select", SRC, str(out), "--precision", "bf16", "--device",
            "cpu"]
    with pytest.raises(SystemExit) as exc:
        cli.main(args)
    assert exc.value.code not in (0, None)
    assert "precision gate failed" in str(exc.value.code)
    assert out.exists()
    monkeypatch.undo()
    assert cli.main(args) == 0


def test_cli_select_best_is_not_gated(tmp_path, monkeypatch):
    for prec in ("bf16", "int8"):
        monkeypatch.setitem(quantize.PRECISION_MIN_COSINE, ("best", prec),
                            1.5)
    out = tmp_path / "out.mgf"
    assert cli.main(["select", SRC, str(out), "--method", "best", "--msms",
                     MSMS, "--precision", "int8", "--device", "cpu"]) == 0
    assert out.read_bytes() == open(os.path.join(DATA, "golden_best.mgf"),
                                    "rb").read()


def test_cli_select_best_without_scores_exits(tmp_path):
    out = tmp_path / "out.mgf"
    proc = _port_select(SRC, str(out), "--method", "best")
    assert proc.returncode != 0
    assert ("select --method best needs a score source: --msms "
            "(MaxQuant msms.txt) or --psms (percolator/crux TSV)"
            in proc.stderr)
    assert not out.exists()


def test_cli_select_best_percolator_scores(tmp_path):
    """``--psms`` with ``--raw-name``: the scan scored highest in each
    cluster wins, as in the JAX CLI."""
    psms = tmp_path / "perc.tsv"
    rows = ["file\tscan\tcharge\tpercolator score"]
    for scan, score in [(17551, 1.0), (17552, 0.1), (17553, 3.0),
                        (17554, 2.0), (17555, 0.5), (17558, 4.0)]:
        rows.append(f"x.mzML\t{scan}\t2\t{score}")
    psms.write_text("\n".join(rows) + "\n")
    raw = "01650b_BA5-TUM_first_pool_75_01_01-3xHCD-1h-R2.raw"
    out, jax_out = tmp_path / "port.mgf", tmp_path / "jax.mgf"
    proc = _port_select(SRC, str(out), "--method", "best", "--psms",
                        str(psms), "--raw-name", raw)
    assert proc.returncode == 0, proc.stderr
    proc = _jax_select(SRC, str(jax_out), "--method", "best", "--psms",
                       str(psms), "--raw-name", raw)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == jax_out.read_bytes()
    assert [s.title.split(":")[-2] for s in mgf.read_mgf(out)] == [
        "17551", "17553", "17558"]


def test_cli_select_without_cuda_refuses_default_device(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from specpride_tpu_torch.cli import main\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )
    out = tmp_path / "out.mgf"
    proc = _run("-c", code, "select", SRC, str(out))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not out.exists()
