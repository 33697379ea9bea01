"""The port's ``evaluate`` (``metrics.py``, ``ops/fragments.py`` and the
CLI subcommand) against the JAX package fed the same inputs.

``avg_cosine`` on the CPU path (``TorchBackend(device="cpu")``, f32 sums)
against the JAX numpy oracle and the JAX ``TpuBackend`` on the CPU at
rtol 1e-5 / atol 1e-6, the tolerance of the port's other cosine tests;
``by_fraction``, ``n_peaks`` and ``n_members`` exact (host float64, the
same code).  The fragment theory is the JAX module's, so its results are
equal bit for bit."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu import metrics as jmetrics
from specpride_tpu.backends import numpy_backend as jnb
from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import CosineConfig as JCosineConfig
from specpride_tpu.io import mgf as jmgf
from specpride_tpu.ops import fragments as jfr
from specpride_tpu_torch import metrics
from specpride_tpu_torch.backends import numpy_backend
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import CosineConfig
from specpride_tpu_torch.data.peaks import (
    Cluster,
    Spectrum,
    peptide_from_usi,
    scan_from_usi,
)
from specpride_tpu_torch.io import mgf
from specpride_tpu_torch.ops import fragments as fr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COS_TOL = dict(rtol=1e-5, atol=1e-6)

# tests/test_fragments.py's sequences, hostile ones included
SEQUENCES = ["G", "DRVYIHPF", "PEPTIDE", "VLHPLEGAVVIIFK", "PEPTMIDE",
             "PEPTM(ox)IDE", "_PEPTIDE_", "_M(Oxidation (M))PEPTIDEK_",
             "(ac)PEPTIDEK", "P(weird)EP", "P(EP", "K", "XX1", "PEPT1DE", ""]


def _seeded_peptides(seed, n=12):
    rng = np.random.default_rng(seed)
    residues = np.array(list("GASPVTCLINDQKEMHFRYW"))
    out = []
    for _ in range(n):
        seq = "".join(rng.choice(residues, int(rng.integers(2, 25))))
        if rng.random() < 0.3:
            k = int(rng.integers(1, len(seq) + 1))
            seq = seq[:k] + "(ph)" + seq[k:]
        out.append(seq)
    return out


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("seq", SEQUENCES + _seeded_peptides(7))
def test_fragments_match_jax(seq):
    assert fr.is_valid_peptide(seq) == jfr.is_valid_peptide(seq)
    for fn in ("parse_peptide", "peptide_mass"):
        a, b = (_outcome(getattr(m, fn), seq) for m in (fr, jfr))
        assert a == b, fn
    for ions, z in (("by", 1), ("by", 2), ("a", 3)):
        a = _outcome(fr.fragment_mzs, seq, ions, z)
        b = _outcome(jfr.fragment_mzs, seq, ions, z)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            mz_a, lab_a = fr.fragment_annotations(seq, ions, z)
            mz_b, lab_b = jfr.fragment_annotations(seq, ions, z)
            np.testing.assert_array_equal(mz_a, mz_b)
            assert lab_a == lab_b
        else:
            assert a == b
    rng = np.random.default_rng(len(seq))
    mz = np.sort(rng.uniform(50, 1500, 120))
    inten = rng.uniform(0, 100, 120)
    for mode, tol in (("ppm", 50.0), ("Da", 0.02)):
        assert fr.fraction_of_by(seq, 600.3, 3, mz, inten, tol, mode) == \
            jfr.fraction_of_by(seq, 600.3, 3, mz, inten, tol, mode)


def test_fraction_of_by_batch_matches_jax():
    rng = np.random.default_rng(3)
    seqs = [None, *SEQUENCES, *_seeded_peptides(8), "PEPTIDEK", None]
    pmz = rng.uniform(300, 1000, len(seqs))
    pz = rng.integers(1, 5, len(seqs))
    mzs = [np.sort(rng.uniform(100, 1300, 80)) for _ in seqs]
    ints = [rng.uniform(1, 100, 80) for _ in seqs]
    got = fr.fraction_of_by_batch(seqs, pmz, pz, mzs, ints)
    want = jfr.fraction_of_by_batch(seqs, pmz, pz, mzs, ints)
    np.testing.assert_array_equal(got, want)


def test_usi_helpers_match_jax():
    from specpride_tpu.data import peaks as jpeaks

    for usi in ("mzspec:PXD1:r:scan:17", "mzspec:PXD1:r:scan:17:PEPK/2",
                "mzspec:PXD1:r:scan:x", "mzspec:PXD1:r:scan", "",
                "mzspec:PXD1:r:scan:3:PE/PK/x", "a:b:c:d:e:PEP/3"):
        assert scan_from_usi(usi) == jpeaks.scan_from_usi(usi)
        assert peptide_from_usi(usi) == jpeaks.peptide_from_usi(usi)


def _clusters(seed):
    """Clusters with a peptide on every member, on one member only or on
    none, one singleton and one with a peakless member."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n_members in enumerate((4, 3, 1, 6, 2, 5)):
        c = make_cluster(rng, f"cluster-{i}", n_members=n_members,
                         n_peaks=int(rng.integers(20, 90)),
                         base_scan=100 * i)
        members = [Spectrum(s.mz, s.intensity, s.precursor_mz,
                            s.precursor_charge, s.rt, s.title)
                   for s in c.members]
        if i in (0, 3):
            for s in members:
                s.title += ":PEPTIDEK/2"
        if i == 1:
            members[-1].title += ":VLHPLEGAVVIIFK/2"
        if i == 5:
            members[2].mz, members[2].intensity = (members[2].mz[:0],
                                                   members[2].intensity[:0])
        out.append(Cluster(c.cluster_id, members))
    return out


def _as_jax(items):
    from specpride_tpu.data.peaks import Cluster as JCluster
    from specpride_tpu.data.peaks import Spectrum as JSpectrum

    def spec(s):
        return JSpectrum(s.mz, s.intensity, s.precursor_mz,
                         s.precursor_charge, s.rt, s.title)

    return [JCluster(x.cluster_id, [spec(s) for s in x.members])
            if isinstance(x, Cluster) else spec(x) for x in items]


def _assert_same_results(got, want, cos_tol=COS_TOL):
    assert [(r.cluster_id, r.n_members, r.n_peaks, r.by_fraction)
            for r in got] == [(r.cluster_id, r.n_members, r.n_peaks,
                               r.by_fraction) for r in want]
    np.testing.assert_allclose([r.avg_cosine for r in got],
                               [r.avg_cosine for r in want], **cos_tol)


@pytest.mark.parametrize("normalization", ["none", "sqrt", "log"])
def test_evaluate_matches_jax(normalization):
    clusters = _clusters(11)
    reps = TorchBackend(device="cpu").run_bin_mean(clusters)
    reps[0].title = "cluster-0;mzspec:PXD1:r:scan:5:PEPTIDEK/2"
    jclusters, jreps = _as_jax(clusters), _as_jax(reps)
    cfg, jcfg = (CosineConfig(normalization=normalization),
                 JCosineConfig(normalization=normalization))
    got = metrics.evaluate(reps, clusters, TorchBackend(device="cpu"), cfg)
    oracle = jmetrics.evaluate(jreps, jclusters, "numpy", jcfg)
    _assert_same_results(got, oracle)
    _assert_same_results(
        got, jmetrics.evaluate(jreps, jclusters, TpuBackend(), jcfg))
    assert [r.by_fraction is None for r in got] == [
        False, False, True, False, True, True]
    # the port's numpy backend is the JAX oracle's arithmetic exactly
    exact = metrics.evaluate(reps, clusters, "numpy", cfg)
    assert [r.to_dict() for r in exact] == [r.to_dict() for r in oracle]
    assert metrics.summarize(exact) == jmetrics.summarize(oracle)


def test_average_cosine_is_the_jax_oracle():
    clusters = _clusters(12)
    reps = TorchBackend(device="cpu").run_bin_mean(clusters)
    for r, c, jr, jc in zip(reps, clusters, _as_jax(reps),
                            _as_jax(clusters)):
        assert numpy_backend.average_cosine(r, c.members) == \
            jnb.average_cosine(jr, jc.members)
    assert numpy_backend.average_cosine(reps[0], []) == 0.0


def test_evaluate_refuses_misaligned_and_unknown_backend():
    clusters = _clusters(13)
    with pytest.raises(ValueError, match="align"):
        metrics.evaluate([], clusters, "numpy")
    with pytest.raises(ValueError, match="TorchBackend"):
        metrics.evaluate(clusters[0].members[:1], clusters[:1], "tpu")


def _run(*args):
    return subprocess.run(
        [sys.executable, *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300,
    )


@pytest.fixture
def eval_files(tmp_path):
    """A clustered MGF and its bin-mean representatives, one cluster
    without a representative, one id that needs CSV quoting."""
    clusters = _clusters(14)
    clusters[4].cluster_id = 'a,"b"'
    for s in clusters[4].members:
        s.title = 'a,"b";' + s.title.partition(";")[2]
    reps = TorchBackend(device="cpu").run_bin_mean(clusters)
    clustered, rep_path = tmp_path / "clustered.mgf", tmp_path / "reps.mgf"
    mgf.write_mgf([s for c in clusters for s in c.members], clustered)
    mgf.write_mgf(reps[:3] + reps[4:], rep_path)
    return str(rep_path), str(clustered)


@pytest.mark.parametrize("fmt", ["json", "csv"])
def test_cli_evaluate_matches_jax_cli(fmt, eval_files, tmp_path):
    reps, clustered = eval_files
    port_rep, jax_rep = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    port = _run("-m", "specpride_tpu_torch", "evaluate", reps, clustered,
                "--report", str(port_rep), "--format", fmt,
                "--normalization", "sqrt", "--device", "cpu")
    assert port.returncode == 0, port.stderr
    jax = _run("-m", "specpride_tpu", "evaluate", reps, clustered,
               "--report", str(jax_rep), "--format", fmt,
               "--normalization", "sqrt", "--backend", "numpy")
    assert jax.returncode == 0, jax.stderr
    got, want = json.loads(port.stdout), json.loads(jax.stdout)
    assert got.keys() == want.keys()
    for key in want:
        if key in ("mean_cosine", "median_cosine"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-6)
        else:
            assert got[key] == want[key], key
    assert got["n_clusters"] == 5 and got["n_with_peptide"] == 2
    if fmt == "json":
        g, w = json.loads(port_rep.read_text()), json.loads(
            jax_rep.read_text())
        assert g["summary"] == got and w["summary"] == want
        rows = list(zip(g["clusters"], w["clusters"]))
        assert len(rows) == 5
        for a, b in rows:
            assert a.keys() == b.keys()
            assert a["avg_cosine"] == pytest.approx(b["avg_cosine"], rel=1e-5,
                                                    abs=1e-6)
            assert {k: v for k, v in a.items() if k != "avg_cosine"} == \
                {k: v for k, v in b.items() if k != "avg_cosine"}
    else:
        with open(port_rep, newline="") as a, open(jax_rep, newline="") as b:
            ga, wb = a.read(), b.read()
        assert "\r" not in ga and ga.count("\n") == wb.count("\n") == 6
        g, w = list(csv.reader(ga.splitlines())), list(
            csv.reader(wb.splitlines()))
        assert g[0] == w[0]
        assert 'a,"b"' in [r[0] for r in g]
        for a, b in zip(g[1:], w[1:]):
            assert a[:3] + a[4:] == b[:3] + b[4:]
            assert float(a[3]) == pytest.approx(float(b[3]), abs=2e-6)


def test_cli_evaluate_without_cuda_refuses_default_device(eval_files):
    reps, clustered = eval_files
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from specpride_tpu_torch.cli import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    proc = _run("-c", code, "evaluate", reps, clustered)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr and proc.stdout == ""


def test_evaluate_reads_jax_written_files(eval_files):
    """The files the JAX writer makes evaluate to the same numbers."""
    reps, clustered = eval_files
    jreps = jmgf.read_mgf(reps, use_native=False)
    assert mgf.write_mgf(mgf.read_mgf(reps), None) == jmgf.write_mgf(
        jreps, None)


EVALUATE_FLAGS = [
    ("--layout", "bucketized"),
    ("--mesh",),
    ("--layout", "flat", "--precision", "bf16"),
    ("--precision", "int8"),
]


@pytest.mark.parametrize("flags", EVALUATE_FLAGS, ids=" ".join)
def test_cli_evaluate_backend_flags_match_jax_cli_and_oracle(
        flags, eval_files, tmp_path, capsys):
    """``evaluate``'s backend flags, the JAX CLI's: ``--layout`` and
    ``--mesh`` score on the (B, K) layout, and ``--precision`` is taken
    and ignored (the cosine is f32 in both packages).  Each against the
    JAX CLI with the same flags and the numpy oracle, per cluster."""
    from specpride_tpu_torch import cli

    reps, clustered = eval_files
    port_rep, jax_rep = tmp_path / "port.json", tmp_path / "jax.json"
    assert cli.main(["evaluate", reps, clustered, "--report", str(port_rep),
                     "--device", "cpu", *flags]) == 0
    got = json.loads(capsys.readouterr().out)
    jax = _run("-m", "specpride_tpu", "evaluate", reps, clustered,
               "--report", str(jax_rep), "--compile-cache", "off", *flags)
    assert jax.returncode == 0, jax.stderr
    oracle = jmetrics.evaluate(
        [r for r in jmgf.read_mgf(reps)],
        [c for c in _grouped(clustered, reps)], "numpy")
    rows = json.loads(port_rep.read_text())["clusters"]
    for want in (json.loads(jax_rep.read_text())["clusters"],
                 [r.to_dict() for r in oracle]):
        assert [r["cluster_id"] for r in rows] == \
            [r["cluster_id"] for r in want]
        np.testing.assert_allclose([r["avg_cosine"] for r in rows],
                                   [r["avg_cosine"] for r in want],
                                   **COS_TOL)
        assert [r["by_fraction"] for r in rows] == \
            [r["by_fraction"] for r in want]
    assert got["n_clusters"] == len(rows) == 5
    # the flags reached the backend: the same layout as the JAX run's
    flat = TorchBackend(device="cpu")
    bucket = TorchBackend(device="cpu", layout="bucketized")
    clusters = _port_clusters(clustered, reps)
    preps = mgf.read_mgf(reps)
    want = (bucket if "--layout" in flags and "bucketized" in flags
            or "--mesh" in flags else flat).average_cosines(preps, clusters)
    np.testing.assert_array_equal(
        [r["avg_cosine"] for r in rows], want)


def _grouped(clustered, reps):
    """The JAX clusters of ``clustered`` that ``reps`` represents, in the
    representatives' order."""
    from specpride_tpu.data.peaks import group_into_clusters

    by_id = {c.cluster_id: c for c in group_into_clusters(
        jmgf.read_mgf(clustered))}
    return [by_id[r.cluster_id] for r in jmgf.read_mgf(reps)]


def _port_clusters(clustered, reps):
    from specpride_tpu_torch.data.peaks import group_into_clusters

    by_id = {c.cluster_id: c for c in group_into_clusters(
        mgf.read_mgf(clustered))}
    return [by_id[r.cluster_id] for r in mgf.read_mgf(reps)]
