"""The port's ``convert``, ``consensus --single`` and direct ``.mzML``
input with ``--clusters`` against the JAX CLI on the same files.

``convert`` is host work only: its MGF and mzML outputs must be the JAX
CLI's bytes.  ``--single`` and mzML input run the methods: medoid picks
are the same bytes; bin-mean and gap-average are held at the tolerances
of ``ROADMAP.md``'s "held against the reference" (headers identical, equal
peak counts, m/z rtol 1e-5 / atol 1e-3 for bin-mean and rtol 1e-5 for gap,
intensity rtol 1e-4 / atol 1e-3) against the JAX CLI with ``--layout
flat``; QC cosines at rtol 1e-5 / atol 1e-6."""

import json
import os
import shutil

import numpy as np
import pytest
from conftest import make_spectrum

from specpride_tpu.cli import main as jax_main
from specpride_tpu.io.mgf import write_mgf as jax_write_mgf
from specpride_tpu.io.mzml import write_mzml as jax_write_mzml
from specpride_tpu_torch import cli
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.io import maracluster, mgf, mzml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
BIN_TOL = (dict(rtol=1e-5, atol=1e-3), dict(rtol=1e-4, atol=1e-3))
GAP_TOL = (dict(rtol=1e-5), dict(rtol=1e-4, atol=1e-3))
COS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def raw_spectra(rng):
    """Raw (unclustered) spectra with scan-style titles (a copy of
    tests/test_pipeline.py's fixture)."""
    out = []
    for scan in range(100, 110):
        s = make_spectrum(rng, n_peaks=30, scan=scan)
        s.title = f"run1.{scan}.{scan}.2 File:run1.raw scan={scan}"
        out.append((scan, s))
    return out


def write_inputs(tmp_path, raw_spectra):
    """raw.mgf, msms.txt (two scans without an ID) and a MaRaCluster TSV
    of two clusters of four scans (a copy of tests/test_pipeline.py's)."""
    raw = tmp_path / "raw.mgf"
    jax_write_mgf([s for _, s in raw_spectra], raw)
    msms = tmp_path / "msms.txt"
    header = [
        "Raw file", "Scan number", "c2", "c3", "c4", "c5", "c6",
        "Modified sequence", "Score",
    ]
    lines = ["\t".join(header)]
    for scan, _ in raw_spectra[:8]:  # last two scans have no ID
        lines.append("\t".join(["run1", str(scan), "x", "x", "x", "x", "x",
                                "_PEPTIDEK_", str(100.0 + scan)]))
    msms.write_text("\n".join(lines) + "\n")
    tsv = tmp_path / "clusters.tsv"
    rows = []
    for scan, _ in raw_spectra[:4]:
        rows.append(f"run1.raw\t{scan}\t0.9")
    rows.append("")
    for scan, _ in raw_spectra[4:8]:
        rows.append(f"run1.raw\t{scan}\t0.9")
    rows.append("")
    tsv.write_text("\n".join(rows))
    return raw, msms, tsv


def _both(command, *args, port_flags=("--device", "cpu"),
          jax_flags=("--layout", "flat"), out=None):
    """The JAX CLI, then the port's CLI, in process, with the same
    arguments and the same output path (titles may name it); returns the
    two outputs' bytes (and the QC reports' when ``--qc-report`` is among
    ``args``)."""
    res = []
    qc = args[args.index("--qc-report") + 1] if "--qc-report" in args \
        else None
    for main, flags in ((jax_main, jax_flags), (cli.main, port_flags)):
        assert main([command, *map(str, args), *flags]) == 0
        with open(out, "rb") as fh:
            got = [fh.read()]
        if qc:
            with open(qc) as fh:
                got.append(json.load(fh))
        res.append(got)
        os.remove(out)
    return res


@pytest.mark.parametrize("flags", [
    (), ("--raw-name", "run1.raw"), ("--px-accession", "PXD000042"),
])
@pytest.mark.parametrize("src,dst", [
    ("mgf", "mgf"), ("mzML", "mgf"), ("mzML", "mzML"),
])
def test_convert_matches_jax_cli(src, dst, flags, tmp_path, raw_spectra):
    raw, msms, tsv = write_inputs(tmp_path, raw_spectra)
    if src == "mzML":
        raw = tmp_path / "raw.mzML"
        jax_write_mzml([(scan, s, {}) for scan, s in raw_spectra], raw)
    out = str(tmp_path / f"out.{dst}")
    (jax_out,), (port_out,) = _both(
        "convert", str(raw), out, "--msms", str(msms), "--clusters",
        str(tsv), *flags, port_flags=(), jax_flags=(), out=out)
    assert port_out == jax_out
    if dst == "mgf":
        assert port_out.count(b"BEGIN IONS") == 8
        assert b"PEPTIDEK/2" in port_out
    else:
        assert port_out.count(b"<spectrum ") == 8
        assert b'value="cluster-2"' in port_out


def test_convert_functions_and_readers(tmp_path, raw_spectra):
    """The library entry points: counts, titles, the MaRaCluster readers
    (a trailing cluster without a blank line kept) and the mzML round
    trip."""
    from specpride_tpu_torch import convert

    raw, msms, tsv = write_inputs(tmp_path, raw_spectra)
    out = tmp_path / "c.mgf"
    assert convert.convert_mgf(raw, msms, tsv, out, "run1.raw") == 8
    got = mgf.read_mgf(out)
    assert got[0].usi.startswith("mzspec:PXD004732:run1.raw:scan:")
    assert got[0].usi.endswith("PEPTIDEK/2")
    assert maracluster.read_maracluster_clusters(tsv) == [
        [100, 101, 102, 103], [104, 105, 106, 107]]
    tail = tmp_path / "tail.tsv"
    tail.write_text("r\t1\n\nr\t2\nr\t3")
    assert maracluster.read_maracluster_clusters(tail) == [[1], [2, 3]]
    assert maracluster.scan_to_cluster(tail) == {
        1: "cluster-1", 2: "cluster-2", 3: "cluster-2"}
    specs = [(s, Spectrum(x.mz, x.intensity, x.precursor_mz,
                          x.precursor_charge, x.rt, x.title),
              {"Peptide sequence": 'PEP<T&"K'})
             for s, x in raw_spectra[:3]]
    mzml.write_mzml(specs, tmp_path / "t.mzML")
    back = mzml.read_mzml_scans(tmp_path / "t.mzML", scans={101, 102})
    assert sorted(back) == [101, 102]
    np.testing.assert_array_equal(back[101].mz, specs[1][1].mz)
    assert back[102].rt == specs[2][1].rt


def _mzml_inputs(tmp_path, rng, n_clusters=4):
    """An mzML of clustered scans, a MaRaCluster TSV and an msms.txt
    naming peptides for every other scan."""
    from conftest import make_cluster

    specs, rows, lines = [], [], ["\t".join(
        ["Raw file", "Scan number", "c2", "c3", "c4", "c5", "c6",
         "Modified sequence", "Score"])]
    for i in range(n_clusters):
        c = make_cluster(rng, f"x{i}", n_members=int(rng.integers(1, 6)),
                         n_peaks=40, base_scan=1000 + 10 * i)
        for k, s in enumerate(c.members):
            scan = 1000 + 10 * i + k
            specs.append((scan, s, {}))
            rows.append(f"run7.raw\t{scan}\t0.9")
            if k % 2 == 0:
                lines.append("\t".join(["run7", str(scan), *"xxxxx",
                                        "_PEPTIDEK_", "50"]))
        rows.append("")
    path = tmp_path / "run7.mzML"
    jax_write_mzml(specs, path)
    tsv, msms = tmp_path / "c.tsv", tmp_path / "msms.txt"
    tsv.write_text("\n".join(rows))
    msms.write_text("\n".join(lines) + "\n")
    return str(path), str(tsv), str(msms)


@pytest.mark.parametrize("command,method,qc", [
    ("consensus", "bin-mean", True), ("consensus", "gap-average", False),
    ("select", "medoid", True),
])
def test_mzml_input_matches_jax_cli(command, method, qc, tmp_path, rng):
    path, tsv, msms = _mzml_inputs(tmp_path, rng)
    out = str(tmp_path / "out.mgf")
    args = [path, out, "--method", method, "--clusters", tsv, "--msms",
            msms, "--raw-name", "run7.raw"]
    if qc:
        args += ["--qc-report", str(tmp_path / "qc.json")]
    jax, port = _both(command, *args, out=out)
    assert port[0].count(b"BEGIN IONS") == 4
    if method == "medoid":
        assert port[0] == jax[0]
        assert b"PEPTIDEK/2" in port[0]
    else:
        (tmp_path / "j.mgf").write_bytes(jax[0])
        (tmp_path / "p.mgf").write_bytes(port[0])
        _assert_same_mgf(tmp_path / "p.mgf", tmp_path / "j.mgf",
                         *(BIN_TOL if method == "bin-mean" else GAP_TOL))
    if qc:
        _assert_same_qc(port[1], jax[1])


@pytest.mark.parametrize("command", ["consensus", "select"])
def test_mzml_input_without_clusters_exits_with_the_jax_message(
        command, tmp_path, rng):
    path, _, _ = _mzml_inputs(tmp_path, rng, n_clusters=1)
    out = str(tmp_path / "out.mgf")
    msgs = []
    for main, flags in ((jax_main, ()), (cli.main, ("--device", "cpu"))):
        with pytest.raises(SystemExit) as exc:
            main([command, path, out, *flags])
        msgs.append(str(exc.value.code))
    assert msgs[0] == msgs[1]
    assert "needs --clusters" in msgs[1]


def _headers(path):
    with open(path) as fh:
        return [ln for ln in fh if not ln[:1].isdigit()]


def _assert_same_mgf(got_path, want_path, mz_tol, int_tol):
    assert _headers(got_path) == _headers(want_path)
    got, want = mgf.read_mgf(got_path), mgf.read_mgf(want_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.n_peaks == w.n_peaks, g.title
        np.testing.assert_allclose(g.mz, w.mz, **mz_tol)
        np.testing.assert_allclose(g.intensity, w.intensity, **int_tol)


def _assert_same_qc(got, want):
    assert [(r["cluster_id"], r["n_members"]) for r in got["clusters"]] == \
        [(r["cluster_id"], r["n_members"]) for r in want["clusters"]]
    np.testing.assert_allclose([r["avg_cosine"] for r in got["clusters"]],
                               [r["avg_cosine"] for r in want["clusters"]],
                               **COS_TOL)
    assert got["summary"]["n_clusters"] == want["summary"]["n_clusters"]


@pytest.mark.parametrize("method,qc", [
    ("bin-mean", True), ("gap-average", False),
])
def test_consensus_single_matches_jax_cli(method, qc, tmp_path):
    src = os.path.join(DATA, "golden_clustered.mgf")
    out = str(tmp_path / "single.mgf")
    args = [src, out, "--single", "--method", method]
    if qc:
        args += ["--qc-report", str(tmp_path / "qc.json")]
    jax, port = _both("consensus", *args, out=out)
    assert port[0].count(b"BEGIN IONS") == 1
    assert f"TITLE={out}\n".encode() in port[0]
    (tmp_path / "j.mgf").write_bytes(jax[0])
    (tmp_path / "p.mgf").write_bytes(port[0])
    _assert_same_mgf(tmp_path / "p.mgf", tmp_path / "j.mgf",
                     *(BIN_TOL if method == "bin-mean" else GAP_TOL))
    if qc:
        _assert_same_qc(port[1], jax[1])
        assert port[1]["clusters"][0]["n_members"] == len(
            mgf.read_mgf(src))


def test_consensus_single_of_no_spectra_is_no_cluster(tmp_path):
    src = tmp_path / "empty.mgf"
    src.write_text("# nothing\n")
    out = str(tmp_path / "out.mgf")
    jax, port = _both("consensus", str(src), out, "--single",
                      "--qc-report", str(tmp_path / "qc.json"), out=out)
    assert port[0] == jax[0] == b""
    assert port[1]["summary"]["n_clusters"] == 0 == \
        jax[1]["summary"]["n_clusters"]


@pytest.mark.parametrize("method", ["bin-mean", "gap-average"])
def test_single_cluster_over_the_chunk_budget(method, tmp_path):
    """``--single`` makes one cluster of every peak in the file, far over a
    small ``max_grid_elements // 4`` chunk budget: it runs as one chunk of
    its own (one consensus chunk, one cosine chunk) with no peak dropped,
    equal to the JAX CLI with ``--layout flat`` at its default budget."""
    src = os.path.join(DATA, "golden_clustered.mgf")
    n_peaks = sum(s.n_peaks for s in mgf.read_mgf(src))
    grid = 64
    assert n_peaks > 4 * (grid // 4)
    out = str(tmp_path / "single.mgf")
    qc = str(tmp_path / "qc.json")
    flags = ["--qc-report", qc] if method == "bin-mean" else []
    assert jax_main(["consensus", src, out, "--single", "--method", method,
                     "--layout", "flat", *flags]) == 0
    shutil.move(out, tmp_path / "jax.mgf")
    jax_qc = json.load(open(qc)) if flags else None
    args = cli.build_parser().parse_args(
        ["consensus", src, out, "--single", "--method", method,
         "--device", "cpu", *flags])
    backend = TorchBackend(device="cpu", max_grid_elements=grid)
    summary = cli._run_pipeline_command(args, backend)
    assert backend.chunks == 1 and summary["counters"]["clusters"] == 1
    if flags:
        assert backend.cos_chunks == 1
        _assert_same_qc(json.load(open(qc)), jax_qc)
    _assert_same_mgf(out, tmp_path / "jax.mgf",
                     *(BIN_TOL if method == "bin-mean" else GAP_TOL))
    # every input peak reached the consensus: the default budget gives
    # the same spectrum
    ref = str(tmp_path / "ref.mgf")
    args = cli.build_parser().parse_args(
        ["consensus", src, ref, "--single", "--method", method,
         "--device", "cpu"])
    cli._run_pipeline_command(args, TorchBackend(device="cpu"))
    with open(ref) as a, open(out) as b:
        assert a.read().replace(ref, out) == b.read()
