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
        "import specpride_tpu_torch.backends.numpy_backend\n"
        "import specpride_tpu_torch.ops.similarity\n"
        "import specpride_tpu_torch.ops.gap_average\n"
        "import specpride_tpu_torch.io.maxquant\n"
        "import specpride_tpu_torch.data.packed\n"
        "import specpride_tpu_torch.ops.segsort\n"
        "import specpride_tpu_torch.robustness.integrity\n"
        "import specpride_tpu_torch.io.native\n"
        "import specpride_tpu_torch.io.mzml\n"
        "import specpride_tpu_torch.io.maracluster\n"
        "import specpride_tpu_torch.convert\n"
        "import specpride_tpu_torch.metrics\n"
        "import specpride_tpu_torch.ops.fragments\n"
        "import specpride_tpu_torch.robustness.harness\n"
        "import specpride_tpu_torch.robustness.quarantine\n"
        "import specpride_tpu_torch.robustness.errors\n"
        "import specpride_tpu_torch.parallel.mesh\n"
        "import specpride_tpu_torch.parallel.parts\n"
        "import specpride_tpu_torch.parallel.store\n"
        "import specpride_tpu_torch.parallel.coordinator\n"
        "import specpride_tpu_torch.parallel.elastic\n"
        "import specpride_tpu_torch.parallel.fleet\n"
        "import specpride_tpu_torch.cache.result_cache\n"
        "import specpride_tpu_torch.observability.exporter\n"
        "import specpride_tpu_torch.viz\n"
        "import specpride_tpu_torch.observability.journal\n"
        "import specpride_tpu_torch.observability.registry\n"
        "import specpride_tpu_torch.observability.stats\n"
        "import specpride_tpu_torch.observability.stats_cli\n"
        "from specpride_tpu_torch.io.mgf import StreamedClusters\n"
        "import numpy\n"
        "from specpride_tpu_torch.ops.segsort import seg_argsort\n"
        "seg_argsort(numpy.arange(3), numpy.array([0, 3]))\n"
        "from specpride_tpu_torch.io.native import parse_mgf_bytes\n"
        "parse_mgf_bytes(b'BEGIN IONS\\n1.0 2.0\\nEND IONS\\n')\n"
        "from specpride_tpu_torch.cli import main\n"
        "for argv in (['--help'], *([cmd, '--help'] for cmd in (\n"
        "        'consensus', 'select', 'evaluate', 'convert',\n"
        "        'merge-parts', 'plot', 'stats', 'fleet',\n"
        "        'cas-server'))):\n"
        "    try:\n"
        "        main(argv)\n"
        "    except SystemExit:\n"
        "        pass\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes',\n"
        "                                             'matplotlib')\n"
        "             or m.startswith(('jax.', 'specpride_tpu.',\n"
        "                              'ml_dtypes.'))\n"
        "             or m == 'specpride_tpu')\n"
        "print('LOADED', bad)\n"
    )
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--qc-report" in proc.stdout
    for flag in ("--precision", "gap-average", "--mz-accuracy",
                 "--dyn-range", "--min-fraction", "--tail-mode",
                 "--pepmass", "--rt"):
        assert flag in proc.stdout
    for flag in ("{best,medoid}", "--msms", "--psms", "--raw-name",
                 "--px-accession", "--xcorr-bin", "--qc-normalization"):
        assert flag in proc.stdout
    for flag in ("--append", "--checkpoint", "--checkpoint-every",
                 "--prefetch", "--pack-workers", "--h2d-buffer",
                 "--async-write", "--on-error", "--stream-clusters",
                 "--retries", "--retry-backoff", "--no-degrade",
                 "--watchdog-timeout", "--inject-faults", "--fault-seed"):
        assert proc.stdout.count(flag) >= 2, flag
    assert proc.stdout.count("--qc-report") >= 2
    assert proc.stdout.count("--device") >= 3
    for flag in ("--single", "--report", "--format", "--normalization"):
        assert flag in proc.stdout
    assert proc.stdout.count("--clusters") >= 3
    # the bucketized layout and the cluster split on consensus and select,
    # the JAX CLI's spellings; merge-parts and its flags
    for flag in ("--layout", "{auto,flat,bucketized}", "--mesh",
                 "--coordinator", "--process-id"):
        assert proc.stdout.count(flag) >= 2, flag
    assert proc.stdout.count("--num-processes") >= 3
    assert proc.stdout.count("--checkpoint ") + proc.stdout.count(
        "--checkpoint BASE") >= 3
    for flag in ("--remove-parts", "<output>.part00000"):
        assert flag in proc.stdout
    # the telemetry flags of consensus and select, and evaluate's backend
    # and trace flags; plot and stats (matplotlib stays unloaded: plot
    # imports it when it draws)
    for flag in ("--journal", "--metrics-out"):
        assert proc.stdout.count(flag) >= 2, flag
    assert proc.stdout.count("--trace-dir") >= 3
    assert proc.stdout.count("{auto,flat,bucketized}") >= 3
    assert proc.stdout.count("--mesh") >= 3
    assert proc.stdout.count("{f32,bf16,int8}") >= 3
    for flag in ("-v, --verbose", "--log-json", "--consensus", "--peptide",
                 "out_prefix", "journals", "--json"):
        assert flag in proc.stdout, flag
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
        if name.split(".")[0] in ("jax", "jaxlib", "specpride_tpu",
                                  "ml_dtypes")
    ]
    assert bad == []
    scanned = {os.path.relpath(f, PKG) for f in files}
    assert {"backends/numpy_backend.py", "ops/gap_average.py",
            "ops/quantize.py", "data/packed.py", "io/maxquant.py",
            "ops/similarity.py", "config.py", "ops/segsort.py",
            "ops/_build.py", "robustness/integrity.py", "cli.py",
            "io/native.py", "io/mzml.py", "io/maracluster.py", "convert.py",
            "metrics.py", "ops/fragments.py", "robustness/errors.py",
            "robustness/faults.py", "robustness/retry.py",
            "robustness/watchdog.py", "robustness/quarantine.py",
            "robustness/harness.py", "io/mgf.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/parts.py", "viz.py",
            "observability/__init__.py", "observability/journal.py",
            "observability/registry.py", "observability/stats.py",
            "observability/stats_cli.py", "parallel/store.py",
            "parallel/coordinator.py", "parallel/elastic.py",
            "parallel/fleet.py"} <= scanned
    assert len(files) > 10
    # the port builds its own host library: none of the JAX package's
    # native libraries (native/lib*.so) is named, let alone loaded, and no
    # environment variable of the JAX package is read but the fault plan's
    # three (robustness/faults.py arms a child process and sets the
    # rank_slow stall through them), the
    # trace context's handoff (observability/tracing.py) and the serving
    # daemon's two (serve/protocol.py's socket, serve/ingest_cache.py's
    # bound)
    for f in files:
        with open(f) as fh:
            text = fh.read()
        for allowed in FAULT_PLAN_ENV + (TRACE_ENV,) + SERVE_ENV:
            text = text.replace(allowed, "")
        for name in ("libsegsort", "libmedoid", "libcosine",
                     "libgap_average", "libmgf_parser", "SPECPRIDE_"):
            assert name not in text, (os.path.relpath(f, REPO), name)


FAULT_PLAN_ENV = ("SPECPRIDE_FAULTS", "SPECPRIDE_FAULT_SEED",
                  "SPECPRIDE_SLOW_S")
TRACE_ENV = "SPECPRIDE_TRACE"
SERVE_ENV = ("SPECPRIDE_SOCKET", "SPECPRIDE_INGEST_CACHE")

# the names the JAX package's lint finds its anchors by, across the whole
# repository (specpride_tpu/analysis/core.py::Project.one_constant): a
# second module-level assignment of one anywhere silences its check and
# breaks tests/test_lint.py::test_repository_anchor_discovery
LINT_ANCHOR_NAMES = frozenset({
    "EVENT_FIELDS", "TRACE_EVENT_FIELDS", "V5_EVENT_FIELDS",
    "V6_EVENT_FIELDS", "FAULT_SITES", "EXECUTOR_FAULT_SITES",
    "DAEMON_ONLY_FLAGS", "_DAEMON_OWNED_DESTS", "_BUILDERS",
    "PRE_REGISTERED_FAMILIES",
})


def _module_level_names(source):
    """Every name a module's source binds at its top level by
    assignment."""
    for node in ast.parse(source).body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(
                       node, (ast.AnnAssign, ast.AugAssign)) else [])
        for target in targets:
            for n in ast.walk(target):
                if isinstance(n, ast.Name):
                    yield n.id


def _read(path):
    with open(path) as fh:
        return fh.read()


def test_package_assigns_no_jax_lint_anchor_name():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    bad = [f"{os.path.relpath(f, REPO)}: {name}"
           for f in files for name in _module_level_names(_read(f))
           if name in LINT_ANCHOR_NAMES]
    assert bad == [], bad
    # the scan sees what it guards: the port's own schema tables, and
    # annotated and unpacking assignments
    names = set(_module_level_names(_read(
        os.path.join(PKG, "observability", "journal.py"))))
    assert {"EVENT_SCHEMA", "TRACE_EVENT_SCHEMA"} <= names
    assert set(_module_level_names(
        "FAULT_SITES: tuple = ()\n(a, [_BUILDERS]) = 1, [2]\n"
        "def f():\n    EVENT_FIELDS = 1\n")) == {
            "FAULT_SITES", "a", "_BUILDERS"}


def _port_cli(*args):
    return _run("-m", "specpride_tpu_torch", "consensus", *args,
                "--device", "cpu")


def _jax_cli(*args):
    return _run("-m", "specpride_tpu", "consensus", *args)


def _assert_same_mgf(got_path, want_path, mz_tol, int_tol):
    """Same headers (title, precursor, RT, charge), equal peak counts."""
    assert _headers(got_path) == _headers(want_path)
    got, want = mgf.read_mgf(got_path), mgf.read_mgf(want_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.n_peaks == w.n_peaks, g.title
        np.testing.assert_allclose(g.mz, w.mz, **mz_tol)
        np.testing.assert_allclose(g.intensity, w.intensity, **int_tol)


def test_cli_gap_average_matches_jax_cli(tmp_path):
    """``--method gap-average`` with every gap flag at a non-default value
    against the JAX CLI with the same flags, and with the defaults against
    the golden file: tolerances of the JAX package's device-vs-oracle gap
    test (float32 group sums on the card, float64 in the JAX CLI's host
    path)."""
    src = os.path.join(DATA, "golden_clustered.mgf")
    tol = (dict(rtol=1e-5), dict(rtol=1e-4, atol=1e-3))
    out = tmp_path / "port.mgf"
    proc = _port_cli(src, str(out), "--method", "gap-average")
    assert proc.returncode == 0, proc.stderr
    _assert_same_mgf(out, os.path.join(DATA, "golden_gap_average.mgf"),
                     *tol)
    flags = ("--method", "gap-average", "--mz-accuracy", "0.02",
             "--dyn-range", "20", "--min-fraction", "0.6", "--tail-mode",
             "split", "--pepmass", "neutral_average", "--rt", "median")
    proc = _port_cli(src, str(out), *flags)
    assert proc.returncode == 0, proc.stderr
    jax_out = tmp_path / "jax.mgf"
    proc = _jax_cli(src, str(jax_out), *flags)
    assert proc.returncode == 0, proc.stderr
    _assert_same_mgf(out, jax_out, *tol)


def test_cli_gap_average_qc_report_matches_jax_cli(tmp_path):
    src = os.path.join(DATA, "golden_clustered.mgf")
    out, qc = tmp_path / "port.mgf", tmp_path / "port.qc.json"
    jax_out, jax_qc = tmp_path / "jax.mgf", tmp_path / "jax.qc.json"
    proc = _port_cli(src, str(out), "--method", "gap-average",
                     "--qc-report", str(qc))
    assert proc.returncode == 0, proc.stderr
    proc = _jax_cli(src, str(jax_out), "--method", "gap-average",
                    "--qc-report", str(jax_qc))
    assert proc.returncode == 0, proc.stderr
    got, want = json.loads(qc.read_text()), json.loads(jax_qc.read_text())
    assert [(r["cluster_id"], r["n_members"]) for r in got["clusters"]] == [
        (r["cluster_id"], r["n_members"]) for r in want["clusters"]
    ]
    np.testing.assert_allclose(
        [r["avg_cosine"] for r in got["clusters"]],
        [r["avg_cosine"] for r in want["clusters"]], rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("method", ["bin-mean", "gap-average"])
def test_cli_reduced_precision_passes_gate(method, precision, tmp_path):
    """A reduced run with ``--qc-report`` passes the gate (exit 0) and
    writes the spectra of the JAX package's device run at the same
    precision: the same peaks, m/z and intensity within the stated
    tolerances; its QC report is the f32 cosine of those spectra."""
    src = os.path.join(DATA, "golden_clustered.mgf")
    out, qc = tmp_path / "out.mgf", tmp_path / "qc.json"
    proc = _port_cli(src, str(out), "--method", method, "--precision",
                     precision, "--qc-report", str(qc))
    assert proc.returncode == 0, proc.stderr
    clusters = jax_group(jmgf.read_mgf(src, use_native=False))
    if method == "bin-mean":
        want = TpuBackend(layout="flat", precision=precision)\
            .run_bin_mean(clusters)
        mz_tol, int_tol = dict(rtol=0, atol=0), dict(rtol=1e-5)
    else:
        want = TpuBackend(layout="bucketized", force_device=True,
                          precision=precision).run_gap_average(clusters)
        mz_tol, int_tol = dict(rtol=1e-5), dict(rtol=1e-4, atol=1e-3)
    got = mgf.read_mgf(out)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.n_peaks == w.n_peaks
        np.testing.assert_allclose(g.mz, w.mz, **mz_tol)
        np.testing.assert_allclose(g.intensity, w.intensity, **int_tol)
    rows = json.loads(qc.read_text())["clusters"]
    assert len(rows) == 3 and all(0 < r["avg_cosine"] <= 1 + 1e-9
                                  for r in rows)


@pytest.mark.parametrize("method", ["bin-mean", "gap-average"])
def test_cli_precision_gate_breach_exits_nonzero(method, tmp_path,
                                                 monkeypatch):
    """With the tolerance raised above 1 no cosine can pass: the run
    writes its outputs, then exits non-zero with the gate's message."""
    from specpride_tpu_torch import cli
    from specpride_tpu_torch.ops import quantize

    monkeypatch.setitem(quantize.PRECISION_MIN_COSINE, (method, "int8"), 1.5)
    out = tmp_path / "out.mgf"
    with pytest.raises(SystemExit) as exc:
        cli.main(["consensus", os.path.join(DATA, "golden_clustered.mgf"),
                  str(out), "--method", method, "--precision", "int8",
                  "--device", "cpu"])
    assert exc.value.code not in (0, None)
    assert "precision gate failed" in str(exc.value.code)
    assert out.exists()
    monkeypatch.undo()
    assert cli.main(["consensus", os.path.join(DATA, "golden_clustered.mgf"),
                     str(out), "--method", method, "--precision", "int8",
                     "--device", "cpu"]) == 0


@pytest.mark.parametrize("method", ["bin-mean", "gap-average"])
def test_cli_f32_precision_is_the_default_bytes(method, tmp_path):
    src = os.path.join(DATA, "golden_clustered.mgf")
    a, b = tmp_path / "a.mgf", tmp_path / "b.mgf"
    assert _port_cli(src, str(a), "--method", method).returncode == 0
    assert _port_cli(src, str(b), "--method", method, "--precision",
                     "f32").returncode == 0
    assert a.read_bytes() == b.read_bytes()


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


def test_layout_and_split_flags_parse_like_the_jax_cli():
    """The new flags parse to the JAX CLI's dests and defaults on both
    commands, and ``merge-parts`` to its flags."""
    from specpride_tpu_torch.cli import build_parser

    port, jax_ap = build_parser(), jcli.build_parser()
    for cmd in ("consensus", "select"):
        base = [cmd, "in.mgf", "out.mgf"]
        for argv in (base, base + [
                "--layout", "bucketized", "--mesh", "--coordinator",
                "127.0.0.1:9", "--num-processes", "4", "--process-id",
                "3"]):
            got, want = port.parse_args(argv), jax_ap.parse_args(argv)
            for dest in ("layout", "mesh", "coordinator", "num_processes",
                         "process_id"):
                assert getattr(got, dest) == getattr(want, dest), dest
        with pytest.raises(SystemExit):
            port.parse_args(base + ["--layout", "sideways"])
    argv = ["merge-parts", "o.mgf", "--num-processes", "2", "--checkpoint",
            "ck", "--qc-report", "qc.json", "--remove-parts"]
    got, want = port.parse_args(argv), jax_ap.parse_args(argv)
    for dest in ("output", "num_processes", "checkpoint", "qc_report",
                 "remove_parts"):
        assert getattr(got, dest) == getattr(want, dest), dest


ELASTIC_ARGV = ["--elastic", "http://127.0.0.1:9", "--elastic-range", "64",
                "--elastic-ttl", "2.5", "--elastic-heartbeat", "0.5",
                "--elastic-steal", "off", "--elastic-local", "loc",
                "--result-cache", "rc:64", "--result-store", "st",
                "--metrics-port", "0", "--metrics-host", "0.0.0.0"]
ELASTIC_DESTS = ("elastic", "elastic_range", "elastic_ttl",
                 "elastic_heartbeat", "elastic_steal", "elastic_local",
                 "result_cache", "result_store", "metrics_port",
                 "metrics_host")


def test_elastic_flags_parse_like_the_jax_cli():
    """The elastic surface on the port's parser: the JAX CLI's dests and
    defaults on ``consensus`` and ``select``, ``merge-parts --elastic``,
    ``serve --result-store``, and ``fleet`` and ``cas-server``."""
    from specpride_tpu_torch.cli import build_parser

    port, jax_ap = build_parser(), jcli.build_parser()
    for cmd in ("consensus", "select"):
        base = [cmd, "in.mgf", "out.mgf"]
        for argv in (base, base + ELASTIC_ARGV):
            got, want = port.parse_args(argv), jax_ap.parse_args(argv)
            for dest in ELASTIC_DESTS:
                assert getattr(got, dest) == getattr(want, dest), dest
    for argv, dests in (
            (["merge-parts", "o.mgf", "--elastic", "d"], ("elastic",)),
            (["serve", "--result-cache", "c", "--result-store", "s"],
             ("result_cache", "result_store")),
            (["fleet", "--ranks", "3", "--spares", "1", "--max-ranks", "5",
              "--scale-horizon", "9", "--poll", "0.2", "--timeout", "60",
              "--journal", "f.jsonl", "--", "consensus", "a", "b",
              "--elastic", "d"],
             ("ranks", "spares", "max_ranks", "scale_horizon", "poll",
              "timeout", "journal", "job")),
            (["fleet", "--", "select", "a", "b"], ("ranks", "job")),
            (["cas-server", "--host", "0.0.0.0", "--port", "7",
              "--url-file", "u"], ("host", "port", "url_file"))):
        got, want = port.parse_args(argv), jax_ap.parse_args(argv)
        for dest in dests:
            assert getattr(got, dest) == getattr(want, dest), (argv, dest)
    with pytest.raises(SystemExit):
        port.parse_args(["consensus", "a", "b", "--elastic-steal", "maybe"])


def test_fleet_spawns_the_port():
    """The supervisor's workers run ``-m specpride_tpu_torch``: its argv is
    built from the module's one constant, and no string of the JAX
    package's module name is in its source."""
    path = os.path.join(PKG, "parallel", "fleet.py")
    tree = ast.parse(_read(path))
    consts = {n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert "specpride_tpu_torch" in consts
    assert "specpride_tpu" not in consts
    from specpride_tpu_torch.parallel import fleet

    sup = fleet.FleetSupervisor(["consensus", "a", "b", "--elastic",
                                 "http://127.0.0.1:9"], ranks=1)
    assert sup.worker_argv()[1:3] == ["-m", "specpride_tpu_torch"]


def test_cli_elastic_refusals(tmp_path):
    """A server without its local tier, and ``--metrics-port`` without
    ``--elastic`` (ignored with a warning, as in the JAX CLI)."""
    from specpride_tpu_torch import cli

    with pytest.raises(SystemExit, match="result-store"):
        cli.main(["serve", "--device", "cpu", "--result-store",
                  str(tmp_path / "s"), "--socket", str(tmp_path / "x")])
    out = tmp_path / "o.mgf"
    assert cli.main(["consensus", os.path.join(DATA, "golden_clustered.mgf"),
                     str(out), "--device", "cpu", "--metrics-port",
                     "0"]) == 0
    assert out.exists()


@pytest.mark.parametrize("command", ["fleet", "cas-server"])
def test_fleet_and_cas_server_start_without_torch(command):
    """``python -m specpride_tpu_torch fleet|cas-server`` go to the fleet
    module before the CLI is imported: the supervisor and the store
    server never import torch (the workers a fleet spawns do)."""
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['specpride_tpu_torch', {command!r}, '--help']\n"
        "try:\n"
        "    runpy.run_module('specpride_tpu_torch', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "print('TORCH', 'torch' in sys.modules)\n"
    )
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert "TORCH False" in proc.stdout
    assert "--url-file" in proc.stdout or "--ranks" in proc.stdout


# the JAX flags the port leaves out by its north star (ROADMAP): no JAX
# backend switch, no XLA donation, compile cache or routing table
NOT_PORTED_FLAGS = {"--backend", "--force-device", "--no-donate",
                    "--compile-cache", "--routing-table"}
# the port's subcommands that run on a device take --device
DEVICE_COMMANDS = {"consensus", "select", "evaluate", "serve", "warmup"}


def _subcommands(ap):
    import argparse

    return next(a.choices for a in ap._actions
                if isinstance(a, argparse._SubParsersAction))


def _options(p):
    return {o for a in p._actions for o in a.option_strings}


def _positionals(p):
    return [a.dest for a in p._actions if not a.option_strings]


def test_every_subcommand_has_the_jax_flags():
    """The port has exactly the JAX CLI's subcommands, and ``lint`` has
    exactly the JAX ``lint``'s flags and positional (it runs on no
    device)."""
    from specpride_tpu_torch import cli

    jsub = _subcommands(jcli.build_parser())
    psub = _subcommands(cli.build_parser())
    assert set(jsub) == set(psub)
    assert _options(psub["lint"]) == _options(jsub["lint"])
    assert _positionals(psub["lint"]) == _positionals(jsub["lint"])


def test_every_subcommand_has_the_jax_flags_but_lint():
    """The ``--help`` parity of the rest: every other subcommand has the
    JAX flag set less the flags the north star leaves out, plus
    ``--device`` on the commands that run on a device."""
    from specpride_tpu_torch import cli

    jax, port = jcli.build_parser(), cli.build_parser()
    jsub, psub = _subcommands(jax), _subcommands(port)
    assert _options(port) == _options(jax)
    for name in sorted(set(psub) - {"lint"}):
        want = _options(jsub[name]) - NOT_PORTED_FLAGS
        if name in DEVICE_COMMANDS:
            want |= {"--device"}
        assert _options(psub[name]) == want, name
        assert _positionals(psub[name]) == _positionals(jsub[name]), name