"""The port's run journal, metrics, logs, ``stats`` and ``--trace-dir``,
against the JAX package's.

The port's journals are read by the JAX package's ``read_events`` (its
schema, ``validate_event``) with no violation, carry the event names of a
JAX CLI run with the same flags on the same input, the span tracer's
``span`` among them (less the warm-start layer's ``warmup`` and
``compile_cache``, which the port has not got), pair every injected fault with its recovery
under both packages' ``audit_fault_recovery``, and both ``stats`` read
both packages' journals.  ``--metrics-out`` registers no metric name a
JAX CLI run on the same input does not.  The JAX CLI runs in a
subprocess on the CPU with ``--layout flat`` (its device path; its
default layout runs these methods on the host and journals no dispatch)
and ``--compile-cache off``."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu.observability import stats_cli as jstats_cli
from specpride_tpu.observability.journal import read_events as jread_events
from specpride_tpu.robustness.faults import audit_fault_recovery as jaudit
from specpride_tpu_torch import cli
from specpride_tpu_torch.observability import journal, stats_cli
from specpride_tpu_torch.observability.stats import trace_path
from specpride_tpu_torch.robustness.faults import audit_fault_recovery

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX CLI's events from layers the port has not ported yet
UNPORTED = {"warmup", "compile_cache"}
N_CLUSTERS, EVERY = 40, 16


def _events(path):
    """The journal through the JAX package's reader: no violation."""
    events, bad = jread_events(str(path))
    assert bad == [], bad[:5]
    own, own_bad = journal.read_events(str(path))
    assert own_bad == [] and own == events
    return events


def _names(events):
    return {e["event"] for e in events}


def _families(path):
    with open(path) as fh:
        return {line.split()[2] for line in fh if line.startswith("# TYPE")}


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    rng = np.random.default_rng(61)
    clusters = [make_cluster(rng, f"cluster-{i}",
                             n_members=int(rng.integers(1, 6)),
                             n_peaks=int(rng.integers(20, 60)),
                             base_scan=100 * i)
                for i in range(N_CLUSTERS)]
    path = tmp_path_factory.mktemp("journal") / "clustered.mgf"
    from specpride_tpu.io.mgf import write_mgf

    write_mgf([s for c in clusters for s in c.members], path)
    return str(path)


def _jax_run(command, src, out, *flags):
    proc = subprocess.run(
        [sys.executable, "-m", "specpride_tpu", command, src, str(out),
         "--layout", "flat", "--compile-cache", "off", *flags],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.fixture(scope="module")
def runs(clustered, tmp_path_factory):
    """consensus (bin-mean) and select (medoid), each with QC, a
    checkpoint every 16 clusters, a journal and a metrics textfile: the
    port's run on the CPU and the JAX CLI's."""
    d = tmp_path_factory.mktemp("runs")
    out = {}
    for command in ("consensus", "select"):
        for who in ("port", "jax"):
            flags = ["--qc-report", str(d / f"{who}.{command}.qc.json"),
                     "--checkpoint", str(d / f"{who}.{command}.ck.json"),
                     "--checkpoint-every", str(EVERY),
                     "--journal", str(d / f"{who}.{command}.jsonl"),
                     "--metrics-out", str(d / f"{who}.{command}.prom")]
            dst = d / f"{who}.{command}.mgf"
            if who == "port":
                assert cli.main([command, clustered, str(dst), "--device",
                                 "cpu", *flags]) == 0
            else:
                _jax_run(command, clustered, dst, *flags)
            out[who, command] = d / f"{who}.{command}"
    return out


@pytest.mark.parametrize("command", ["consensus", "select"])
def test_port_journal_reads_clean_with_the_jax_names(runs, command):
    port = _events(f"{runs['port', command]}.jsonl")
    jax = _events(f"{runs['jax', command]}.jsonl")
    assert _names(port) == _names(jax) - UNPORTED
    assert [e["event"] for e in port][:2] == ["run_start", "clock_anchor"]
    assert port[-1]["event"] == "run_end"
    start = port[0]
    assert start["command"] == command and start["n_clusters"] == N_CLUSTERS
    n_chunks = -(-N_CLUSTERS // EVERY)
    for name in ("chunk_start", "chunk_done", "checkpoint_write"):
        assert sum(e["event"] == name for e in port) == n_chunks, name
    done = [e for e in port if e["event"] == "chunk_done"]
    assert sum(e["n_clusters"] for e in done) == N_CLUSTERS
    # one consensus (or medoid) and one cosine dispatch per chunk at least
    dispatch = [e for e in port if e["event"] == "dispatch"]
    kernels = {e["kernel"] for e in dispatch}
    assert kernels == ({"bin_mean_flat_intensity", "cosine_flat"}
                       if command == "consensus"
                       else {"shared_bins_packed", "cosine_flat"})
    compiles = [e for e in port if e["event"] == "compile"]
    assert 0 < len(compiles) <= len(dispatch)
    end = port[-1]
    assert end["device"]["dispatches"] == len(dispatch)
    assert end["device"]["compiles"] == len(compiles)
    assert end["counters"]["clusters"] == N_CLUSTERS
    assert set(end["device"]) == set(jax[-1]["device"])


@pytest.mark.parametrize("command", ["consensus", "select"])
def test_metrics_out_names_are_the_jax_runs(runs, command):
    port = _families(f"{runs['port', command]}.prom")
    jax = _families(f"{runs['jax', command]}.prom")
    # the JAX backend on the CPU reads no device memory; the port reports
    # 0 there (torch.cuda.max_memory_allocated on the card)
    assert port - jax == {"specpride_device_peak_bytes_in_use"}
    with open(os.path.join(REPO, "specpride_tpu", "backends",
                           "tpu_backend.py")) as fh:
        assert '"specpride_device_peak_bytes_in_use"' in fh.read()
    assert {"specpride_dispatches_total", "specpride_compiles_total",
            "specpride_bytes_h2d_total", "specpride_bytes_d2h_total",
            "specpride_phase_seconds_total",
            "specpride_run_clusters_total"} <= port


def test_stats_reads_port_and_jax_journals(runs, tmp_path, capsys):
    paths = [f"{runs[who, c]}.jsonl" for who in ("port", "jax")
             for c in ("consensus", "select")]
    agg = tmp_path / "agg.json"
    assert stats_cli.run_stats(paths, json_out=str(agg)) == 0
    text = capsys.readouterr().out
    assert "consensus/bin-mean backend=torch" in text
    assert "select/medoid backend=tpu" in text
    runs_json = json.loads(agg.read_text())["runs"]
    assert [r["complete"] for r in runs_json] == [True] * 4
    assert runs_json[0]["chunks"] == -(-N_CLUSTERS // EVERY)
    assert jstats_cli.run_stats(paths[:2]) == 0
    assert "consensus/bin-mean backend=torch" in capsys.readouterr().out
    # rank shards: a base path resolves to its .part<id> files in order
    base = tmp_path / "ranks.jsonl"
    for i in range(2):
        (tmp_path / f"ranks.jsonl.part{i:05d}").write_bytes(
            open(paths[i], "rb").read())
    assert cli.main(["stats", str(base), "--json", str(agg)]) == 0
    assert json.loads(agg.read_text())["totals"]["n_journals"] == 2
    # a line that breaks the schema fails the command
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 7, "ts": 1.0, "event": "run_start"}\n')
    assert cli.main(["stats", str(bad)]) == 1
    assert "schema violation" in capsys.readouterr().err


# a fault at every executor site; the d2h fault at the first fetch, a
# dispatch's, where both packages' recovery maps look for its retry
CHAOS = ("parse:io:1:1,pack:io:1:1,prepare:io:1:1,dispatch:oom:1:1,"
         "d2h:io:1:0,qc:io:1:1,write:io:1:1,checkpoint_write:io:1:1,"
         "dispatch:hang:1:2")


def test_chaos_faults_pair_with_their_recoveries(clustered, tmp_path):
    """A fault at every executor site: each is journaled, with the retry
    or split that recovered it, and both packages' audits find no fault
    unrecovered; the bytes are the clean run's."""
    clean, chaos = tmp_path / "clean.mgf", tmp_path / "chaos.mgf"
    assert cli.main(["select", clustered, str(clean), "--device", "cpu",
                     "--checkpoint-every", str(EVERY)]) == 0
    jpath = tmp_path / "chaos.jsonl"
    assert cli.main([
        "select", clustered, str(chaos), "--device", "cpu",
        "--checkpoint", str(tmp_path / "ck.json"), "--checkpoint-every",
        str(EVERY), "--qc-report", str(tmp_path / "qc.json"),
        "--retries", "3", "--retry-backoff", "0.01",
        "--watchdog-timeout", "0.3", "--inject-faults", CHAOS,
        "--journal", str(jpath)]) == 0
    assert chaos.read_bytes() == clean.read_bytes()
    events = _events(jpath)
    faults = [e for e in events if e["event"] == "fault"]
    assert {f["site"] for f in faults} == {
        "parse", "pack", "prepare", "dispatch", "d2h", "qc", "write",
        "checkpoint_write"}
    names = _names(events)
    assert {"retry", "degrade", "watchdog_stall"} <= names
    assert audit_fault_recovery(events) == []
    assert jaudit(events) == []
    robustness = events[-1]["robustness"]
    assert robustness["faults"]["fired_total"] == len(faults)
    assert robustness["retries"] == sum(e["event"] == "retry"
                                        for e in events)
    # an unrecovered fault is found: drop the retries
    assert audit_fault_recovery(
        [e for e in events if e["event"] != "retry"]) != []
    # the port's QC pass fetches on the card under the qc retry
    fault = {"event": "fault", "site": "d2h", "kind": "io", "mono": 1.0}
    retry = {"event": "retry", "site": "qc", "attempt": 0, "mono": 2.0}
    assert audit_fault_recovery([fault, retry]) == []
    # a retry before the fault recovers nothing
    assert audit_fault_recovery([dict(retry, mono=0.5), fault]) == [fault]


def test_quarantine_and_skip_events(tmp_path):
    """A malformed record under ``--on-error skip``: a ``quarantine``
    event after ``run_start``, however early the parse found it."""
    src = os.path.join(REPO, "tests", "data", "golden_clustered.mgf")
    text = open(src).read()
    cut = text.index("END IONS") + len("END IONS\n")
    dirty = tmp_path / "dirty.mgf"
    dirty.write_text(text[:cut] + "BEGIN IONS\nTITLE=broken\n100.0 1.0\n"
                     + text[cut:])
    jpath = tmp_path / "q.jsonl"
    assert cli.main(["consensus", str(dirty), str(tmp_path / "q.mgf"),
                     "--device", "cpu", "--on-error", "skip",
                     "--stream-clusters", "off", "--journal",
                     str(jpath)]) == 0
    events = _events(jpath)
    names = [e["event"] for e in events]
    assert names[0] == "run_start" and names.count("quarantine") == 1
    q = events[names.index("quarantine")]
    assert q["path"].endswith("q.mgf.quarantine.mgf")
    assert audit_fault_recovery(events) == []


def test_precision_event_and_run_end(clustered, tmp_path):
    jpath = tmp_path / "p.jsonl"
    assert cli.main(["consensus", clustered, str(tmp_path / "p.mgf"),
                     "--device", "cpu", "--precision", "int8",
                     "--journal", str(jpath)]) == 0
    events = _events(jpath)
    (prec,) = [e for e in events if e["event"] == "precision"]
    assert prec["method"] == "bin-mean" and prec["precision"] == "int8"
    assert prec["gated"] and prec["ok"] and prec["checked"] == 32
    assert prec["min_cosine"] >= prec["tolerance"]
    assert events[-1]["precision"]["min_cosine"] == prec["min_cosine"]
    assert {e["kernel"] for e in events if e["event"] == "dispatch"} == {
        "bin_mean_flat_q"}


def test_resume_and_repair_events(clustered, tmp_path):
    """A resume over an output with bytes past the manifest: the torn
    tail is truncated (``resume_repair``) and the run resumes
    (``resume``)."""
    out, ck = tmp_path / "r.mgf", tmp_path / "r.ck.json"
    flags = ["--device", "cpu", "--checkpoint", str(ck),
             "--checkpoint-every", str(EVERY)]
    assert cli.main(["consensus", clustered, str(out), *flags]) == 0
    with open(out, "a") as fh:
        fh.write("BEGIN IONS\nTITLE=torn\n")
    jpath = tmp_path / "r.jsonl"
    assert cli.main(["consensus", clustered, str(out), *flags,
                     "--journal", str(jpath)]) == 0
    events = _events(jpath)
    (repair,) = [e for e in events if e["event"] == "resume_repair"]
    assert repair["action"] == "truncate_tail"
    (resume,) = [e for e in events if e["event"] == "resume"]
    assert resume["n_done"] == N_CLUSTERS and not resume["restarted"]
    assert events[-1]["counters"]["clusters_skipped_done"] == N_CLUSTERS


@pytest.fixture
def root_logging():
    """``-v`` and ``--log-json`` replace the root logger's handlers and
    level (``logging.basicConfig(force=True)``, as the JAX CLI does):
    put back what the test process had."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in root.handlers:
                root.addHandler(h)
        root.setLevel(level)


def test_verbose_and_json_logs(clustered, tmp_path, capsys, root_logging):
    assert cli.main(["-v", "consensus", clustered, str(tmp_path / "a.mgf"),
                     "--device", "cpu", "--metrics-out",
                     str(tmp_path / "m.prom")]) == 0
    err = capsys.readouterr().err
    assert " INFO specpride_tpu_torch: metrics -> " in err
    assert cli.main(["--log-json", "-v", "consensus", clustered,
                     str(tmp_path / "b.mgf"), "--device", "cpu",
                     "--metrics-out", str(tmp_path / "m.prom")]) == 0
    logs = [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith('{"ts"')]
    assert any(r["msg"].startswith("metrics -> ") and r["level"] == "INFO"
               and r["logger"] == "specpride_tpu_torch" for r in logs)


def test_no_logging_flags_leave_the_root_logger_alone(clustered, tmp_path):
    root = logging.getLogger()
    before = (list(root.handlers), root.level)
    assert cli.main(["consensus", clustered, str(tmp_path / "a.mgf"),
                     "--device", "cpu"]) == 0
    assert (list(root.handlers), root.level) == before


@pytest.mark.parametrize("command", ["consensus", "select", "evaluate"])
def test_trace_dir_writes_a_cpu_chrome_trace(command, clustered, tmp_path):
    """``--trace-dir``: a ``torch.profiler`` capture of the compute as a
    Chrome trace (CPU activity here; CUDA too on the card)."""
    tdir = tmp_path / "trace"
    if command == "evaluate":
        reps = tmp_path / "reps.mgf"
        assert cli.main(["consensus", clustered, str(reps), "--device",
                         "cpu"]) == 0
        argv = ["evaluate", str(reps), clustered]
    else:
        argv = [command, clustered, str(tmp_path / "o.mgf"), "--qc-report",
                str(tmp_path / "q.json")]
    assert cli.main([*argv, "--device", "cpu", "--trace-dir",
                     str(tdir)]) == 0
    (name,) = os.listdir(tdir)
    assert str(tdir / name) == trace_path(str(tdir))
    trace = json.loads((tdir / name).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert len(trace["traceEvents"]) > 10
    assert any(n.startswith("aten::") for n in names)


def test_journal_heals_a_torn_line_and_null_journal(tmp_path):
    path = tmp_path / "j.jsonl"
    path.write_text('{"v": 7, "ts": 1.0, "event": "run_st')
    with journal.Journal(str(path)) as j:
        j.emit("resume", n_done=np.int64(3))
    lines = path.read_text().splitlines()
    assert json.loads(lines[-1])["n_done"] == 3
    events, bad = journal.read_events(str(path))
    assert len(events) == 1 and len(bad) == 1
    assert journal.open_journal(None).emit("resume", n_done=1) == {}
    assert journal.expand_parts(str(tmp_path / "none.jsonl"))[0] == []
