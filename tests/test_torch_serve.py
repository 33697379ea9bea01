"""The port's serving daemon (``serve``, ``submit``, ``profile``;
``specpride_tpu_torch/serve/``) on the CPU, against the port's one-shot
CLI and the JAX package.

A daemon runs in a thread with ``device="cpu"`` and its socket under the
test's temporary directory; every fixture drains it in a ``finally`` and
every join, socket read and ``wait_for_socket`` has a timeout.  The cases
mirror the JAX package's ``tests/test_serve.py``: served bytes equal to
the one-shot CLI's for bin-mean, gap-average and medoid, with and
without QC (bin-mean with QC also within the ROADMAP tolerances of the
JAX CLI); concurrent jobs; admission (queue full retriable and ``submit``
exit 75, refused flags and a prefix spelling permanent, quotas); a job
error that does not stop the daemon; drain; the scheduler's pop order
against the JAX ``AdmissionQueue``; the refused-flag list; the ingest
cache; journal rotation; ``stats --follow``; placement on faked cards; a
sticky CUDA error draining the daemon; and a ``submit`` child that never
imports torch."""

import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from conftest import make_cluster

from specpride_tpu import cli as jcli
from specpride_tpu.io.mgf import write_mgf as jwrite_mgf
from specpride_tpu.observability.journal import read_events as jread_events
from specpride_tpu.observability.stats_cli import run_stats as jrun_stats
from specpride_tpu.serve import protocol as jprotocol
from specpride_tpu.serve.scheduler import AdmissionQueue as JQueue
from specpride_tpu.serve.scheduler import parse_quota_spec as jparse_quota
from specpride_tpu_torch import cli
from specpride_tpu_torch.io import mgf
from specpride_tpu_torch.observability.journal import Journal, read_events
from specpride_tpu_torch.observability.stats_cli import (
    follow_stats,
    run_stats,
)
from specpride_tpu_torch.serve import client as sc
from specpride_tpu_torch.serve import ingest_cache, placement, protocol
from specpride_tpu_torch.serve.daemon import ServeDaemon
from specpride_tpu_torch.serve.scheduler import AdmissionQueue
from specpride_tpu_torch.serve.scheduler import parse_quota_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = [("bin-mean", "consensus"), ("gap-average", "consensus"),
           ("medoid", "select")]
JOIN_S = 60


def _start(daemon: ServeDaemon) -> threading.Thread:
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    assert sc.wait_for_socket(daemon.socket_path, timeout=60), \
        "daemon never answered ping"
    return t


def _stop(daemon: ServeDaemon, thread: threading.Thread) -> None:
    daemon.drain()
    thread.join(timeout=JOIN_S)
    assert not thread.is_alive(), "daemon thread did not exit after drain"


def _write_workload(path, seed: int, n: int = 8):
    rng = np.random.default_rng(seed)
    clusters = [make_cluster(rng, f"cluster-{i}",
                             n_members=int(rng.integers(1, 5)), n_peaks=25)
                for i in range(n)]
    jwrite_mgf([s for c in clusters for s in c.members], path)
    return str(path)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    return _write_workload(tmp_path_factory.mktemp("wl") / "in.mgf", 99)


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """One long-lived daemon shared by the parity cases."""
    tmp = tmp_path_factory.mktemp("srv")
    d = ServeDaemon(str(tmp / "s.sock"), device="cpu", workers=1,
                    journal_path=str(tmp / "serve.jsonl"))
    t = _start(d)
    try:
        yield d
    finally:
        _stop(d, t)
    events, violations = read_events(d.journal_path)
    assert not violations, violations
    names = [e["event"] for e in events]
    assert names[0] == "run_start" and names[-1] == "run_end"
    assert "serve_start" in names and "serve_drain" in names


def _one_shot(src, out, method, command, qc=None, extra=()):
    argv = [command, src, out, "--method", method, "--device", "cpu"]
    if qc:
        argv += ["--qc-report", qc]
    assert cli.main(argv + list(extra)) == 0


def _job(src, out, method, command, qc=None, extra=()):
    argv = [command, src, out, "--method", method]
    if qc:
        argv += ["--qc-report", qc]
    return argv + list(extra)


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


class TestServedParity:
    @pytest.mark.parametrize("qc", [False, True], ids=["noqc", "qc"])
    @pytest.mark.parametrize("method,command", METHODS)
    def test_served_bytes_equal_one_shot_cli(self, tmp_path, workload,
                                             daemon, method, command, qc):
        """A served job writes the one-shot CLI's output and QC report
        bytes, and journals a complete run of its own that both
        packages' readers accept."""
        cli_qc = str(tmp_path / "cli.qc.json") if qc else None
        _one_shot(workload, str(tmp_path / "cli.mgf"), method, command,
                  cli_qc)
        srv_qc = str(tmp_path / "srv.qc.json") if qc else None
        job_journal = str(tmp_path / "job.jsonl")
        term = sc.submit_wait(daemon.socket_path, _job(
            workload, str(tmp_path / "srv.mgf"), method, command, srv_qc,
            ("--journal", job_journal)), timeout=JOIN_S)
        assert term["status"] == "done" and term["rc"] == 0, term
        assert term["worker"] == 0
        assert _read(tmp_path / "srv.mgf") == _read(tmp_path / "cli.mgf")
        if qc:
            assert _read(srv_qc) == _read(cli_qc)
        for reader in (read_events, jread_events):
            events, violations = reader(job_journal)
            assert not violations, violations
            (end,) = [e for e in events if e["event"] == "run_end"]
            assert end["worker"] == 0
            assert len({e["trace_id"] for e in events}) == 1
        assert events[0]["trace_id"] == term["trace_id"]

    def test_served_bin_mean_qc_matches_the_jax_cli(self, tmp_path,
                                                    workload, daemon):
        """The served main path against the JAX CLI on the same input:
        headers identical, m/z rtol 1e-5 / atol 1e-3, intensity rtol 1e-4
        / atol 1e-3, QC cosines rtol 1e-5 / atol 1e-6."""
        assert jcli.main(["consensus", workload, str(tmp_path / "j.mgf"),
                          "--qc-report", str(tmp_path / "j.qc.json")]) == 0
        term = sc.submit_wait(daemon.socket_path, _job(
            workload, str(tmp_path / "s.mgf"), "bin-mean", "consensus",
            str(tmp_path / "s.qc.json")), timeout=JOIN_S)
        assert term["status"] == "done", term
        got = mgf.read_mgf(str(tmp_path / "s.mgf"))
        want = mgf.read_mgf(str(tmp_path / "j.mgf"))
        assert [s.title for s in got] == [s.title for s in want]
        for g, w in zip(got, want):
            assert g.n_peaks == w.n_peaks
            np.testing.assert_allclose(g.mz, w.mz, rtol=1e-5, atol=1e-3)
            np.testing.assert_allclose(g.intensity, w.intensity, rtol=1e-4,
                                       atol=1e-3)
        gq = json.loads((tmp_path / "s.qc.json").read_text())["clusters"]
        wq = json.loads((tmp_path / "j.qc.json").read_text())["clusters"]
        assert [r["cluster_id"] for r in gq] == [r["cluster_id"] for r in wq]
        np.testing.assert_allclose([r["avg_cosine"] for r in gq],
                                   [r["avg_cosine"] for r in wq],
                                   rtol=1e-5, atol=1e-6)

    def test_two_concurrent_jobs_byte_identical(self, tmp_path, workload,
                                                daemon):
        golden = {}
        for method, command in METHODS[:2]:
            out = tmp_path / f"cli_{method}.mgf"
            _one_shot(workload, str(out), method, command)
            golden[method] = _read(out)
        results = {}

        def client(method, command):
            results[method] = sc.submit_wait(daemon.socket_path, _job(
                workload, str(tmp_path / f"srv_{method}.mgf"), method,
                command), timeout=JOIN_S)

        threads = [threading.Thread(target=client, args=mc)
                   for mc in METHODS[:2]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        for method, _ in METHODS[:2]:
            assert results[method]["status"] == "done", results[method]
            assert _read(tmp_path / f"srv_{method}.mgf") == golden[method]


class TestAdmission:
    @pytest.mark.parametrize("argv_tail,flag", [
        (["--layout", "flat"], "--layout"),
        (["--layou", "flat"], "--layout"),  # a prefix spelling
        (["--device", "cpu"], "--device"),
        (["--devic=cpu"], "--device"),
        (["--result-cache", "x"], "--result-cache"),
        (["--precision", "bf16"], "--precision"),
        (["--elastic", "coord"], "--elastic"),
        (["--elastic-steal", "off"], "--elastic-steal"),
        (["--elastic-local", "loc"], "--elastic-local"),
        (["--metrics-port", "0"], "--metrics-port"),
        (["--result-store", "http://127.0.0.1:9"], "--result-store"),
        (["--result-stor=s"], "--result-store"),  # a prefix spelling
    ])
    def test_refused_flags_rejected_permanently(self, tmp_path, workload,
                                                daemon, argv_tail, flag):
        term = sc.submit_wait(daemon.socket_path, [
            "consensus", workload, str(tmp_path / "o.mgf"), *argv_tail],
            timeout=JOIN_S)
        assert term["status"] == "rejected" and not term["retriable"]
        assert flag in term["reason"]
        assert sc.exit_code(term) == 2
        assert not (tmp_path / "o.mgf").exists()

    def test_bad_jobs_rejected_permanently(self, tmp_path, workload,
                                           daemon):
        for argv in (["evaluate", "x", "y"],
                     ["consensus", workload, str(tmp_path / "o.mgf"),
                      "--method", "no-such-method"],
                     ["consensus", "--help"]):
            term = sc.submit_wait(daemon.socket_path, argv, timeout=JOIN_S)
            assert term["status"] == "rejected" and not term["retriable"]
        term = sc.request(daemon.socket_path, {
            "op": "submit", "argv": ["consensus", workload, "o.mgf"],
            "client": ["not", "a", "string"]})
        assert term["status"] == "rejected" and "client" in term["reason"]

    def test_job_error_reported_not_fatal(self, tmp_path, workload, daemon):
        term = sc.submit_wait(daemon.socket_path, [
            "consensus", str(tmp_path / "missing.mgf"),
            str(tmp_path / "o.mgf")], timeout=JOIN_S)
        # an OSError is transient by the taxonomy, as in the JAX daemon
        assert term["status"] == "error" and term["retriable"], term
        assert "FileNotFoundError" in term["error"]
        ok = tmp_path / "after.mgf"
        term = sc.submit_wait(daemon.socket_path, [
            "consensus", workload, str(ok)], timeout=JOIN_S)
        assert term["status"] == "done" and ok.exists()

    def test_queue_full_retriable_and_submit_exits_75(
            self, tmp_path_factory, workload, capsys):
        tmp = tmp_path_factory.mktemp("full")
        d = ServeDaemon(str(tmp / "s.sock"), device="cpu", max_queue=1,
                        workers=1, journal_path=str(tmp / "serve.jsonl"))
        d._gate.clear()  # hold the lane: the next job stays queued
        t = _start(d)
        terms = {}

        def submit(tag):
            terms[tag] = sc.submit_wait(d.socket_path, [
                "consensus", workload, str(tmp / f"{tag}.mgf")],
                timeout=JOIN_S)

        threads = []
        try:
            threads.append(threading.Thread(target=submit, args=("a",)))
            threads[-1].start()
            deadline = time.time() + 30
            while d._inflight is None and time.time() < deadline:
                time.sleep(0.01)
            assert d._inflight is not None
            threads.append(threading.Thread(target=submit, args=("b",)))
            threads[-1].start()
            while len(d.queue) < 1 and time.time() < deadline:
                time.sleep(0.01)
            submit("c")
            assert terms["c"]["status"] == "rejected"
            assert terms["c"]["reason"] == "queue_full"
            assert terms["c"]["retriable"] is True
            capsys.readouterr()
            rc = sc.main(["submit", "--socket", d.socket_path, "--",
                          "consensus", workload, str(tmp / "d.mgf")])
            assert rc == protocol.EX_TEMPFAIL == 75
            assert '"queue_full"' in capsys.readouterr().out
            d._gate.set()
            for th in threads:
                th.join(timeout=JOIN_S)
                assert not th.is_alive()
            assert terms["a"]["status"] == terms["b"]["status"] == "done"
        finally:
            d._gate.set()
            _stop(d, t)

    def test_quota_caps_a_client(self, tmp_path_factory, workload):
        """``--quota capped=1:1``: a second job of the capped client while
        its first holds the lane is rejected retriable with the quota
        named; another client's job is admitted."""
        tmp = tmp_path_factory.mktemp("quota")
        d = ServeDaemon(str(tmp / "s.sock"), device="cpu", workers=1,
                        quotas=parse_quota_spec("capped=1:1"))
        d._gate.clear()
        t = _start(d)
        terms = {}

        def submit(tag, client):
            terms[tag] = sc.submit_wait(d.socket_path, [
                "consensus", workload, str(tmp / f"{tag}.mgf")],
                client=client, timeout=JOIN_S)

        first = threading.Thread(target=submit, args=("a", "capped"))
        other = threading.Thread(target=submit, args=("b", "free"))
        try:
            first.start()
            deadline = time.time() + 30
            while d._inflight is None and time.time() < deadline:
                time.sleep(0.01)
            submit("c", "capped")
            assert terms["c"]["status"] == "rejected"
            assert terms["c"]["retriable"] is True
            assert "quota client=capped max_inflight=1" in \
                terms["c"]["reason"]
            other.start()
            while len(d.queue) < 1 and time.time() < deadline:
                time.sleep(0.01)
            assert len(d.queue) == 1
            d._gate.set()
            for th in (first, other):
                th.join(timeout=JOIN_S)
                assert not th.is_alive()
            assert terms["a"]["status"] == terms["b"]["status"] == "done"
        finally:
            d._gate.set()
            _stop(d, t)


def test_drain_commits_inflight_rejects_queued(tmp_path_factory, workload):
    """The SIGTERM contract: the in-flight job commits its bytes and
    manifest, the queued one is rejected retriable, the socket goes, and
    the journal ends in ``serve_drain`` and ``run_end`` and reads under
    both packages' ``read_events`` with no violation."""
    tmp = tmp_path_factory.mktemp("drain")
    _one_shot(workload, str(tmp / "cli.mgf"), "bin-mean", "consensus")
    d = ServeDaemon(str(tmp / "s.sock"), device="cpu", workers=1,
                    journal_path=str(tmp / "serve.jsonl"))
    d._gate.clear()
    t = _start(d)
    terms = {}

    def submit(tag):
        terms[tag] = sc.submit_wait(d.socket_path, [
            "consensus", workload, str(tmp / f"{tag}.mgf"), "--checkpoint",
            str(tmp / f"{tag}.ck.json"), "--checkpoint-every", "2"],
            timeout=JOIN_S)

    t1 = threading.Thread(target=submit, args=("inflight",))
    t2 = threading.Thread(target=submit, args=("queued",))
    try:
        t1.start()
        deadline = time.time() + 30
        while d._inflight is None and time.time() < deadline:
            time.sleep(0.01)
        assert d._inflight is not None
        t2.start()
        while len(d.queue) < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert len(d.queue) == 1
    finally:
        _stop(d, t)
    for th in (t1, t2):
        th.join(timeout=JOIN_S)
        assert not th.is_alive()
    assert terms["inflight"]["status"] == "done", terms["inflight"]
    assert _read(tmp / "inflight.mgf") == _read(tmp / "cli.mgf")
    manifest = json.loads((tmp / "inflight.ck.json").read_text())
    assert len(manifest["done"]) == 8
    assert terms["queued"]["status"] == "rejected"
    assert terms["queued"]["reason"] == "draining"
    assert terms["queued"]["retriable"] is True
    with pytest.raises(OSError):
        sc.request(d.socket_path, {"op": "ping"}, timeout=2.0)
    for reader in (read_events, jread_events):
        events, violations = reader(d.journal_path)
        assert not violations, violations
        assert [e["event"] for e in events][-2:] == ["serve_drain",
                                                      "run_end"]
        assert events[-2]["n_rejected"] == 1


# -- the scheduler against the JAX package's ---------------------------------

def _pop_order(queue_cls, quotas, ops, conflict=None):
    """Replay ``ops`` (``("offer", client, job)``, ``("pop",)``,
    ``("release", job)``) and return each offer's outcome (admitted, or
    the quota's refusal) and what each pop returned."""
    q = queue_cls(64, quotas=quotas, conflict_key=conflict)
    seen = []
    for op in ops:
        if op[0] == "offer":
            try:
                seen.append(q.offer(op[1], op[2]))
            except Exception as e:  # the package's own QuotaExceeded
                assert type(e).__name__ == "QuotaExceeded"
                seen.append(str(e))
        elif op[0] == "pop":
            seen.append(q.pop(timeout=0.01))
        else:
            q.release(op[1])
    return seen


def _offers(spec):
    return [("offer", c, f"{c}{i}") for c, n in spec for i in range(n)]


SCHEDULES = {
    # no quotas: FIFO-fair round robin over clients
    "fair": (None, _offers([("a", 4), ("b", 2), ("c", 3)])
             + [("pop",)] * 10, None),
    # weights 3 : 1
    "weighted": ("a=3,b=1", _offers([("a", 8), ("b", 8)])
                 + [("pop",)] * 12, None),
    # an inflight cap: a's third offer is refused until a release
    "capped": ("a=1:2,*=1", _offers([("a", 3), ("b", 3)])
               + [("pop",)] * 3 + [("release", "a0"), ("offer", "a", "a9"),
                                    ("pop",), ("pop",), ("pop",)],
               None),
    # jobs on one output path never run together
    "conflict": (None, _offers([("a", 2), ("b", 2)])
                 + [("pop",)] * 3 + [("release", "a0"), ("pop",),
                                      ("pop",)],
                 lambda job: ["same.mgf"] if job in ("a0", "b0", "b1")
                 else []),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scheduler_pop_order_equals_jax(name):
    spec, ops, conflict = SCHEDULES[name]
    got = _pop_order(AdmissionQueue, parse_quota_spec(spec), ops, conflict)
    want = _pop_order(JQueue, jparse_quota(spec), ops, conflict)
    assert got == want
    assert any(p is not None for p in got)


def test_refused_flags_are_the_jax_list_on_the_port_parser_plus_device():
    """The port refuses the JAX daemon's flags its parser has, plus
    ``--device``; each parses on ``consensus`` and ``select``, and every
    dest's default is the parser's own."""
    consensus = cli.build_parser()._subparsers._group_actions[0].choices[
        "consensus"]
    port_flags = {o for a in consensus._actions for o in a.option_strings}
    jax_list = set(jprotocol.DAEMON_ONLY_FLAGS)
    assert set(protocol.JOB_REFUSED_FLAGS) == (jax_list & port_flags) | {
        "--device"}
    assert len(protocol.JOB_REFUSED_FLAGS) == len(
        set(protocol.JOB_REFUSED_FLAGS))
    base = cli.build_parser().parse_args(["select", "i", "o"])
    for dest, default in protocol._owned_defaults().items():
        assert getattr(base, dest) == default
    assert protocol.forbidden_flags(["consensus", "--device=cpu",
                                     "--layout", "x", "--qc-report"]) == [
        "--device", "--layout"]


# -- the ingest cache --------------------------------------------------------


@pytest.fixture
def fresh_ingest():
    ingest_cache.clear()
    yield
    ingest_cache.clear()


def test_ingest_cache_hits_repeats_and_misses_changed_inputs(
        tmp_path, fresh_ingest, workload):
    src = tmp_path / "in.mgf"
    src.write_bytes(_read(workload))
    assert ingest_cache.lookup(str(src)) == (None, "miss")
    clusters = cli._load_mgf_clusters(str(src), "off", None)
    ingest_cache.put(str(src), clusters)
    got, kind = ingest_cache.lookup(str(src))
    assert got is clusters and kind == "stat"
    # a changed mtime: the stat key misses, the same bytes match by content
    st = os.stat(src)
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    got, kind = ingest_cache.lookup(str(src))
    assert got is clusters and kind == "content"
    # a changed size: a miss
    with open(src, "ab") as fh:
        fh.write(b"\n")
    assert ingest_cache.lookup(str(src)) == (None, "miss")
    assert ingest_cache.info() == {"hits": 2, "misses": 1,
                                   "content_hits": 1, "size": 1}


def test_served_repeat_job_skips_the_parse(tmp_path, fresh_ingest,
                                           workload, daemon):
    src = tmp_path / "in.mgf"
    src.write_bytes(_read(workload))
    for i, want in ((0, "ingest_cache_misses"), (1, "ingest_cache_hits")):
        term = sc.submit_wait(daemon.socket_path, [
            "consensus", str(src), str(tmp_path / f"o{i}.mgf"),
            "--journal", str(tmp_path / f"j{i}.jsonl")], timeout=JOIN_S)
        assert term["status"] == "done", term
        assert term["stats"]["counters"][want] == 1
        (end,) = [e for e in read_events(str(tmp_path / f"j{i}.jsonl"))[0]
                  if e["event"] == "run_end"]
        assert end["counters"][want] == 1
    assert _read(tmp_path / "o0.mgf") == _read(tmp_path / "o1.mgf")
    os.utime(src, ns=(0, 10**9))  # an older mtime: the content still hits
    term = sc.submit_wait(daemon.socket_path, [
        "consensus", str(src), str(tmp_path / "o2.mgf")], timeout=JOIN_S)
    assert term["stats"]["counters"]["ingest_cache_content_hits"] == 1


def test_one_shot_cli_never_consults_the_ingest_cache(tmp_path, workload,
                                                      monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a one-shot run consulted the ingest cache")

    monkeypatch.setattr(ingest_cache, "lookup", refuse)
    monkeypatch.setattr(ingest_cache, "put", refuse)
    _one_shot(workload, str(tmp_path / "o.mgf"), "bin-mean", "consensus")


# -- journal rotation and stats --follow --------------------------------------


def test_rotated_daemon_journal_reads_in_both_packages(tmp_path_factory,
                                                       workload, capsys):
    tmp = tmp_path_factory.mktemp("rot")
    path = str(tmp / "serve.jsonl")
    d = ServeDaemon(str(tmp / "s.sock"), device="cpu", workers=1,
                    journal_path=path, journal_rotate_mb=0.001)
    t = _start(d)
    try:
        for i in range(3):
            term = sc.submit_wait(d.socket_path, [
                "consensus", workload, str(tmp / f"o{i}.mgf")],
                timeout=JOIN_S)
            assert term["status"] == "done"
    finally:
        _stop(d, t)
    segments = sorted(p for p in os.listdir(tmp)
                      if p.startswith("serve.jsonl."))
    assert len(segments) >= 2, segments
    for seg in segments:
        with open(tmp / seg) as fh:
            assert json.loads(fh.readline())["event"] == "clock_anchor" \
                or seg == segments[0]
    capsys.readouterr()
    assert run_stats([path]) == 0
    port_out = capsys.readouterr().out
    assert jrun_stats([path]) == 0
    jax_out = capsys.readouterr().out
    # each segment is summarized on its own, as in the JAX package
    for out in (port_out, jax_out):
        done = [int(tok.split("=")[1]) for tok in out.split()
                if tok.startswith("jobs_done=")]
        assert sum(done) == 3, out


def test_follow_rerenders_as_jobs_land(tmp_path):
    """``stats --follow`` renders again as complete events land, never a
    torn line, and follows the journal across a rotation."""
    path = tmp_path / "live.jsonl"
    journal = Journal(path)
    journal.emit("run_start", command="serve", method="serve",
                 backend="torch", n_clusters=0)
    journal.emit("serve_start", socket="s", max_queue=4, warmed_kernels=0,
                 workers=2)
    buf = io.StringIO()
    stop = threading.Event()
    t = threading.Thread(target=follow_stats, args=(str(path),),
                         kwargs={"out": buf, "interval": 0.05,
                                 "stop": stop, "slo": True},
                         daemon=True)
    t.start()

    def wait_for(needle, timeout=20):
        deadline = time.time() + timeout
        while needle not in buf.getvalue():
            assert time.time() < deadline, (needle, buf.getvalue())
            time.sleep(0.02)

    try:
        wait_for("update 1")
        assert "serving:" in buf.getvalue()
        with open(path, "a") as fh:
            fh.write('{"v": 7, "ts": 1.0, "mono": 1.0, "event": "job_')
            fh.flush()
            time.sleep(0.2)
            assert "update 2" not in buf.getvalue()
            fh.write('done", "job_id": 1, "status": "done", "wall_s": 0.5, '
                     '"fresh_compiles": 0, "worker": 1, "trace_id": "'
                     + "a" * 32 + '", "method": "bin-mean", '
                     '"slo_objective_s": 1.0, "slo_latency_s": 0.6, '
                     '"slo_ok": true}\n')
        wait_for("update 2")
        assert "jobs_done=1" in buf.getvalue()
        assert "worker 1: jobs=1" in buf.getvalue()
        assert "slo: method=bin-mean" in buf.getvalue()
        journal.close()
        os.replace(path, f"{path}.1")
        journal = Journal(path)
        journal.emit("job_done", job_id=2, status="done", wall_s=0.4,
                     trace_id="b" * 32, worker=0)
        wait_for("jobs_done=2")
    finally:
        stop.set()
        t.join(timeout=10)
        journal.close()
    assert not t.is_alive()


def test_follow_requires_one_journal(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["stats", str(tmp_path / "a"), str(tmp_path / "b"),
                  "--follow"])


# -- placement, CUDA and the torch-free client ------------------------------


class _FakeStream:
    def __init__(self, device):
        self.device = device


@pytest.mark.parametrize("cards,workers,want", [
    (1, 2, ["cuda:0", "cuda:0"]),
    (2, 3, ["cuda:0", "cuda:1", "cuda:0"]),
    (2, 0, ["cuda:0", "cuda:1"]),
])
def test_placement_gives_each_lane_a_card_and_its_own_stream(
        monkeypatch, cards, workers, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    n = workers or placement.default_workers()
    slots = placement.plan_placement(n)
    assert [s.describe() for s in slots] == want
    assert [s.worker for s in slots] == list(range(len(want)))
    assert all(s.stream.device == s.device for s in slots)
    assert len({id(s.stream) for s in slots}) == len(slots)
    cpu = placement.plan_placement(2, device="cpu")
    assert [s.describe() for s in cpu] == ["cpu:shared", "cpu:shared"]
    assert all(s.stream is None for s in cpu)


def test_daemon_without_cuda_refuses_unless_asked_for_the_cpu(tmp_path):
    assert not torch.cuda.is_available()
    d = ServeDaemon(str(tmp_path / "s.sock"),
                    journal_path=str(tmp_path / "j.jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        d.boot()
    assert not (tmp_path / "s.sock").exists()
    assert not (tmp_path / "j.jsonl").exists()
    with pytest.raises(SystemExit):
        cli.main(["serve", "--socket", str(tmp_path / "s.sock")])


def test_sticky_cuda_error_drains_the_daemon(tmp_path_factory, workload,
                                             monkeypatch):
    """A sticky CUDA error: the job's terminal line says not retriable,
    ``/healthz`` turns degraded, the queued job is refused retriable and
    never run, and ``run()`` drains and returns 1."""
    tmp = tmp_path_factory.mktemp("sticky")
    ran = []

    def poisoned(args, backend, *a, **k):
        ran.append(args.output)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(cli, "_run_pipeline_command", poisoned)
    d = ServeDaemon(str(tmp / "s.sock"), device="cpu", workers=1,
                    journal_path=str(tmp / "serve.jsonl"))
    d._gate.clear()
    rc = []
    t = threading.Thread(target=lambda: rc.append(d.run()), daemon=True)
    t.start()
    assert sc.wait_for_socket(d.socket_path, timeout=60)
    terms = {}

    def submit(tag):
        terms[tag] = sc.submit_wait(d.socket_path, [
            "consensus", workload, str(tmp / f"{tag}.mgf")], timeout=JOIN_S)

    threads = [threading.Thread(target=submit, args=(tag,))
               for tag in ("first", "second")]
    try:
        threads[0].start()
        deadline = time.time() + 30
        while d._inflight is None and time.time() < deadline:
            time.sleep(0.01)
        threads[1].start()
        while len(d.queue) < 1 and time.time() < deadline:
            time.sleep(0.01)
        d._gate.set()
        for th in threads:
            th.join(timeout=JOIN_S)
            assert not th.is_alive()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    finally:
        d._gate.set()
        d.drain()
    assert rc == [1]
    assert terms["first"]["status"] == "error"
    assert terms["first"]["retriable"] is False
    assert "illegal memory access" in terms["first"]["error"]
    assert terms["second"]["status"] == "rejected"
    assert terms["second"]["retriable"] is True
    assert ran == [str(tmp / "first.mgf")]
    ok, detail = d._healthz()
    assert not ok and detail.startswith("cuda_error")
    events, violations = read_events(d.journal_path)
    assert not violations
    assert [e["event"] for e in events][-2:] == ["serve_drain", "run_end"]
    assert "illegal memory access" in events[-2]["cuda_error"]


def test_submit_child_imports_no_torch(tmp_path, workload, daemon):
    """``python -m specpride_tpu_torch submit`` in a child: the job runs
    and the child's ``sys.modules`` holds no torch; with no daemon the
    child exits 75."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['specpride_tpu_torch'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('specpride_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print('RC', rc, 'TORCH', 'torch' in sys.modules, flush=True)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    for sock, want in ((daemon.socket_path, 0),
                       (str(tmp_path / "none.sock"), 75)):
        proc = subprocess.run(
            [sys.executable, "-c", code, "submit", "--socket", sock, "--",
             "consensus", workload, str(tmp_path / "o.mgf")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert f"RC {want} TORCH False" in proc.stdout, proc.stdout
    assert (tmp_path / "o.mgf").exists()


def test_daemon_boot_configures_the_shared_tier(tmp_path, workload,
                                                request):
    """``serve --result-cache --result-store``: the boot installs both
    tiers, a job populates the shared store, and a second daemon with a
    fresh local tier serves the job again from the shared one (every
    cluster a shared hit) with the same bytes."""
    from specpride_tpu_torch.cache import result_cache as rc_mod

    store = str(tmp_path / "store")
    outs = []
    # the cache's process totals are shared: zero them before and after,
    # so no other test's exposition counts these hits
    rc_mod.reset()
    request.addfinalizer(rc_mod.reset)
    for i in range(2):
        d = ServeDaemon(str(tmp_path / f"s{i}.sock"), device="cpu",
                        workers=1, result_cache=str(tmp_path / f"tier{i}"),
                        result_store=store)
        t = _start(d)
        try:
            cache = rc_mod.active()
            assert cache.shared is not None
            assert cache.shared.describe() == f"filesystem:{store}"
            out, journal = tmp_path / f"o{i}.mgf", tmp_path / f"j{i}.jsonl"
            term = sc.submit_wait(d.socket_path, [
                "consensus", workload, str(out), "--journal", str(journal)],
                timeout=JOIN_S)
            assert term["status"] == "done", term
            outs.append(_read(out))
        finally:
            _stop(d, t)
        assert rc_mod.active() is None  # the drain uninstalls it
        events, _ = read_events(str(journal))
        ev = [e for e in events if e["event"] == "result_cache"][-1]
        if i == 0:
            assert ev["shared_hits"] == 0 and ev["populated"] > 0
            assert any(n.startswith("rc-") for n in os.listdir(store))
        else:
            assert ev["shared_hits"] == ev["hits"] > 0
            assert ev["misses"] == ev["populated"] == 0
    assert outs[0] == outs[1]
