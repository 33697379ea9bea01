"""The port's flight recorder (``observability/detect.py``,
``flightrec.py``, the journal taps, ``incident_cli.py``, the hosts'
``--flightrec``) against the JAX package's, on the CPU.

Detector parity: seeded event streams that cover every detector (SLO
streaks broken and cleared, latency walls around the EWMA, a queue
filling to its bound, stalls, retries up to attempt 3, fallback bursts in
and out of the window, lease churn, flapping inside the cooldown) give
the same firings, as JSON, from the JAX ``DetectorSet`` and the port's,
and the same ``status()``.  Replay across packages: journals written by
either package's ``Journal`` and ``FlightRecorder`` (observe and on)
replay clean in both; a tampered incident, and an observe-mode incident
that claims a bundle, fail in both; a recorder that never drained leaves
warnings; two rank shards replay independently.  Bundles written by
either package read in both.  The taps: catch-up over rotated segments,
detach in either order, a raising tap, and the fold order of several
emitting threads.  The hosts: a daemon, an elastic rank and ``fleet``.
The faults: C5 (``cas-server``'s order) and C6 (``serve --mesh``); and
``evaluate`` over two ranks (A10)."""

import builtins
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tarfile
import threading
import types

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu import cli as jcli
from specpride_tpu.io.mgf import write_mgf as jwrite_mgf
from specpride_tpu.observability import detect as jdetect
from specpride_tpu.observability import flightrec as jflightrec
from specpride_tpu.observability.journal import Journal as JJournal
from specpride_tpu.observability.stats_cli import run_stats as jrun_stats
from specpride_tpu_torch import cli
from specpride_tpu_torch.observability import detect, flightrec
from specpride_tpu_torch.observability.exporter import (
    ServeTelemetry,
    parse_exposition,
)
from specpride_tpu_torch.observability.journal import (
    Journal,
    NullJournal,
    expand_segments,
    read_events,
)
from specpride_tpu_torch.observability.stats_cli import run_stats
from specpride_tpu_torch.parallel import fleet
from specpride_tpu_torch.serve import client as sc
from specpride_tpu_torch.serve.daemon import ServeDaemon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = "cd" * 16
JOIN_S = 60
PACKAGES = {"port": (Journal, flightrec), "jax": (JJournal, jflightrec)}


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


# -- detector parity ---------------------------------------------------------


def _random_stream(seed: int, n: int = 400) -> list:
    """A seeded stream over every event a detector reads (and some it
    ignores): gaps mostly short (inside the 30 s cooldown and the 60 s
    windows), sometimes long; walls around a baseline with spikes."""
    rng = np.random.default_rng(seed)
    mono, out = 1000.0 + float(rng.uniform(0, 10)), []
    kinds = ["job_queued", "job_start", "job_done", "job_done", "retry",
             "batch_dispatch", "lease_expire", "chunk_reassign",
             "lease_split", "watchdog_stall", "heartbeat", "incident",
             "serve_start"]
    for i in range(n):
        mono += float(rng.choice([rng.uniform(0, 2), rng.uniform(0, 20),
                                  rng.uniform(25, 90)], p=[0.6, 0.3, 0.1]))
        kind = str(rng.choice(kinds))
        rec = {"event": kind, "mono": mono, "ts": 1.7e9 + mono}
        if rng.random() < 0.3:
            rec["trace_id"] = f"{int(rng.integers(0, 2**62)):032x}"
        if kind == "serve_start":
            rec["max_queue"] = int(rng.integers(1, 8))
        elif kind == "job_done":
            rec.update(job_id=i, status="done",
                       wall_s=float(rng.choice(
                           [rng.uniform(0.5, 1.5), rng.uniform(5, 20)],
                           p=[0.85, 0.15])))
            ok = rng.choice([True, False, None], p=[0.3, 0.5, 0.2])
            if ok is not None:
                rec.update(slo_ok=bool(ok), slo_latency_s=rec["wall_s"],
                           slo_objective_s=1.0)
        elif kind in ("job_queued", "job_start"):
            rec["job_id"] = i
        elif kind == "retry":
            rec.update(site=str(rng.choice(["dispatch", "write", "cas"])),
                       attempt=int(rng.integers(0, 4)),
                       backoff_s=float(rng.uniform(0, 1)))
        elif kind == "batch_dispatch":
            rec.update(batch_id=i, status=str(rng.choice(
                ["shared", "fallback_solo"])), error="RuntimeError: x")
        elif kind in ("lease_expire", "chunk_reassign", "lease_split"):
            rec.update(rank=int(rng.integers(0, 3)),
                       range=int(rng.integers(0, 9)))
        elif kind == "watchdog_stall":
            rec.update(lane=str(rng.choice(["dispatch", "serve:job"])),
                       elapsed_s=float(rng.uniform(1, 5)), timeout_s=1.0)
        elif kind == "incident":
            rec.update(detector="watchdog", reason="fed back?")
        out.append(rec)
    return out


def _scripted_streams() -> dict:
    """One stream per detector, each crossing its threshold, clearing
    and firing again, with flapping inside the cooldown."""
    def job(m, ok=None, wall=1.0):
        rec = {"event": "job_done", "mono": m, "job_id": int(m),
               "status": "done", "wall_s": wall}
        if ok is not None:
            rec.update(slo_ok=ok, slo_latency_s=wall, slo_objective_s=0.5)
        return rec

    streams = {
        "slo_breach": [job(t, ok=t % 7 == 0) for t in range(1, 80)]
        + [job(200 + t, ok=False) for t in range(5)],
        "latency_spike": [job(t, wall=1.0 + 0.01 * (t % 3))
                          for t in range(1, 12)]
        + [job(12, wall=9.0), job(13, wall=1.0), job(50, wall=30.0),
           job(51, wall=40.0)],
        "queue_sat": [{"event": "serve_start", "mono": 0.5,
                       "max_queue": 4}]
        + [{"event": "job_queued", "mono": 1.0 + t, "job_id": t}
           for t in range(5)]
        + [{"event": "job_start", "mono": 10.0 + t, "job_id": t}
           for t in range(5)]
        + [{"event": "job_queued", "mono": 60.0 + t, "job_id": t}
           for t in range(4)],
        "watchdog": [{"event": "watchdog_stall", "mono": m, "lane": "x",
                      "elapsed_s": 2.0, "timeout_s": 1.0}
                     for m in (1.0, 5.0, 29.0, 31.5, 80.0)],
        "retry_exhaust": [{"event": "retry", "mono": 1.0 + a + 40 * k,
                           "site": "dispatch", "attempt": a,
                           "backoff_s": 0.1 * a}
                          for k in range(3) for a in range(4)],
        "solo_burst": [{"event": "batch_dispatch", "mono": m,
                        "batch_id": i, "status": s}
                       for i, (m, s) in enumerate(
                           [(1, "fallback_solo"), (2, "shared"),
                            (30, "fallback_solo"), (70, "fallback_solo"),
                            (71, "fallback_solo"), (72, "fallback_solo"),
                            (200, "fallback_solo"), (201, "fallback_solo"),
                            (202, "fallback_solo")])],
        "lease_churn": [{"event": ev, "mono": 1.0 + i * 3, "rank": i % 2,
                         "range": i}
                        for i, ev in enumerate(
                            ["lease_expire", "chunk_reassign",
                             "lease_split"] * 6)],
    }
    assert set(streams) == set(detect.DETECTOR_NAMES)
    return streams


def _fold(module, stream, params=None) -> tuple[list, dict]:
    dset = module.DetectorSet(params)
    firings = []
    for rec in stream:
        firings.extend(dset.observe(rec))
    return firings, dset.status()


STREAMS = {**{f"seed{s}": _random_stream(s) for s in range(6)},
           **_scripted_streams()}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_detector_firings_equal_the_jax_detectors(name):
    got, got_status = _fold(detect, STREAMS[name])
    want, want_status = _fold(jdetect, STREAMS[name])
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got_status == want_status
    if name in detect.DETECTOR_NAMES:
        # the scripted stream fires its own detector, more than once
        assert sum(f["detector"] == name for f in got) >= 2, got


def test_every_detector_fires_and_suppresses_somewhere():
    fired, suppressed = set(), 0
    for stream in STREAMS.values():
        firings, status = _fold(detect, stream)
        fired |= {f["detector"] for f in firings}
        suppressed += status["suppressed"]
    assert fired == set(detect.DETECTOR_NAMES)
    assert suppressed > 0


def test_detector_parameters_and_identities_equal_the_jax_ones():
    assert detect.DEFAULT_PARAMS == jdetect.DEFAULT_PARAMS
    assert detect.DETECTOR_NAMES == jdetect.DETECTOR_NAMES
    for name in detect.DETECTOR_NAMES:
        for clock in (0.0, 1.2345675, 98765.4321):
            assert detect.incident_id(name, clock) == jdetect.incident_id(
                name, clock)
            assert detect.derived_trace_id(name, clock) == \
                jdetect.derived_trace_id(name, clock)
    params = {"slo_breach": {"streak": 2}, "cooldown_s": 5.0}
    stream = STREAMS["seed3"]
    assert _fold(detect, stream, params) == _fold(jdetect, stream, params)


# -- replay across packages ------------------------------------------------


def _recorded_journal(tmp_path, package: str, mode: str, name="j.jsonl"):
    """A serving-shaped journal written by ``package``'s ``Journal`` with
    its ``FlightRecorder`` attached: two incidents (an SLO streak, a
    stall), a suppressed stall inside the cooldown."""
    journal_cls, module = PACKAGES[package]
    path = str(tmp_path / name)
    j = journal_cls(path)
    kw = {"incident_dir": str(tmp_path / f"inc-{package}")} \
        if mode == "on" else {}
    rec = module.FlightRecorder(j, mode=mode, **kw).start()
    j.emit("serve_start", socket="s", max_queue=16)
    for i in range(3):
        j.emit("job_done", job_id=i, status="done", wall_s=0.01,
               slo_ok=False, slo_latency_s=0.01, slo_objective_s=0.001,
               trace_id=TRACE)
    for _ in range(2):
        j.emit("watchdog_stall", lane="serve:job", elapsed_s=2.0,
               timeout_s=1.0)
    rec.stop()
    j.close()
    return path


def _rewrite(path, fn) -> None:
    lines = [json.loads(ln) for ln in open(path, encoding="utf-8")]
    for rec in lines:
        if rec.get("event") == "incident":
            fn(rec)
            break
    with open(path, "w", encoding="utf-8") as fh:
        fh.writelines(json.dumps(rec) + "\n" for rec in lines)


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("mode", ["observe", "on"])
def test_journals_replay_clean_in_both_packages(tmp_path, writer, mode):
    path = _recorded_journal(tmp_path, writer, mode)
    results = [m.replay_incidents(path) for m in (flightrec, jflightrec)]
    for res in results:
        assert res["ok"], res
        assert res["reproduced"] == res["incidents"] == 2
        assert res["by_detector"] == {"slo_breach": 1, "watchdog": 1}
        assert res["bundled"] == (2 if mode == "on" else 0)
        assert res["unjournaled"] == []
    strip = [{k: v for k, v in r.items() if k != "warnings"}
             for r in results]
    assert strip[0] == strip[1]
    events, bad = read_events(path)
    assert bad == []
    incidents = [e for e in events if e["event"] == "incident"]
    assert [e["suppressed"] for e in incidents] == [0, 0]


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("field,value,expect", [
    ("incident_id", "0" * 16, "incident_id"),
    ("reason", "forged", "reason"),
    ("evidence", {"streak": 99}, "evidence"),
    ("bundled", True, "bundled=true in observe mode"),
])
def test_a_tampered_incident_fails_in_both_packages(tmp_path, writer, field,
                                                    value, expect):
    path = _recorded_journal(tmp_path, writer, "observe")
    _rewrite(path, lambda rec: rec.__setitem__(field, value))
    for module in (flightrec, jflightrec):
        res = module.replay_incidents(path)
        assert not res["ok"]
        assert any(expect in m for m in res["mismatches"]), res
    assert cli.main(["incident-replay", path]) == 1


@pytest.mark.parametrize("module", [flightrec, jflightrec],
                         ids=["port", "jax"])
def test_a_recorder_that_never_drained_leaves_warnings(tmp_path, module):
    path = str(tmp_path / "j.jsonl")
    j = Journal(path)
    j.emit("watchdog_stall", lane="x", elapsed_s=2.0, timeout_s=1.0)
    j.close()
    res = module.replay_incidents(path)
    assert res["ok"] and res["incidents"] == 0
    assert len(res["unjournaled"]) == 1


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_two_rank_shards_replay_independently(tmp_path, writer):
    journal_cls, module = PACKAGES[writer]
    base = str(tmp_path / "el.jsonl")
    count = detect.DEFAULT_PARAMS["lease_churn"]["count"]
    for rank in range(2):
        j = journal_cls(f"{base}.part{rank:05d}")
        rec = module.FlightRecorder(j, mode="observe").start()
        j.emit("heartbeat", rank=rank, chunk_s=0.5)
        for i in range(count if rank == 0 else count - 1):
            j.emit("lease_expire", rank=rank, range=i)
        rec.stop()
        j.close()
    for replay in (flightrec.replay_incidents, jflightrec.replay_incidents):
        res = replay(base)
        assert res["ok"], res
        assert res["streams"] == 2 and res["incidents"] == 1
        assert res["by_detector"] == {"lease_churn": 1}


# -- bundles -----------------------------------------------------------------


def _bundle(tmp_path, module, journal_cls, **kw):
    j = journal_cls(str(tmp_path / "b.jsonl"))
    inc = str(tmp_path / "incidents")
    rec = module.FlightRecorder(j, mode="on", incident_dir=inc, **kw).start()
    j.emit("watchdog_stall", lane="dispatch", elapsed_s=2.0, timeout_s=1.0)
    rec.stop()
    j.close()
    return inc, rec


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_bundles_read_in_both_packages(tmp_path, writer):
    journal_cls, module = PACKAGES[writer]
    inc, rec = _bundle(tmp_path, module, journal_cls,
                       metrics_fn=lambda: "# TYPE x counter\nx 1\n",
                       extra_fn=lambda: {"ranges_committed": 3},
                       config={"host": "test"})
    assert rec.status()["bundles"] == 1
    got = [m.list_bundles(inc) for m in (flightrec, jflightrec)]
    assert got[0] == got[1]
    (bundle,), warnings = got[0]
    assert warnings == []
    assert bundle["schema"] == flightrec.BUNDLE_SCHEMA == \
        jflightrec.BUNDLE_SCHEMA
    assert bundle["files"] == ["config.json", "host.json",
                               "journal_tail.jsonl", "metrics.prom",
                               "ring.jsonl", "stacks.txt"]
    iid = bundle["incident"]["incident_id"]
    for m in (flightrec, jflightrec):
        assert m.find_bundle(inc, iid[:6])["dir"] == bundle["dir"]
    with open(os.path.join(bundle["dir"], "host.json")) as fh:
        assert json.load(fh) == {"ranges_committed": 3}
    with open(os.path.join(bundle["dir"], "config.json")) as fh:
        cfg = json.load(fh)
    assert cfg["digest"] == jflightrec.config_digest({"host": "test"})


def test_debris_manifests_and_schemas_on_the_read_side(tmp_path):
    inc, _ = _bundle(tmp_path, flightrec, Journal)
    os.makedirs(os.path.join(inc, "abc-watchdog.tmp-123"))
    os.makedirs(os.path.join(inc, "nomanifest"))
    future = os.path.join(inc, "future")
    os.makedirs(future)
    with open(os.path.join(future, "manifest.json"), "w") as fh:
        json.dump({"schema": flightrec.BUNDLE_SCHEMA + 1}, fh)
    for module in (flightrec, jflightrec):
        bundles, warnings = module.list_bundles(inc)
        assert len(bundles) == 1
        assert len(warnings) == 2
        assert any("unreadable manifest" in w for w in warnings)
        assert any("newer than this build" in w for w in warnings)
        assert not any(".tmp-" in w for w in warnings)


def test_a_failing_hook_degrades_its_section(tmp_path):
    def boom():
        raise RuntimeError("scrape failed")

    inc, rec = _bundle(tmp_path, flightrec, Journal, metrics_fn=boom,
                       extra_fn=boom)
    (bundle,), _ = flightrec.list_bundles(inc)
    assert "metrics.error.txt" in bundle["files"]
    assert "host.error.txt" in bundle["files"]
    assert "metrics.prom" not in bundle["files"]
    assert rec.status()["bundle_errors"] == 0
    with open(os.path.join(bundle["dir"], "metrics.error.txt")) as fh:
        assert fh.read() == "RuntimeError: scrape failed\n"


def test_mode_on_needs_an_incident_dir_and_off_is_not_a_mode(tmp_path):
    j = Journal(str(tmp_path / "j.jsonl"))
    for module in (flightrec, jflightrec):
        with pytest.raises(ValueError, match="incident-dir"):
            module.FlightRecorder(j, mode="on")
        with pytest.raises(ValueError, match="observe or on"):
            module.FlightRecorder(j, mode="off")
    j.close()


# -- the journal taps --------------------------------------------------------


def test_attach_catches_up_over_rotated_segments(tmp_path):
    path = str(tmp_path / "r.jsonl")
    j = Journal(path, rotate_mb=0.002)
    for i in range(120):
        j.emit("heartbeat", rank=0, chunk_s=0.1, i=i)
    assert len(expand_segments(path)) > 3
    seen = []
    j.attach_tap(seen.append)
    j.emit("heartbeat", rank=0, chunk_s=0.1, i=120)
    j.close()
    want = [json.loads(line) for p in expand_segments(path)
            for line in open(p, encoding="utf-8")]
    assert [r.get("i") for r in seen if r["event"] == "heartbeat"] == \
        list(range(121))
    # every line of the file, in its order (the inline anchors of the
    # rotation are caught up; later ones are written past the taps)
    assert seen[:len(want) - 1] == want[:-1]


def test_detach_in_either_order_and_a_raising_tap(tmp_path):
    for order in ((0, 1), (1, 0)):
        j = Journal(str(tmp_path / f"d{order}.jsonl"))
        seen = [[], []]
        taps = [seen[0].append, seen[1].append]

        def boom(rec):
            raise RuntimeError("broken observer")

        j.attach_tap(taps[0])
        j.attach_tap(boom)
        j.attach_tap(taps[1])
        assert j.emit("heartbeat", rank=0, chunk_s=0.1)["event"] == \
            "heartbeat"
        j.detach_tap(taps[order[0]])
        j.emit("heartbeat", rank=1, chunk_s=0.1)
        j.detach_tap(taps[order[1]])
        j.emit("heartbeat", rank=2, chunk_s=0.1)
        j.close()
        kept = order[1]
        assert [r["rank"] for r in seen[kept]] == [0, 1]
        assert [r["rank"] for r in seen[order[0]]] == [0]
        events, bad = read_events(j.path)
        assert bad == [] and len(events) == 3
    nj = NullJournal()
    nj.attach_tap(print)
    nj.detach_tap(print)
    nj.set_tap(None)


def test_threads_fold_in_file_line_order(tmp_path):
    path = str(tmp_path / "t.jsonl")
    j = Journal(path)
    seen = []
    j.attach_tap(seen.append)

    def work(w):
        for i in range(200):
            j.emit("heartbeat", rank=w, chunk_s=0.0, i=i)

    threads = [threading.Thread(target=work, args=(w,)) for w in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    j.close()
    lines = [json.loads(line) for line in open(path, encoding="utf-8")]
    assert len(lines) == 1200
    assert [(r["rank"], r["i"]) for r in seen] == \
        [(r["rank"], r["i"]) for r in lines]


def test_the_recorder_folds_what_the_file_held_before_it(tmp_path):
    path = str(tmp_path / "c.jsonl")
    j = Journal(path)
    for i in range(2):
        j.emit("job_done", job_id=i, status="done", wall_s=0.1,
               slo_ok=False, trace_id=TRACE)
    rec = flightrec.FlightRecorder(j, mode="observe").start()
    assert len(rec.ring) == 2
    j.emit("job_done", job_id=2, status="done", wall_s=0.1, slo_ok=False,
           trace_id=TRACE)
    rec.stop()
    j.close()
    assert rec.status()["fired"] == 1
    assert flightrec.replay_incidents(path)["reproduced"] == 1


# -- the hosts ---------------------------------------------------------------


def _write_workload(path, seed: int = 7, n: int = 6):
    rng = np.random.default_rng(seed)
    clusters = [make_cluster(rng, f"cluster-{i}",
                             n_members=int(rng.integers(1, 4)), n_peaks=20)
                for i in range(n)]
    jwrite_mgf([s for c in clusters for s in c.members], path)
    return str(path)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    return _write_workload(tmp_path_factory.mktemp("fr") / "in.mgf")


def _serve(daemon):
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    assert sc.wait_for_socket(daemon.socket_path, timeout=60)
    return t


def test_a_daemon_without_flightrec_builds_no_recorder(tmp_path):
    d = ServeDaemon(str(tmp_path / "s.sock"), device="cpu", workers=1,
                    journal_path=str(tmp_path / "serve.jsonl"))
    t = _serve(d)
    try:
        assert d.recorder is None
        assert "flightrec" not in d.status()
    finally:
        d.drain()
        t.join(timeout=JOIN_S)
    events, _ = read_events(str(tmp_path / "serve.jsonl"))
    assert "flightrec" not in next(e for e in events
                                   if e["event"] == "serve_start")


def _exit_message(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code


@pytest.mark.parametrize("argv", [
    ["serve", "--flightrec", "observe"],
    ["serve", "--flightrec", "on", "--journal", "j.jsonl"],
    ["fleet", "--flightrec", "observe", "--", "consensus", "a", "b",
     "--elastic", "coord"],
    ["fleet", "--flightrec", "on", "--journal", "J", "--", "consensus",
     "a", "b", "--elastic", "coord"],
])
def test_refusals_give_the_jax_messages(tmp_path, monkeypatch, argv):
    monkeypatch.chdir(tmp_path)
    if argv[0] == "serve":
        argv = argv + ["--socket", str(tmp_path / "x.sock")]
    got = _exit_message(cli.main, argv + (["--device", "cpu"]
                                          if argv[0] == "serve" else []))
    want = _exit_message(jcli.main, argv)
    assert isinstance(got, str) and got == want


def test_an_elastic_rank_refuses_observe_without_a_journal(tmp_path,
                                                           workload):
    argv = ["consensus", workload, str(tmp_path / "o.mgf"), "--elastic",
            str(tmp_path / "c"), "--flightrec", "observe"]
    got = _exit_message(cli.main, argv + ["--device", "cpu"])
    want = _exit_message(jcli.main, ["consensus", workload,
                                     str(tmp_path / "j.mgf"), "--elastic",
                                     str(tmp_path / "jc"), "--flightrec",
                                     "observe", "--backend", "numpy"])
    assert got == want
    assert "--flightrec observe|on requires --journal" in got
    got = _exit_message(cli.main, [
        "consensus", workload, str(tmp_path / "o2.mgf"), "--elastic",
        str(tmp_path / "c2"), "--flightrec", "on", "--journal",
        str(tmp_path / "j2.jsonl"), "--device", "cpu"])
    with pytest.raises(ValueError) as jerr:
        jflightrec.FlightRecorder(JJournal(str(tmp_path / "x")), mode="on")
    assert got == str(jerr.value)


def test_a_served_slo_breach_is_an_incident_with_a_bundle(tmp_path,
                                                          workload):
    inc = str(tmp_path / "incidents")
    d = ServeDaemon(str(tmp_path / "s.sock"), device="cpu", workers=1,
                    journal_path=str(tmp_path / "serve.jsonl"),
                    slo={"bin-mean": 1e-6}, flightrec="on",
                    incident_dir=inc, metrics_out=str(tmp_path / "m.prom"))
    t = _serve(d)
    try:
        for i in range(3):
            term = sc.submit_wait(d.socket_path, [
                "consensus", workload, str(tmp_path / f"o{i}.mgf"),
                "--qc-report", str(tmp_path / f"o{i}.qc.json")],
                timeout=JOIN_S)
            assert term["status"] == "done", term
        status = sc.request(d.socket_path, {"op": "status"}, timeout=10)
        assert status["flightrec"]["mode"] == "on"
    finally:
        d.drain()
        t.join(timeout=JOIN_S)
    path = str(tmp_path / "serve.jsonl")
    events, bad = read_events(path)
    assert bad == []
    (incident,) = [e for e in events if e["event"] == "incident"]
    assert incident["detector"] == "slo_breach" and incident["bundled"]
    names = [e["event"] for e in events]
    assert names.index("incident") < names.index("serve_drain")
    assert flightrec.replay_incidents(path)["ok"]
    assert jflightrec.replay_incidents(path)["ok"]
    (bundle,), _ = jflightrec.list_bundles(inc)
    with open(os.path.join(bundle["dir"], "metrics.prom")) as fh:
        samples, _ = parse_exposition(fh.read())
    with open(str(tmp_path / "m.prom")) as fh:
        drained, _ = parse_exposition(fh.read())
    for name in detect.DETECTOR_NAMES:
        key = ("specpride_incidents_total", (("detector", name),))
        want = 1 if name == "slo_breach" else 0
        assert drained[key] == want
        assert samples[key] == want
    # the stats rollup equals the JAX one
    got, want = tmp_path / "p.json", tmp_path / "j.json"
    assert run_stats([path], json_out=str(got), out=io.StringIO()) == 0
    assert jrun_stats([path], json_out=str(want), out=io.StringIO()) == 0
    assert json.loads(got.read_text())["runs"][0]["incidents"] == \
        json.loads(want.read_text())["runs"][0]["incidents"]


def test_the_telemetry_preregisters_and_counts_incidents():
    tel = ServeTelemetry()
    samples, _ = parse_exposition(tel.exposition())
    for name in detect.DETECTOR_NAMES:
        for fam in ("specpride_incidents_total",
                    "specpride_incidents_suppressed_total"):
            assert samples[(fam, (("detector", name),))] == 0
    tel.incident(detector="watchdog", suppressed=3)
    samples, _ = parse_exposition(tel.exposition())
    assert samples[("specpride_incidents_total",
                    (("detector", "watchdog"),))] == 1
    assert samples[("specpride_incidents_suppressed_total",
                    (("detector", "watchdog"),))] == 3


def _elastic(tmp_path, workload, name, *extra):
    out = tmp_path / f"{name}.mgf"
    assert cli.main(["consensus", workload, str(out), "--device", "cpu",
                     "--qc-report", f"{out}.qc.json", "--checkpoint-every",
                     "2", "--elastic", str(tmp_path / f"coord_{name}"),
                     "--process-id", "0", "--journal",
                     str(tmp_path / f"{name}.jsonl"), *extra]) == 0
    assert cli.main(["merge-parts", str(out), "--elastic",
                     str(tmp_path / f"coord_{name}"), "--qc-report",
                     f"{out}.qc.json"]) == 0
    return out.read_bytes(), (tmp_path / f"{name}.mgf.qc.json").read_bytes()


def test_an_elastic_rank_bundles_its_retry_exhaustion(tmp_path, workload):
    faults = ("--inject-faults", "dispatch:io:1:0:3", "--retries", "3",
              "--retry-backoff", "0.001")
    off = _elastic(tmp_path, workload, "off", *faults)
    inc = str(tmp_path / "incidents")
    on = _elastic(tmp_path, workload, "on", *faults, "--flightrec", "on",
                  "--incident-dir", inc)
    assert on == off
    journal = str(tmp_path / "on.jsonl.part00000")
    events, bad = read_events(journal)
    assert bad == []
    (incident,) = [e for e in events if e["event"] == "incident"]
    assert incident["detector"] == "retry_exhaust"
    assert incident["evidence"]["attempt"] == 2
    for module in (flightrec, jflightrec):
        assert module.replay_incidents(journal)["ok"]
    (bundle,), _ = flightrec.list_bundles(inc)
    with open(os.path.join(bundle["dir"], "host.json")) as fh:
        host = json.load(fh)
    assert {"ranges_run", "ranges_committed", "reassignments",
            "lease_expires_observed"} <= host.keys()
    with open(os.path.join(bundle["dir"], "config.json")) as fh:
        assert json.load(fh)["config"]["host"] == "elastic"
    off_events, _ = read_events(str(tmp_path / "off.jsonl.part00000"))
    assert not any(e["event"] == "incident" for e in off_events)


def test_flightrec_on_a_one_shot_run_is_inert_in_both_clis(tmp_path,
                                                           workload):
    """The JAX CLI builds a recorder only on elastic ranks: a plain run
    takes the flag (even ``on`` without ``--incident-dir``) and journals
    no incident."""
    faults = ["--inject-faults", "dispatch:io:1:0:3", "--retries", "3",
              "--retry-backoff", "0.001", "--flightrec", "on"]
    out = tmp_path / "p.mgf"
    assert cli.main(["consensus", workload, str(out), "--device", "cpu",
                     "--journal", str(tmp_path / "p.jsonl"),
                     *faults]) == 0
    assert jcli.main(["consensus", workload, str(tmp_path / "j.mgf"),
                      "--backend", "numpy", "--journal",
                      str(tmp_path / "j.jsonl"), *faults]) == 0
    for name in ("p.jsonl", "j.jsonl"):
        events, _ = read_events(str(tmp_path / name))
        assert any(e["event"] == "retry" and e["attempt"] == 2
                   for e in events)
        assert not any(e["event"] == "incident" for e in events)
    assert cli.main(["consensus", workload, str(tmp_path / "off.mgf"),
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == (tmp_path / "off.mgf").read_bytes()


TORCH_FREE = (
    "import runpy, sys\n"
    "sys.argv = ['specpride_tpu_torch'] + sys.argv[1:]\n"
    "rc = 0\n"
    "try:\n"
    "    runpy.run_module('specpride_tpu_torch', run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "print('RC', rc, 'TORCH', 'torch' in sys.modules, flush=True)\n"
)


def _torch_free(*argv, timeout=300):
    return subprocess.run([sys.executable, "-c", TORCH_FREE, *argv],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=timeout)


def test_fleet_with_flightrec_runs_without_torch(tmp_path, workload):
    journal, inc = tmp_path / "f.jsonl", tmp_path / "incidents"
    proc = _torch_free(
        "fleet", "--ranks", "1", "--flightrec", "on", "--incident-dir",
        str(inc), "--journal", str(journal), "--timeout", "240", "--",
        "consensus", workload, str(tmp_path / "fl.mgf"), "--device", "cpu",
        "--elastic", str(tmp_path / "coord"), "--checkpoint-every", "3")
    assert "RC 0 TORCH False" in proc.stdout, proc.stderr[-3000:]
    summary = json.loads(proc.stderr.strip().splitlines()[-1])
    assert summary["flightrec"]["mode"] == "on"
    assert summary["flightrec"]["fired"] == 0
    for module in (flightrec, jflightrec):
        assert module.replay_incidents(str(journal))["ok"]
    events, bad = read_events(str(journal))
    assert bad == [] and [e["event"] for e in events].count(
        "rank_spawn") == 1


def test_fleet_recorder_carries_the_process_counts(tmp_path):
    j = Journal(str(tmp_path / "f.jsonl"))
    sup = fleet.FleetSupervisor(
        ["consensus", "a", "b", "--elastic", str(tmp_path / "coord")],
        ranks=1, journal=j, flightrec="on",
        incident_dir=str(tmp_path / "inc"))
    j.emit("watchdog_stall", lane="fleet", elapsed_s=2.0, timeout_s=1.0)
    sup.recorder.stop()
    j.close()
    (bundle,), _ = flightrec.list_bundles(str(tmp_path / "inc"))
    with open(os.path.join(bundle["dir"], "host.json")) as fh:
        assert json.load(fh) == {"procs_alive": 0, "spawned": 0,
                                 "retired": 0, "replaced": 0,
                                 "failures": []}
    assert sup.summary()["flightrec"]["bundles"] == 1


# -- the CLI -----------------------------------------------------------------


def test_incident_replay_exit_codes_and_no_torch(tmp_path):
    path = _recorded_journal(tmp_path, "port", "observe")
    proc = _torch_free("incident-replay", path, "--json",
                       str(tmp_path / "r.json"))
    assert "RC 0 TORCH False" in proc.stdout
    assert "reproduced: 2/2" in proc.stdout
    assert json.loads((tmp_path / "r.json").read_text())["ok"]
    _rewrite(path, lambda rec: rec.__setitem__("clock", 0.5))
    proc = _torch_free("incident-replay", path)
    assert "RC 1 TORCH False" in proc.stdout and "FAILED" in proc.stdout


def test_incidents_list_show_export(tmp_path, monkeypatch, capsys):
    _recorded_journal(tmp_path, "port", "on")
    inc = str(tmp_path / "inc-port")
    assert cli.main(["incidents", "list", inc]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 2
    assert {r.split()[1] for r in rows} == {"slo_breach", "watchdog"}
    iid = rows[0].split()[0]
    assert cli.main(["incidents", "show", inc, iid[:5], "--files"]) == 0
    shown = capsys.readouterr().out
    assert f'"incident_id": "{iid}"' in shown and "===== ring.jsonl" in shown
    monkeypatch.chdir(tmp_path)
    assert cli.main(["incidents", "export", inc, iid]) == 0
    tarball = capsys.readouterr().out.strip()
    assert tarball == f"incident-{iid}.tar.gz"
    with tarfile.open(tmp_path / tarball) as tar:
        assert any(n.endswith("manifest.json") for n in tar.getnames())
    with pytest.raises(SystemExit, match="needs an INCIDENT_ID"):
        cli.main(["incidents", "show", inc])
    with pytest.raises(SystemExit, match="no unique bundle"):
        cli.main(["incidents", "show", inc, "zzzz"])
    assert cli.main(["incidents", "list", str(tmp_path / "none")]) == 0
    assert "no incident bundles" in capsys.readouterr().out


def test_stats_incidents_renders_the_log_like_the_jax_stats(tmp_path):
    path = _recorded_journal(tmp_path, "jax", "on")
    outs = []
    for fn in (run_stats, jrun_stats):
        buf = io.StringIO()
        assert fn([path], out=buf, incidents=True) == 0
        outs.append([ln for ln in buf.getvalue().splitlines()
                     if ln.startswith(("  incidents:", "    "))])
    assert outs[0] == outs[1]
    assert "incidents: mode=on total=2 bundled=2 suppressed=0 " \
        "slo_breach=1 watchdog=1" in outs[0][0]
    buf = io.StringIO()
    assert run_stats([path], out=buf) == 0
    assert "incidents: mode=on" in buf.getvalue()
    assert "[bundled]" not in buf.getvalue()


# -- faults C5, C6 and A10 ----------------------------------------------------


def test_cas_server_writes_its_file_and_handler_before_its_line(tmp_path,
                                                                monkeypatch):
    """C5: when the URL line is printed, the URL file holds the URL (put
    in place by a rename) and SIGTERM's handler is installed."""
    url_file = tmp_path / "url"
    seen = {}

    class FakeServer:
        def __init__(self, host, port):
            self.url = "http://127.0.0.1:4242"

        def serve_forever(self):
            raise KeyboardInterrupt

        def stop(self):
            seen["stopped"] = True

    real_replace = os.replace

    def replace(src, dst):
        seen["replaced_over_existing"] = os.path.exists(dst)
        real_replace(src, dst)

    def fake_print(*args, **kw):
        seen["line"] = args[0]
        seen["file_at_print"] = (url_file.read_text()
                                 if url_file.exists() else None)
        seen["handler_at_print"] = signal.getsignal(signal.SIGTERM)

    monkeypatch.setattr(fleet, "CasServer", FakeServer)
    monkeypatch.setattr(fleet.os, "replace", replace)
    monkeypatch.setattr(fleet, "print", fake_print, raising=False)
    before = signal.getsignal(signal.SIGTERM)
    try:
        args = types.SimpleNamespace(host="127.0.0.1", port=0,
                                     url_file=str(url_file))
        assert fleet.cmd_cas_server(args) == 0
    finally:
        signal.signal(signal.SIGTERM, before)
    assert seen["line"] == "http://127.0.0.1:4242"
    assert seen["file_at_print"] == "http://127.0.0.1:4242\n"
    assert seen["handler_at_print"] is signal.default_int_handler
    assert seen["replaced_over_existing"] is False and seen["stopped"]
    assert os.listdir(tmp_path) == ["url"]
    assert builtins.print is not fake_print


def test_serve_takes_no_mesh_in_either_cli():
    """C6: ``serve --mesh`` is an unrecognized argument (exit 2), as in
    the JAX CLI; ``--layout`` stays."""
    for parser in (cli.build_parser(), jcli.build_parser()):
        with pytest.raises(SystemExit) as e:
            parser.parse_args(["serve", "--mesh"])
        assert e.value.code == 2
        assert parser.parse_args(["serve", "--layout",
                                  "bucketized"]).layout == "bucketized"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_evaluate_over_two_ranks_gives_the_jax_summary(tmp_path, workload):
    """A10: each of two ``--coordinator`` ranks scores the whole input and
    prints the summary the JAX CLI's single-process ``evaluate`` prints."""
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.data.peaks import group_into_clusters
    from specpride_tpu_torch.io import mgf

    clusters = group_into_clusters(mgf.read_mgf(workload))
    reps = tmp_path / "reps.mgf"
    mgf.write_mgf(TorchBackend(device="cpu").run_bin_mean(clusters), reps)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "specpride_tpu_torch", "evaluate", str(reps),
         workload, "--device", "cpu", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(i)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    jax = subprocess.run(
        [sys.executable, "-m", "specpride_tpu", "evaluate", str(reps),
         workload, "--backend", "numpy"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=240)
    assert jax.returncode == 0, jax.stderr
    want = json.loads(jax.stdout)
    for got in outs:
        assert got.keys() == want.keys()
        for key in want:
            if key in ("mean_cosine", "median_cosine"):
                assert got[key] == pytest.approx(want[key], rel=1e-5,
                                                 abs=1e-6)
            else:
                assert got[key] == want[key], key
    assert outs[0] == outs[1]
    assert want["n_clusters"] == len(clusters)
