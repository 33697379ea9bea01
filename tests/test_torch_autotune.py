"""The port's closed-loop autotune (``specpride_tpu_torch/autotune/``, the
daemon's live knobs, the coordinator's split hint, ``autotune-replay`` and
``stats --autotune``) against the JAX package's ``autotune/``, on the CPU.

Seeded record streams (numpy) fold to the same snapshots in both
``SignalState`` copies, seeded snapshots give the same decisions from each
policy and its JAX twin (through ``evaluate``'s cooldown and deadband),
params round-trip through both ``policy_from_params``, a fake-clock
controller journals the same ``autotune`` events in both packages, each
package's replay passes the other's journal and catches a tampered one,
and the daemon's knobs hold under a mutation hammer.  The hosts: ``serve
--autotune`` without ``--journal`` and a job carrying ``--autotune`` are
refused as in the JAX CLI; two elastic ranks with ``--autotune on`` and a
forced steal merge to the ``off`` bytes; the split hint caps a donor's
cede in both coordinators; ``stats --autotune`` prints the JAX lines."""

import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu.autotune import controller as jcontroller
from specpride_tpu.autotune import policy as jpolicy
from specpride_tpu.autotune import replay as jreplay
from specpride_tpu.autotune import signals as jsignals
from specpride_tpu.observability.journal import Journal as JJournal
from specpride_tpu.observability.stats_cli import run_stats as jrun_stats
from specpride_tpu.parallel.coordinator import Coordinator as JCoordinator
from specpride_tpu.serve import protocol as jprotocol
from specpride_tpu_torch import cli
from specpride_tpu_torch.autotune import controller, policy, replay, signals
from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.io.mgf import write_mgf
from specpride_tpu_torch.observability.journal import Journal, read_events
from specpride_tpu_torch.observability.stats_cli import run_stats
from specpride_tpu_torch.parallel.coordinator import Coordinator
from specpride_tpu_torch.serve import protocol
from specpride_tpu_torch.serve.daemon import ServeDaemon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = "ab" * 16
CHILD_TIMEOUT_S = 240
PORT = (signals, policy, controller, replay, Journal)
JAX = (jsignals, jpolicy, jcontroller, jreplay, JJournal)


def _dump(x) -> str:
    return json.dumps(x, sort_keys=True, default=str)


# -- the signal fold ------------------------------------------------------


def _records(seed: int, n: int = 400) -> list[dict]:
    """A seeded stream of every folded event (and some the fold ignores:
    ``autotune``, unknown events, records without ``mono``)."""
    rng = np.random.default_rng(seed)
    mono = 100.0
    out = []
    kinds = ("job_queued", "job_start", "job_done", "batch_dispatch",
             "heartbeat", "lease_split", "span", "autotune", "mystery",
             "no_mono")
    for i in range(n):
        mono += float(rng.exponential(0.4))
        kind = kinds[int(rng.integers(len(kinds)))]
        tid = f"{int(rng.integers(6)):032x}"
        rec = {"event": kind, "mono": round(mono, 6)}
        if kind == "job_done":
            rec.update(wall_s=float(rng.uniform(0, 3)),
                       queue_wait_s=float(rng.uniform(0, 1)),
                       status="done" if rng.random() < 0.8 else "error",
                       trace_id=tid)
            if rng.random() < 0.6:
                rec["slo_ok"] = bool(rng.random() < 0.7)
        elif kind == "batch_dispatch":
            rec.update(n_jobs=int(rng.integers(1, 5)),
                       window_wait_s=float(rng.uniform(0, 0.05)),
                       trace_ids=[tid])
            if rng.random() < 0.7:
                rec["bucket_occupancy_frac"] = float(rng.uniform(0, 1))
        elif kind == "heartbeat":
            rec.update(rank=int(rng.integers(3)))
            if rng.random() < 0.8:
                rec["chunk_s"] = float(rng.uniform(0.1, 5))
        elif kind == "span":
            rec.update(name=f"s{int(rng.integers(5))}",
                       dur_s=float(rng.uniform(0, 2)))
        elif kind == "autotune":
            rec.update(knob="workers", new=3)
        elif kind == "no_mono":
            rec = {"event": "job_queued"}
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window_s", [5.0, 30.0])
def test_signal_state_snapshots_equal_the_jax_fold(seed, window_s):
    recs = _records(seed)
    port, jax = signals.SignalState(window_s), jsignals.SignalState(window_s)
    for i, rec in enumerate(recs):
        port.observe(dict(rec))
        jax.observe(dict(rec))
        if i % 25 == 24:
            now = rec.get("mono", 0.0) + 0.1234567
            extras = {"steal_proposals": i % 3} if i % 50 == 49 else None
            assert _dump(port.snapshot(now, extras)) == \
                _dump(jax.snapshot(now, extras))
            assert port.recent_traces() == jax.recent_traces()
    port.observe("not a dict")
    assert port.snapshot(1e9)["queue_depth"] == jax.snapshot(1e9)[
        "queue_depth"]


# -- policies and their gating --------------------------------------------


def _signal(rng) -> dict:
    snap = {"now": round(float(rng.uniform(0, 100)), 6), "window_s": 30.0,
            "queue_depth": int(rng.integers(0, 6))}
    if rng.random() < 0.8:
        n = int(rng.integers(1, 8))
        slo = int(rng.integers(0, n + 1))
        snap["jobs"] = {"n": n, "done": n, "busy_s": float(rng.uniform(0, 40)),
                        "slo_jobs": slo,
                        "slo_breaches": int(rng.integers(0, slo + 1))}
    if rng.random() < 0.6:
        snap["batch"] = {"n": 2, "jobs_mean": float(rng.uniform(1, 3))}
    if rng.random() < 0.7:
        snap["heartbeats"] = {"ranks": 2,
                              "chunk_s_mean": float(rng.uniform(0, 4))}
    if rng.random() < 0.7:
        snap["store"] = {"steal_proposals": int(rng.integers(0, 3)),
                         "stale_ranks": int(rng.integers(0, 2))}
    return snap


POLICIES = [
    ("BatchWindowPolicy", dict(lo_ms=0.0, hi_ms=50.0), (0.0, 1.0, 8.0, 50.0)),
    ("BatchWindowPolicy", dict(lo_ms=5.0, hi_ms=25.0, deadband=0.5),
     (5.0, 10.0, 25.0)),
    ("WorkerPolicy", dict(lo=1, hi=4, min_slo_jobs=2), (1, 2, 4)),
    ("ElasticRangePolicy", dict(lo=8, hi=400, target_s=3.0, chunk_hint=8),
     (8, 64, 400)),
    ("FleetSparesPolicy", dict(lo=0, hi=3), (0, 1, 3)),
]


@pytest.mark.parametrize("name,params,currents", POLICIES)
def test_policy_decisions_equal_the_jax_twins(name, params, currents):
    rng = np.random.default_rng(len(name) * 31 + len(params))
    port = getattr(policy, name)(**params)
    jax = getattr(jpolicy, name)(**params)
    assert port.params == jax.params and port.knob == jax.knob
    decided = 0
    for _ in range(300):
        sig = _signal(rng)
        cur = currents[int(rng.integers(len(currents)))]
        assert port.decide(sig, cur) == jax.decide(sig, cur)
        # the gate: no last decision, one inside and one outside the
        # cooldown
        for last in (None, sig["now"] - 0.5, sig["now"] - 60.0):
            got = controller.evaluate(port, sig, cur, last)
            assert got == jcontroller.evaluate(jax, sig, cur, last)
            decided += got is not None
    assert decided > 0


@pytest.mark.parametrize("name,params,_", POLICIES)
def test_policy_from_params_round_trips_across_packages(name, params, _):
    port = getattr(policy, name)(**params)
    jax = getattr(jpolicy, name)(**params)
    for rebuilt in (policy.policy_from_params(port.knob, jax.params),
                    jpolicy.policy_from_params(jax.knob, port.params)):
        assert rebuilt.params == port.params
    extra = policy.policy_from_params(port.knob, {**port.params, "new": 1})
    assert extra.params == port.params
    for mod in (policy, jpolicy):
        with pytest.raises(ValueError, match="unknown autotune knob"):
            mod.policy_from_params("no_such_knob", {})
    assert policy.MODES == jpolicy.MODES
    for spec in ("0:50", "2.5:2.5", "50", "a:b", "9:1", "-1:3"):
        try:
            want = jpolicy.parse_clamp(spec, "--x")
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:12]):
                policy.parse_clamp(spec, "--x")
        else:
            assert policy.parse_clamp(spec, "--x") == want


# -- the controller over a journal ----------------------------------------


def _drive(path: str, mode: str, pkg) -> tuple[float, list[dict]]:
    """The JAX tests' widen, widen, shrink scenario on a fake clock."""
    _, pol, ctl_mod, _, journal_cls = pkg
    clock, value = [100.0], [0.0]
    j = journal_cls(path)
    ctl = ctl_mod.Controller(j, mode=mode, window_s=30.0,
                             clock=lambda: clock[0])
    ctl.register(pol.BatchWindowPolicy(lo_ms=5.0, hi_ms=25.0, queue_hi=3,
                                       cooldown_s=2.0),
                 get=lambda: value[0], set=lambda v: value.__setitem__(0, v))
    decisions = []
    for i in range(4):
        j.emit("job_queued", job_id=i, client="t", trace_id=TRACE)
    decisions += ctl.tick()
    clock[0] += 10.0
    decisions += ctl.tick()
    for i in range(4):
        j.emit("job_start", job_id=i, trace_id=TRACE)
        j.emit("job_done", job_id=i, status="done", wall_s=0.01,
               queue_wait_s=0.0, trace_id=TRACE)
    j.emit("batch_dispatch", batch_id=1, jobs=[3], n_jobs=1, n_clusters=1,
           window_wait_s=0.0, status="shared", trace_ids=[TRACE])
    clock[0] += 10.0
    decisions += ctl.tick()
    clock[0] += 0.5  # inside the cooldown: nothing
    decisions += ctl.tick()
    ctl.close()
    j.close()
    return value[0], decisions


_DECISION_KEYS = ("knob", "mode", "old", "new", "reason", "signal", "acted",
                  "params", "clock", "trace_ids")


def _no_ages(x):
    """A snapshot without its ``age_s`` fields: they measure the fake
    clock against the records' real ``mono``, which two runs cannot
    share."""
    if isinstance(x, dict):
        return {k: _no_ages(v) for k, v in x.items() if k != "age_s"}
    if isinstance(x, list):
        return [_no_ages(v) for v in x]
    return x


@pytest.mark.parametrize("mode,want", [
    ("on", [(5.0, True), (10.0, True), (5.0, True)]),
    ("observe", [(5.0, False), (5.0, False)]),
])
def test_fake_clock_controller_journals_the_jax_events(tmp_path, mode, want):
    got = {}
    for tag, pkg in (("port", PORT), ("jax", JAX)):
        path = str(tmp_path / f"{tag}.jsonl")
        final, decisions = _drive(path, mode, pkg)
        events, bad = read_events(path)
        assert bad == []
        got[tag] = (final, [{k: _no_ages(e[k]) for k in _DECISION_KEYS}
                            for e in events if e["event"] == "autotune"])
        assert [(d["new"], d["acted"]) for d in decisions] == want
    assert _dump(got["port"]) == _dump(got["jax"])
    assert got["port"][0] == (5.0 if mode == "on" else 0.0)


def _tamper(path, field, value):
    lines = [json.loads(ln) for ln in open(path, encoding="utf-8")]
    for rec in lines:
        if rec.get("event") == "autotune":
            rec[field] = value
            break
    with open(path, "w", encoding="utf-8") as fh:
        for rec in lines:
            fh.write(json.dumps(rec) + "\n")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_replays_the_others_journal(tmp_path, writer):
    path = str(tmp_path / "serve.jsonl")
    _drive(path, "on", PORT if writer == "port" else JAX)
    for mod in (replay, jreplay):
        res = mod.replay_journal(path)
        assert res["ok"], res
        assert (res["decisions"], res["reproduced"], res["acted"]) == \
            (3, 3, 3)
    out = io.StringIO()
    replay.render_replay(replay.replay_journal(path), out)
    jout = io.StringIO()
    jreplay.render_replay(jreplay.replay_journal(path), jout)
    assert out.getvalue() == jout.getvalue()
    _tamper(path, "new", 17.0)
    for mod in (replay, jreplay):
        res = mod.replay_journal(path)
        assert not res["ok"]
        assert any("replay new=5.0" in m for m in res["mismatches"])
    rc = subprocess.run([sys.executable, "-m", "specpride_tpu_torch",
                         "autotune-replay", path], cwd=REPO,
                        env=dict(os.environ, PYTHONPATH=REPO),
                        capture_output=True, text=True, timeout=120)
    assert rc.returncode == 1 and rc.stdout.rstrip().endswith("FAILED")


def test_replay_refolds_a_fleet_snapshot_with_store_extras(tmp_path):
    path = str(tmp_path / "fleet.jsonl")
    j = Journal(path)
    ctl = controller.Controller(j, mode="on", clock=lambda: 50.0)
    spares = [0]
    ctl.register(policy.FleetSparesPolicy(lo=0, hi=2),
                 get=lambda: spares[0],
                 set=lambda v: spares.__setitem__(0, v))
    out = ctl.tick(extras={"steal_proposals": 2, "stale_ranks": 0})
    assert len(out) == 1 and out[0]["signal"]["store"] and spares == [1]
    assert ctl.knob_values() == {"spares": 1}
    ctl.close()
    j.close()
    for mod in (replay, jreplay):
        res = mod.replay_journal(path)
        assert res["ok"] and res["reproduced"] == 1, res


def test_controller_thread_drain_tick_and_detach(tmp_path):
    j = Journal(str(tmp_path / "j.jsonl"))
    ctl = controller.Controller(j, mode="on")
    ctl.register(policy.FleetSparesPolicy(lo=0, hi=2, cooldown_s=0.0),
                 get=lambda: 0, set=lambda v: None)
    ticks = []
    orig = ctl.tick
    ctl.tick = lambda extras=None: ticks.append(1) or orig(extras)
    t = controller.ControllerThread(ctl, interval=0.05).start()
    deadline = time.perf_counter() + 10
    while not ticks:
        assert time.perf_counter() < deadline
        time.sleep(0.01)
    t.stop()
    n = len(ticks)
    j.close()
    assert j._taps == ()  # the drain tick ran, then the tap detached
    assert n >= 2


# -- the daemon's live knobs ------------------------------------------------


def test_daemon_live_knobs_under_mutation_hammer(tmp_path):
    """Two writers move the batch window and the active lanes while two
    readers read them: never a torn or out-of-set value (JAX
    ``test_autotune.py::TestLiveValueConcurrency``)."""
    d = ServeDaemon(str(tmp_path / "s.sock"), device="cpu", workers=4)
    d.slots = [object()] * 4  # the lanes boot would place
    windows = {0.005 * k for k in range(8)}
    stop = threading.Event()
    errors: list = []

    def mutate():
        try:
            for i in range(2000):
                d.batch_window = 0.005 * (i % 8)
                d.active_workers = (i % 4) + 1
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                assert d.batch_window in windows
                assert 1 <= d.active_workers <= 4
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    writers = [threading.Thread(target=mutate) for _ in range(2)]
    readers = [threading.Thread(target=read) for _ in range(2)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join(timeout=60)
    stop.set()
    for t in readers:
        t.join(timeout=60)
    assert not errors, errors
    d.active_workers = 9
    assert d.active_workers == 4  # clamped to the pool
    d.active_workers = 0
    assert d.active_workers == 1


def test_serve_autotune_needs_a_journal_as_in_jax(capsys):
    for main in (cli.main,):
        with pytest.raises(SystemExit) as exc:
            main(["serve", "--device", "cpu", "--autotune", "on"])
        assert str(exc.value) == ("serve --autotune observe|on requires "
                                  "--journal: every decision must be "
                                  "journaled as evidence")
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--device", "cpu", "--journal", "j.jsonl",
                  "--autotune-batch-window", "9:1"])
    assert "--autotune-batch-window" in str(exc.value)
    with pytest.raises(SystemExit):
        cli.main(["serve", "--autotune", "sometimes"])


def test_a_job_may_not_carry_autotune():
    argv = ["consensus", "in.mgf", "out.mgf", "--autotune", "on"]
    assert protocol.forbidden_flags(argv) == \
        jprotocol.forbidden_flags(argv) == ["--autotune"]
    assert protocol.forbidden_flags(
        ["consensus", "a", "b", "--autotune=observe"]) == ["--autotune"]
    args = cli.build_parser().parse_args(
        ["consensus", "a", "b", "--autot", "on"])
    assert protocol.overridden_daemon_flags(args) == ["--autotune"]


def test_daemon_with_autotune_on_acts_journals_and_drains(tmp_path):
    """A CPU daemon with ``--autotune on`` and a burst of queued jobs (the
    lanes held at the gate): one acted ``batch_window_ms`` decision, the
    status reply's autotune section, the knob on ``/metrics``' text, the
    bundle's ``autotune.json``, a journal both replays pass."""
    from specpride_tpu_torch.serve import client as sc

    rng = np.random.default_rng(7)
    src = tmp_path / "in.mgf"
    write_mgf([s for i in range(4) for s in make_cluster(
        rng, f"c{i}", n_members=3, n_peaks=20).members], src)
    journal = str(tmp_path / "serve.jsonl")
    d = ServeDaemon(str(tmp_path / "s.sock"), device="cpu", workers=1,
                    journal_path=journal, autotune="on",
                    autotune_interval=0.05, autotune_batch_window=(0.0, 8.0),
                    slo={"bin-mean": 1e-6}, flightrec="on",
                    incident_dir=str(tmp_path / "inc"))
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    assert sc.wait_for_socket(d.socket_path, timeout=60)
    try:
        d._gate.clear()  # hold the lane: the queue fills
        outs, threads = [], []
        for i in range(4):
            out = str(tmp_path / f"o{i}.mgf")
            outs.append(out)
            th = threading.Thread(target=sc.submit_wait, args=(
                d.socket_path, ["consensus", str(src), out]),
                kwargs={"client": f"c{i}", "timeout": 120})
            th.start()
            threads.append(th)
        deadline = time.perf_counter() + 30
        while d.batch_window == 0.0:
            assert time.perf_counter() < deadline, "no decision acted"
            time.sleep(0.02)
        status = sc.request(d.socket_path, {"op": "status"})
        assert status["autotune"]["mode"] == "on"
        assert status["autotune"]["acted"] >= 1
        assert 'specpride_autotune_knob{knob="batch_window_ms"}' in \
            d.telemetry.exposition()
        d._gate.set()
        for th in threads:
            th.join(timeout=120)
    finally:
        d._gate.set()
        d.drain()
        t.join(timeout=60)
    assert not t.is_alive()
    ref = str(tmp_path / "ref.mgf")
    assert cli.main(["consensus", str(src), ref, "--device", "cpu"]) == 0
    for out in outs:
        assert open(out, "rb").read() == open(ref, "rb").read()
    events, bad = read_events(journal)
    assert bad == []
    at = [e for e in events if e["event"] == "autotune"]
    assert any(e["knob"] == "batch_window_ms" and e["acted"] for e in at)
    assert replay.replay_journal(journal)["ok"]
    assert jreplay.replay_journal(journal)["ok"]
    start = next(e for e in events if e["event"] == "serve_start")
    assert start["autotune"] == "on"
    assert start["autotune_batch_window_ms"] == [0.0, 8.0]
    # three breached jobs in a row: a slo_breach bundle with the knobs
    bundles = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "inc")
               for f in fs if f == "autotune.json"]
    assert bundles
    with open(bundles[0]) as fh:
        snap = json.load(fh)
    assert snap["status"]["mode"] == "on"
    assert set(snap["knobs"]) == {"batch_window_ms", "workers"}


# -- the coordinator's split hint -----------------------------------------


class _Rec:
    enabled = True

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})
        return {}


@pytest.mark.parametrize("coord_cls", [Coordinator, JCoordinator],
                         ids=["port", "jax"])
@pytest.mark.parametrize("hint,cut", [(None, 14), (4, 20), (100, 14)])
def test_split_hint_caps_the_cede(tmp_path, coord_cls, hint, cut):
    """24 clusters in one range, chunks of 2, the donor at cluster 4: steal
    half cuts at 14; a hint of 4 cedes 4 (cut 20); a hint above the half
    changes nothing.  Both coordinators cut alike."""
    a = coord_cls(str(tmp_path), 0, 24, 24, ttl=5.0, journal=_Rec(),
                  chunk_hint=2)
    b = coord_cls(str(tmp_path), 1, 24, 24, ttl=5.0, journal=_Rec(),
                  chunk_hint=2)
    try:
        assert a.claim_next().range.range_id == 0
        a.set_split_hint(hint)
        assert a.split_hint == hint
        got = {}
        th = threading.Thread(
            target=lambda: got.update(c=b.try_steal(poll_timeout=5.0)))
        th.start()
        deadline = time.perf_counter() + 5.0
        while not [k for k in b.store.list_keys("split/")
                   if ".proposed." in k]:
            assert time.perf_counter() < deadline
            time.sleep(0.01)
        assert a.clip_or_ratify(0, next_min_idx=4) == cut
        th.join(timeout=10)
        assert (got["c"].range.start, got["c"].range.stop) == (cut, 24)
        a.flush_progress()
    finally:
        a.stop()
        b.stop()


def test_a_capped_cut_stays_on_the_chunk_grid(tmp_path):
    """23 clusters, chunks of 2, the donor at cluster 4: 19 remain, and a
    hint of 4 would keep 15 (a cut at 19, off the even grid, as the JAX
    coordinator cuts); the port keeps 16 whole chunks' worth and cuts at
    20, so both sides chunk as the single run does."""
    for cls, root, want in ((Coordinator, tmp_path / "port", 20),
                            (JCoordinator, tmp_path / "jax", 19)):
        a = cls(str(root), 0, 23, 23, ttl=5.0, journal=_Rec(), chunk_hint=2)
        b = cls(str(root), 1, 23, 23, ttl=5.0, journal=_Rec(), chunk_hint=2)
        try:
            a.claim_next()
            a.set_split_hint(4)
            got = {}
            th = threading.Thread(
                target=lambda: got.update(c=b.try_steal(poll_timeout=5.0)))
            th.start()
            deadline = time.perf_counter() + 5.0
            while not [k for k in b.store.list_keys("split/")
                       if ".proposed." in k]:
                assert time.perf_counter() < deadline
                time.sleep(0.01)
            assert a.clip_or_ratify(0, next_min_idx=4) == want
            th.join(timeout=10)
        finally:
            a.stop()
            b.stop()


# -- two elastic ranks, a forced steal, autotune on ----------------------


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    rng = np.random.default_rng(2024)
    spectra = []
    for i in range(24):
        c = make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 5)),
                         n_peaks=int(rng.integers(5, 40)), base_scan=100 * i)
        spectra += [Spectrum(s.mz, s.intensity, s.precursor_mz,
                             s.precursor_charge, s.rt, s.title)
                    for s in c.members]
    src = tmp_path_factory.mktemp("autotune_wl") / "clustered.mgf"
    write_mgf(spectra, src)
    return str(src)


def test_two_elastic_ranks_with_autotune_on_give_the_off_bytes(tmp_path,
                                                               workload):
    """The forced steal of ``test_torch_steal.py`` with ``--autotune on``
    on both ranks: the merged bytes are the single run's, each rank
    journals its controller's decisions, both replays pass, and the
    donor's cede is within the hint in force when it ratified."""
    single, single_qc = tmp_path / "single.mgf", tmp_path / "single.qc"
    assert cli.main(["consensus", workload, str(single), "--device", "cpu",
                     "--qc-report", str(single_qc), "--checkpoint",
                     str(tmp_path / "s.ck"), "--checkpoint-every", "1"]) == 0
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    journal = str(tmp_path / "j.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO)

    def argv(rank):
        return [sys.executable, "-m", "specpride_tpu_torch", "consensus",
                workload, str(out), "--device", "cpu", "--elastic",
                str(coord), "--process-id", str(rank), "--elastic-range",
                "24", "--checkpoint-every", "1", "--elastic-ttl", "2",
                "--qc-report", f"{out}.qc.json", "--journal", journal,
                "--autotune", "on"]

    donor = subprocess.Popen(
        argv(0), env=dict(env, SPECPRIDE_FAULTS="dispatch:rank_slow:1:0:9999",
                          SPECPRIDE_SLOW_S="0.6"),
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    procs = [donor]
    try:
        deadline = time.perf_counter() + CHILD_TIMEOUT_S
        while True:
            try:
                with open(journal + ".part00000") as fh:
                    if '"lease_claim"' in fh.read():
                        break
            except OSError:
                pass
            assert donor.poll() is None, donor.stderr.read().decode()
            assert time.perf_counter() < deadline
            time.sleep(0.05)
        procs.append(subprocess.Popen(argv(1), env=env, cwd=REPO,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
        for p in procs:
            _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert cli.main(["merge-parts", str(out), "--elastic", str(coord),
                     "--qc-report", f"{out}.qc.json"]) == 0
    assert out.read_bytes() == single.read_bytes()
    assert (tmp_path / "out.mgf.qc.json").read_bytes() == \
        single_qc.read_bytes()
    donor_events, bad = read_events(journal + ".part00000")
    assert bad == []
    at = [e for e in donor_events if e["event"] == "autotune"]
    assert at and all(e["knob"] == "elastic_range" for e in at)
    hint = None
    for e in donor_events:
        if e["event"] == "autotune" and e["acted"]:
            hint = e["new"]
        if e["event"] == "lease_split" and hint is not None:
            assert e["n_clusters_split"] <= max(hint, 1)
    for part in (".part00000", ".part00001"):
        assert replay.replay_journal(journal + part)["ok"]
        assert jreplay.replay_journal(journal + part)["ok"]


# -- stats --autotune -----------------------------------------------------


def _autotune_lines(text: str) -> list[str]:
    lines = text.splitlines()
    out = []
    for i, line in enumerate(lines):
        if line.startswith("  autotune:"):
            out.append(line)
            out += [ln for ln in lines[i + 1:]
                    if ln.startswith("    ") and ("[acted]" in ln
                                                 or "[observed]" in ln)]
    return out


@pytest.mark.parametrize("mode", ["on", "observe"])
def test_stats_autotune_prints_the_jax_lines(tmp_path, capsys, mode):
    path = str(tmp_path / "serve.jsonl")
    _drive(path, mode, PORT)
    texts = []
    for fn in (run_stats, jrun_stats):
        out = io.StringIO()
        assert fn([path], out=out, autotune=True) == 0
        texts.append(out.getvalue())
    port, jax = (_autotune_lines(t) for t in texts)
    assert port == jax and len(port) == (4 if mode == "on" else 3)
    plain = io.StringIO()
    run_stats([path], out=plain)
    assert _autotune_lines(plain.getvalue()) == port[:1]
