"""The port's span tracing (``observability/tracing.py``,
``traceplane.py``; ``--chrome-trace``, ``trace``, ``stats --top-spans`` /
``--trace``) against the JAX package's, on the CPU.

The read side runs the same journals through both packages:
``aggregate_spans``, ``render_top_spans`` and ``build_chrome_trace`` give
equal rows, text and bytes on one seeded span list; ``clock_anchor_fit``,
``extract_trace``, ``critical_path`` and the flow events agree on two
shards with skewed clocks and a torn ``.part`` line.  The write side: a
port ``consensus --qc-report --journal --chrome-trace`` run carries the
span names of a JAX CLI run with the same flags (``--layout flat
--compile-cache off``), less the names ``JAX_ONLY_SPANS`` gives with a
reason; the JAX ``read_events`` reads its spans and trace ids with no
violation; each package's ``stats --top-spans`` and ``trace`` read the
other's journal; its top-level spans cover at least 95 % of its phase
seconds; without ``--journal`` or ``--chrome-trace`` no span is recorded
and the bytes are those of a traced run; two ``--coordinator`` ranks
share one trace id and ``trace`` merges their shards with pid = rank.

Host time by thread: a pipelined run on a streamed input reports each
phase's thread CPU beside its wall (the window parse a phase of its own),
the process's CPU and each lane's; its lane spans carry their CPU; its
``--trace-dir`` capture holds the dispatch lane's and a pack lane's spans
as profiler ranges on their own threads, and no range is opened without
one; a prepared chunk's stages reach the backend's phases, the lane's
own do not; ``clusters_per_sec`` is over the run's wall."""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu.io.mgf import write_mgf as jwrite_mgf
from specpride_tpu.observability import stats_cli as jstats_cli
from specpride_tpu.observability import traceplane as jtraceplane
from specpride_tpu.observability import tracing as jtracing
from specpride_tpu.observability.journal import read_events as jread_events
from specpride_tpu_torch import cli
from specpride_tpu_torch.observability import stats, traceplane, tracing
from specpride_tpu_torch.observability.journal import Journal, read_events
from specpride_tpu_torch.observability.stats_cli import run_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLUSTERS, EVERY = 40, 16
TRACE_ID = "0123456789abcdef0123456789abcdef"
# the JAX run's span names the port does not record, each with its reason
JAX_ONLY_SPANS = {
    # the JAX backend times its phases with RunStats.phase (a span each)
    # inside its method calls and its pack lane; the port's backend keeps
    # its phase seconds in `phase_seconds`, and the same intervals are on
    # the port's trace as its pack:*, method:* and kernel:* spans
    "pack": "JAX backend phase timer",
    "dispatch": "JAX backend phase timer",
    "d2h": "JAX backend phase timer",
    "finalize": "JAX backend phase timer",
}
# names recorded only when a lane waits a millisecond or more: timing,
# not code, decides whether either run has one
TIMING_SPANS = {"pipeline:idle"}


# -- the read side: one seeded span list through both packages -------------


def _synthetic_events(rng, trace_id, offset=0.0, mono0=100.0, lanes=3,
                      parent=None):
    """One process run's events: run_start and a clock anchor (wall =
    mono + ``offset`` + 1.7e9), then nested spans on ``lanes`` threads
    with span ids (the first top-level span parented under ``parent``),
    a dispatch instant and run_end."""
    wall0 = 1.7e9 + offset
    ev = [{"v": 7, "ts": wall0 + mono0, "mono": mono0, "event": "run_start",
           "trace_id": trace_id, "command": "consensus",
           "method": "bin-mean", "backend": "torch", "n_clusters": 4},
          {"v": 7, "ts": wall0 + mono0, "mono": mono0 + 1e-4,
           "event": "clock_anchor", "trace_id": trace_id,
           "wall": wall0 + mono0 + 1e-4, "uncertainty_s": 2e-6}]
    t = mono0 + 0.01
    for lane in range(lanes):
        for k in range(int(rng.integers(2, 5))):
            outer_id = f"{rng.integers(0, 2**62):016x}"
            d_outer = float(rng.uniform(0.02, 0.08))
            start = t + float(rng.uniform(0, 0.01))
            inner = []
            cur = start + 0.001
            for j in range(int(rng.integers(0, 3))):
                d = float(rng.uniform(0.001, d_outer / 4))
                inner.append({
                    "v": 7, "ts": wall0 + cur + d, "mono": cur + d,
                    "event": "span", "trace_id": trace_id,
                    "name": f"kernel:k{j}", "dur_s": round(d, 6),
                    "depth": 1, "tid": lane,
                    "span_id": f"{rng.integers(0, 2**62):016x}",
                    "parent_span_id": outer_id,
                    "labels": {"kernel": f"k{j}", "chunk_index": k}})
                cur += d + 0.0005
            ev.extend(inner)
            ev.append({
                "v": 7, "ts": wall0 + start + d_outer,
                "mono": start + d_outer, "event": "span",
                "trace_id": trace_id, "name": "chunk" if lane == 0
                else f"pipeline:pack[{lane}]", "dur_s": round(d_outer, 6),
                "depth": 0, "tid": lane, "span_id": outer_id,
                "parent_span_id": parent if parent and k == 0 and lane == 0
                else f"{rng.integers(0, 2**62):016x}",
                "labels": {"chunk_index": k}})
            t = start + d_outer
        ev.append({"v": 7, "ts": wall0 + t, "mono": t, "event": "dispatch",
                   "trace_id": trace_id, "kernel": "k0", "rows": 3,
                   "padded_rows": 3})
    ev.sort(key=lambda e: e["mono"])
    ev.append({"v": 7, "ts": wall0 + t + 0.01, "mono": t + 0.01,
               "event": "run_end", "trace_id": trace_id, "counters": {},
               "phases_s": {}, "elapsed_s": t - mono0, "device": {}})
    return ev


def _write_jsonl(path, events, torn=False):
    with open(path, "w") as fh:
        for e in events:
            fh.write(json.dumps(e) + "\n")
        if torn:
            fh.write('{"v": 7, "ts": 1.0, "event": "span", "na')


@pytest.fixture
def shards(tmp_path):
    """Two rank shards of one trace, rank 1's wall clock 0.35 s ahead and
    its journal ending in a torn line, plus a rank-0 root span that
    rank 1's first span parents under (a cross-process edge)."""
    rng = np.random.default_rng(2024)
    e0 = _synthetic_events(rng, TRACE_ID)
    root = next(e["span_id"] for e in e0
                if e["event"] == "span" and e["depth"] == 0)
    e1 = _synthetic_events(rng, TRACE_ID, offset=0.35, mono0=5000.0,
                           parent=root)
    base = tmp_path / "j.jsonl"
    _write_jsonl(f"{base}.part00000", e0)
    _write_jsonl(f"{base}.part00001", e1, torn=True)
    return str(base), [e0, e1]


def test_aggregate_and_render_top_spans_equal_jax(shards):
    _, lists = shards
    rows = tracing.aggregate_spans(lists)
    assert rows == jtracing.aggregate_spans(lists)
    assert rows and rows[0]["self_s"] >= rows[-1]["self_s"]
    for n in (3, 50):
        ours, theirs = io.StringIO(), io.StringIO()
        tracing.render_top_spans(rows, n, ours)
        jtracing.render_top_spans(rows, n, theirs)
        assert ours.getvalue() == theirs.getvalue()
    empty = io.StringIO()
    tracing.render_top_spans([], 5, empty)
    assert "no span events" in empty.getvalue()


def test_build_chrome_trace_equals_jax(shards, tmp_path):
    base, _ = shards
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    got = tracing.build_chrome_trace([base], str(ours))
    want = jtracing.build_chrome_trace([base], str(theirs))
    assert got == want
    n_spans, n_files, _, violations = got
    assert n_files == 2 and n_spans > 0
    assert len(violations) == 1 and "part00001" in violations[0]
    assert ours.read_bytes() == theirs.read_bytes()
    pids = {e["pid"] for e in json.loads(ours.read_text())["traceEvents"]}
    assert pids == {0, 1}
    assert tracing.rank_of_path(f"{base}.part00001") == 1
    assert tracing.chrome_events_from_journal(
        shards[1][1], 1) == jtracing.chrome_events_from_journal(
        shards[1][1], 1)


def test_traceplane_agrees_with_jax(shards, tmp_path):
    base, lists = shards
    for events in lists:
        fit = traceplane.clock_anchor_fit(events)
        assert fit == jtraceplane.clock_anchor_fit(events)
        assert fit[1] < 1e-3
    # skewed clocks: the shards' offsets differ by the 0.35 s skew
    fits = [traceplane.clock_anchor_fit(e)[0] for e in lists]
    assert fits[1] - fits[0] == pytest.approx(0.35, abs=1e-6)
    view = traceplane.extract_trace([base], TRACE_ID)
    jview = jtraceplane.extract_trace([base], TRACE_ID)
    for attr in ("spans", "instants", "shards", "warnings", "violations"):
        assert getattr(view, attr) == getattr(jview, attr), attr
    assert view.skew_bound_s == jview.skew_bound_s
    assert len(view.violations) == 1  # the torn line, dropped
    assert traceplane.critical_path(view) == jtraceplane.critical_path(
        jview)
    flows = traceplane._flow_events(view)
    assert flows == jtraceplane._flow_events(jview) and len(flows) == 2
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    traceplane.build_trace_chrome([base], TRACE_ID, str(ours))
    jtraceplane.build_trace_chrome([base], TRACE_ID, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    a, b = io.StringIO(), io.StringIO()
    traceplane.render_critical_path(view, a)
    jtraceplane.render_critical_path(jview, b)
    assert a.getvalue() == b.getvalue() and "critical path" in a.getvalue()
    assert traceplane.extract_trace([base], "f" * 32).spans == []


def test_trace_context_env_and_wire_forms(monkeypatch):
    ctx = tracing.TraceContext.mint()
    assert re.fullmatch(r"[0-9a-f]{32}", ctx.trace_id)
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    back = jtracing.TraceContext.from_env(ctx.to_env())
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    assert tracing.TraceContext.from_wire(ctx.to_wire()).span_id \
        == ctx.span_id
    monkeypatch.setenv(tracing.TRACE_ENV, "not:a-context")
    assert tracing.TraceContext.from_env() is None
    with pytest.raises(ValueError):
        tracing.TraceContext.from_wire({"trace_id": "x"})


def test_journal_binding_and_tracer_lanes(tmp_path):
    """A bound journal stamps every event (an emit's own trace_id wins);
    spans on two threads keep their own stacks and lanes; ``complete``
    parents under the open span; a NullTracer records nothing."""
    import threading

    path = tmp_path / "j.jsonl"
    journal = Journal(path)
    journal.bind_trace(TRACE_ID)
    ctx = tracing.TraceContext(TRACE_ID, "a" * 16)
    tracer = tracing.Tracer(journal=journal, keep=True, ctx=ctx)
    prev = tracing.set_current(tracer)
    try:
        journal.emit("run_start", command="consensus", method="bin-mean",
                     backend="torch", n_clusters=1)
        with tracing.span("outer", chunk_index=0) as sp:
            tracing.current().complete("kernel:x", sp.t0, 0.0, rows=1)
            sp.note(extra=1)

        def lane():
            tracing.set_thread_current(tracer)
            with tracing.span("pipeline:pack[0]"):
                pass

        t = threading.Thread(target=lane)
        t.start()
        t.join()
        journal.emit("dispatch", kernel="x", rows=1, padded_rows=1,
                     trace_id="b" * 32)
    finally:
        tracing.set_current(prev)
        journal.close()
    assert isinstance(tracing.current(), tracing.NullTracer)
    events, bad = jread_events(str(path))
    assert bad == []
    assert [e["trace_id"] for e in events] == [TRACE_ID] * 4 + ["b" * 32]
    spans = {e["name"]: e for e in events if e["event"] == "span"}
    assert spans["kernel:x"]["parent_span_id"] == spans["outer"]["span_id"]
    assert spans["outer"]["parent_span_id"] == "a" * 16
    assert spans["outer"]["labels"] == {"chunk_index": 0, "extra": 1}
    assert spans["pipeline:pack[0]"]["depth"] == 0
    assert spans["pipeline:pack[0]"]["tid"] != spans["outer"]["tid"]
    assert len(tracer.spans) == 3


# -- the write side: CLI runs of both packages -----------------------------


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    rng = np.random.default_rng(61)
    clusters = [make_cluster(rng, f"cluster-{i}",
                             n_members=int(rng.integers(1, 6)),
                             n_peaks=int(rng.integers(20, 60)),
                             base_scan=100 * i)
                for i in range(N_CLUSTERS)]
    path = tmp_path_factory.mktemp("tracing") / "clustered.mgf"
    jwrite_mgf([s for c in clusters for s in c.members], path)
    return str(path)


def _flags(d, who):
    return ["--qc-report", str(d / f"{who}.qc.json"),
            "--checkpoint", str(d / f"{who}.ck.json"),
            "--checkpoint-every", str(EVERY),
            "--journal", str(d / f"{who}.jsonl"),
            "--chrome-trace", str(d / f"{who}.trace.json")]


@pytest.fixture(scope="module")
def runs(clustered, tmp_path_factory):
    """``consensus --qc-report --journal --chrome-trace`` (with a
    checkpoint), the port's on the CPU and the JAX CLI's; and the port's
    untraced run of the same flags."""
    d = tmp_path_factory.mktemp("runs")
    assert cli.main(["consensus", clustered, str(d / "port.mgf"),
                     "--device", "cpu", *_flags(d, "port")]) == 0
    assert cli.main(["consensus", clustered, str(d / "plain.mgf"),
                     "--device", "cpu", "--qc-report",
                     str(d / "plain.qc.json"), "--checkpoint",
                     str(d / "plain.ck.json"), "--checkpoint-every",
                     str(EVERY)]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "specpride_tpu", "consensus", clustered,
         str(d / "jax.mgf"), "--layout", "flat", "--compile-cache", "off",
         *_flags(d, "jax")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return d


def _span_names(events):
    names = {re.sub(r"\[\d+\]$", "[]", e["name"])
             for e in events if e["event"] == "span"}
    return names - TIMING_SPANS


def test_port_run_carries_the_jax_span_names(runs):
    port, bad = jread_events(str(runs / "port.jsonl"))
    assert bad == []
    jax, _ = jread_events(str(runs / "jax.jsonl"))
    assert _span_names(port) == _span_names(jax) - set(JAX_ONLY_SPANS)
    assert {"parse", "parse:mgf", "pack:flat_bin_mean", "chunk", "compute",
            "method:bin_mean_with_cosines", "kernel:bin_mean_flat_intensity",
            "kernel:cosine_flat", "write", "write:mgf", "pipeline:write",
            "checkpoint_write"} <= _span_names(port)
    # every event of the run carries its one trace id
    ids = {e.get("trace_id") for e in port}
    assert len(ids) == 1 and re.fullmatch(r"[0-9a-f]{32}", ids.pop())
    # one kernel span per dispatch event, labelled as the JAX package's
    for kernel in ("bin_mean_flat_intensity", "cosine_flat"):
        spans = [e for e in port if e["event"] == "span"
                 and e["name"] == f"kernel:{kernel}"]
        dispatch = [e for e in port if e["event"] == "dispatch"
                    and e["kernel"] == kernel]
        assert len(spans) == len(dispatch) == -(-N_CLUSTERS // EVERY)
        assert {"kernel", "shape_key", "rows", "padded_rows",
                "compile"} <= set(spans[0]["labels"])
    method = [e for e in port if e["event"] == "span"
              and e["name"].startswith("method:")]
    assert all(e["labels"] == {"backend": "torch", "prepared": True}
               for e in method)


def test_phase_seconds_are_covered_by_top_level_spans(runs):
    events, _ = read_events(str(runs / "port.jsonl"))
    end = next(e for e in events if e["event"] == "run_end")
    top = sum(e["dur_s"] for e in events
              if e["event"] == "span" and e["depth"] == 0)
    assert top >= 0.95 * sum(end["phases_s"].values())
    # and the phase-named spans are the phase timers' own intervals
    named = {}
    for e in events:
        if e["event"] == "span" and e["name"] in ("parse", "compute",
                                                  "write"):
            named[e["name"]] = named.get(e["name"], 0.0) + e["dur_s"]
    for name, secs in named.items():
        assert secs >= 0.95 * end["phases_s"][name] - 1e-4, name


def test_chrome_trace_and_trace_command_hold_the_spans(runs, capsys):
    kept = json.loads((runs / "port.trace.json").read_text())["traceEvents"]
    out = runs / "rebuilt.json"
    assert cli.main(["trace", str(runs / "port.jsonl"), "-o",
                     str(out)]) == 0
    rebuilt = json.loads(out.read_text())["traceEvents"]
    names = sorted(e["name"] for e in kept if e["ph"] == "X")
    assert names == sorted(e["name"] for e in rebuilt if e["ph"] == "X")
    assert "parse" in names and "kernel:cosine_flat" in names
    capsys.readouterr()


@pytest.mark.parametrize("who,reader", [("jax", "port"), ("port", "jax")])
def test_stats_top_spans_and_trace_read_the_other_package(runs, who,
                                                          reader, capsys,
                                                          tmp_path):
    journal = str(runs / f"{who}.jsonl")
    agg = tmp_path / "agg.json"
    if reader == "port":
        assert run_stats([journal], json_out=str(agg), top_spans=5) == 0
    else:
        assert jstats_cli.run_stats([journal], json_out=str(agg),
                                    top_spans=5) == 0
    text = capsys.readouterr().out
    assert "TOP 5 SPANS by self time" in text
    rows = json.loads(agg.read_text())["top_spans"]
    events, _ = jread_events(journal)
    assert rows == jtracing.aggregate_spans([events])[:5]
    out = tmp_path / "t.json"
    build = (tracing.build_chrome_trace if reader == "port"
             else jtracing.build_chrome_trace)
    n_spans, n_files, _, violations = build([journal], str(out))
    assert n_files == 1 and violations == []
    assert n_spans == sum(e["event"] == "span" for e in events)
    trace_id = events[0]["trace_id"]
    assert cli.main(["stats", journal, "--trace", trace_id]) == 0
    assert f"trace {trace_id}" in capsys.readouterr().out
    assert cli.main(["trace", journal, "--trace-id", trace_id, "-o",
                     str(tmp_path / "c.json")]) == 0


def test_untraced_run_records_no_span_and_writes_the_same_bytes(
        runs, clustered, tmp_path, monkeypatch):
    for name in ("mgf", "qc.json"):
        assert ((runs / f"port.{name}").read_bytes()
                == (runs / f"plain.{name}").read_bytes()), name
    recorded = []
    monkeypatch.setattr(tracing.Tracer, "_record",
                        lambda self, *a, **k: recorded.append(a[0]))
    assert cli.main(["consensus", clustered, str(tmp_path / "x.mgf"),
                     "--device", "cpu", "--qc-report",
                     str(tmp_path / "x.qc.json"), "--metrics-out",
                     str(tmp_path / "x.prom")]) == 0
    assert recorded == []
    assert isinstance(tracing.current(), tracing.NullTracer)
    assert (tmp_path / "x.mgf").read_bytes() == (runs / "plain.mgf"
                                                 ).read_bytes()
    # --chrome-trace alone traces, with no journal
    assert cli.main(["consensus", clustered, str(tmp_path / "y.mgf"),
                     "--device", "cpu", "--chrome-trace",
                     str(tmp_path / "y.json")]) == 0
    assert "chunk" in recorded
    assert isinstance(tracing.current(), tracing.NullTracer)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("handoff", [True, False])
def test_coordinator_ranks_share_one_trace(clustered, tmp_path, handoff):
    """Two CPU ranks: with ``SPECPRIDE_TRACE`` both adopt its trace id,
    without it both take rank 0's; ``trace`` merges their journal shards
    with pid = rank, and each rank's ``--chrome-trace`` is its own
    ``.part`` file."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(tracing.TRACE_ENV, None)
    if handoff:
        env[tracing.TRACE_ENV] = f"{TRACE_ID}:{'c' * 16}"
    port = _free_port()
    journal, chrome = tmp_path / "j.jsonl", tmp_path / "c.json"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "specpride_tpu_torch", "consensus", clustered,
         str(tmp_path / "out.mgf"), "--device", "cpu", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(i), "--journal", str(journal), "--chrome-trace", str(chrome)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE) for i in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ids = set()
    for rank in range(2):
        events, bad = jread_events(f"{journal}.part{rank:05d}")
        assert bad == []
        ids |= {e["trace_id"] for e in events}
        kept = json.loads(open(f"{chrome}.part{rank:05d}").read())
        assert {e["pid"] for e in kept["traceEvents"]} == {rank}
    assert len(ids) == 1
    if handoff:
        assert ids == {TRACE_ID}
    merged = tmp_path / "merged.json"
    assert cli.main(["trace", str(journal), "-o", str(merged)]) == 0
    events = json.loads(merged.read_text())["traceEvents"]
    assert {e["pid"] for e in events if e["ph"] == "X"} == {0, 1}
    view = traceplane.extract_trace([str(journal)], ids.pop())
    assert len(view.shards) == 2


# -- host time by thread: CPU per phase and lane, spans as profiler ranges


def _streamed(clustered, d, *flags):
    """A pipelined CPU run on a streamed input (windows of 8 clusters,
    chunks of 8, two pack workers); its run summary."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(["consensus", clustered, str(d / "s.mgf"),
                         "--device", "cpu", "--qc-report",
                         str(d / "s.qc.json"), "--pack-workers", "2",
                         "--stream-clusters", "8", "--checkpoint-every", "8",
                         *flags]) == 0
    return json.loads([ln for ln in err.getvalue().splitlines()
                       if ln.startswith("{")][-1])


def _pair_within(pair, wall):
    user, sys_ = pair
    assert user >= 0.0 and sys_ >= 0.0
    assert user + sys_ <= wall + 0.01


def test_streamed_run_reports_thread_cpu_per_phase_and_lane(clustered,
                                                           tmp_path):
    summary = _streamed(clustered, tmp_path)
    phases, cpu = summary["phases_s"], summary["phases_cpu_s"]
    assert set(cpu) == set(phases)
    assert {"parse", "window_parse", "pack", "qc_pack", "compute",
            "write"} <= set(phases)
    for name, wall in phases.items():
        _pair_within(cpu[name], wall)
    assert summary["cpu_s"]["user"] >= 0.0 and summary["cpu_s"]["sys"] >= 0.0
    pipe = summary["pipeline"]
    assert pipe["pack_workers"] == 2 and pipe["n_chunks"] == 5
    assert len(pipe["pack_cpu_s"]) == len(pipe["pack_busy_s"]) == 2
    for pair, busy in zip(pipe["pack_cpu_s"], pipe["pack_busy_s"]):
        _pair_within(pair, busy)
    _pair_within(pipe["write_cpu_s"], pipe["write_busy_s"])
    _pair_within(pipe["dispatch_cpu_s"], pipe["wall_s"])


def test_lane_spans_carry_their_thread_cpu(clustered, tmp_path):
    journal = tmp_path / "s.jsonl"
    _streamed(clustered, tmp_path, "--journal", str(journal))
    events, bad = read_events(str(journal))
    assert bad == []
    seen = set()
    for e in events:
        if e["event"] == "span" and e["name"] in (
                "pipeline:pack[0]", "pipeline:pack[1]", "chunk",
                "pipeline:write", "parse"):
            labels = e["labels"]
            _pair_within((labels["cpu_user_s"], labels["cpu_sys_s"]),
                         e["dur_s"])
            seen.add(e["name"])
    assert seen == {"pipeline:pack[0]", "pipeline:pack[1]", "chunk",
                    "pipeline:write", "parse"}


def test_a_prepared_chunk_keeps_its_own_stats(clustered, tmp_path):
    """The backend's pack stages reach the run's phases and the backend's
    (which also holds the dispatch lane's own packs); the lane's own stage
    (``window_parse``) only the run's, and a phase the backend does not
    know is an error, not dropped."""
    from specpride_tpu_torch.backends.torch_backend import (
        PreparedChunk,
        TorchBackend,
    )

    summary = _streamed(clustered, tmp_path)
    backend_phases = summary["backend"]["phase_s"]
    assert "window_parse" not in backend_phases
    for name in ("pack", "qc_pack"):
        assert backend_phases[name] >= summary["phases_s"][name] - 1e-3
    prepared = PreparedChunk("bin-mean", [], None)
    prepared.stats.add("window_parse", stats.Lap().stop())
    with pytest.raises(KeyError):
        TorchBackend(device="cpu")._merge_prepared(prepared)


def _counting_range_hooks(monkeypatch):
    """Wrap every range hook a capture installs; the ranges it opened."""
    opened = []
    make = stats._range_hook

    def counting(all_threads):
        hook = make(all_threads)

        def open_range(name):
            opened.append(name)
            return hook(name)

        return open_range

    monkeypatch.setattr(stats, "_range_hook", counting)
    return opened


@pytest.mark.skipif(stats._all_threads_config() is None,
                    reason="this torch's profiler has no profile_all_threads")
def test_trace_dir_holds_the_lanes_spans_as_ranges(clustered, tmp_path,
                                                   monkeypatch):
    opened = _counting_range_hooks(monkeypatch)
    trace_dir = tmp_path / "td"
    _streamed(clustered, tmp_path, "--trace-dir", str(trace_dir))
    assert "chunk" in opened and tracing._range_hook is None
    assert isinstance(tracing.current(), tracing.NullTracer)
    events = json.loads(open(stats.trace_path(str(trace_dir))).read())
    tids: dict[str, set] = {}
    for e in events["traceEvents"]:
        if e.get("cat") == "user_annotation":
            tids.setdefault(e["name"], set()).add(e["tid"])
    assert tids.get("chunk") and tids.get("pipeline:pack[0]")
    assert tids["chunk"].isdisjoint(tids["pipeline:pack[0]"])
    assert "pipeline:write" in tids


def test_no_range_is_opened_without_trace_dir(clustered, tmp_path,
                                              monkeypatch):
    opened = _counting_range_hooks(monkeypatch)
    _streamed(clustered, tmp_path, "--journal", str(tmp_path / "j.jsonl"),
              "--chrome-trace", str(tmp_path / "c.json"))
    assert opened == [] and tracing._range_hook is None


def test_clusters_per_sec_is_over_the_wall(runs):
    events, _ = read_events(str(runs / "port.jsonl"))
    end = next(e for e in events if e["event"] == "run_end")
    assert end["counters"]["clusters"] == N_CLUSTERS
    assert end["clusters_per_sec"] == pytest.approx(
        N_CLUSTERS / end["elapsed_s"], rel=1e-3)
