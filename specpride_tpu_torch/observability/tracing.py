"""Hierarchical span tracing, where the time goes inside a run: the
port's copy of the JAX package's ``observability/tracing.py`` (the same
span names, event fields and Chrome export, so the two packages' traces
read alike).

The phase timers (``RunStats.phase``) answer "how much total time did
parse/pack/compute take"; spans answer "which chunk, which kernel call,
which pack lane": each span is one timed interval with a name, labels,
and a position in the nesting hierarchy.  Three consumers share one span
stream:

* the **run journal** (``--journal``): every finished span is one
  ``span`` event (emitted at close, so a killed run simply lacks the
  events for spans still open: nothing to repair);
* **Chrome trace export** (``--chrome-trace FILE`` or ``trace
  JOURNAL...``): trace-event JSON loadable in Perfetto /
  chrome://tracing, multi-host ``.part<rank>`` shards merged onto one
  timeline with ``pid`` = rank;
* **slowest-span analysis** (``stats --top-spans N``): per-name self
  time / count / p50 / p99 without opening a UI.

A ``kernel:<name>`` span is the host's dispatch of a card call (the
backend's ``_note_dispatch``): its duration is host time, asynchronous
to the card, as the JAX package's ``specpride_dispatch_seconds`` is.

A fourth consumer, the device trace (``--trace-dir``): while its capture
runs it installs a range hook (``set_range_hook``), and every span opened
with a ``with`` block is also a profiler range on its thread, so the
capture holds the port's spans beside the card's kernels on one clock.
Spans recorded after the fact (``complete()``) stay journal-only.  This
module imports no torch: the hook is the torch side's.

Clocks: span durations come from ``time.perf_counter`` (monotonic — a
wall-clock jump mid-run cannot corrupt them).  For cross-host merging the
monotonic axis is anchored to the wall clock once per run segment (at
``run_start``), so ranks align on their NTP-synced wall clocks while
within-rank intervals stay monotonic-exact.

Usage: the CLI installs one ``Tracer`` per run (``set_current``); library
code opens spans through the module-level ``span()`` / ``traced()``
helpers, which no-op against a ``NullTracer`` when tracing is off.
"""

from __future__ import annotations

import functools
import json
import os
import re
import threading
import time

from specpride_tpu_torch.observability.journal import (
    NullJournal,
    _json_default,
    expand_parts,
    read_events,
)


# -- trace context -------------------------------------------------------
#
# The v4 causal envelope: a `trace_id` minted once per logical request
# (job admission, elastic run start, one-shot CLI run) plus the span id
# of the hop that spawned the current scope.  The pair threads through
# every process boundary — the serve wire protocol (`"trace"` on
# submit), the coordinator's plan record, and the SPECPRIDE_TRACE env
# handoff for spawned rank processes — so every hop's spans parent into
# ONE cross-process tree the trace merger (observability.traceplane)
# can reassemble.

TRACE_ENV = "SPECPRIDE_TRACE"


def new_trace_id() -> str:
    """A fresh 128-bit trace id (32 lowercase hex chars)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """A fresh 64-bit span id (16 lowercase hex chars)."""
    return os.urandom(8).hex()


class TraceContext:
    """One hop's causal coordinates: the trace it belongs to and the
    span id its top-level spans parent under."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def mint(cls) -> "TraceContext":
        return cls(new_trace_id(), new_span_id())

    def child(self) -> "TraceContext":
        """The context a spawned hop runs under: same trace, fresh
        parent span id."""
        return TraceContext(self.trace_id, new_span_id())

    def to_env(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "parent_span_id": self.span_id}

    @classmethod
    def from_env(cls, value: str | None = None) -> "TraceContext | None":
        """Parse the ``SPECPRIDE_TRACE`` handoff (``trace_id:span_id``);
        None when absent or malformed — a bad handoff must degrade to a
        fresh trace, never crash a rank."""
        if value is None:
            value = os.environ.get(TRACE_ENV)
        if not value:
            return None
        parts = value.strip().split(":")
        if len(parts) != 2:
            return None
        trace_id, span_id = parts
        if re.fullmatch(r"[0-9a-f]{32}", trace_id) and re.fullmatch(
            r"[0-9a-f]{16}", span_id
        ):
            return cls(trace_id, span_id)
        return None

    @classmethod
    def from_wire(cls, obj) -> "TraceContext | None":
        """Parse the submit message's ``trace`` object; None when absent,
        raises ``ValueError`` on a present-but-malformed one (the daemon
        rejects the job — a half-broken trace join is worse than none)."""
        if obj is None:
            return None
        if not isinstance(obj, dict):
            raise ValueError("trace must be an object")
        trace_id = obj.get("trace_id")
        span_id = obj.get("parent_span_id")
        if not (isinstance(trace_id, str)
                and re.fullmatch(r"[0-9a-f]{32}", trace_id)):
            raise ValueError("trace.trace_id must be 32 hex chars")
        if not (isinstance(span_id, str)
                and re.fullmatch(r"[0-9a-f]{16}", span_id)):
            raise ValueError("trace.parent_span_id must be 16 hex chars")
        return cls(trace_id, span_id)


class _NullSpan:
    """Reusable no-op span (one shared instance; carries no state)."""

    __slots__ = ()
    enabled = False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **labels) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op stand-in so call sites never branch on 'tracing on?'."""

    enabled = False
    spans: tuple = ()

    def span(self, name: str, **labels) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, name: str, t_start: float, dur_s: float,
                 **labels) -> None:
        pass


class Span:
    """One open interval; a context manager that records itself on exit.

    ``note(**labels)`` may add labels any time before close — the journal
    event is only written when the span finishes."""

    __slots__ = ("tracer", "name", "labels", "t0", "depth", "span_id",
                 "parent_span_id", "range")
    enabled = True

    def __init__(self, tracer: "Tracer", name: str, labels: dict):
        self.tracer = tracer
        self.name = name
        self.labels = labels
        self.span_id = None
        self.parent_span_id = None
        self.range = None  # the profiler range the hook opened, if any

    def note(self, **labels) -> None:
        self.labels.update(labels)

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.depth = len(stack)
        if self.tracer.ctx is not None:
            # causal ids are assigned at OPEN (children must see their
            # parent's id on the stack), journaled at close with the rest
            self.span_id = new_span_id()
            self.parent_span_id = (
                stack[-1].span_id if stack and stack[-1].span_id
                else self.tracer.ctx.span_id
            )
        stack.append(self)
        hook = _range_hook
        if hook is not None:
            self.range = hook(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._record(
            self.name, end, end - self.t0, self.depth, self.labels,
            span_id=self.span_id, parent_span_id=self.parent_span_id,
        )
        return False


class Tracer:
    """Span recorder: nestable context-manager spans on a per-thread
    stack, each emitted as a journal ``span`` event at close and
    (``keep=True``) retained in memory for direct Chrome-trace export.

    The journal envelope's ``mono`` field (emission time ==  span end)
    plus the event's ``dur_s`` reconstruct the interval; ``depth`` is the
    nesting depth at open, informational — consumers derive the true
    hierarchy from time containment, which also places spans recorded
    retroactively via ``complete()`` (e.g. async kernel dispatches timed
    by the backend) under the phase that contained them."""

    enabled = True

    def __init__(self, journal=None, keep: bool = False, ctx=None):
        self.journal = journal if journal is not None else NullJournal()
        self.keep = keep
        # trace context (v4 causal envelope): when set, every span gets
        # a fresh span_id at open and a parent_span_id from the
        # enclosing span (ctx.span_id at stack bottom), journaled with
        # the span event — the cross-process causal tree
        self.ctx: TraceContext | None = ctx
        self.spans: list[dict] = []  # finished spans (when keep)
        # wall/mono anchor pair for exporting kept spans without a journal
        self.t0_wall = time.time()
        self.t0_mono = time.perf_counter()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **labels) -> Span:
        return Span(self, name, labels)

    def attach_journal(self, journal, keep: bool) -> None:
        """Attach the run journal after the fact — the CLI installs the
        tracer BEFORE the journal exists so input parsing is traced.
        Spans finished so far replay into it, each overriding the
        envelope ``mono`` with its original end time so reconstruction
        places it correctly on the anchored timeline; every later span
        streams directly.  ``keep=False`` drops the in-memory copies
        once replayed (no ``--chrome-trace`` export will need them)."""
        self.journal = journal
        for s in self.spans:
            journal.emit("span", **s)
        self.keep = keep
        if not keep:
            self.spans = []

    def complete(self, name: str, t_start: float, dur_s: float,
                 **labels) -> None:
        """Record a span measured externally (``t_start`` from
        ``time.perf_counter()``).  Used where the interval is timed by
        existing instrumentation — per-kernel dispatch timing — rather
        than a ``with`` block."""
        span_id = parent = None
        if self.ctx is not None:
            span_id = new_span_id()
            stack = self._stack()
            parent = (
                stack[-1].span_id if stack and stack[-1].span_id
                else self.ctx.span_id
            )
        self._record(
            name, t_start + dur_s, dur_s, len(self._stack()), labels,
            span_id=span_id, parent_span_id=parent,
        )

    def _record(self, name: str, mono_end: float, dur_s: float,
                depth: int, labels: dict, span_id: str | None = None,
                parent_span_id: str | None = None) -> None:
        # `tid`: the recording thread's lane.  The pipelined executor's
        # packer thread emits spans that GENUINELY overlap the dispatch
        # lane's — without a lane id the Chrome view would stack both
        # lanes on one track and time-containment nesting
        # (aggregate_spans) would credit a packer span running inside a
        # consumer span's interval as its child.  Spans are recorded on
        # their owning thread (Span.__exit__) or the dispatching thread
        # (complete()), so the current thread's lane is the right one.
        rec = {
            "name": name, "dur_s": round(dur_s, 6), "depth": depth,
            "tid": _lane_of_thread(),
        }
        if span_id is not None:
            rec["span_id"] = span_id
        if parent_span_id is not None:
            rec["parent_span_id"] = parent_span_id
        if labels:
            rec["labels"] = dict(labels)
        # the envelope `mono` must be the span's END, not the emit time:
        # retroactive spans (complete(); kernel dispatches) are journaled
        # after their containing phase span closed, and a late `mono`
        # would shift them outside it, breaking time-containment nesting
        self.journal.emit("span", mono=mono_end, **rec)
        if self.keep:
            self.spans.append({**rec, "mono": mono_end})

    def write_chrome_trace(self, path: str, pid: int = 0) -> int:
        """Export the kept spans as Chrome trace-event JSON.  Returns the
        number of span events written."""
        events = []
        for s in self.spans:
            wall = self.t0_wall + (s["mono"] - self.t0_mono)
            events.append(_chrome_span(s, wall, pid))
        meta = [_chrome_process_meta(pid, f"rank {pid}")]
        _dump_trace(meta + events, path)
        return len(events)


# small sequential lane id per recording thread (0 = first recorder, in
# practice the main thread): raw thread idents are pthread addresses whose
# truncation could collide, and full idents make unreadable Chrome tids
_TID_LANES: dict[int, int] = {}
_TID_LANES_LOCK = threading.Lock()


def _lane_of_thread() -> int:
    ident = threading.get_ident()
    lane = _TID_LANES.get(ident)
    if lane is None:
        with _TID_LANES_LOCK:
            lane = _TID_LANES.setdefault(ident, len(_TID_LANES))
    return lane


# -- profiler ranges -----------------------------------------------------
#
# Called with a span's name as it opens, on the opening thread, the hook
# returns an entered context manager (the span's exit, on the same
# thread, exits it) or None.  Only a device-trace capture installs one.

_range_hook = None


def set_range_hook(hook):
    """Install the span-open hook (None removes it); returns the previous
    one so the installer can restore it."""
    global _range_hook
    prev = _range_hook
    _range_hook = hook  # lint: ok[lane-safety] one store, set and restored around a capture by the thread that runs it
    return prev


# -- current-tracer plumbing ---------------------------------------------
#
# Two scopes: the PROCESS-global tracer (one-shot CLI runs, bench, and
# every caller that predates multi-lane serving) and an optional
# THREAD-local override.  A serving worker lane installs its job's
# tracer thread-locally so concurrent jobs' spans land in their OWN
# journals instead of whichever job installed the global last; the
# job's lane threads (pack workers, committer) adopt the creating
# thread's tracer at start (cli wires it), so the per-run behaviour is
# identical to the one-shot CLI's.

_NULL_TRACER = NullTracer()
_current: Tracer | NullTracer = _NULL_TRACER
_current_tls = threading.local()


def current() -> Tracer | NullTracer:
    override = getattr(_current_tls, "tracer", None)
    return override if override is not None else _current


def set_current(tracer: Tracer | None) -> Tracer | NullTracer:
    """Install ``tracer`` PROCESS-wide (None restores the no-op tracer);
    returns the previous one so callers can restore it."""
    global _current
    prev = _current
    # serving lanes never call this — they scope tracers per thread via
    # set_thread_current; the process-wide install happens only on the
    # one-shot CLI path, and the swap itself is a single GIL-atomic
    # store either way
    _current = tracer if tracer is not None else _NULL_TRACER  # lint: ok[lane-safety] one-shot CLI installs process-wide; serve lanes use the tls override
    return prev


def set_thread_current(
    tracer: Tracer | NullTracer | None,
) -> Tracer | NullTracer | None:
    """Install ``tracer`` as THIS thread's tracer override (None removes
    the override, falling back to the process-global tracer); returns
    the previous override for restore-on-exit."""
    prev = getattr(_current_tls, "tracer", None)
    _current_tls.tracer = tracer
    return prev


def span(name: str, **labels):
    """Open a span on the current tracer (no-op when tracing is off)."""
    return current().span(name, **labels)


def traced(name: str, **static_labels):
    """Decorator: run the function under a span (no-op when off)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            tracer = current()
            if not tracer.enabled:
                return fn(*args, **kwargs)
            with tracer.span(name, **static_labels):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# -- journal -> timeline reconstruction ----------------------------------

def _wall_times(events):
    """Yield ``(event, wall_seconds)`` with the monotonic axis anchored
    to the wall clock once per run segment (``run_start``), so trace
    reconstruction is immune to wall-clock jumps mid-run: only the
    anchor uses ``ts``, every interval after it rides ``mono``.  v1
    events (no ``mono``) fall back to raw ``ts``."""
    anchor_ts = anchor_mono = None
    for e in events:
        ts = e.get("ts", 0.0)
        mono = e.get("mono")
        if isinstance(mono, (int, float)):
            if e.get("event") == "run_start" or anchor_mono is None:
                anchor_ts, anchor_mono = ts, mono
            wall = anchor_ts + (mono - anchor_mono)
        else:
            wall = ts
        yield e, wall


def rank_of_path(path: str, default: int = 0) -> int:
    """Rank from a ``.part<id>`` suffix (``.part00001`` or ``.part1``),
    else ``default`` — the Chrome-trace ``pid``."""
    m = re.search(r"\.part(\d+)$", path)
    return int(m.group(1)) if m else default


def _chrome_span(rec: dict, wall_end: float, pid: int) -> dict:
    dur = float(rec["dur_s"])
    return {
        "name": rec["name"],
        "cat": "span",
        "ph": "X",
        "ts": (wall_end - dur) * 1e6,
        "dur": dur * 1e6,
        "pid": pid,
        # one Chrome track per recording thread: pipelined runs put the
        # packer lane and the dispatch lane on separate rows (v1 spans
        # without tid all land on track 0, as before)
        "tid": rec.get("tid", 0),
        "args": {**rec.get("labels", {}), "depth": rec.get("depth", 0)},
    }


def _chrome_process_meta(pid: int, name: str) -> dict:
    return {
        "name": "process_name",
        "ph": "M",
        "ts": 0,
        "pid": pid,
        "tid": 0,
        "args": {"name": name},
    }


def _dump_trace(events: list[dict], path: str) -> None:
    """Write trace-event JSON with the time origin shifted to zero (epoch
    microseconds overflow the viewers' float precision)."""
    t0 = min(
        (e["ts"] for e in events if e.get("ph") != "M"), default=0.0
    )
    for e in events:
        if e.get("ph") != "M":
            e["ts"] = round(e["ts"] - t0, 3)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {"traceEvents": events, "displayTimeUnit": "ms"},
            fh, default=_json_default,
        )
        fh.write("\n")


def chrome_events_from_journal(events: list[dict], pid: int) -> list[dict]:
    """One journal's events as Chrome trace events: ``span`` -> complete
    ("X") slices, every other event an instant ("i") marker on the same
    timeline.  Orphaned spans cannot occur here by construction — a span
    is only journaled once finished, and a line torn by a mid-write kill
    was already dropped (deterministically) by ``read_events``."""
    out = []
    for e, wall in _wall_times(events):
        if e["event"] == "span":
            out.append(_chrome_span(e, wall, pid))
        else:
            args = {
                k: v for k, v in e.items()
                if k not in ("v", "ts", "mono", "event")
            }
            out.append({
                "name": e["event"],
                "cat": "event",
                "ph": "i",
                "s": "t",
                "ts": wall * 1e6,
                "pid": pid,
                "tid": 0,
                "args": args,
            })
    return out


def build_chrome_trace(
    journal_paths: list[str], out_path: str
) -> tuple[int, int, list[str], list[str]]:
    """Reconstruct one Chrome trace from one or more journals, merging
    multi-host ``.part<rank>`` shards onto a single timeline (pid =
    rank).  Returns ``(n_span_events, n_files, warnings, violations)`` —
    a post-mortem tool must still render what it CAN read, so schema
    violations are reported, not fatal; nothing is written only when no
    journal file resolves at all (``n_files == 0``)."""
    files: list[str] = []
    warnings: list[str] = []
    for p in journal_paths:
        got, warn = expand_parts(p)
        files.extend(got)
        warnings.extend(warn)
    trace_events: list[dict] = []
    violations: list[str] = []
    n_spans = 0
    for i, path in enumerate(files):
        events, bad = read_events(path)
        violations.extend(bad)
        pid = rank_of_path(path, default=i)
        trace_events.append(
            _chrome_process_meta(pid, os.path.basename(path))
        )
        chunk = chrome_events_from_journal(events, pid)
        n_spans += sum(1 for e in chunk if e["ph"] == "X")
        trace_events.extend(chunk)
    if files:
        _dump_trace(trace_events, out_path)
    return n_spans, len(files), warnings, violations


# -- slowest-span analysis -----------------------------------------------

def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, round(q * (len(sorted_vals) - 1)))
    return sorted_vals[int(idx)]


def aggregate_spans(event_lists: list[list[dict]]) -> list[dict]:
    """Per-name span statistics over one or more journals' events:
    count, total time, SELF time (total minus directly-contained child
    spans — the number that actually localizes a regression), and
    p50/p99/max duration.  Hierarchy is reconstructed per journal by
    time containment on the anchored timeline, so retroactively recorded
    spans (async kernel dispatches) credit their containing phase.
    Sorted by self time, descending."""
    agg: dict[str, dict] = {}
    for events in event_lists:
        spans = []
        for e, wall in _wall_times(events):
            if e.get("event") != "span":
                continue
            dur = float(e["dur_s"])
            spans.append({
                "name": e["name"], "start": wall - dur, "end": wall,
                "dur": dur, "child": 0.0, "tid": e.get("tid", 0),
            })
        # containment runs PER LANE: a packer-thread span genuinely
        # overlapping a dispatch-lane span (pipelined runs) is parallel
        # work, not a child — cross-lane containment would deflate the
        # containing span's self time by work it never did
        spans.sort(key=lambda s: (s["tid"], s["start"], -s["end"]))
        stack: list[dict] = []
        # 1us containment tolerance: dur_s is journaled at 1us precision,
        # so reconstructed start times carry sub-us rounding error
        for s in spans:
            while stack and (
                stack[-1]["tid"] != s["tid"]
                or stack[-1]["end"] <= s["start"] + 1e-6
            ):
                stack.pop()
            if stack and s["end"] <= stack[-1]["end"] + 1e-6:
                stack[-1]["child"] += s["dur"]
            stack.append(s)
        for s in spans:
            a = agg.setdefault(
                s["name"],
                {"name": s["name"], "count": 0, "total_s": 0.0,
                 "self_s": 0.0, "durs": []},
            )
            a["count"] += 1
            a["total_s"] += s["dur"]
            a["self_s"] += max(s["dur"] - s["child"], 0.0)
            a["durs"].append(s["dur"])
    rows = []
    for a in agg.values():
        durs = sorted(a.pop("durs"))
        rows.append({
            **a,
            "total_s": round(a["total_s"], 6),
            "self_s": round(a["self_s"], 6),
            "p50_s": round(_percentile(durs, 0.50), 6),
            "p99_s": round(_percentile(durs, 0.99), 6),
            "max_s": round(durs[-1], 6),
        })
    rows.sort(key=lambda r: r["self_s"], reverse=True)
    return rows


def render_top_spans(rows: list[dict], n: int, out) -> None:
    """The ``specpride stats --top-spans N`` table."""
    if not rows:
        print("no span events (v2 journals emit them when tracing is on)",
              file=out)
        return
    print(f"TOP {min(n, len(rows))} SPANS by self time:", file=out)
    print(
        f"  {'name':<32} {'count':>7} {'total_s':>10} {'self_s':>10} "
        f"{'p50_ms':>9} {'p99_ms':>9} {'max_ms':>9}", file=out,
    )
    for r in rows[:n]:
        print(
            f"  {r['name']:<32} {r['count']:>7} {r['total_s']:>10.3f} "
            f"{r['self_s']:>10.3f} {r['p50_s'] * 1e3:>9.2f} "
            f"{r['p99_s'] * 1e3:>9.2f} {r['max_s'] * 1e3:>9.2f}",
            file=out,
        )
