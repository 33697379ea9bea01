"""Cross-process trace reassembly (``trace --job/--trace-id``, ``stats
--trace``): the port's copy of the JAX package's
``observability/traceplane.py``.

Every process keeps a private journal on a private monotonic clock: the
submit client, a serving daemon, each served job, every rank.  This
module is the read side of the v4 trace-context plane: given those
journal shards and a ``trace_id`` (or a served ``job_id`` to resolve
one), it reassembles ONE causally-linked Perfetto timeline.  It only
reads journals, so it reads a JAX daemon's as well as the port's runs':

* **clock anchoring** — each journal's ``clock_anchor`` events (paired
  wall<->mono captures with a per-pair ``uncertainty_s``) fit a
  ``wall = mono + offset`` mapping per process run segment, with a
  reported skew bound (max anchor residual from the median offset plus
  the capture uncertainty).  Pre-v4 journals fall back to the envelope
  ``ts``/``mono`` pair of their first event, with a coarse bound.
* **trace extraction** — events belong to the trace when their
  ``trace_id`` matches (run journals stamp every event via
  ``Journal.bind_trace``; the daemon's per-job events carry it
  explicitly) or the id appears in a ``batch_dispatch``'s ``trace_ids``.
  A matching batch additionally pulls in its member jobs' serve spans
  (matched by ``labels.job_id``), so a batch-leader trace spans every
  tenant the shared dispatch served.
* **flow events** — a span whose ``parent_span_id`` resolves to a span
  in a DIFFERENT process track emits a Chrome flow arrow (``ph: s/f``)
  from parent to child, so the client -> daemon -> job -> rank causality
  renders as arrows across tracks, not just stacked slices.
* **critical path** — ``specpride stats --trace ID`` descends the span
  tree from the trace root, at each hop following the child that
  finishes last, and reports each hop's exclusive contribution — the
  chain to shorten first.

Torn shard lines were already dropped deterministically by
``read_events``; journals a trace never touched contribute nothing.
"""

from __future__ import annotations

import os

from specpride_tpu_torch.observability.journal import (
    expand_parts,
    read_events,
)
from specpride_tpu_torch.observability.tracing import (
    _chrome_process_meta,
    _dump_trace,
)

# fallback skew bound for pre-v4 journals anchored on an envelope
# (ts, mono) pair: the two reads are adjacent but unpaired, so assume a
# generous capture window instead of claiming false precision
_ENVELOPE_ANCHOR_UNCERTAINTY_S = 0.05


def clock_anchor_fit(events: list[dict]) -> tuple[float, float] | None:
    """Fit one process segment's mono axis onto the wall axis.

    Returns ``(offset, bound)`` with ``wall ~ mono + offset`` and every
    anchor within ``bound`` seconds of that line, or None when the
    segment has no usable pair.  The offset is the median over the
    anchors (robust to one NTP step mid-run); the bound is the largest
    residual plus that anchor's own capture uncertainty — the number
    the merger reports as the alignment's worst case."""
    anchors: list[tuple[float, float, float]] = []
    for e in events:
        if e.get("event") != "clock_anchor":
            continue
        mono, wall = e.get("mono"), e.get("wall")
        if isinstance(mono, (int, float)) and isinstance(
            wall, (int, float)
        ):
            anchors.append(
                (mono, wall, float(e.get("uncertainty_s", 0.0)))
            )
    if not anchors:
        for e in events:  # pre-v4: first envelope pair, coarse bound
            mono, ts = e.get("mono"), e.get("ts")
            if isinstance(mono, (int, float)) and isinstance(
                ts, (int, float)
            ):
                anchors.append(
                    (mono, ts, _ENVELOPE_ANCHOR_UNCERTAINTY_S)
                )
                break
    if not anchors:
        return None
    offsets = sorted(w - m for m, w, _ in anchors)
    offset = offsets[len(offsets) // 2]
    bound = max(abs((w - m) - offset) + u for m, w, u in anchors)
    return offset, bound


def _segments(events: list[dict]) -> list[list[dict]]:
    """Split one journal's events at ``run_start`` boundaries — each
    segment is one PROCESS run, so its mono axis is self-consistent
    (a journal reopened across runs must never mix axes in one fit)."""
    segments: list[list[dict]] = []
    for e in events:
        if e.get("event") == "run_start" or not segments:
            segments.append([])
        segments[-1].append(e)
    return segments


def _matches(e: dict, trace_id: str) -> bool:
    if e.get("trace_id") == trace_id:
        return True
    ids = e.get("trace_ids")
    return isinstance(ids, (list, tuple)) and trace_id in ids


def resolve_job_trace(files: list[str], job_id: int) -> str | None:
    """The trace id of served job ``job_id``: from its ``job_done`` /
    ``job_start`` / ``job_queued`` events in any of the journals (last
    writer wins — job ids restart per daemon boot, traces do not)."""
    found = None
    for path in files:
        events, _bad = read_events(path)
        for e in events:
            if e.get("event") in ("job_queued", "job_start", "job_done") \
                    and e.get("job_id") == job_id \
                    and isinstance(e.get("trace_id"), str):
                found = e["trace_id"]
    return found


class TraceView:
    """One reassembled trace: per-shard aligned spans + instants."""

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: list[dict] = []     # wall-aligned, cross-shard
        self.instants: list[dict] = []
        self.shards: list[dict] = []    # {path, pid, offset, bound}
        self.warnings: list[str] = []
        self.violations: list[str] = []

    @property
    def skew_bound_s(self) -> float:
        return max(
            (s["bound"] for s in self.shards if s["bound"] is not None),
            default=0.0,
        )


def _segment_base(path: str) -> str:
    """The logical journal a file belongs to: a rotated segment
    (``serve.jsonl.3``, including a part shard's
    ``x.jsonl.part00000.2``) maps to its un-numbered base — rotation
    splits FILES, not processes, so segments share one event stream,
    one clock fit, and one Chrome process track."""
    root, dot, suffix = path.rpartition(".")
    return root if dot and suffix.isdigit() else path


def extract_trace(journal_paths: list[str], trace_id: str) -> TraceView:
    """Collect one trace's spans and instants from journal shards onto
    one wall axis (one Chrome ``pid`` per logical journal — rotated
    segments of one journal concatenate into its stream)."""
    view = TraceView(trace_id)
    files: list[str] = []
    for p in journal_paths:
        got, warn = expand_parts(p)
        files.extend(got)
        view.warnings.extend(warn)
    # group rotated segments under their logical journal, preserving
    # expand_parts order (segments arrive oldest-first before their
    # live file, so concatenation reconstructs the written stream)
    streams: list[tuple[str, list[dict]]] = []
    by_base: dict[str, list[dict]] = {}
    for path in files:
        events, bad = read_events(path)
        view.violations.extend(bad)
        base = _segment_base(path)
        if base not in by_base:
            by_base[base] = []
            streams.append((base, by_base[base]))
        by_base[base].extend(events)
    pid = 0
    for path, events in streams:
        shard_spans: list[dict] = []
        shard_instants: list[dict] = []
        fit_used: tuple[float, float] | None = None
        for seg in _segments(events):
            fit = clock_anchor_fit(seg)
            # a shared batch dispatch pulls its member jobs' serve
            # spans AND the shared serve:batch span itself into every
            # member's trace: the causal join a single trace_id match
            # cannot see (members and the leader carry their own ids)
            batches = [
                e for e in seg
                if e.get("event") == "batch_dispatch"
                and _matches(e, trace_id)
            ]
            linked_jobs = {
                j for e in batches for j in (e.get("jobs") or ())
            }
            linked_spans = {
                e.get("span_id") for e in batches if e.get("span_id")
            }
            for e in seg:
                linked = (
                    not _matches(e, trace_id)
                    and e.get("event") == "span"
                    and (
                        (e.get("labels") or {}).get("job_id")
                        in linked_jobs and linked_jobs
                        or e.get("span_id") in linked_spans
                    )
                )
                if not (_matches(e, trace_id) or linked):
                    continue
                mono = e.get("mono")
                if fit is None or not isinstance(mono, (int, float)):
                    continue
                wall = mono + fit[0]
                fit_used = fit
                if e.get("event") == "span":
                    dur = float(e.get("dur_s", 0.0))
                    rec = {
                        "name": e["name"],
                        "start": wall - dur,
                        "end": wall,
                        "dur": dur,
                        "pid": pid,
                        "tid": e.get("tid", 0),
                        "span_id": e.get("span_id"),
                        "parent_span_id": e.get("parent_span_id"),
                        "labels": dict(e.get("labels") or {}),
                    }
                    if linked:
                        rec["labels"]["linked"] = "batch"
                    shard_spans.append(rec)
                else:
                    shard_instants.append({
                        "name": e["event"],
                        "wall": wall,
                        "pid": pid,
                        "args": {
                            k: v for k, v in e.items()
                            if k not in ("v", "ts", "mono", "event")
                        },
                    })
        if shard_spans or shard_instants:
            view.shards.append({
                "path": path,
                "pid": pid,
                "offset": fit_used[0] if fit_used else None,
                "bound": fit_used[1] if fit_used else None,
            })
            view.spans.extend(shard_spans)
            view.instants.extend(shard_instants)
            pid += 1
    return view


def _flow_events(view: TraceView) -> list[dict]:
    """Chrome flow arrows for every cross-process parent -> child edge.

    The arrow starts inside the parent slice and finishes at the child
    slice's start; the flow id is the child's span id (unique per
    edge).  Same-process edges stay implicit — slice nesting already
    shows them."""
    by_id = {
        s["span_id"]: s for s in view.spans if s.get("span_id")
    }
    flows: list[dict] = []
    for child in view.spans:
        parent = by_id.get(child.get("parent_span_id"))
        if parent is None or parent["pid"] == child["pid"]:
            continue
        fid = child["span_id"]
        # the source timestamp must land inside the parent slice
        src_ts = min(max(child["start"], parent["start"]), parent["end"])
        flows.append({
            "name": "causal", "cat": "flow", "ph": "s", "id": fid,
            "ts": src_ts * 1e6, "pid": parent["pid"],
            "tid": parent["tid"],
        })
        flows.append({
            "name": "causal", "cat": "flow", "ph": "f", "bp": "e",
            "id": fid, "ts": child["start"] * 1e6,
            "pid": child["pid"], "tid": child["tid"],
        })
    return flows


def build_trace_chrome(
    journal_paths: list[str], trace_id: str, out_path: str
) -> TraceView:
    """Write the reassembled trace as Perfetto-loadable trace-event
    JSON: one process track per shard (named by file), complete spans,
    instant markers, and cross-process flow arrows.  Returns the view
    (span/track counts, skew bound, violations) for the caller to
    report; writes nothing when the trace has no spans at all."""
    view = extract_trace(journal_paths, trace_id)
    if not view.spans and not view.instants:
        return view
    events: list[dict] = []
    for shard in view.shards:
        events.append(_chrome_process_meta(
            shard["pid"], os.path.basename(shard["path"]),
        ))
    for s in view.spans:
        events.append({
            "name": s["name"], "cat": "span", "ph": "X",
            "ts": s["start"] * 1e6, "dur": s["dur"] * 1e6,
            "pid": s["pid"], "tid": s["tid"],
            "args": {
                **s["labels"],
                **({"span_id": s["span_id"]} if s["span_id"] else {}),
            },
        })
    for i in view.instants:
        events.append({
            "name": i["name"], "cat": "event", "ph": "i", "s": "t",
            "ts": i["wall"] * 1e6, "pid": i["pid"], "tid": 0,
            "args": i["args"],
        })
    events.extend(_flow_events(view))
    _dump_trace(events, out_path)
    return view


# -- critical path -------------------------------------------------------


def critical_path(view: TraceView) -> list[dict]:
    """The chain to shorten first: descend from the trace root span, at
    each level into the child that finishes LAST, until a leaf.  Each
    hop reports its exclusive contribution — its duration minus the
    picked child's — so the rows sum (approximately) to the trace's
    end-to-end wall."""
    spans = [s for s in view.spans if s.get("span_id")]
    if not spans:
        return []
    by_id = {s["span_id"]: s for s in spans}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in spans:
        p = s.get("parent_span_id")
        if p in by_id:
            children.setdefault(p, []).append(s)
        else:
            roots.append(s)
    # the root interval: earliest-starting top-level span (ties: the
    # longest) — with several orphan roots (e.g. rank-local roots whose
    # parent span was never journaled), walk the one that starts first
    cur = min(roots, key=lambda s: (s["start"], -s["end"]))
    path: list[dict] = []
    while cur is not None:
        kids = children.get(cur["span_id"], [])
        nxt = max(kids, key=lambda s: s["end"]) if kids else None
        contrib = cur["dur"] - (nxt["dur"] if nxt is not None else 0.0)
        path.append({
            "name": cur["name"],
            "pid": cur["pid"],
            "start": cur["start"],
            "dur_s": round(cur["dur"], 6),
            "self_s": round(max(contrib, 0.0), 6),
            "labels": cur.get("labels") or {},
        })
        cur = nxt
    return path


def render_critical_path(view: TraceView, out) -> None:
    """The ``specpride stats --trace ID`` rendering."""
    path = critical_path(view)
    if not path:
        print(
            f"trace {view.trace_id}: no spans with causal ids found "
            "(v4 journals emit them when a trace context is installed)",
            file=out,
        )
        return
    total = max(s["end"] for s in view.spans) - min(
        s["start"] for s in view.spans
    )
    print(
        f"trace {view.trace_id}: {len(view.spans)} span(s) across "
        f"{len(view.shards)} process(es), wall {total:.3f}s, "
        f"clock-skew bound {view.skew_bound_s:.4f}s", file=out,
    )
    print("critical path (exclusive seconds per hop):", file=out)
    for i, hop in enumerate(path):
        extras = "".join(
            f" {k}={v}" for k, v in sorted(hop["labels"].items())
            if k in ("job_id", "kernel", "chunk_index", "rank")
        )
        print(
            f"  {'  ' * min(i, 8)}{hop['name']} [pid {hop['pid']}] "
            f"self={hop['self_s']:.3f}s total={hop['dur_s']:.3f}s"
            f"{extras}", file=out,
        )
