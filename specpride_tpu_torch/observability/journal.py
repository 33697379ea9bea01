"""Run journal: an append-only JSONL event stream (``--journal FILE``), the
port's trimmed copy of the JAX package's ``observability/journal.py``.

Every line is one JSON object with the envelope fields ``v`` (schema
version), ``ts`` (unix seconds), ``mono`` (``time.perf_counter()``
seconds) and ``event``, plus the payload ``EVENT_SCHEMA`` requires for
that event.  The schema is the JAX package's, so its ``read_events``,
``validate_event`` and ``stats`` read the port's journals, and the port's
read theirs.  The tables carry other names than the JAX package's: its
lint finds its schema anchors by name across the repository, and each
name must stay unique there.

Left out: rotation (``--journal-rotate-mb``, a serving-daemon flag), the
in-process taps (autotune, flight recorder) and the trace-context
binding (the span tracer's).  Multi-host runs write one journal per rank
(``<journal>.part<id>``); ``expand_parts`` resolves a base path to its
rank-ordered parts, each after its rotated segments if a JAX daemon left
any.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time

SCHEMA_VERSION = 7

# v3 is reserved (a docs-only revision); a v3 journal reads like v2
ACCEPTED_VERSIONS = frozenset({1, 2, 3, 4, 5, 6, SCHEMA_VERSION})

# event -> required payload fields (the JAX package's EVENT_FIELDS; the
# envelope is implied and extra fields are allowed)
EVENT_SCHEMA: dict[str, frozenset] = {
    "run_start": frozenset({"command", "method", "backend", "n_clusters"}),
    "chunk_start": frozenset({"chunk_index", "n_clusters"}),
    "chunk_done": frozenset(
        {"chunk_index", "n_clusters", "n_representatives", "elapsed_s",
         "clusters_per_sec"}
    ),
    "compile": frozenset({"kernel", "shape_key"}),
    "dispatch": frozenset({"kernel", "rows", "padded_rows"}),
    "checkpoint_write": frozenset({"n_done", "output_bytes"}),
    "resume": frozenset({"n_done"}),
    "qc_failure": frozenset({"cluster_ids"}),
    "skipped_clusters": frozenset({"cluster_ids"}),
    "routing": frozenset({"method", "path", "reason"}),
    "precision": frozenset({"method", "precision"}),
    "fault": frozenset({"site", "kind", "visit"}),
    "retry": frozenset({"site", "attempt", "backoff_s"}),
    "degrade": frozenset({"action", "reason"}),
    "resume_repair": frozenset({"action", "reason"}),
    "quarantine": frozenset({"path", "reason"}),
    "watchdog_stall": frozenset({"lane", "elapsed_s"}),
    "heartbeat": frozenset({"rank"}),
    "lease_claim": frozenset({"rank", "range"}),
    "lease_expire": frozenset({"rank", "range"}),
    "chunk_reassign": frozenset({"range", "from_rank", "to_rank"}),
    "lease_split": frozenset({"range", "new_range", "rank", "split_at"}),
    "rank_spawn": frozenset({"pid"}),
    "rank_retire": frozenset({"pid", "reason"}),
    "clock_anchor": frozenset({"wall", "uncertainty_s"}),
    "compile_cache": frozenset({"enabled"}),
    "warmup": frozenset({"kernel", "cache_hit", "seconds"}),
    "serve_start": frozenset({"socket", "max_queue"}),
    "job_queued": frozenset({"job_id", "client"}),
    "job_start": frozenset({"job_id"}),
    "job_done": frozenset({"job_id", "status", "wall_s"}),
    "job_rejected": frozenset({"reason"}),
    "batch_dispatch": frozenset(
        {"batch_id", "jobs", "n_jobs", "n_clusters", "window_wait_s",
         "status"}
    ),
    "serve_drain": frozenset({"n_rejected"}),
    "autotune": frozenset(
        {"knob", "mode", "old", "new", "reason", "signal", "acted"}
    ),
    "incident": frozenset({"detector", "reason", "clock", "mode",
                           "bundled"}),
    "result_cache": frozenset(
        {"hits", "misses", "populated", "evictions", "bytes_saved"}
    ),
    "profile_start": frozenset({"seconds"}),
    "profile_done": frozenset({"seconds", "trace_dir"}),
    "bench_run": frozenset({"method", "phases_s"}),
    "run_end": frozenset({"counters", "phases_s", "elapsed_s", "device"}),
    "span": frozenset({"name", "dur_s", "depth"}),
}

# fields required from schema v4 (the causal trace envelope), v5 and v6
# on, version-gated in validate_event as in the JAX package
TRACE_EVENT_SCHEMA: dict[str, frozenset] = {
    "job_queued": frozenset({"trace_id"}),
    "job_start": frozenset({"trace_id"}),
    "job_done": frozenset({"trace_id"}),
    "batch_dispatch": frozenset({"trace_ids"}),
    "autotune": frozenset({"trace_ids"}),
    "incident": frozenset({"trace_id"}),
}
V5_EVENT_SCHEMA: dict[str, frozenset] = {
    "heartbeat": frozenset({"chunk_s"}),
}
V6_EVENT_SCHEMA: dict[str, frozenset] = {
    "incident": frozenset({"incident_id", "evidence"}),
}
_GATED = ((4, TRACE_EVENT_SCHEMA, "v4 trace fields"),
          (5, V5_EVENT_SCHEMA, "v5 fields"),
          (6, V6_EVENT_SCHEMA, "v6 fields"))

_TRACE_ID_RE = re.compile(r"[0-9a-f]{32}")
_SPAN_ID_RE = re.compile(r"[0-9a-f]{16}")


def _json_default(obj):
    """A numpy scalar in a payload must never crash a run."""
    for cast in (int, float):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return str(obj)


class Journal:
    """Append-only JSONL event writer, line-buffered so each event reaches
    the file as one whole line (tailable mid-run; a crash loses at most
    the line being written).  The dispatch lane, the pack workers, the
    write lane and the watchdog share one journal: a lock keeps each line
    whole.  A torn last line left by a killed run is ended before the
    first new event, so a resumed run appending to the same path writes
    whole lines."""

    enabled = True

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", buffering=1, encoding="utf-8")
        try:
            with open(self.path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() > 0:
                    fh.seek(-1, os.SEEK_END)
                    if fh.read(1) != b"\n":
                        self._fh.write("\n")
        except OSError:
            pass

    def emit(self, event: str, **fields) -> dict:
        rec = {"v": SCHEMA_VERSION, "ts": time.time(),
               "mono": time.perf_counter(), "event": event}
        rec.update(fields)
        line = json.dumps(rec, default=_json_default) + "\n"
        with self._lock:
            # a late event from a lane racing close() is dropped, not
            # written to a closed file
            if not self._fh.closed:
                self._fh.write(line)
        return rec

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullJournal:
    """No-op stand-in, so call sites never branch on whether --journal
    was given."""

    enabled = False
    path = None

    def emit(self, event: str, **fields) -> dict:
        return {}

    def close(self) -> None:
        pass


def open_journal(path: str | None) -> Journal | NullJournal:
    return Journal(path) if path else NullJournal()


def emit_clock_anchor(journal) -> dict:
    """One wall<->mono pair: ``wall`` read between two ``perf_counter``
    reads, the envelope ``mono`` their midpoint, ``uncertainty_s`` half
    their distance (the JAX package's anchor, which its trace merger
    aligns processes by)."""
    t0 = time.perf_counter()
    wall = time.time()
    t1 = time.perf_counter()
    return journal.emit("clock_anchor", mono=(t0 + t1) / 2.0, wall=wall,
                        uncertainty_s=round((t1 - t0) / 2.0, 9))


def validate_event(rec: object) -> list[str]:
    """Schema-violation messages for one decoded journal line (empty when
    valid), the JAX package's rules."""
    if not isinstance(rec, dict):
        return [f"event is not an object: {rec!r}"]
    problems: list[str] = []
    if rec.get("v") not in ACCEPTED_VERSIONS:
        problems.append(f"unsupported schema version {rec.get('v')!r}")
    if not isinstance(rec.get("ts"), (int, float)):
        problems.append("missing/non-numeric 'ts'")
    if rec.get("v") == 2 and not isinstance(rec.get("mono"), (int, float)):
        problems.append("missing/non-numeric 'mono' (required in v2)")
    event = rec.get("event")
    required = EVENT_SCHEMA.get(event)
    if required is None:
        problems.append(f"unknown event type {event!r}")
    else:
        missing = sorted(required - rec.keys())
        if missing:
            problems.append(f"{event}: missing fields {missing}")
        version = rec.get("v", 0)
        for since, table, what in _GATED:
            if isinstance(version, int) and version >= since:
                missing = sorted(table.get(event, frozenset()) - rec.keys())
                if missing:
                    problems.append(f"{event}: missing {what} {missing}")
    tid = rec.get("trace_id")
    if tid is not None and not (isinstance(tid, str)
                                and _TRACE_ID_RE.fullmatch(tid)):
        problems.append(f"malformed trace_id {tid!r} (need 32 hex chars)")
    for key in ("span_id", "parent_span_id"):
        sid = rec.get(key)
        if sid is not None and not (isinstance(sid, str)
                                    and _SPAN_ID_RE.fullmatch(sid)):
            problems.append(f"malformed {key} {sid!r} (need 16 hex chars)")
    return problems


def read_events(path: str) -> tuple[list[dict], list[str]]:
    """Decode one journal file: ``(valid events, violations)``, each
    violation prefixed ``path:line:``.  Only valid events are returned,
    so readers may index their required fields."""
    events: list[dict] = []
    violations: list[str] = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                violations.append(f"{path}:{lineno}: invalid JSON ({e.msg})")
                continue
            problems = validate_event(rec)
            violations.extend(f"{path}:{lineno}: {p}" for p in problems)
            if not problems:
                events.append(rec)
    return events, violations


def expand_segments(path: str) -> list[str]:
    """A journal's rotated segments (``<path>.1``, ``.2``, ...; the whole
    suffix digits) and then the live file, oldest first; absent paths
    are left out."""
    numbered = []
    for seg in glob.glob(glob.escape(path) + ".*"):
        suffix = seg[len(path) + 1:]
        if suffix.isdigit():
            numbered.append((int(suffix), seg))
    out = [seg for _, seg in sorted(numbered)]
    if os.path.exists(path):
        out.append(path)
    return out


def expand_parts(path: str) -> tuple[list[str], list[str]]:
    """A journal path's files, rank-aware like ``merge-parts``: the path
    itself (after its segments) if it exists, else its
    ``<path>.part<id>`` shards ordered by rank number, each after its
    segments.  Returns ``(paths, warnings)``; a gap in the ranks is a
    warning, so a dead run's surviving ranks still read."""
    if os.path.exists(path):
        return expand_segments(path), []
    parts = glob.glob(glob.escape(path) + ".part*")
    if not parts:
        return [], [f"no journal at {path} and no {path}.part* shards"]
    ranked, warnings = [], []
    for p in parts:
        suffix = p.rsplit(".part", 1)[1]
        if suffix.isdigit():
            ranked.append((int(suffix), p))
        elif not re.fullmatch(r"\d+\.\d+", suffix):  # not a part's segment
            warnings.append(f"unrecognized part name {p}")
    ranked.sort()
    ranks = [r for r, _ in ranked]
    missing = sorted(set(range(max(ranks) + 1)) - set(ranks)) if ranks else []
    if missing:
        warnings.append(f"{path}: rank gap — have {ranks}, missing {missing} "
                        "(a rank died before writing its journal?)")
    out: list[str] = []
    for _, p in ranked:
        out.extend(expand_segments(p))
    return out, warnings
