"""``stats``: read one or more run journals and print a summary per run,
plus a machine-readable aggregate (``--json``); the port's trimmed copy of
the JAX package's ``observability/stats_cli.py``.

A base path with multi-host ``.part<id>`` shards resolves rank-aware, as
``merge-parts`` resolves outputs.  Exits non-zero on a schema violation,
so a drifting event schema fails the run that reads it.  The port's
journals and the JAX package's read alike (one schema).  ``--top-spans
N`` adds the N slowest spans by self time (``tracing.aggregate_spans``);
``--trace ID`` (``render_critical_path``, in the CLI) renders one causal
trace's critical path instead.  Left out: the elastic rank view, the
serving, autotune and incident views, and ``--follow``.
"""

from __future__ import annotations

import json
import sys

from specpride_tpu_torch.observability.journal import (
    expand_parts,
    read_events,
)
from specpride_tpu_torch.observability.tracing import (
    aggregate_spans,
    render_top_spans,
)
from specpride_tpu_torch.robustness.faults import audit_fault_recovery

ROBUSTNESS_EVENTS = ("fault", "retry", "degrade", "quarantine",
                     "resume_repair", "watchdog_stall")


def _split_runs(events: list[dict]) -> list[list[dict]]:
    """One journal's events cut into runs at each ``run_start``: a resumed
    run appends to the same journal."""
    segments: list[list[dict]] = []
    for e in events:
        if e["event"] == "run_start" or not segments:
            segments.append([])
        segments[-1].append(e)
    return segments


def _summarize_run(path: str, events: list[dict]) -> dict:
    names = [e["event"] for e in events]
    start = next((e for e in events if e["event"] == "run_start"), None)
    end = next((e for e in reversed(events) if e["event"] == "run_end"),
               None)
    chunks = [e for e in events if e["event"] == "chunk_done"]
    skipped = sum(len(e.get("cluster_ids", ())) for e in events
                  if e["event"] == "skipped_clusters")
    run: dict = {
        "journal": path,
        "n_events": len(events),
        "complete": end is not None,
        "resumes": names.count("resume"),
        "chunks": len(chunks),
        "skipped_clusters": skipped,
    }
    rb_counts = {kind: names.count(kind) for kind in ROBUSTNESS_EVENTS}
    if any(rb_counts.values()) or (end or {}).get("robustness"):
        rb: dict = {k: v for k, v in rb_counts.items() if v}
        rb["unrecovered_faults"] = len(audit_fault_recovery(events))
        if end and end.get("robustness"):
            rb["run_end"] = end["robustness"]
        run["robustness"] = rb
    if start:
        run.update(command=start.get("command"), method=start.get("method"),
                   backend=start.get("backend"),
                   n_clusters=start.get("n_clusters"))
    if chunks:
        rates = [c["clusters_per_sec"] for c in chunks]
        run["mean_chunk_clusters_per_sec"] = round(sum(rates) / len(rates),
                                                   2)
    compiles, dispatches = names.count("compile"), names.count("dispatch")
    if not end:
        # a dead run: the heartbeats are all there is
        run["compile_count"] = compiles
        run["dispatch_count"] = dispatches
        if chunks:
            run["last_chunk"] = chunks[-1]
        return run
    device = end.get("device", {})
    run.update(
        counters=end.get("counters", {}),
        phases_s=end.get("phases_s", {}),
        elapsed_s=end.get("elapsed_s"),
        representatives_written=end.get("representatives_written"),
        compile_count=max(compiles, device.get("compiles", 0)),
        dispatch_count=max(dispatches, device.get("dispatches", 0)),
        padding_waste_frac=device.get("padding_waste_frac", 0.0),
        bucket_occupancy_frac=device.get("bucket_occupancy_frac", 0.0),
        bytes_h2d=device.get("bytes_h2d", 0),
        bytes_d2h=device.get("bytes_d2h", 0),
        device_peak_bytes_in_use=device.get("device_peak_bytes_in_use", 0),
    )
    if end.get("precision"):
        run["precision"] = end["precision"]
    # the result cache's accounting, the event just before run_end
    rc_ev = next((e for e in reversed(events)
                  if e["event"] == "result_cache"), None)
    if rc_ev is not None:
        hits = int(rc_ev.get("hits") or 0)
        misses = int(rc_ev.get("misses") or 0)
        rc: dict = {
            "hits": hits,
            "misses": misses,
            "hit_rate": (round(hits / (hits + misses), 4)
                         if hits + misses else 0.0),
            "populated": int(rc_ev.get("populated") or 0),
            "evictions": int(rc_ev.get("evictions") or 0),
            "bytes_saved": int(rc_ev.get("bytes_saved") or 0),
        }
        for opt in ("shared_hits", "corrupt", "entries", "bytes"):
            if rc_ev.get(opt) is not None:
                rc[opt] = rc_ev[opt]
        run["result_cache"] = rc
    pipeline = end.get("pipeline")
    if pipeline:
        for key in ("prefetch", "device_idle_s", "overlap_efficiency",
                    "pack_workers", "async_write", "wall_s", "pack_busy_s",
                    "write_busy_s", "reorder_stall_s", "h2d"):
            if pipeline.get(key) is not None:
                run[key] = pipeline[key]
    return run


def _render_run(run: dict, out) -> None:
    print(f"{run['journal']}: {run.get('command', '?')}"
          f"/{run.get('method', '?')} backend={run.get('backend', '?')}",
          file=out)
    if not run["complete"]:
        print("  INCOMPLETE — no run_end event (crashed or still running); "
              f"{run['chunks']} chunk(s) journaled", file=out)
        if "last_chunk" in run:
            lc = run["last_chunk"]
            print(f"  last heartbeat: chunk {lc['chunk_index']} "
                  f"({lc['n_clusters']} clusters, "
                  f"{lc['clusters_per_sec']:.1f} cl/s)", file=out)
        return
    counters = run.get("counters", {})
    print(f"  clusters={counters.get('clusters', 0)} "
          f"representatives={run.get('representatives_written') or 0} "
          f"elapsed={run.get('elapsed_s', 0):.3f}s "
          f"chunks={run['chunks']} resumes={run['resumes']} "
          f"skipped={run['skipped_clusters']}", file=out)
    phases = run.get("phases_s", {})
    if phases:
        print("  phases: " + " ".join(f"{k}={v:.3f}s"
                                      for k, v in sorted(phases.items())),
              file=out)
    if run.get("device_idle_s") is not None:
        print(f"  pipeline: prefetch={run.get('prefetch')} "
              f"pack_workers={run.get('pack_workers')} "
              f"device_idle_s={run['device_idle_s']:.3f} "
              f"overlap_efficiency={run.get('overlap_efficiency')}",
              file=out)
    rb = run.get("robustness")
    if rb:
        bits = " ".join(f"{k}={rb[k]}" for k in ROBUSTNESS_EVENTS
                        if rb.get(k))
        state = "UNRECOVERED" if rb.get("unrecovered_faults") else "recovered"
        print(f"  robustness: {bits or 'armed, no events'} "
              f"({rb.get('unrecovered_faults', 0)} {state})", file=out)
    print(f"  device: compile_count={run['compile_count']} "
          f"dispatches={run['dispatch_count']} "
          f"padding_waste_frac={run['padding_waste_frac']} "
          f"bucket_occupancy_frac={run['bucket_occupancy_frac']} "
          f"h2d={run['bytes_h2d']}B d2h={run['bytes_d2h']}B "
          f"peak_device_mem={run['device_peak_bytes_in_use']}B", file=out)
    rc = run.get("result_cache")
    if rc:
        bits = [f"hits={rc['hits']}", f"misses={rc['misses']}",
                f"hit_rate={rc['hit_rate']:.1%}",
                f"evictions={rc['evictions']}",
                f"bytes_saved={rc['bytes_saved']}"]
        if rc.get("corrupt"):
            bits.append(f"corrupt={rc['corrupt']}")
        if rc.get("entries") is not None:
            bits.append(f"entries={rc['entries']}")
        print(f"  result-cache: {' '.join(bits)}", file=out)
    prec = run.get("precision")
    if prec:
        bits = [f"precision={prec.get('precision')}"]
        if prec.get("gated"):
            bits.append(f"gate={'ok' if prec.get('ok') else 'FAILED'} "
                        f"min_cosine={prec.get('min_cosine')} "
                        f"tolerance={prec.get('tolerance')} "
                        f"checked={prec.get('checked')}")
        print(f"  precision: {' '.join(bits)}", file=out)


def run_stats(journal_paths: list[str], json_out: str | None = None,
              out=None, top_spans: int = 0) -> int:
    """Summarize the journals at ``journal_paths`` on ``out`` (stdout),
    with the ``top_spans`` slowest spans when above 0; 1 when no file was
    found or an event broke the schema."""
    out = out or sys.stdout
    files: list[str] = []
    for p in journal_paths:
        got, warnings = expand_parts(p)
        files.extend(got)
        for w in warnings:
            print(f"warning: {w}", file=sys.stderr)
    if not files:
        print("no journal files to read", file=sys.stderr)
        return 1
    runs: list[dict] = []
    violations: list[str] = []
    events_per_file: list[list[dict]] = []
    for path in files:
        events, bad = read_events(path)
        violations.extend(bad)
        events_per_file.append(events)
        segments = _split_runs(events) or [[]]
        for i, seg in enumerate(segments):
            label = path if len(segments) == 1 else f"{path}#run{i}"
            runs.append(_summarize_run(label, seg))
    for run in runs:
        _render_run(run, out)
    span_rows = aggregate_spans(events_per_file) if top_spans else []
    if top_spans:
        render_top_spans(span_rows, top_spans, out)
    totals = {
        "n_journals": len(files),
        "n_runs_complete": sum(r["complete"] for r in runs),
        "clusters": sum(r.get("counters", {}).get("clusters", 0)
                        for r in runs),
        "representatives_written": sum(r.get("representatives_written") or 0
                                       for r in runs),
        "skipped_clusters": sum(r["skipped_clusters"] for r in runs),
        "compile_count": sum(r.get("compile_count", 0) for r in runs),
    }
    if len(runs) > 1:
        print(f"TOTAL: {totals['n_journals']} journals, "
              f"{totals['clusters']} clusters, "
              f"{totals['representatives_written']} representatives, "
              f"{totals['compile_count']} compiles", file=out)
    if json_out:
        agg = {"v": 1, "runs": runs, "totals": totals}
        if top_spans:
            agg["top_spans"] = span_rows[:top_spans]
        with open(json_out, "w", encoding="utf-8") as fh:
            json.dump(agg, fh, indent=1)
            fh.write("\n")
    if violations:
        for v in violations:
            print(f"schema violation: {v}", file=sys.stderr)
        print(f"{len(violations)} schema violation(s)", file=sys.stderr)
        return 1
    return 0
