"""``stats``: read one or more run journals and print a summary per run,
plus a machine-readable aggregate (``--json``); the port's trimmed copy of
the JAX package's ``observability/stats_cli.py``.

A base path with multi-host ``.part<id>`` shards resolves rank-aware, as
``merge-parts`` resolves outputs.  Exits non-zero on a schema violation,
so a drifting event schema fails the run that reads it.  The port's
journals and the JAX package's read alike (one schema).  ``--top-spans
N`` adds the N slowest spans by self time (``tracing.aggregate_spans``);
``--trace ID`` (``render_critical_path``, in the CLI) renders one causal
trace's critical path instead.  A serving daemon's journal renders its
``serving:`` line (jobs, latency, lanes, batching), with ``--slo`` the
per-method SLO table; ``--follow`` tails one live journal, across its
rotated segments, and renders again as events land.  An elastic rank's
journal renders its ``elastic:`` line (``run_end.elastic``), and the
journals read together the cross-rank view
(``parallel.elastic.summarize_ranks``: ``--json``'s ``elastic`` key).
A flight recorder's ``incident`` events roll up by detector
(``run["incidents"]``: its ``incidents:`` line); ``--incidents`` adds the
per-incident log.  The autotune controller's ``autotune`` events roll up
by knob (``run["autotune"]``: its ``autotune:`` line); ``--autotune`` adds
the per-decision log.  ``warmup`` events give the ``warmstart:`` line
(the port has no XLA compile cache, so no cache counters).
"""

from __future__ import annotations

import json
import sys

from specpride_tpu_torch.observability.journal import (
    expand_parts,
    expand_segments,
    read_events,
    validate_event,
)
from specpride_tpu_torch.observability.tracing import (
    aggregate_spans,
    render_top_spans,
)
from specpride_tpu_torch.parallel.elastic import summarize_ranks
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
    incidents = _summarize_incidents(events)
    if incidents is not None:
        run["incidents"] = incidents
    autotune = _summarize_autotune(events)
    if autotune is not None:
        run["autotune"] = autotune
    warmups = [e for e in events if e["event"] == "warmup"]
    if warmups:
        run["warmstart"] = {
            "kernels_warmed": len(warmups),
            "warmup_cache_hits": sum(1 for e in warmups
                                     if e.get("cache_hit")),
            "warmup_s": round(sum(e.get("seconds", 0.0) for e in warmups),
                              4),
        }
    if start:
        run.update(command=start.get("command"), method=start.get("method"),
                   backend=start.get("backend"),
                   n_clusters=start.get("n_clusters"))
    if chunks:
        rates = [c["clusters_per_sec"] for c in chunks]
        run["mean_chunk_clusters_per_sec"] = round(sum(rates) / len(rates),
                                                   2)
    serving = _summarize_serving(events)
    if serving is not None:
        run["serving"] = serving
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
    # an elastic rank's own summary; the cross-rank view is rendered from
    # all the journals read
    if end.get("elastic"):
        run["elastic"] = end["elastic"]
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


def _summarize_incidents(events: list[dict]) -> dict | None:
    """The flight recorder's rollup (the JAX package's): incidents,
    bundled and suppressed firings in all and by detector, and the log;
    None for a journal without ``incident`` events."""
    inc_events = [e for e in events if e["event"] == "incident"]
    if not inc_events:
        return None
    by_det: dict[str, dict] = {}
    for e in inc_events:
        row = by_det.setdefault(str(e.get("detector")), {
            "incidents": 0, "bundled": 0, "suppressed": 0})
        row["incidents"] += 1
        if e.get("bundled"):
            row["bundled"] += 1
        row["suppressed"] += int(e.get("suppressed") or 0)
    return {
        "mode": inc_events[-1].get("mode"),
        "incidents": len(inc_events),
        "bundled": sum(1 for e in inc_events if e.get("bundled")),
        "suppressed": sum(int(e.get("suppressed") or 0)
                          for e in inc_events),
        "detectors": by_det,
        "log": [{"detector": e.get("detector"),
                 "incident_id": e.get("incident_id"),
                 "clock": e.get("clock"), "reason": e.get("reason"),
                 "bundled": bool(e.get("bundled")),
                 "suppressed": int(e.get("suppressed") or 0),
                 **({"bundle_dir": e["bundle_dir"]}
                    if e.get("bundle_dir") else {})}
                for e in inc_events],
    }


def _summarize_autotune(events: list[dict]) -> dict | None:
    """The controller's rollup (the JAX package's): decisions and acted
    ones in all and by knob (with the last acted value), and the log;
    None for a journal without ``autotune`` events."""
    at_events = [e for e in events if e["event"] == "autotune"]
    if not at_events:
        return None
    knobs: dict[str, dict] = {}
    for e in at_events:
        row = knobs.setdefault(str(e.get("knob")),
                               {"decisions": 0, "acted": 0})
        row["decisions"] += 1
        if e.get("acted"):
            row["acted"] += 1
            row["value"] = e.get("new")
    return {
        "mode": at_events[-1].get("mode"),
        "decisions": len(at_events),
        "acted": sum(1 for e in at_events if e.get("acted")),
        "knobs": knobs,
        "log": [{"knob": e.get("knob"), "old": e.get("old"),
                 "new": e.get("new"), "acted": bool(e.get("acted")),
                 "reason": e.get("reason"), "clock": e.get("clock")}
                for e in at_events],
    }


def _render_autotune(run: dict, out, detail: bool = False) -> None:
    """The controller's line (mode, decisions, acted, each knob's last
    acted value); with ``detail`` (``stats --autotune``) one line per
    decision."""
    at = run.get("autotune")
    if not at:
        if detail:
            print("  autotune: no decisions in this journal (was the run "
                  "booted with --autotune observe|on?)", file=out)
        return
    per_knob = " ".join(f"{k}={row['value']}"
                        for k, row in sorted(at["knobs"].items())
                        if "value" in row)
    print(f"  autotune: mode={at.get('mode')} "
          f"decisions={at['decisions']} acted={at['acted']}"
          + (f" {per_knob}" if per_knob else ""), file=out)
    if detail:
        for d in at["log"]:
            mark = "acted" if d["acted"] else "observed"
            print(f"    {d['knob']}: {d['old']} -> {d['new']} [{mark}] "
                  f"{d['reason']}", file=out)


def _render_warmstart(run: dict, out) -> None:
    ws = run.get("warmstart")
    if ws:
        print(f"  warmstart: kernels_warmed={ws['kernels_warmed']} "
              f"warmup_cache_hits={ws['warmup_cache_hits']} "
              f"warmup_s={ws['warmup_s']}", file=out)


def _render_incidents(run: dict, out, detail: bool = False) -> None:
    """The recorder's line (mode, totals, incidents by detector); with
    ``detail`` (``stats --incidents``) one line per incident."""
    inc = run.get("incidents")
    if not inc:
        if detail:
            print("  incidents: none in this journal (was the run booted "
                  "with --flightrec observe|on?)", file=out)
        return
    per_det = " ".join(f"{d}={row['incidents']}"
                       for d, row in sorted(inc["detectors"].items()))
    print(f"  incidents: mode={inc.get('mode')} "
          f"total={inc['incidents']} bundled={inc['bundled']} "
          f"suppressed={inc['suppressed']}"
          + (f" {per_det}" if per_det else ""), file=out)
    if detail:
        for i in inc["log"]:
            mark = "bundled" if i["bundled"] else "observed"
            sup = (f" (+{i['suppressed']} suppressed)"
                   if i["suppressed"] else "")
            where = f" -> {i['bundle_dir']}" if i.get("bundle_dir") else ""
            print(f"    {i['incident_id']} {i['detector']} "
                  f"@ {i['clock']}: {i['reason']} [{mark}]{sup}{where}",
                  file=out)


def _summarize_serving(events: list[dict]) -> dict | None:
    """A serving daemon's journal (the JAX package's rollup): job
    outcomes, latency and queue wait, per-lane work, the SLO evaluations
    and the shared passes; None for a journal without serving events."""
    serve_ev = next((e for e in events if e["event"] == "serve_start"),
                    None)
    jobs = [e for e in events if e["event"] == "job_done"]
    rejected = [e for e in events if e["event"] == "job_rejected"]
    if not (serve_ev or jobs or rejected):
        return None
    sv: dict = {
        "jobs_done": sum(1 for e in jobs if e.get("status") == "done"),
        "jobs_failed": sum(1 for e in jobs if e.get("status") != "done"),
        "jobs_rejected": len(rejected),
    }
    if serve_ev:
        sv["socket"] = serve_ev.get("socket")
        sv["warmed_kernels"] = serve_ev.get("warmed_kernels", 0)
        if serve_ev.get("workers") is not None:
            sv["n_workers"] = serve_ev.get("workers")
    workers: dict[str, dict] = {}
    for e in jobs:
        w = e.get("worker")
        if w is None:
            continue
        row = workers.setdefault(str(w), {"jobs": 0, "failed": 0,
                                          "busy_s": 0.0})
        row["jobs"] += 1
        if e.get("status") != "done":
            row["failed"] += 1
        if isinstance(e.get("wall_s"), (int, float)):
            row["busy_s"] = round(row["busy_s"] + e["wall_s"], 4)
    if workers:
        sv["workers"] = workers
    walls = [e["wall_s"] for e in jobs]
    if walls:
        sv["mean_wall_s"] = round(sum(walls) / len(walls), 4)
        sv["max_wall_s"] = round(max(walls), 4)
    waits = [e["queue_wait_s"] for e in jobs
             if isinstance(e.get("queue_wait_s"), (int, float))]
    if waits:
        sv["max_queue_wait_s"] = round(max(waits), 4)
    # jobs with no fresh compile (the port compiles nothing per job: all)
    fresh = [e["fresh_compiles"] for e in jobs
             if isinstance(e.get("fresh_compiles"), int)]
    if fresh:
        sv["warm_jobs"] = sum(1 for f in fresh if f == 0)
    slo_jobs = [e for e in jobs if "slo_objective_s" in e]
    if slo_jobs:
        slo: dict = {}
        for e in slo_jobs:
            row = slo.setdefault(str(e.get("method") or "-"), {
                "objective_s": e["slo_objective_s"], "jobs": 0,
                "breaches": 0, "max_latency_s": 0.0})
            row["objective_s"] = e["slo_objective_s"]
            row["jobs"] += 1
            if not e.get("slo_ok", True):
                row["breaches"] += 1
            lat = e.get("slo_latency_s")
            if isinstance(lat, (int, float)):
                row["max_latency_s"] = max(row["max_latency_s"], lat)
        for row in slo.values():
            row["burn_frac"] = round(row["breaches"] / row["jobs"], 4)
            row["max_latency_s"] = round(row["max_latency_s"], 4)
        sv["slo"] = slo
        sv["slo_breaches"] = sum(r["breaches"] for r in slo.values())
    shared = [e for e in events if e["event"] == "batch_dispatch"
              and e.get("status") == "shared"]
    fellback = sum(1 for e in events if e["event"] == "batch_dispatch"
                   and e.get("status") == "fallback_solo")
    if shared or fellback:
        bt: dict = {
            "dispatches": len(shared),
            "batched_jobs": sum(e.get("n_jobs", 0) for e in shared),
            "clusters": sum(e.get("n_clusters", 0) for e in shared),
        }
        if shared:
            bt["max_jobs"] = max(e.get("n_jobs", 0) for e in shared)
            bt["mean_occupancy"] = round(
                sum(e.get("bucket_occupancy_frac", 0.0) for e in shared)
                / len(shared), 4)
            bt["mean_window_wait_s"] = round(
                sum(e.get("window_wait_s", 0.0) for e in shared)
                / len(shared), 4)
        if fellback:
            bt["fallback_solo"] = fellback
        sv["batching"] = bt
    monos = [e["mono"] for e in jobs if isinstance(e.get("mono"),
                                                   (int, float))]
    anchor = (serve_ev.get("mono") if serve_ev
              else (min(monos) if monos else 0))
    if jobs and isinstance(anchor, (int, float)) and monos:
        span = max(monos) - anchor
        if span > 0:
            sv["jobs_per_sec"] = round(len(jobs) / span, 3)
    return sv


def _render_serving(sv: dict, out) -> None:
    """The daemon's line: job outcomes, warm jobs, latency, queue
    pressure, lanes; then the shared passes and each lane's work."""
    bits = [f"jobs_done={sv.get('jobs_done', 0)}",
            f"failed={sv.get('jobs_failed', 0)}",
            f"rejected={sv.get('jobs_rejected', 0)}"]
    for key, label in (("warm_jobs", "warm"), ("mean_wall_s", None),
                       ("max_queue_wait_s", None), ("jobs_per_sec", None),
                       ("warmed_kernels", None), ("slo_breaches", None),
                       ("n_workers", "workers")):
        if key in sv:
            bits.append(f"{label or key}={sv[key]}")
    print(f"  serving: {' '.join(bits)}", file=out)
    bt = sv.get("batching")
    if bt:
        bbits = [f"dispatches={bt.get('dispatches', 0)}",
                 f"jobs={bt.get('batched_jobs', 0)}",
                 f"clusters={bt.get('clusters', 0)}"]
        for key in ("max_jobs", "mean_occupancy", "mean_window_wait_s"):
            if key in bt:
                bbits.append(f"{key}={bt[key]}")
        if bt.get("fallback_solo"):
            bbits.append(f"fallback_solo={bt['fallback_solo']}")
        print(f"  batching: {' '.join(bbits)}", file=out)
    workers = sv.get("workers") or {}
    for w in sorted(workers, key=lambda k: (len(k), k)):
        row = workers[w]
        failed = f" failed={row['failed']}" if row.get("failed") else ""
        print(f"    worker {w}: jobs={row['jobs']}{failed} "
              f"busy_s={row['busy_s']}", file=out)


def _render_slo(run: dict, out) -> None:
    """``stats --slo``: the per-method SLO table of a serving journal."""
    slo = (run.get("serving") or {}).get("slo")
    if not slo:
        print("  slo: no SLO-evaluated jobs in this journal (was the "
              "daemon booted with --slo?)", file=out)
        return
    for method in sorted(slo):
        row = slo[method]
        print(f"  slo: method={method} objective_s={row['objective_s']} "
              f"jobs={row['jobs']} breaches={row['breaches']} "
              f"burn={row['burn_frac']:.1%} "
              f"max_latency_s={row['max_latency_s']}", file=out)


def _render_rank_view(view: dict, out) -> None:
    """The cross-rank view (``summarize_ranks``): one line per rank from
    the ranks' ``.part<rank>`` journals, with the expiry and split
    pairing audit."""
    audit = view.get("unpaired_lease_expiries", 0)
    state = "UNPAIRED" if audit else "unpaired"
    print(f"ranks: {len(view.get('ranks', {}))} seen, "
          f"{view.get('reassignments', 0)} reassignment(s), "
          f"{view.get('lease_splits', 0)} split(s), "
          f"{audit} {state} lease expiries/splits", file=out)
    for rank, r in view.get("ranks", {}).items():
        age = r.get("last_heartbeat_age_s")
        bits = [f"last_heartbeat_age_s={age if age is not None else '-'}",
                f"chunks={r.get('chunks_committed', 0)}",
                f"ranges={r.get('ranges_claimed', 0)}"]
        for key in ("takeovers", "leases_expired", "reassigned_away",
                    "lease_splits", "steals"):
            if r.get(key):
                bits.append(f"{key}={r[key]}")
        # silent past its TTL while holding leases, never expired: the
        # rank a live fleet should be stealing from
        slow = "slow: " if r.get("slow") else ""
        print(f"  rank {rank}: {slow}{' '.join(bits)}", file=out)


def _render_run(run: dict, out, slo: bool = False,
                incidents: bool = False, autotune: bool = False) -> None:
    print(f"{run['journal']}: {run.get('command', '?')}"
          f"/{run.get('method', '?')} backend={run.get('backend', '?')}",
          file=out)
    live = run.get("serving")
    if not run["complete"]:
        print("  INCOMPLETE — no run_end event ("
              + ("live daemon or crashed" if live
                 else "crashed or still running")
              + f"); {run['chunks']} chunk(s) journaled", file=out)
        if "last_chunk" in run:
            lc = run["last_chunk"]
            print(f"  last heartbeat: chunk {lc['chunk_index']} "
                  f"({lc['n_clusters']} clusters, "
                  f"{lc['clusters_per_sec']:.1f} cl/s)", file=out)
        if live:
            _render_serving(live, out)
            if slo:
                _render_slo(run, out)
        _render_autotune(run, out, detail=autotune)
        _render_incidents(run, out, detail=incidents)
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
    if live:
        _render_serving(live, out)
        if slo:
            _render_slo(run, out)
    _render_autotune(run, out, detail=autotune)
    _render_incidents(run, out, detail=incidents)
    _render_warmstart(run, out)
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
    el = run.get("elastic")
    if el:
        extras = "".join(f" {key}={el[key]}"
                         for key in ("lease_splits", "steals",
                                     "cas_conflicts") if el.get(key))
        print(f"  elastic: rank={el.get('rank')} "
              f"ranges_run={el.get('ranges_run')}/{el.get('n_ranges')} "
              f"committed={el.get('ranges_committed')} "
              f"reassignments={el.get('reassignments', 0)}{extras}",
              file=out)
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


def _read_new_events(path: str, offset: int) -> tuple[list[dict], int]:
    """The complete journal lines past ``offset``: ``(events, new
    offset)``.  Reads only up to the last newline, so a line being
    written is read whole on a later poll; a missing file is nothing new;
    a line that breaks the schema is skipped (a live tail keeps
    rendering)."""
    try:
        with open(path, "rb") as fh:
            fh.seek(offset)
            blob = fh.read()
    except FileNotFoundError:
        return [], offset
    end = blob.rfind(b"\n")
    if end < 0:
        return [], offset
    chunk = blob[:end + 1]
    events: list[dict] = []
    for line in chunk.decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not validate_event(rec):
            events.append(rec)
    return events, offset + len(chunk)


def _poll_rotated(path: str, offset: int,
                  segs_seen: int) -> tuple[list[dict], int, int]:
    """One ``--follow`` poll across a rotation: when new numbered
    segments appeared, the file being tailed was renamed; the first new
    segment is read on from the old offset, later ones whole, then the
    fresh live file from 0.  Returns ``(events, offset, segs_seen)``."""
    rotated = [p for p in expand_segments(path) if p != path]
    events: list[dict] = []
    if len(rotated) > segs_seen:
        for i, seg in enumerate(rotated[segs_seen:]):
            evs, _ = _read_new_events(seg, offset if i == 0 else 0)
            events.extend(evs)
        segs_seen = len(rotated)
        offset = 0
    evs, offset = _read_new_events(path, offset)
    events.extend(evs)
    return events, offset, segs_seen


def follow_stats(path: str, out=None, interval: float = 1.0, stop=None,
                 max_updates: int = 0, top_spans: int = 0,
                 slo: bool = False, incidents: bool = False,
                 autotune: bool = False) -> int:
    """``stats --follow``: tail one live journal and render its last run
    again each time complete events land.  ``stop`` (a
    ``threading.Event``) and ``max_updates`` end it from a program;
    Ctrl-C ends it with 0."""
    import time

    out = out or sys.stdout
    offset = 0
    # segments rotated before the follow began are history
    segs_seen = len([p for p in expand_segments(path) if p != path])
    events: list[dict] = []
    updates = 0
    try:
        while True:
            new_events, offset, segs_seen = _poll_rotated(path, offset,
                                                          segs_seen)
            if new_events:
                events.extend(new_events)
                # only the last run is rendered: keep O(current run)
                for i in range(len(events) - 1, 0, -1):
                    if events[i]["event"] == "run_start":
                        del events[:i]
                        break
                updates += 1
                segments = _split_runs(events) or [[]]
                print(f"--- {time.strftime('%H:%M:%S')} update {updates}: "
                      f"{len(events)} event(s) ---", file=out)
                _render_run(_summarize_run(path, segments[-1]), out,
                            slo=slo, incidents=incidents, autotune=autotune)
                view = summarize_ranks([segments[-1]])
                if view is not None:
                    _render_rank_view(view, out)
                if top_spans:
                    render_top_spans(aggregate_spans([events]), top_spans,
                                     out)
                try:
                    out.flush()
                except (AttributeError, OSError):
                    pass
            if stop is not None and stop.is_set():
                return 0
            if max_updates and updates >= max_updates:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def run_stats(journal_paths: list[str], json_out: str | None = None,
              out=None, top_spans: int = 0, slo: bool = False,
              incidents: bool = False, autotune: bool = False) -> int:
    """Summarize the journals at ``journal_paths`` on ``out`` (stdout),
    with the ``top_spans`` slowest spans when above 0, with ``slo`` a
    serving daemon's SLO table, with ``incidents`` the flight recorder's
    incident log and with ``autotune`` the controller's decision log; 1
    when no file was found or an event broke
    the schema."""
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
        _render_run(run, out, slo=slo, incidents=incidents,
                    autotune=autotune)
    rank_view = summarize_ranks(events_per_file)
    if rank_view is not None:
        _render_rank_view(rank_view, out)
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
        if rank_view is not None:
            agg["elastic"] = rank_view
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
