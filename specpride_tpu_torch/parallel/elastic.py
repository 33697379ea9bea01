"""The consumers of an elastic run's records (the port's copy of the JAX
package's ``parallel/elastic.py``), shared by ``stats``, ``merge-parts``
and the tests:

* :func:`audit_elastic`: every ``lease_expire`` and every
  ``lease_split`` must pair with a ``chunk_reassign`` of its range, or
  work was lost;
* :func:`summarize_ranks`: the per-rank rollup ``stats`` renders from
  the ranks' ``.part<rank>`` journals;
* :func:`elastic_range_table`, :func:`read_done_marker`: the effective
  ranges (the plan, the stolen tails, the cuts) in cluster order, and
  each range's commit marker;
* :func:`sha256_file`, :func:`verify_part_manifest`,
  :func:`merge_qc_reports`: ``merge-parts``'s checks and its QC merge,
  for static and elastic parts alike.
"""

from __future__ import annotations

import json
import os
import statistics

from specpride_tpu_torch.parallel.coordinator import plan_ranges
from specpride_tpu_torch.parallel.store import store_from_spec
from specpride_tpu_torch.robustness.integrity import OutputIntegrity


def audit_elastic(events: list[dict]) -> list[dict]:
    """Unpaired work-movement events.  Two pairings are audited the
    same way:

    * every ``lease_expire`` must pair with a ``chunk_reassign`` for
      the same range (a dead rank's work actually moved);
    * every ``lease_split`` must pair with a ``chunk_reassign`` for its
      ``new_range`` (a split-off tail was actually claimed — a ratified
      split nobody picked up is lost work exactly like an unreassigned
      expiry).

    Feed MERGED events from every rank's journal — an expiry and its
    reassignment live in the observer's journal, but a split lives in
    the DONOR's journal while the reassignment lives in the claimer's,
    so a multi-file audit must never depend on which file an event came
    from."""
    reassigned: dict[int, int] = {}
    for e in events:
        if e.get("event") == "chunk_reassign":
            k = e.get("range")
            if isinstance(k, int):
                reassigned[k] = reassigned.get(k, 0) + 1
    unmatched = []
    for e in events:
        ev = e.get("event")
        if ev == "lease_expire":
            k = e.get("range")
        elif ev == "lease_split":
            k = e.get("new_range")
        else:
            continue
        if isinstance(k, int) and reassigned.get(k, 0) > 0:
            reassigned[k] -= 1
        else:
            unmatched.append(e)
    return unmatched


def summarize_ranks(events_per_file: list[list[dict]]) -> dict | None:
    """The multi-host rank view: one row per rank seen across the
    journals, plus the expiry/reassignment pairing audit.  Returns None
    when no elastic events exist (non-elastic journals render as
    before)."""
    ranks: dict[int, dict] = {}

    def row(r) -> dict:
        return ranks.setdefault(int(r), {
            "heartbeats": 0, "last_heartbeat_ts": None,
            "last_holding": [], "ttl": None,
            "ranges_claimed": 0, "takeovers": 0, "chunks_committed": 0,
            "leases_expired": 0, "reassigned_away": 0,
            "lease_splits": 0, "steals": 0,
        })

    saw_elastic = False
    max_ts = None
    for events in events_per_file:
        # chunk_done events carry no rank: attribute them to the rank
        # whose elastic events share the file (one journal per rank)
        file_rank = None
        chunk_done = 0
        for e in events:
            ts = e.get("ts")
            if isinstance(ts, (int, float)):
                max_ts = ts if max_ts is None else max(max_ts, ts)
            ev = e.get("event")
            if ev == "heartbeat":
                saw_elastic = True
                r = row(e.get("rank", -1))
                r["heartbeats"] += 1
                if isinstance(ts, (int, float)) and (
                    r["last_heartbeat_ts"] is None
                    or ts >= r["last_heartbeat_ts"]
                ):
                    r["last_heartbeat_ts"] = ts
                    holding = e.get("holding")
                    r["last_holding"] = (
                        list(holding) if isinstance(holding, list) else []
                    )
                if isinstance(e.get("ttl"), (int, float)):
                    r["ttl"] = e["ttl"]
                file_rank = e.get("rank", file_rank)
            elif ev == "lease_claim":
                saw_elastic = True
                r = row(e.get("rank", -1))
                r["ranges_claimed"] += 1
                if e.get("takeover"):
                    r["takeovers"] += 1
                file_rank = e.get("rank", file_rank)
            elif ev == "lease_expire":
                saw_elastic = True
                row(e.get("rank", -1))["leases_expired"] += 1
            elif ev == "lease_split":
                saw_elastic = True
                row(e.get("rank", -1))["lease_splits"] += 1
            elif ev == "chunk_reassign":
                saw_elastic = True
                row(e.get("from_rank", -1))["reassigned_away"] += 1
                if e.get("via") == "lease_split":
                    row(e.get("to_rank", -1))["steals"] += 1
            elif ev == "chunk_done":
                chunk_done += 1
        if file_rank is not None and chunk_done:
            row(file_rank)["chunks_committed"] += chunk_done
    if not saw_elastic:
        return None
    for r in ranks.values():
        last = r.pop("last_heartbeat_ts")
        holding = r.pop("last_holding")
        ttl = r.pop("ttl")
        r["last_heartbeat_age_s"] = (
            round(max_ts - last, 3)
            if last is not None and max_ts is not None else None
        )
        # stale-but-alive: the rank's heartbeat went silent past its
        # TTL while it still HELD leases, yet nobody expired it — the
        # signature of a slow (throttled, swapping, noisy-neighbour)
        # rank a live fleet should be stealing from, rendered as a
        # `slow:` marker by `specpride stats`
        r["slow"] = bool(
            holding
            and isinstance(ttl, (int, float))
            and r["last_heartbeat_age_s"] is not None
            and r["last_heartbeat_age_s"] > ttl
            and r["leases_expired"] == 0
        )
    unpaired = audit_elastic(
        [e for events in events_per_file for e in events]
    )
    return {
        "ranks": {str(k): ranks[k] for k in sorted(ranks)},
        "reassignments": sum(
            r["reassigned_away"] for r in ranks.values()
        ),
        "lease_splits": sum(
            r["lease_splits"] for r in ranks.values()
        ),
        "unpaired_lease_expiries": len(unpaired),
    }


# -- manifest-verified merging ------------------------------------------


def elastic_range_table(spec: str) -> tuple[list[dict] | None, str | None]:
    """The EFFECTIVE range set of an elastic run: the base plan plus
    every overlay range the work-stealing handshake registered, with
    ratified cuts applied to their parents — sorted by cluster START,
    which is the concatenation order that reproduces single-host serial
    bytes (overlay ids are allocated past the base plan, so id order is
    NOT cluster order once a split happened).

    Returns ``(table, problem)``: ``table`` is a list of
    ``{"range_id", "start", "stop"}`` rows, or None with a problem
    string when the plan is unreadable or the effective ranges do not
    tile ``[0, n_clusters)`` exactly (overlapping or gapped splits —
    states the handshake cannot legally produce, so seeing one means
    the store was tampered with or torn)."""
    store = store_from_spec(spec)
    got = store.get("plan.json")
    if got is None:
        return None, "no readable plan.json"
    plan = got[0]
    n = plan.get("n_clusters")
    size = plan.get("range_size")
    if not isinstance(n, int) or not isinstance(size, int):
        return None, "malformed plan.json"
    rows = {
        r.range_id: {"range_id": r.range_id, "start": r.start,
                     "stop": r.stop}
        for r in plan_ranges(n, size)
    }
    # splits are discovered from CUT records only — the single atomic
    # publication of the handshake.  Overlay records are id-allocation
    # markers; one without a referencing cut is debris from a donor
    # that died mid-handshake and must NOT appear in the table (its
    # parent was never narrowed).
    for key in store.list_keys("split/"):
        if ".cut." not in key:
            continue
        rec_got = store.get(key)
        if rec_got is None:
            return None, f"unreadable cut record {key}"
        rec = rec_got[0]
        cut = rec.get("cut")
        try:
            parent = int(
                key.rsplit("/", 1)[1].split(".", 1)[0].replace("range_", "")
            )
        except ValueError:
            continue
        if not isinstance(cut, int):
            return None, f"malformed cut record {key}"
        rid = rec.get("new_range")
        if isinstance(rid, int):
            stop = rec.get("stop")
            if not isinstance(stop, int):
                return None, f"malformed cut record {key}"
            rows[rid] = {"range_id": rid, "start": cut, "stop": stop}
        row = rows.get(parent)
        if row is not None and cut < row["stop"]:
            row["stop"] = cut
    table = sorted(rows.values(), key=lambda r: (r["start"], r["range_id"]))
    pos = 0
    for row in table:
        if row["start"] != pos or row["stop"] < row["start"]:
            return None, (
                f"effective ranges do not tile the input: range "
                f"{row['range_id']} spans [{row['start']}, {row['stop']}) "
                f"but cluster {pos} is next"
            )
        pos = row["stop"]
    if pos != n:
        return None, (
            f"effective ranges cover {pos} of {n} clusters"
        )
    return table, None


def read_done_marker(spec: str, range_id: int) -> dict | None:
    """Range ``range_id``'s commit marker (None = never committed)."""
    got = store_from_spec(spec).get(f"done/range_{range_id:05d}.json")
    return got[0] if got is not None else None


def sha256_file(path: str, upto: int | None = None) -> str:
    """sha256 of the first ``upto`` bytes (the whole file when None):
    the prefix hash the commit protocol keeps, through its one
    implementation (``robustness.integrity``)."""
    if upto is None:
        upto = os.path.getsize(path)
    return OutputIntegrity().seed_file(path, upto)


def verify_part_manifest(part: str, manifest: dict) -> str | None:
    """Check one output shard against its schema-2 manifest.  Returns a
    problem string (None = verified): size mismatch, sha256 mismatch, or
    a manifest too old to carry a hash."""
    want_bytes = manifest.get("output_bytes")
    if not isinstance(want_bytes, int):
        return "manifest records no output_bytes"
    try:
        size = os.path.getsize(part)
    except OSError as e:
        return f"unreadable part ({e})"
    if size != want_bytes:
        return (
            f"part is {size} bytes but its manifest committed "
            f"{want_bytes}"
        )
    want_sha = manifest.get("sha256")
    if not want_sha:
        return "manifest has no sha256 (pre-schema-2)"
    got = sha256_file(part, want_bytes)
    if got != want_sha:
        return (
            f"sha256 mismatch: manifest {want_sha[:12]}… vs part "
            f"{got[:12]}…"
        )
    return None


def merge_qc_reports(shards: list[str], out_path: str) -> int:
    """Merge per-shard QC reports (rank order) into one report that is
    byte-identical to the report a single-host serial run writes:
    same key order, same ``statistics`` aggregation over the same row
    sequence, same ``indent=1`` serialization.  Returns the merged
    cluster-row count."""
    rows: list[dict] = []
    n_input = 0
    method_failed: list[str] = []
    qc_failed: list[str] = []
    for path in shards:
        with open(path, encoding="utf-8") as fh:
            shard = json.load(fh)
        summary = shard.get("summary", {})
        rows.extend(shard.get("clusters", []))
        n_input += int(summary.get("n_input_clusters", 0))
        method_failed.extend(summary.get("method_failed_cluster_ids", []))
        qc_failed.extend(summary.get("qc_failed_cluster_ids", []))
    cosines = [row["avg_cosine"] for row in rows]
    method_failed = sorted(set(method_failed))
    qc_failed = sorted(set(qc_failed))
    report = {
        "summary": {
            "n_clusters": len(rows),
            "mean_cosine": statistics.fmean(cosines) if cosines else None,
            "median_cosine": (
                statistics.median(cosines) if cosines else None
            ),
            "n_input_clusters": n_input,
            "n_method_failed": len(method_failed),
            "n_qc_failed": len(qc_failed),
            **(
                {"method_failed_cluster_ids": method_failed}
                if method_failed else {}
            ),
            **({"qc_failed_cluster_ids": qc_failed} if qc_failed else {}),
        },
        "clusters": rows,
    }
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")
    return len(rows)
