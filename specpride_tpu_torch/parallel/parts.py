"""The part files of a multi-host run and their merge (the port's copy of
the JAX package's ``cli.py::cmd_merge_parts`` and of the two helpers it
takes from ``parallel/elastic.py``, without the elastic runs).

Each rank of a ``--coordinator`` run writes ``<output>.part<id>`` (five
digits), with a per-rank checkpoint manifest and QC report beside it.
Ranks own contiguous blocks of the clusters, so the parts in rank order
are the single-process output, and the per-rank QC reports merge into the
single-process report."""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import statistics

from specpride_tpu_torch.robustness.integrity import OutputIntegrity

logger = logging.getLogger("specpride_tpu_torch")


def part_path(path: str, rank: int) -> str:
    """``<path>.part<rank>``, the rank in five digits."""
    return f"{path}.part{rank:05d}"


def verify_part_manifest(part: str, manifest: dict) -> str | None:
    """Check one part against its schema-2 manifest: None when its size
    and sha256 match, else what is wrong."""
    want_bytes = manifest.get("output_bytes")
    if not isinstance(want_bytes, int):
        return "manifest records no output_bytes"
    try:
        size = os.path.getsize(part)
    except OSError as e:
        return f"unreadable part ({e})"
    if size != want_bytes:
        return (f"part is {size} bytes but its manifest committed "
                f"{want_bytes}")
    want_sha = manifest.get("sha256")
    if not want_sha:
        return "manifest has no sha256 (pre-schema-2)"
    got = OutputIntegrity().seed_file(part, want_bytes)
    if got != want_sha:
        return f"sha256 mismatch: manifest {want_sha[:12]}… vs part {got[:12]}…"
    return None


def merge_qc_reports(shards: list[str], out_path: str) -> int:
    """The per-rank QC reports (in rank order) as one report with the
    single-process run's bytes: its keys and their order, the statistics
    over the same rows, ``indent=1``.  Returns the merged row count."""
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
            "median_cosine": (statistics.median(cosines) if cosines
                              else None),
            "n_input_clusters": n_input,
            "n_method_failed": len(method_failed),
            "n_qc_failed": len(qc_failed),
            **({"method_failed_cluster_ids": method_failed}
               if method_failed else {}),
            **({"qc_failed_cluster_ids": qc_failed} if qc_failed else {}),
        },
        "clusters": rows,
    }
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")
    return len(rows)


def merge_parts(output: str, num_processes: int | None = None,
                checkpoint: str | None = None, qc_report: str | None = None,
                remove_parts: bool = False) -> str | None:
    """Concatenate ``<output>.part<id>`` in rank order into ``output``.
    Refuses, before any byte moves, a gap or duplicate in the ids (the
    expected count is ``num_processes``, else the highest id seen plus
    one), a part that fails its ``<checkpoint>.part<id>`` manifest, and a
    missing QC shard when ``qc_report`` asks for the merged report.
    Returns None on success, else the reason."""
    parts = sorted(glob.glob(glob.escape(output) + ".part*"))
    if not parts:
        return f"no part files match {output}.part*"
    ranks = []
    for p in parts:
        suffix = p.rsplit(".part", 1)[1]
        if not suffix.isdigit():
            return f"unrecognized part name {p}"
        ranks.append(int(suffix))
    expected = num_processes or (max(ranks) + 1)
    missing = sorted(set(range(expected)) - set(ranks))
    extra = sorted(set(ranks) - set(range(expected)))
    if missing or extra or len(ranks) != len(set(ranks)):
        return (f"incomplete part set for {output}: have ids {ranks}, "
                f"missing {missing}"
                + (f", unexpected {extra}" if extra else "")
                + " — refusing to merge a gapped sequence (a missing id "
                "means a rank never committed; pass --num-processes to "
                "pin the expected count)")
    ordered = sorted(zip(ranks, parts))
    if checkpoint:
        for rank, part in ordered:
            mpath = f"{checkpoint}.part{part.rsplit('.part', 1)[1]}"
            try:
                with open(mpath, encoding="utf-8") as fh:
                    manifest = json.load(fh)
            except (OSError, ValueError) as e:
                return (f"rank {rank}: unreadable checkpoint manifest "
                        f"{mpath} ({e}) — refusing to merge an "
                        "unverifiable shard")
            problem = verify_part_manifest(part, manifest)
            if problem is not None:
                return (f"rank {rank}: {part} fails its checkpoint "
                        f"manifest: {problem} — refusing to merge")
    if qc_report:
        shards = []
        for rank, part in ordered:
            qpath = f"{qc_report}.part{part.rsplit('.part', 1)[1]}"
            if not os.path.exists(qpath):
                return (f"rank {rank}: no QC shard {qpath} — refusing a "
                        "partial QC merge")
            shards.append(qpath)
        n_rows = merge_qc_reports(shards, qc_report)
        logger.info("merged %d QC shards (%d clusters) -> %s", len(shards),
                    n_rows, qc_report)
    with open(output, "wb") as out:
        for _, p in ordered:
            with open(p, "rb") as fh:
                shutil.copyfileobj(fh, out)
    if remove_parts:
        for p in parts:
            os.remove(p)
    logger.info("merged %d parts -> %s", len(parts), output)
    return None
