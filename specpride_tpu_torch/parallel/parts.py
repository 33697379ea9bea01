"""The part files of a multi-host run and their merge (the port's copy of
the JAX package's ``cli.py::cmd_merge_parts``).

Each rank of a ``--coordinator`` run writes ``<output>.part<id>`` (five
digits), with a per-rank checkpoint manifest and QC report beside it.
Ranks own contiguous blocks of the clusters, so the parts in rank order
are the single-process output, and the per-rank QC reports merge into the
single-process report.  An ``--elastic`` run writes one part per chunk
range instead, numbered by range, each verified against its commit
marker in the coordinator store and joined in cluster order
(``parallel.elastic.elastic_range_table``)."""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil

from specpride_tpu_torch.parallel.elastic import (
    elastic_range_table,
    merge_qc_reports,
    read_done_marker,
    verify_part_manifest,
)

logger = logging.getLogger("specpride_tpu_torch")


def part_path(path: str, rank: int) -> str:
    """``<path>.part<rank>``, the rank in five digits."""
    return f"{path}.part{rank:05d}"


def merge_parts(output: str, num_processes: int | None = None,
                checkpoint: str | None = None, qc_report: str | None = None,
                remove_parts: bool = False,
                elastic: str | None = None) -> str | None:
    """Concatenate ``<output>.part<id>`` into ``output``: in id order, or
    with ``elastic`` (the ``--elastic`` store) in the cluster order of the
    run's effective ranges.  Refuses, before any byte moves, a gap or
    duplicate in the ids (the expected ids are the elastic table's, else
    ``num_processes``, else the highest id seen plus one), a part that
    fails its manifest (the range's commit marker, or with ``checkpoint``
    the ``<checkpoint>.part<id>`` resume manifest), and a missing QC shard
    when ``qc_report`` asks for the merged report.  Returns None on
    success, else the reason."""
    parts = sorted(glob.glob(glob.escape(output) + ".part*"))
    if not parts:
        return f"no part files match {output}.part*"
    ids = []
    for p in parts:
        suffix = p.rsplit(".part", 1)[1]
        if not suffix.isdigit():
            return f"unrecognized part name {p}"
        ids.append(int(suffix))
    by_id = dict(zip(ids, parts))
    if elastic:
        table, problem = elastic_range_table(elastic)
        if table is None:
            return (f"--elastic {elastic}: {problem} — is this the "
                    "coordinator store the ranks ran against?")
        # overlay ids follow the base plan: cluster order is start order
        expected = [row["range_id"] for row in table]
    else:
        expected = list(range(num_processes or (max(ids) + 1)))
    missing = sorted(set(expected) - set(ids))
    extra = sorted(set(ids) - set(expected))
    if missing or extra or len(ids) != len(set(ids)):
        return (f"incomplete part set for {output}: have ids {ids}, "
                f"missing {missing}"
                + (f", unexpected {extra}" if extra else "")
                + " — refusing to merge a gapped sequence (a missing id "
                "means a rank or range never committed; pass "
                "--num-processes or --elastic to pin the expected ids)")
    ordered = [(i, by_id[i]) for i in expected]
    if elastic or checkpoint:
        for i, part in ordered:
            if elastic:
                kind, manifest = "commit marker", read_done_marker(elastic,
                                                                   i)
                if manifest is None:
                    return (f"range {i}: no readable commit marker — "
                            "refusing to merge an unverifiable shard")
            else:
                kind = "checkpoint manifest"
                mpath = f"{checkpoint}.part{part.rsplit('.part', 1)[1]}"
                try:
                    with open(mpath, encoding="utf-8") as fh:
                        manifest = json.load(fh)
                except (OSError, ValueError) as e:
                    return (f"rank {i}: unreadable checkpoint manifest "
                            f"{mpath} ({e}) — refusing to merge an "
                            "unverifiable shard")
            problem = verify_part_manifest(part, manifest)
            if problem is not None:
                return (f"rank/range {i}: {part} fails its {kind}: "
                        f"{problem} — refusing to merge")
    if qc_report:
        shards = []
        for i, part in ordered:
            qpath = f"{qc_report}.part{part.rsplit('.part', 1)[1]}"
            if not os.path.exists(qpath):
                return (f"rank/range {i}: no QC shard {qpath} — refusing a "
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
