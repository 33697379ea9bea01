"""Readings that the limits of ``correct`` are set from: one job of a
cell's argv at its own size per seed and variant, through the same
entry the window drives, compared with the plain reference::

    python3 -m benchmark.control <cell> <variant,...> <seed> [<seed> ...]

A variant is a precision of the port (``PRECISIONS``: the cell's argv,
with ``--precision`` where it is not the configuration's own) or a name
under the configuration's ``check.control``, whose argv it appends (for
a method whose answer no precision changes, as a selection's).  The
configuration's own precision gives the lower readings; the control (the
port's reduced precisions, ``--precision bf16`` and ``int8``, or a named
variant) the upper ones.  Prints one JSON line per seed and variant.
The benchmark's runs do not run this.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmark import check, generate, spec
from benchmark.run import job_argv, run_job


# the port's ``--precision`` values
PRECISIONS = ("f32", "bf16", "int8")


def variants(cell: spec.Cell) -> dict[str, tuple[str, list[str]]]:
    """The cell's variants by name: (precision, argv appended to the
    cell's).  A precision keeps its meaning over a named variant."""
    own = cell.config["precision"]
    out = {name: (own, list(extra)) for name, extra
           in cell.config["check"].get("control", {}).items()}
    out.update({p: (p, [] if p == own else ["--precision", p])
                for p in PRECISIONS})
    return out


def readings(cell: spec.Cell, names: list[str], seeds: list[int],
             device: str = "cuda") -> list[dict]:
    have = variants(cell)
    unknown = [name for name in names if name not in have]
    if unknown:
        raise SystemExit(f"{cell.name}: no control variant "
                         f"{', '.join(unknown)}; it has: {', '.join(have)}")
    from specpride_tpu_torch import cli

    rows = []
    work = tempfile.mkdtemp(prefix="specpride-control-")
    pool = multiprocessing.get_context("spawn").Pool(generate.WRITERS)
    try:
        for seed in seeds:
            w = generate.make_workload(cell.traffic, seed)
            src = os.path.join(work, "input.mgf")
            generate.write_mgf(w, src, pool)
            t0 = time.perf_counter()
            ref = cell.reference().run(w, cell.config)
            ref_s = time.perf_counter() - t0
            for name in names:
                prec, extra = have[name]
                out = os.path.join(work, "out.mgf")
                qc = os.path.join(work, "qc.json")
                argv = job_argv(cell, src, out, qc, device) + extra
                t0 = time.perf_counter()
                summary = run_job(cli, argv)
                job_s = time.perf_counter() - t0
                row = {"cell": cell.name, "seed": seed, "precision": prec,
                       "variant": name, "job_s": job_s,
                       "reference_s": ref_s, "ok": summary is not None}
                if summary is not None:
                    row.update(check.compare(
                        check.read_mgf(out),
                        check.read_qc(qc if "{qc}" in cell.config["argv"]
                                      else None),
                        ref, w.cluster_ids, np.diff(w.member_offsets)))
                    row["gate"] = summary.get("precision_gate")
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        pool.close()
        pool.join()
        shutil.rmtree(work, ignore_errors=True)
    return rows


def main(argv: list[str]) -> int:
    cell = spec.Cell(argv[0])
    readings(cell, argv[1].split(","), [int(s) for s in argv[2:]])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
