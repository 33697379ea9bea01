"""Readings that the limits of ``correct`` are set from: one job of a
cell's argv at its own size per seed and precision, through the same
entry the window drives, compared with the plain reference::

    python3 -m benchmark.control <cell> <precision,...> <seed> [<seed> ...]

The configuration's own precision gives the lower readings; the port's
reduced precisions (``--precision bf16``, ``int8``) are the control,
whose readings are the upper ones.  Prints one JSON line per seed and
precision.  The benchmark's runs do not run this.
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


def readings(cell: spec.Cell, precisions: list[str], seeds: list[int],
             device: str = "cuda") -> list[dict]:
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
            for prec in precisions:
                out = os.path.join(work, "out.mgf")
                qc = os.path.join(work, "qc.json")
                argv = job_argv(cell, src, out, qc, device)
                if prec != cell.config["precision"]:
                    argv += ["--precision", prec]
                t0 = time.perf_counter()
                summary = run_job(cli, argv)
                job_s = time.perf_counter() - t0
                row = {"cell": cell.name, "seed": seed, "precision": prec,
                       "job_s": job_s, "reference_s": ref_s,
                       "ok": summary is not None}
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
