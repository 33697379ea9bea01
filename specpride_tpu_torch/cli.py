"""Command line of the port: ``python -m specpride_tpu_torch consensus IN
OUT --method bin-mean [--qc-report QC.json]``.  Reads the clustered MGF,
groups it into clusters, runs the binned-mean consensus on the card
(``--device cpu`` for the CPU) and writes one consensus spectrum per
cluster; with ``--qc-report`` it also scores each consensus by its mean
binned cosine to the cluster's members and writes the per-cluster QC
report."""

from __future__ import annotations

import argparse
import json
import statistics

from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BinMeanConfig, CosineConfig
from specpride_tpu_torch.data.peaks import group_into_clusters
from specpride_tpu_torch.io.mgf import read_mgf, write_mgf


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="specpride_tpu_torch",
        description="representative spectra on an NVIDIA GPU (PyTorch/CUDA)",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    pc = sub.add_parser("consensus",
                        help="merge clusters into consensus spectra")
    pc.add_argument("input")
    pc.add_argument("output")
    pc.add_argument("--method", choices=["bin-mean"], default="bin-mean")
    pc.add_argument("--min-mz", type=float, default=100.0)
    pc.add_argument("--max-mz", type=float, default=2000.0)
    pc.add_argument("--bin-size", type=float, default=0.02)
    pc.add_argument("--no-quorum", action="store_true")
    pc.add_argument("--quorum-fraction", type=float, default=0.25)
    pc.add_argument(
        "--tolerance-mode", choices=["da", "ppm"], default="da",
        help="bin-mean grid: fixed-Da bins (reference) or "
        "mass-proportional ppm bins",
    )
    pc.add_argument("--ppm", type=float, default=20.0,
                    help="bin width in ppm for --tolerance-mode ppm")
    pc.add_argument(
        "--qc-normalization", choices=["none", "sqrt", "log"],
        default="none",
        help="intensity transform for the QC cosine (sqrt tempers "
        "dominant peaks; log flattens dynamic range)",
    )
    pc.add_argument(
        "--qc-report", metavar="FILE",
        help="also compute each consensus spectrum's mean member cosine "
        "and write the per-cluster QC report here",
    )
    pc.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the consensus runs (default: the GPU)")
    return ap


def write_qc_report(path: str, clusters, cosines) -> None:
    """The per-cluster QC report, in the JAX package's keys and layout: a
    summary and one row per cluster in input order.  Every cluster gets a
    row here, so no method or QC failure is ever listed."""
    rows = [
        {"cluster_id": c.cluster_id, "n_members": c.n_members,
         "avg_cosine": float(v)}
        for c, v in zip(clusters, cosines)
    ]
    values = [row["avg_cosine"] for row in rows]
    report = {
        "summary": {
            "n_clusters": len(rows),
            "mean_cosine": statistics.fmean(values) if values else None,
            "median_cosine": statistics.median(values) if values else None,
            "n_input_clusters": len(clusters),
            "n_method_failed": 0,
            "n_qc_failed": 0,
        },
        "clusters": rows,
    }
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")


def cmd_consensus(args, backend: TorchBackend) -> int:
    config = BinMeanConfig(
        min_mz=args.min_mz,
        max_mz=args.max_mz,
        bin_size=args.bin_size,
        apply_peak_quorum=not args.no_quorum,
        quorum_fraction=args.quorum_fraction,
        tolerance_mode=args.tolerance_mode,
        ppm=args.ppm,
    )
    clusters = group_into_clusters(read_mgf(args.input))
    if args.qc_report is None:
        write_mgf(backend.run_bin_mean(clusters, config), args.output)
        return 0
    reps, cosines = backend.run_bin_mean_with_cosines(
        clusters, config, CosineConfig(normalization=args.qc_normalization)
    )
    write_mgf(reps, args.output)
    write_qc_report(args.qc_report, clusters, cosines)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        backend = TorchBackend(device=args.device)
    except RuntimeError as exc:  # no CUDA for the default --device cuda
        ap.error(f"{exc} (here: --device cpu)")
    return cmd_consensus(args, backend)
