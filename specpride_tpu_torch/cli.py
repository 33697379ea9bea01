"""Command line of the port:

    python -m specpride_tpu_torch consensus IN OUT \
        [--method bin-mean|gap-average] [--precision f32|bf16|int8] \
        [--qc-report QC.json]
    python -m specpride_tpu_torch select IN OUT [--method medoid|best] \
        [--msms msms.txt | --psms psms.tsv] [--precision f32|bf16|int8] \
        [--qc-report QC.json]

Both read the clustered MGF and group it into clusters.  ``consensus``
runs the binned-mean or gap-average consensus on the card (``--device
cpu`` for the CPU) and writes one consensus spectrum per cluster;
``select`` writes one member per cluster: the medoid (shared-bin counts on
the card) or the best-scored member (a host join; clusters without a
score are dropped).  With ``--qc-report`` each representative is also
scored by its mean binned cosine to the cluster's members (always in f32,
on the card) and the per-cluster QC report written.  A consensus or
medoid run at a reduced ``--precision`` must pass the precision gate
(``precision_gate``) or it exits non-zero."""

from __future__ import annotations

import argparse
import json
import statistics

from specpride_tpu_torch.backends import numpy_backend
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import (
    BestSpectrumConfig,
    BinMeanConfig,
    CosineConfig,
    GapAverageConfig,
    MedoidConfig,
)
from specpride_tpu_torch.data.peaks import group_into_clusters
from specpride_tpu_torch.io.maxquant import (
    read_msms_scores,
    read_percolator_scores,
)
from specpride_tpu_torch.io.mgf import read_mgf, write_mgf
from specpride_tpu_torch.ops import quantize


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
    pc.add_argument("--method", choices=["bin-mean", "gap-average"],
                    default="bin-mean")
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
    pc.add_argument("--mz-accuracy", type=float, default=0.01)
    pc.add_argument("--dyn-range", type=float, default=1000.0)
    pc.add_argument("--min-fraction", type=float, default=0.5)
    pc.add_argument("--tail-mode", choices=["reference", "split"],
                    default="reference")
    pc.add_argument("--pepmass", choices=["naive_average", "neutral_average",
                                          "lower_median"],
                    default="lower_median")
    pc.add_argument("--rt", choices=["median", "mass_lower_median"],
                    default="median")
    _add_common(pc, "consensus spectrum")
    pc.set_defaults(fn=cmd_consensus)

    ps = sub.add_parser("select", help="pick an existing member per cluster")
    ps.add_argument("input")
    ps.add_argument("output")
    ps.add_argument("--method", choices=["best", "medoid"], default="medoid")
    ps.add_argument("--msms", help="MaxQuant msms.txt (for --method best)")
    ps.add_argument("--psms", help="percolator/crux PSM TSV score source "
                                   "(for --method best)")
    ps.add_argument("--raw-name", help="raw file name for --psms USIs "
                                       "(default: basename of its 'file' "
                                       "column)")
    ps.add_argument("--px-accession", default="PXD004732")
    ps.add_argument("--xcorr-bin", type=float, default=0.1,
                    help="medoid occupancy-grid bin width in Da")
    _add_common(ps, "representative")
    ps.set_defaults(fn=cmd_select)
    return ap


def _add_common(p: argparse.ArgumentParser, what: str) -> None:
    """The QC, precision and device flags both subcommands take."""
    p.add_argument(
        "--qc-report", metavar="FILE",
        help=f"also compute each {what}'s mean member cosine and write the "
        "per-cluster QC report here",
    )
    p.add_argument(
        "--qc-normalization", choices=["none", "sqrt", "log"],
        default="none",
        help="intensity transform for the QC cosine (sqrt tempers "
        "dominant peaks; log flattens dynamic range)",
    )
    p.add_argument(
        "--precision", choices=list(quantize.PRECISIONS), default="f32",
        help="encoding of the channels sent to the card: bf16 or int8 send "
        "fewer bytes, and a consensus or medoid run must then pass a gate "
        "against f32 on a sample of clusters",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the method runs (default: the GPU)")


def write_qc_report(path: str, clusters, cosines,
                    n_input_clusters: int | None = None) -> None:
    """The per-cluster QC report, in the JAX package's keys and layout: a
    summary and one row per scored cluster in input order.
    ``n_input_clusters`` (default: all rows) counts the input's clusters,
    scored or not: a method may drop some (``select --method best``
    drops the scoreless), which is no failure."""
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
            "n_input_clusters": (len(clusters) if n_input_clusters is None
                                 else n_input_clusters),
            "n_method_failed": 0,
            "n_qc_failed": 0,
        },
        "clusters": rows,
    }
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")


def method_config(args):
    """The configuration of ``args.method`` from the command line."""
    if args.method == "medoid":
        return MedoidConfig(bin_size=args.xcorr_bin)
    if args.method == "best":
        return BestSpectrumConfig(px_accession=args.px_accession)
    if args.method == "gap-average":
        return GapAverageConfig(
            mz_accuracy=args.mz_accuracy, dyn_range=args.dyn_range,
            min_fraction=args.min_fraction, tail_mode=args.tail_mode,
            pepmass=args.pepmass, rt=args.rt,
        )
    return BinMeanConfig(
        min_mz=args.min_mz,
        max_mz=args.max_mz,
        bin_size=args.bin_size,
        apply_peak_quorum=not args.no_quorum,
        quorum_fraction=args.quorum_fraction,
        tolerance_mode=args.tolerance_mode,
        ppm=args.ppm,
    )


def run_method(backend: TorchBackend, method: str, clusters, config):
    if method == "gap-average":
        return backend.run_gap_average(clusters, config)
    return backend.run_bin_mean(clusters, config)


def load_scores(args) -> dict[str, float]:
    """The PSM scores of ``select --method best``: ``--psms`` (percolator
    or crux) before ``--msms`` (MaxQuant); neither exits with a message."""
    if args.psms:
        return read_percolator_scores(args.psms, args.px_accession,
                                      raw_name=args.raw_name)
    if args.msms:
        return read_msms_scores(args.msms, args.px_accession)
    raise SystemExit(
        "select --method best needs a score source: --msms "
        "(MaxQuant msms.txt) or --psms (percolator/crux TSV)"
    )


# clusters re-run at f32 by the precision gate: a fixed cost however large
# the input (the drift it checks is per cluster and i.i.d. across them)
PRECISION_GATE_SAMPLE = 32


def precision_gate(backend: TorchBackend, method: str, clusters, config,
                   cos_config: CosineConfig) -> dict | None:
    """The gate of a reduced-precision run: the first
    ``PRECISION_GATE_SAMPLE`` clusters run again at the run's precision
    and at f32, on twin backends on the same device, and every pair's
    binned cosine must reach ``quantize.precision_tolerance(method,
    precision)``.  Returns the gate's numbers (None for f32, which is
    the reference); a breach raises ``SystemExit`` with a message."""
    precision = backend.precision
    if precision == "f32" or method == "best":
        return None
    sample = [c for c in clusters[:PRECISION_GATE_SAMPLE] if c.n_members]
    tol = quantize.precision_tolerance(method, precision)

    def twin(prec: str):
        return TorchBackend(device=backend.device, precision=prec,
                            max_grid_elements=backend.max_grid_elements)

    if method == "medoid":
        # an equal pick scores 1; a different one, the two members' cosine
        red = twin(precision).medoid_indices(sample, config)
        ref = twin("f32").medoid_indices(sample, config)
        cosines = [
            1.0 if a == b else numpy_backend.binned_cosine(
                c.members[a], c.members[b], cos_config)
            for a, b, c in zip(red, ref, sample)
        ]
    else:
        red = run_method(twin(precision), method, sample, config)
        ref = run_method(twin("f32"), method, sample, config)
        cosines = [numpy_backend.binned_cosine(a, b, cos_config)
                   for a, b in zip(red, ref)]
    min_cos = min(cosines, default=1.0)
    if min_cos < tol:
        raise SystemExit(
            f"precision gate failed: {method} at --precision {precision} "
            f"scored min cosine {min_cos:.6f} against f32 over "
            f"{len(sample)} sampled clusters (tolerance {tol}); rerun at "
            "f32 or a wider precision"
        )
    return {"precision": precision, "checked": len(sample),
            "min_cosine": min_cos, "tolerance": tol}


def cmd_consensus(args, backend: TorchBackend) -> int:
    config = method_config(args)
    cos_config = CosineConfig(normalization=args.qc_normalization)
    clusters = group_into_clusters(read_mgf(args.input))
    if args.method == "bin-mean" and args.qc_report is not None:
        reps, cosines = backend.run_bin_mean_with_cosines(
            clusters, config, cos_config
        )
    else:
        reps = run_method(backend, args.method, clusters, config)
        cosines = None
        if args.qc_report is not None:
            cosines = backend.average_cosines(reps, clusters, cos_config)
    write_mgf(reps, args.output)
    if cosines is not None:
        write_qc_report(args.qc_report, clusters, cosines)
    # after the outputs, so a breach leaves them on disk to diagnose
    precision_gate(backend, args.method, clusters, config, cos_config)
    return 0


def cmd_select(args, backend: TorchBackend) -> int:
    config = method_config(args)
    cos_config = CosineConfig(normalization=args.qc_normalization)
    clusters = group_into_clusters(read_mgf(args.input))
    if args.method == "best":
        reps = backend.run_best_spectrum(clusters, load_scores(args), config)
    else:
        reps = backend.run_medoid(clusters, config)
    write_mgf(reps, args.output)
    if args.qc_report is not None:
        # representatives align to clusters by id: best drops clusters
        by_id = {r.cluster_id: r for r in reps}
        kept = [c for c in clusters if c.cluster_id in by_id]
        cosines = backend.average_cosines(
            [by_id[c.cluster_id] for c in kept], kept, cos_config)
        write_qc_report(args.qc_report, kept, cosines, len(clusters))
    precision_gate(backend, args.method, clusters, config, cos_config)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        backend = TorchBackend(device=args.device, precision=args.precision)
    except RuntimeError as exc:  # no CUDA for the default --device cuda
        ap.error(f"{exc} (here: --device cpu)")
    return args.fn(args, backend)
