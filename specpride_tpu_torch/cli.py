"""Command line of the port:

    python -m specpride_tpu_torch consensus IN OUT \
        [--method bin-mean|gap-average] [--precision f32|bf16|int8] \
        [--qc-report QC.json] [--checkpoint CK.json] [executor flags]
    python -m specpride_tpu_torch select IN OUT [--method medoid|best] \
        [--msms msms.txt | --psms psms.tsv] [--precision f32|bf16|int8] \
        [--qc-report QC.json] [--checkpoint CK.json] [executor flags]
    python -m specpride_tpu_torch evaluate REPS CLUSTERED \
        [--report R.json] [--format json|csv] [--normalization ...]
    python -m specpride_tpu_torch convert IN OUT --msms msms.txt \
        --clusters clusters.tsv [--raw-name NAME] [--px-accession PXD]
    python -m specpride_tpu_torch merge-parts OUT [--num-processes N] \
        [--checkpoint BASE] [--qc-report QC.json] [--remove-parts]
    python -m specpride_tpu_torch plot CLUSTERED CLUSTER_ID OUT_PREFIX \
        [--consensus REPS.mgf | --peptide PEPTIDE]
    python -m specpride_tpu_torch stats JOURNAL [JOURNAL ...] [--json F]

``consensus`` and ``select`` read the clustered MGF (or, with
``--clusters``, an mzML file and a MaRaCluster TSV) and group it into
clusters; ``consensus --single`` takes the whole file as one cluster.
``consensus`` runs the binned-mean or gap-average consensus on the card
(``--device cpu`` for the CPU) and writes one consensus spectrum per
cluster; ``select`` writes one member per cluster: the medoid (shared-bin
counts on the card) or the best-scored member (a host join; clusters
without a score are dropped).  With ``--qc-report`` each representative is also
scored by its mean binned cosine to the cluster's members (always in f32,
on the card) and the per-cluster QC report written.  A consensus or
medoid run at a reduced ``--precision`` must pass the precision gate
(``precision_gate``) or it exits non-zero.

Both run through the chunked executor (``_checkpointed_run``, the JAX
package's names kept): chunks of ``--checkpoint-every`` clusters, each
appended to the output and then recorded in the ``--checkpoint`` manifest,
so a killed run resumes where it stopped.  With ``--prefetch N`` pack
workers (``--pack-workers``) build the next chunks' host inputs
(``TorchBackend.prepare_chunk``) while the dispatch lane runs the current
one on the card, an optional lane copies them to the card ahead
(``--h2d-buffer``) and a write lane commits finished chunks in order
(``--async-write``).  Every setting writes the same bytes.  The run
summary goes to stderr as one JSON line.

``--layout bucketized`` runs the consensus and the QC on the (B, K)
layout; ``--mesh`` also splits each batch's clusters over every visible
card.  With ``--coordinator HOST:PORT --num-processes N --process-id I``
each of N processes (on one host or several) takes the I-th contiguous
block of the clusters and writes ``OUT.part<I>`` (and per-rank checkpoint
and QC report), on the bucketized layout over its own cards;
``merge-parts`` joins the parts in rank order into the bytes of a
single-process run.

``evaluate`` scores representatives against their clusters (the mean
binned cosine on the card, flat or with ``--layout bucketized`` / ``--mesh``
on the (B, K) layout, and the b/y-ion fraction on the host) and prints
the summary on stdout; ``convert`` builds the clustered MGF (or mzML)
from raw spectra, MaxQuant peptides and MaRaCluster clusters; ``plot``
draws a cluster's members mirrored against a peptide's theoretical
spectrum or against its representative (matplotlib, no card).  Every MGF
is read and written through the host library (``io/native.py``).

Telemetry, in the JAX package's formats: ``--journal FILE`` appends the
run's events (``run_start``, chunk heartbeats, ``compile`` / ``dispatch``,
``checkpoint_write``, ``resume``, the robustness events, ``precision``,
``run_end``) as JSON lines, which ``stats`` summarizes; ``--metrics-out
FILE`` writes the run's metrics as a Prometheus textfile; ``--trace-dir
DIR`` captures the run's compute with ``torch.profiler`` as a Chrome
trace; the global ``-v`` and ``--log-json`` set the logging.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import statistics
import sys
import threading
import time

from specpride_tpu_torch import convert, metrics
from specpride_tpu_torch.backends import numpy_backend
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import (
    BestSpectrumConfig,
    BinMeanConfig,
    CosineConfig,
    GapAverageConfig,
    MedoidConfig,
)
from specpride_tpu_torch.data.peaks import (
    Cluster,
    build_title,
    group_into_clusters,
)
from specpride_tpu_torch.io.maracluster import scan_to_cluster
from specpride_tpu_torch.io.maxquant import (
    read_msms_peptides,
    read_msms_scores,
    read_percolator_scores,
)
from specpride_tpu_torch.io.mgf import (
    StreamedClusters,
    read_mgf,
    truncate_tail,
    write_mgf,
)
from specpride_tpu_torch.io.mzml import read_mzml_scans
from specpride_tpu_torch.observability.journal import (
    NullJournal,
    emit_clock_anchor,
    open_journal,
)
from specpride_tpu_torch.observability.registry import (
    device_summary,
    export_run_metrics,
)
from specpride_tpu_torch.observability.stats import (
    RunStats,
    configure_logging,
    device_trace,
)
from specpride_tpu_torch.ops import kernels, quantize
from specpride_tpu_torch.parallel.mesh import (
    DeviceMesh,
    initialize_distributed,
    shutdown_distributed,
)
from specpride_tpu_torch.parallel.parts import merge_parts, part_path
from specpride_tpu_torch.robustness import errors, faults
from specpride_tpu_torch.robustness.harness import Harness
from specpride_tpu_torch.robustness.integrity import (
    OutputIntegrity,
    manifest_payload,
)
from specpride_tpu_torch.robustness.quarantine import Quarantine

logger = logging.getLogger("specpride_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="specpride_tpu_torch",
        description="representative spectra on an NVIDIA GPU (PyTorch/CUDA)",
    )
    ap.add_argument("-v", "--verbose", action="count", default=0)
    ap.add_argument("--log-json", action="store_true",
                    help="structured JSON logs on stderr")
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
    pc.add_argument("--single", action="store_true",
                    help="treat the whole input file as one cluster "
                         "(ref average_spectrum_clustering.py:172-176)")
    pc.add_argument(
        "--clusters",
        help="MaRaCluster TSV: consume a raw .mzML input directly, no "
        "convert step (ref binning.py:33-118)",
    )
    pc.add_argument("--msms", help="MaxQuant msms.txt for peptide titles "
                                   "(direct .mzML input; optional)")
    pc.add_argument("--raw-name", help="raw file name for USIs "
                                       "(direct .mzML input)")
    pc.add_argument("--px-accession", default="PXD004732")
    _add_common(pc, "consensus spectrum")

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
    ps.add_argument(
        "--clusters",
        help="MaRaCluster TSV: consume a raw .mzML input directly, no "
        "convert step (--msms then also provides peptide titles)",
    )
    _add_common(ps, "representative")

    pv = sub.add_parser("convert",
                        help="build the clustered-MGF interchange file")
    pv.add_argument("input", help="raw spectra (.mgf or .mzML)")
    pv.add_argument("output")
    pv.add_argument("--msms", required=True, help="MaxQuant msms.txt")
    pv.add_argument("--clusters", required=True, help="MaRaCluster TSV")
    pv.add_argument("--raw-name", help="raw file name for USIs")
    pv.add_argument("--px-accession", default="PXD004732")

    pe = sub.add_parser("evaluate",
                        help="quality metrics for representatives")
    pe.add_argument("representatives")
    pe.add_argument("clustered")
    pe.add_argument("--report", help="write per-cluster report to this path")
    pe.add_argument(
        "--normalization", choices=["none", "sqrt", "log"], default="none",
        help="intensity transform for the cosine metric",
    )
    pe.add_argument("--format", choices=["json", "csv"], default="json")
    pe.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the cosines run (default: the GPU)")
    _add_layout(pe)
    pe.add_argument(
        "--precision", choices=list(quantize.PRECISIONS), default="f32",
        help="accepted for the JAX CLI's flag set and ignored: the QC "
        "cosine always runs in f32",
    )
    _add_trace_dir(pe, "the evaluate compute")

    pm = sub.add_parser(
        "merge-parts",
        help="concatenate multi-host <output>.part<id> shards in order",
    )
    pm.add_argument("output", help="final output path (parts are "
                    "<output>.part00000, <output>.part00001, ...)")
    pm.add_argument("--num-processes", type=int,
                    help="expected part count (refuse to merge fewer)")
    pm.add_argument(
        "--checkpoint", metavar="BASE",
        help="verify each part against its <BASE>.part<id> schema-2 "
        "resume manifest (size + sha256) from a static multi-host run",
    )
    pm.add_argument(
        "--qc-report", metavar="FILE",
        help="also merge the per-shard <FILE>.part<id> QC reports into "
        "FILE (byte-identical to a single-host serial run's report)",
    )
    pm.add_argument("--remove-parts", action="store_true",
                    help="delete the part files after a successful merge")

    pp = sub.add_parser("plot", help="mirror plots for one cluster")
    pp.add_argument("clustered",
                    help="clustered MGF, or a raw .mzML with --clusters")
    pp.add_argument("cluster_id")
    pp.add_argument("out_prefix")
    pp.add_argument("--consensus",
                    help="representatives MGF (vs-consensus mode)")
    pp.add_argument("--peptide", help="peptide for the theoretical mirror")
    pp.add_argument("--clusters",
                    help="MaRaCluster TSV (direct .mzML input, "
                    "ref plot_cluster.py:50-86)")
    pp.add_argument("--msms", help="MaxQuant msms.txt for peptide titles "
                    "(direct .mzML input)")
    pp.add_argument("--raw-name", help="raw file name for USIs")
    pp.add_argument("--px-accession", default="PXD004732")

    pst = sub.add_parser(
        "stats", help="summarize run journals (schema-checked)")
    pst.add_argument("journals", nargs="+",
                     help="journal paths; a base path with .part<id> "
                     "shards merges them in rank order")
    pst.add_argument("--json", metavar="FILE",
                     help="also write the machine-readable aggregate here")
    return ap


def _add_layout(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--layout", choices=["auto", "flat", "bucketized"], default="auto",
        help="mesh-less device layout (escape hatch: 'bucketized' forces "
        "the (B, K) paths mesh runs use)",
    )
    p.add_argument(
        "--mesh", action="store_true",
        help="split each (B, K) batch's clusters over ALL visible cards, "
        "one stream each (single-host multi-card; implied by "
        "--coordinator)",
    )


def _add_trace_dir(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument(
        "--trace-dir", metavar="DIR",
        help=f"capture a torch.profiler trace of {what} (CPU and, on the "
        "card, CUDA activity) into this directory as a Chrome trace "
        "(view with Perfetto or chrome://tracing)",
    )


def _add_common(p: argparse.ArgumentParser, what: str) -> None:
    """The QC, precision, device and executor flags both subcommands
    take."""
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
    _add_layout(p)
    p.add_argument(
        "--coordinator", metavar="HOST:PORT",
        help="multi-host: torch.distributed (gloo) rendezvous address, "
        "rank 0 listening; every process runs the same command with its "
        "own --process-id and writes <output>.part<id> (merge with "
        "`merge-parts`)",
    )
    p.add_argument("--num-processes", type=int,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int,
                   help="multi-host: this process's rank")
    p.add_argument("--append", action="store_true",
                   help="append to the output instead of replacing it")
    p.add_argument("--checkpoint", help="resume manifest path")
    p.add_argument("--checkpoint-every", type=int, default=512,
                   help="clusters per chunk (one manifest write each)")
    p.add_argument(
        "--prefetch", type=int, default=2, metavar="N",
        help="pipelined chunk executor: pack up to N chunks ahead of the "
        "dispatch lane (0 = serial; the output is the same bytes)",
    )
    p.add_argument(
        "--pack-workers", type=int, default=None, metavar="N",
        help="N threads pack distinct chunks at once, released to the "
        "dispatch lane in order (default min(4, cores/4); 0 = one packer "
        "thread; only with --prefetch > 0)",
    )
    p.add_argument(
        "--h2d-buffer", type=int, default=0, metavar="N",
        help="a transfer lane copies up to N packed bin-mean chunks to the "
        "card ahead of their dispatch, on a side stream (only with "
        "--prefetch > 0; default 0 = off)",
    )
    p.add_argument(
        "--async-write", choices=["auto", "on", "off"], default="auto",
        help="commit chunks (QC rows, MGF append, then the manifest) on a "
        "write lane, in order (auto = on whenever the executor pipelines)",
    )
    p.add_argument(
        "--on-error", choices=["abort", "skip"], default="abort",
        help="a failed chunk aborts the run, or (skip) is retried cluster "
        "by cluster and the failing clusters are recorded and skipped (a "
        "failed QC pass then omits its rows from the report); skip also "
        "diverts malformed MGF records to <output>.quarantine.mgf",
    )
    p.add_argument(
        "--stream-clusters", default="auto", metavar="N|auto|off",
        help="bounded-memory ingest: parse member spectra in windows of N "
        "clusters off a byte index instead of loading the whole MGF "
        "(default auto: streams inputs over 256 MB)",
    )
    p.add_argument(
        "--retries", type=int, default=2, metavar="N",
        help="retry transient failures (I/O errors, device memory "
        "pressure, lane hangs) up to N times per stage with exponential "
        "backoff + deterministic jitter; permanent errors (malformed "
        "input, sticky CUDA errors) never retry (default 2; 0 disables)",
    )
    p.add_argument(
        "--retry-backoff", type=float, default=0.05, metavar="BASE",
        help="base backoff seconds: retry i sleeps BASE * 2^i * "
        "(1 + jitter) (default 0.05)",
    )
    p.add_argument(
        "--no-degrade", action="store_true",
        help="disable graceful degradation: without it a device OOM "
        "splits the chunk in half and re-dispatches (floor 1 cluster)",
    )
    p.add_argument(
        "--watchdog-timeout", type=float, default=0.0, metavar="S",
        help="per-lane stall watchdog: a lane section (pack / dispatch / "
        "write) busy longer than S seconds is counted and logged, and "
        "breaks injected hangs so the retry policy recovers them "
        "(default 0 = off)",
    )
    p.add_argument(
        "--inject-faults", metavar="SPEC",
        help="deterministic fault injection for chaos testing: "
        "comma list of SITE:KIND:RATE[:AFTER[:MAX]] — sites "
        f"{{{','.join(faults.SITES)}}}, kinds "
        f"{{{','.join(faults.KINDS)}}}; the run summary counts "
        "every fired fault (the SPECPRIDE_FAULTS env var arms a child "
        "process instead)",
    )
    p.add_argument(
        "--fault-seed", type=int, default=0, metavar="N",
        help="seed for --inject-faults firing decisions and retry "
        "jitter: same plan + seed fires at the same visits every run",
    )
    p.add_argument(
        "--journal", metavar="FILE",
        help="append-only JSONL run journal: typed events (run_start, "
        "chunk heartbeats, compile/dispatch, checkpoint_write, resume, "
        "run_end) an operator can tail live; multi-host runs write "
        "<FILE>.part<rank> (read with `stats`)",
    )
    p.add_argument(
        "--metrics-out", metavar="FILE",
        help="write run metrics as a Prometheus textfile on exit "
        "(counters and gauges; node_exporter textfile format)",
    )
    _add_trace_dir(p, "the compute")


def _host_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _default_pack_workers() -> int:
    """Default ``--pack-workers``: min(4, cores/4), at least 1."""
    return max(1, min(4, _host_cores() // 4))


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
                   cos_config: CosineConfig, journal=None) -> dict | None:
    """The gate of a reduced-precision run: the first
    ``PRECISION_GATE_SAMPLE`` clusters run again at the run's precision
    and at f32, on twin backends on the same device (their dispatches
    reach neither the run's journal nor its metrics), and every pair's
    binned cosine must reach ``quantize.precision_tolerance(method,
    precision)``.  The f32 twin of a gap average runs the flat layout,
    whose group m/z are the host's float64 means: the reference every
    reduced gap average is held to, as the JAX package holds its reduced
    runs to its host path.  Returns the gate's numbers, journaled as a
    ``precision`` event (None for f32, which is the reference); a breach
    raises ``SystemExit`` with a message after journaling them."""
    precision = backend.precision
    if precision == "f32" or method == "best":
        return None
    sample = [c for c in clusters[:PRECISION_GATE_SAMPLE] if c.n_members]
    tol = quantize.precision_tolerance(method, precision)

    def twin(prec: str):
        flat = prec == "f32" and method == "gap-average"
        return TorchBackend(device=backend.device, precision=prec,
                            max_grid_elements=backend.max_grid_elements,
                            layout="flat" if flat else backend.layout,
                            mesh=None if flat else backend.mesh,
                            batch_config=backend.batch_config)

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
        red = _run_method(twin(precision), method, sample, config)
        ref = _run_method(twin("f32"), method, sample, config)
        cosines = [numpy_backend.binned_cosine(a, b, cos_config)
                   for a, b in zip(red, ref)]
    min_cos = float(min(cosines, default=1.0))
    ok = bool(min_cos >= tol)
    result = {"precision": precision, "gated": True, "checked": len(sample),
              "min_cosine": min_cos,
              "mean_cosine": float(sum(cosines) / len(cosines)) if cosines
              else 1.0,
              "tolerance": tol, "ok": ok}
    if journal is not None:
        journal.emit("precision", method=method, precision=precision,
                     gated=True, checked=len(sample), min_cosine=min_cos,
                     mean_cosine=result["mean_cosine"], tolerance=tol, ok=ok)
    if not ok:
        raise SystemExit(
            f"precision gate failed: {method} at --precision {precision} "
            f"scored min cosine {min_cos:.6f} against f32 over "
            f"{len(sample)} sampled clusters (tolerance {tol}); rerun at "
            "f32 or a wider precision"
        )
    return result


def _cosine_config(args) -> CosineConfig:
    return CosineConfig(normalization=args.qc_normalization)


def _cluster_ids(clusters) -> list[str]:
    """The ids in order: off a streamed input's byte index (nothing
    parsed), else from the clusters."""
    if isinstance(clusters, StreamedClusters):
        return clusters.cluster_ids
    return [c.cluster_id for c in clusters]


def _append_qc_rows(qc: list, clusters, cosines) -> None:
    qc.extend(
        {"cluster_id": c.cluster_id, "n_members": c.n_members,
         "avg_cosine": float(v)}
        for c, v in zip(clusters, cosines)
    )


def _run_method(backend: TorchBackend, method: str, clusters, config,
                scores=None, qc: list | None = None, cos_config=None):
    """One-shot ``method`` over ``clusters``; bin-mean with a ``qc`` list
    runs the fused consensus and QC (``cos_config``) and appends the
    rows."""
    if method == "bin-mean":
        if qc is not None:
            reps, cosines = backend.run_bin_mean_with_cosines(
                clusters, config, cos_config)
            _append_qc_rows(qc, clusters, cosines)
            return reps
        return backend.run_bin_mean(clusters, config)
    if method == "gap-average":
        return backend.run_gap_average(clusters, config)
    if method == "medoid":
        return backend.run_medoid(clusters, config)
    return backend.run_best_spectrum(clusters, scores, config)


def _write_qc_report(args, backend: TorchBackend, clusters, qc: list,
                     resumed_ids: set[str], failed_ids=(),
                     qc_failed_ids=()) -> None:
    """Finalize and write the per-cluster QC report, in the JAX package's
    keys and layout.

    A resume skips the clusters already in the manifest, so their cosines
    were not computed this run: they are recomputed from the
    representatives in the output, in groups of ``--checkpoint-every``
    (the chunks the run committed them in, so the cosines equal an
    uninterrupted run's: the card's f32 scans round by chunk layout).
    Only resume-skipped ids are candidates: clusters a method dropped
    (scoreless best-spectrum, ``--on-error skip``) are no reason to
    re-read the output."""
    have = {row["cluster_id"] for row in qc}
    ids = _cluster_ids(clusters)
    # by index: a streamed input parses only the windows it needs
    missing = [i for i, cid in enumerate(ids)
               if cid in resumed_ids and cid not in have]
    if missing:
        reps_by_id = {s.cluster_id: s for s in read_mgf(args.output)}
        w = args.checkpoint_every if args.checkpoint else len(missing)
        for b0 in range(0, len(missing), w):
            batch = [clusters[i] for i in missing[b0 : b0 + w]]
            pairs = [(reps_by_id[c.cluster_id], c) for c in batch
                     if c.cluster_id in reps_by_id and c.n_members > 0]
            if pairs:
                kept = [c for _, c in pairs]
                _append_qc_rows(qc, kept, backend.average_cosines(
                    [r for r, _ in pairs], kept, _cosine_config(args)))
    order = {cid: i for i, cid in enumerate(ids)}
    qc.sort(key=lambda row: order.get(row["cluster_id"], len(order)))
    cosines = [row["avg_cosine"] for row in qc]
    # rows can be missing because the METHOD dropped or failed the cluster
    # (failed_ids, scoreless best-spectrum) or because the QC pass failed
    have = {row["cluster_id"] for row in qc}
    qc_failed = sorted(i for i in qc_failed_ids if i not in have)
    report = {
        "summary": {
            "n_clusters": len(qc),
            "mean_cosine": statistics.fmean(cosines) if cosines else None,
            "median_cosine": statistics.median(cosines) if cosines else None,
            "n_input_clusters": len(clusters),
            "n_method_failed": len(failed_ids),
            "n_qc_failed": len(qc_failed),
            **({"method_failed_cluster_ids": sorted(failed_ids)}
               if failed_ids else {}),
            **({"qc_failed_cluster_ids": qc_failed} if qc_failed else {}),
        },
        "clusters": qc,
    }
    with open(args.qc_report, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")


# -- the chunked executor ---------------------------------------------------


class _ChunkItem:
    """One chunk flowing from a pack lane to the dispatch lane (or made
    inline when serial)."""

    __slots__ = ("index", "idxs", "part", "prepared", "pack_stats", "error",
                 "wait_s")

    def __init__(self, index: int, idxs: list[int]):
        self.index = index
        self.idxs = idxs
        self.part = None  # the chunk's clusters (None if packing died)
        self.prepared = None  # the backend's PreparedChunk (None: one-shot)
        self.pack_stats = None  # the pack lane's RunStats, merged at handoff
        self.error = None  # the exception packing raised
        self.wait_s = 0.0  # the dispatch lane's wait for this item


def _serial_chunks(clusters, worklist):
    """``--prefetch 0``: each chunk made inline."""
    for chunk_index, idxs in worklist:
        item = _ChunkItem(chunk_index, idxs)
        item.part = [clusters[i] for i in idxs]
        yield item


def _pack_chunk(clusters, chunk_index: int, idxs: list, prepare,
                method: str, config, cos_config, harness: Harness):
    """THE pack stage, the one copy every pack worker runs: the chunk's
    clusters (on a streamed input, the MGF window parse) and the backend's
    host pack (``prepare_chunk``) into a private RunStats, retried whole
    at ``pack`` on a transient error (both halves are pure functions of
    the chunk).  The ``parse`` site fires before the clusters are made,
    ``pack`` before the backend's pack, ``prepare`` inside it.  An error
    that outlives the retries is kept on the item for the dispatch lane's
    ``--on-error`` policy.  Returns ``(item, busy seconds)``."""
    item = _ChunkItem(chunk_index, idxs)
    item.pack_stats = RunStats()
    t0 = time.perf_counter()

    def _stage() -> None:
        # the watchdog section covers one attempt: the backoff between
        # attempts is no stall
        with harness.section("pack"):
            faults.check("parse")
            item.part = [clusters[i] for i in idxs]
            faults.check("pack")
            if prepare is not None and item.part:
                item.prepared = prepare(method, item.part, config,
                                        cos_config=cos_config,
                                        phases=item.pack_stats.phases)

    try:
        harness.retry_call("pack", _stage)
    except Exception as e:  # noqa: BLE001 - raised on the dispatch lane
        item.error = e
    return item, time.perf_counter() - t0


def _lane_inputs(backend: TorchBackend, method: str, args, want_qc: bool):
    """What a pack lane hands ``_pack_chunk``: the prepare function (None
    for a method without a pack stage), the config and the QC config of
    the fused bin-mean."""
    prepare = (backend.prepare_chunk if backend.supports_prepare(method)
               else None)
    cos_config = (_cosine_config(args)
                  if want_qc and method == "bin-mean" else None)
    return prepare, method_config(args), cos_config


def _bounded_put(q: queue.Queue, stop: threading.Event, obj) -> bool:
    """Put ``obj`` unless the consumer stopped; a lane parks on ``stop``
    while the queue is full, so an aborting consumer never deadlocks it."""
    while True:
        if stop.is_set():
            return False
        try:
            q.put(obj, timeout=0.1)
            return True
        except queue.Full:
            if stop.wait(timeout=0.05):
                return False


def _pooled_chunks(clusters, worklist, backend, method, args, prefetch: int,
                   want_qc: bool, n_workers: int, lanes: dict,
                   harness: Harness):
    """``--prefetch P --pack-workers N``, the counterpart of both the JAX
    package's ``_pipelined_chunks`` (its ``--pack-workers 0``, run here as
    one worker) and its ``_pooled_chunks``: N threads pack distinct chunks
    at once and a bounded reorder buffer releases them to the dispatch
    lane strictly in worklist order, so dispatch order, resume and
    ``--on-error skip`` are those of the serial path.  At most
    ``max(prefetch, N)`` chunks are out
    (packing or buffered) at once.  Worker i's busy seconds go to
    ``lanes["pack_busy_s"][i]``; the dispatch lane's waits for chunk s
    while later chunks sat finished go to ``lanes["reorder_stall_s"]``."""
    prepare, config, cos_config = _lane_inputs(backend, method, args,
                                               want_qc)
    n_workers = max(1, min(n_workers, len(worklist)))
    if isinstance(clusters, StreamedClusters):
        # one window slot per worker plus the dispatch lane's walk again
        # under --on-error skip, so the workers' lookahead never thrashes;
        # and the host's cores shared among the workers' window parses
        clusters.cache_slots = max(clusters.cache_slots, n_workers + 1)
        clusters.parse_threads = max(1, _host_cores() // n_workers)
    admit = threading.Semaphore(max(prefetch, n_workers))
    stop = threading.Event()
    cond = threading.Condition()
    buf: dict[int, _ChunkItem] = {}
    state = {"next_task": 0, "exited": 0}
    busy = [0.0] * n_workers
    lanes["pack_busy_s"] = busy

    def _worker(wid: int) -> None:
        claimed: int | None = None  # claimed but not yet delivered
        try:
            while True:
                admit.acquire()
                if stop.is_set():
                    return
                with cond:
                    seq = state["next_task"]
                    if seq >= len(worklist):
                        return
                    state["next_task"] = seq + 1
                claimed = seq
                chunk_index, idxs = worklist[seq]
                item, elapsed = _pack_chunk(clusters, chunk_index, idxs,
                                            prepare, method, config,
                                            cos_config, harness)
                busy[wid] += elapsed
                with cond:
                    buf[seq] = item
                    claimed = None
                    cond.notify_all()
        finally:
            with cond:
                if claimed is not None:
                    # dying between claim and delivery (an exception
                    # outside _pack_chunk's guard): deliver an errored item
                    # so the dispatch lane applies its policy
                    chunk_index, idxs = worklist[claimed]
                    it = _ChunkItem(chunk_index, idxs)
                    it.error = RuntimeError(
                        f"pack worker {wid} died packing chunk {chunk_index}")
                    buf.setdefault(claimed, it)
                state["exited"] += 1
                cond.notify_all()

    threads = [threading.Thread(target=_worker, args=(w,),
                                name=f"specpride-packer-{w}", daemon=True)
               for w in range(n_workers)]
    for t in threads:
        t.start()
    stall = 0.0
    try:
        for seq in range(len(worklist)):
            t_wait = time.perf_counter()
            with cond:
                while seq not in buf:
                    if state["exited"] == n_workers:
                        raise RuntimeError(
                            "pack worker pool exited without delivering "
                            f"chunk {seq}")
                    blocked = bool(buf)
                    seg0 = time.perf_counter()
                    cond.wait(0.1)
                    if blocked:
                        stall += time.perf_counter() - seg0
                item = buf.pop(seq)
            item.wait_s = time.perf_counter() - t_wait
            admit.release()
            yield item
    finally:
        stop.set()
        for _ in threads:
            admit.release()  # unblock workers parked on the admit gate
        with cond:
            cond.notify_all()
        for t in threads:
            t.join()
        lanes["reorder_stall_s"] = lanes.get("reorder_stall_s", 0.0) + stall


def _h2d_staged_chunks(items, backend: TorchBackend, slots: int,
                       lanes: dict):
    """``--h2d-buffer N``: a transfer thread between the pack lanes and the
    dispatch lane takes packed chunks in order and copies each stageable
    one's device inputs to the card (``backend.stage_chunk``: pinned host
    tensors, a side stream, its own event) into a queue of ``slots``, so
    chunk i+1's copy runs while chunk i dispatches.  A staging failure
    lands on ``item.error``; an upstream failure is raised on the dispatch
    lane."""
    q: queue.Queue = queue.Queue(maxsize=max(slots, 1))
    stop = threading.Event()
    busy, staged_bytes, upstream_wait = [0.0], [0], [0.0]
    lanes["h2d_busy_s"] = busy
    lanes["h2d_bytes"] = staged_bytes
    lanes["h2d_upstream_wait_s"] = upstream_wait
    upstream_error: list = [None]

    def _stager() -> None:
        it = iter(items)
        try:
            while True:
                t_wait = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                except BaseException as e:  # noqa: BLE001 - re-raised
                    # a pack-lane failure must abort the run on the
                    # dispatch lane, never end the stream early
                    upstream_error[0] = e
                    return
                upstream_wait[0] += time.perf_counter() - t_wait
                if stop.is_set():
                    return
                if item.error is None and backend.supports_h2d_stage(
                        item.prepared):
                    t0 = time.perf_counter()
                    try:
                        staged_bytes[0] += backend.stage_chunk(item.prepared)
                    except Exception as e:  # noqa: BLE001 - to dispatch lane
                        item.error = e
                    busy[0] += time.perf_counter() - t0
                if not _bounded_put(q, stop, item):
                    return
        finally:
            _bounded_put(q, stop, None)

    t = threading.Thread(target=_stager, name="specpride-h2d", daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if item is None:
                if upstream_error[0] is not None:
                    raise upstream_error[0]
                break
            item.wait_s = time.perf_counter() - t0
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join()
        # the stager drove the pack generator; it is parked now, so close
        # it here to stop the pack lanes at once
        close = getattr(items, "close", None)
        if close is not None:
            close()


class _CommitItem:
    """One finished chunk handed from the dispatch lane to the write lane,
    everything the commit needs taken on the dispatch lane."""

    __slots__ = ("index", "reps", "part_ids", "qc_rows", "failed",
                 "chunk_t0")

    def __init__(self, index, reps, part_ids, qc_rows, failed, chunk_t0):
        self.index = index
        self.reps = reps
        self.part_ids = part_ids
        self.qc_rows = qc_rows  # the chunk's QC rows (or None)
        self.failed = failed  # sorted failures at submit time (or None)
        self.chunk_t0 = chunk_t0  # perf_counter at the chunk's start


def _commit_chunk(item: _CommitItem, args, stats: RunStats, qc: list,
                  done: set, first_write: bool,
                  integrity: OutputIntegrity, harness: Harness,
                  journal) -> None:
    """THE commit protocol, the one copy the inline tail of
    ``_checkpointed_run`` and the ``_Committer`` lane run: the QC rows,
    the MGF append, the counters and the ``chunk_done`` event, then (with
    a checkpoint) the atomic schema-2 manifest replace and its
    ``checkpoint_write`` event, strictly after the append: a kill between
    the two leaves output past the manifest, which a resume truncates.
    The append retries at ``write``, each retry after truncating a
    partial append back to the offset before it (so no record is written
    twice); the manifest replace retries at ``checkpoint_write``."""
    if item.qc_rows:
        qc.extend(item.qc_rows)
    pre_bytes = (os.path.getsize(args.output)
                 if not first_write and os.path.exists(args.output) else 0)

    def _append() -> None:
        with harness.section("write"):
            faults.check("write")
            with stats.phase("write"):
                write_mgf(item.reps, args.output, append=not first_write)

    def _undo_partial_append() -> None:
        # a first write reopens with mode "w": its truncation is built in
        if (not first_write and os.path.exists(args.output)
                and os.path.getsize(args.output) > pre_bytes):
            with open(args.output, "r+b") as fh:
                fh.truncate(pre_bytes)

    harness.retry_call("write", _append, before_retry=_undo_partial_append)
    output_bytes = os.path.getsize(args.output)
    if first_write:
        integrity.reset()
    integrity.absorb(args.output, output_bytes)
    stats.count("clusters", len(item.part_ids))
    stats.count("representatives", len(item.reps))
    done.update(item.part_ids)
    dt = time.perf_counter() - item.chunk_t0
    journal.emit(
        "chunk_done", chunk_index=item.index,
        n_clusters=len(item.part_ids), n_representatives=len(item.reps),
        elapsed_s=round(dt, 4),
        clusters_per_sec=round(len(item.part_ids) / dt, 2) if dt > 0
        else 0.0,
    )
    if args.checkpoint:
        def _replace_manifest() -> None:
            with harness.section("write"):
                faults.check("checkpoint_write")
                tmp = args.checkpoint + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(manifest_payload(done, output_bytes, integrity,
                                               failed=item.failed), fh)
                os.replace(tmp, args.checkpoint)

        harness.retry_call("checkpoint_write", _replace_manifest)
        journal.emit("checkpoint_write", n_done=len(done),
                     output_bytes=output_bytes)


class _Committer:
    """The ordered write lane (``--async-write``): a thread commits
    finished chunks in order from a bounded queue, each through
    ``_commit_chunk``, so a kill at any point leaves a state a serial run
    can leave.  It owns ``done``, ``first_write`` and the QC list from
    construction on.  Its phase time and counters go to a private RunStats
    merged at ``finish``/``shutdown``; a commit error is raised on the
    dispatch lane at the next ``submit`` or at ``finish``, and the lane
    keeps draining its queue after one."""

    def __init__(self, args, qc: list, done: set, first_write: bool,
                 depth: int, integrity: OutputIntegrity, harness: Harness,
                 journal):
        self._args = args
        self._harness = harness
        self._journal = journal
        self._qc = qc
        self._done = done
        self._first_write = first_write
        self._integrity = integrity
        self.stats = RunStats()
        self.busy_s = 0.0
        self.error: BaseException | None = None
        self._merged = False
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._thread = threading.Thread(target=self._run,
                                        name="specpride-committer",
                                        daemon=True)
        self._thread.start()

    def submit(self, item: _CommitItem) -> None:
        if self.error is not None:
            self.finish(None)  # raises the commit error on this lane
        self._q.put(item)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.error is not None:
                continue  # drain; submit() re-raises
            t0 = time.perf_counter()
            try:
                _commit_chunk(item, self._args, self.stats, self._qc,
                              self._done, self._first_write,
                              self._integrity, self._harness, self._journal)
                self._first_write = False
            except BaseException as e:  # noqa: BLE001 - re-raised on submit
                self.error = e
            self.busy_s += time.perf_counter() - t0

    def finish(self, stats: RunStats | None) -> None:
        """Flush every queued commit, stop the lane, fold its counters
        into ``stats`` and raise any commit error."""
        self.shutdown(stats)
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def shutdown(self, stats: RunStats | None) -> None:
        """Idempotent stop: drain, join, merge once, never raise."""
        if self._thread.is_alive():
            self._q.put(None)
        self._thread.join()
        if stats is not None and not self._merged:
            self._merged = True
            stats.merge(self.stats)


def _dispatch_chunk(backend: TorchBackend, method: str, item: _ChunkItem,
                    part, args, stats: RunStats, scores, chunk_qc,
                    harness: Harness):
    """The chunk's device work on the dispatch lane: ``run_prepared`` of
    what the pack lane prepared, else the one-shot method, under the
    recovery ladder (steps 1, 2 and 4 of the JAX package's), per
    (sub-)chunk:

    1. **Split on OOM**: a device allocation failure on a chunk of several
       clusters halves it and dispatches each half through the one-shot
       path (every method is per cluster), down to single clusters.
    2. **Retry with backoff**: a transient error (I/O, a hang the watchdog
       broke, an OOM that cannot be split) runs the same dispatch again,
       up to ``--retries`` times.
    3. **Surface**: anything else, and what outlives the retries, goes to
       ``--on-error``; a permanent error (malformed input, a sticky CUDA
       error) skips the ladder.

    ``--no-degrade`` turns off step 1.  Nothing reroutes a chunk off the
    card (the JAX package's step 3 runs it in numpy)."""
    policy = harness.policy
    config, cos_config = method_config(args), _cosine_config(args)

    def _run_parts(sub_part, prepared):
        attempt = 0
        while True:
            split = None
            try:
                with harness.section("dispatch"):
                    if prepared is not None:
                        reps, cosines = backend.run_prepared(prepared)
                        if chunk_qc is not None and cosines is not None:
                            _append_qc_rows(chunk_qc, sub_part, cosines)
                        return reps
                    return _run_method(backend, method, sub_part, config,
                                       scores, chunk_qc, cos_config)
            except Exception as e:  # noqa: BLE001 - the ladder classifies
                if (harness.degrade and errors.is_oom(e)
                        and len(sub_part) > 1):
                    split = f"{type(e).__name__}: {e}"
                elif attempt < policy.retries and errors.is_transient(e):
                    wait = policy.backoff_s("dispatch", attempt)
                    policy.note_retry("dispatch", attempt, e, wait)
                else:
                    raise
            # out of the except block: the error's traceback, and with it
            # the failed attempt's tensors, is released before the card is
            # asked for memory again
            if split is not None:
                harness.note_degrade("split", split, item.index,
                                     len(sub_part))
                logger.warning("device OOM on a %d-cluster chunk (%s); "
                               "splitting in half", len(sub_part), split)
                mid = (len(sub_part) + 1) // 2
                return (_run_parts(sub_part[:mid], None)
                        + _run_parts(sub_part[mid:], None))
            if wait > 0:
                time.sleep(wait)
            attempt += 1

    with stats.phase("compute"):
        return _run_parts(part, item.prepared)


def _read_manifest(args, integ: OutputIntegrity, harness: Harness,
                   journal):
    """The resume state of ``args.checkpoint``: ``(done, output_bytes,
    restarted, prior_failed)``, each unusable state repaired as the JAX
    package does: an unreadable manifest, a missing output, an output
    shorter than the manifest, a ragged boundary without a hash and a
    sha256 mismatch restart; a torn tail is truncated back.  Each repair
    is journaled (``resume_repair``) and, where the JAX package counts
    it, counted on ``harness``; a run that found a checkpoint journals
    ``resume``.  Seeds ``integ`` with the committed prefix."""
    if not (args.checkpoint and os.path.exists(args.checkpoint)):
        return set(), None, False, []
    state = _manifest_state(args, integ, harness, journal)
    done, _, restarted, prior_failed = state
    logger.info("resuming: %d clusters already done", len(done))
    journal.emit("resume", n_done=len(done), restarted=restarted,
                 n_prior_failed=len(prior_failed))
    return state


def _repair(harness: Harness, journal, action: str, reason: str,
            **fields) -> None:
    harness.note_repair()
    journal.emit("resume_repair", action=action, reason=reason, **fields)


def _manifest_state(args, integ: OutputIntegrity, harness: Harness,
                    journal):
    manifest: dict | None = None
    try:
        with open(args.checkpoint, encoding="utf-8") as fh:
            manifest = json.load(fh)
        if not isinstance(manifest, dict):
            raise ValueError("manifest is not a JSON object")
    except (ValueError, UnicodeDecodeError) as e:
        logger.warning("checkpoint %s is unreadable (%s); restarting from "
                       "scratch", args.checkpoint, e)
        _repair(harness, journal, "restart", "manifest_unreadable",
                error=str(e))
        return set(), 0, True, []
    done = set(manifest.get("done", []))
    prior_failed = list(manifest.get("failed", []))
    raw = manifest.get("output_bytes")
    output_bytes = None if raw is None else int(raw)
    out_size = (os.path.getsize(args.output)
                if os.path.exists(args.output) else None)
    if done and out_size is None:
        logger.warning("checkpoint lists %d done clusters but output %s is "
                       "gone; restarting from scratch", len(done),
                       args.output)
        # no output on disk: nothing a redo could duplicate, so this
        # restart is safe even under --append
        _repair(harness, journal, "restart", "output_missing")
        return set(), 0, False, []
    if output_bytes is not None and out_size is not None:
        if out_size < output_bytes:
            # an append lost after its manifest landed: done-listed
            # clusters are missing from the output
            logger.warning("output %s is %d bytes but the manifest recorded "
                           "%d; restarting from scratch", args.output,
                           out_size, output_bytes)
            _repair(harness, journal, "restart",
                    "output_shorter_than_manifest")
            return set(), 0, True, []
        if out_size > output_bytes:
            logger.info("dropping %d output bytes past the manifest "
                        "(interrupted chunk)", out_size - output_bytes)
            clean = truncate_tail(args.output, output_bytes)
            _repair(harness, journal, "truncate_tail", "torn_tail",
                    n_bytes=out_size - output_bytes, clean_boundary=clean)
            if not clean and not manifest.get("sha256"):
                logger.warning("truncated output does not end on a record "
                               "boundary and the manifest has no sha256; "
                               "restarting from scratch")
                journal.emit("resume_repair", action="restart",
                             reason="ragged_boundary")
                return set(), 0, True, []
    # a bit flip inside the committed prefix passes every byte count: only
    # the hash catches it.  The check also seeds this run's running hash.
    want = manifest.get("sha256")
    if done and output_bytes and os.path.exists(args.output):
        got = integ.seed_file(args.output, output_bytes)
        if want and got != want:
            logger.warning("output %s fails the manifest's sha256 check; "
                           "restarting from scratch", args.output)
            _repair(harness, journal, "restart", "sha256_mismatch")
            integ.reset()
            return set(), 0, True, []
    return done, output_bytes, False, prior_failed


def _checkpointed_run(backend: TorchBackend, method: str, clusters, args,
                      stats: RunStats, scores=None, qc: list | None = None,
                      quarantine: Quarantine | None = None,
                      journal=None):
    """Chunked execution with a resume manifest.

    Each chunk appends to the output FIRST, then the manifest records
    {done ids, output byte size, sha256 of the output} atomically; a kill
    between the two leaves output past the manifest's size, which the
    resume truncates before appending, so no chunk is written twice.
    Chunks are consumed in order whatever the lanes, and every method is
    per cluster, so pipelined and serial runs write the same bytes.

    The run owns a robustness ``Harness`` (``--retries``,
    ``--inject-faults``, ``--watchdog-timeout``, ``--no-degrade``): its
    counts, with the ``quarantine``'s, go to ``stats.robustness`` however
    the run ends, and it is closed (the fault plan disarmed) in a
    ``finally``.  ``journal`` (the run's, else none) receives the chunk,
    checkpoint, resume and robustness events.  Returns ``(resumed ids,
    failed ids, QC-failed ids)``."""
    journal = journal if journal is not None else NullJournal()
    harness = Harness.from_args(args, journal)
    try:
        return _checkpointed_run_impl(backend, method, clusters, args, stats,
                                      scores, qc, harness, journal)
    finally:
        stats.robustness = harness.summary(
            quarantined=quarantine.count if quarantine is not None else 0)
        harness.close()


def _checkpointed_run_impl(backend: TorchBackend, method: str, clusters,
                           args, stats: RunStats, scores, qc, harness,
                           journal):
    integ = OutputIntegrity()
    done, output_bytes, restarted, prior_failed = _read_manifest(
        args, integ, harness, journal)
    ids = _cluster_ids(clusters)
    todo_idx = [i for i, cid in enumerate(ids) if cid not in done]
    resumed_ids = set(done)  # skipped this run (the QC recomputes these)
    stats.count("clusters_skipped_done", len(ids) - len(todo_idx))
    first_write = not done if output_bytes is None else output_bytes == 0
    if args.append:
        if restarted:
            # with --append, earlier user content and this run's partial
            # output cannot be told apart: refuse rather than duplicate
            raise SystemExit(
                f"resume state for {args.output} is unusable (see warning "
                "above) and --append cannot safely redo on top of partial "
                f"output; remove the stale checkpoint {args.checkpoint} "
                "(and clean the output) before re-running"
            )
        # ref average_spectrum_clustering.py:183-184,198: mode 'a'
        first_write = False
    if not first_write and integ.offset == 0 and os.path.exists(args.output):
        # --append over existing content, or a legacy resume: fold the
        # committed prefix into the running hash so the manifests cover
        # the whole output
        integ.seed_file(args.output, output_bytes if output_bytes is not None
                        else os.path.getsize(args.output))
    # chunk size: the checkpoint interval, with or without a checkpoint
    # when the executor can pack this method ahead or the input is streamed
    # (a streamed run stays bounded in memory), else one chunk.  Not the
    # stream's window, as in the JAX package: the chunks set the flat
    # layouts the card's float32 sums round by, so a streamed and a whole
    # read of one input with the same flags chunk alike and write the same
    # bytes.
    prefetch = max(int(args.prefetch or 0), 0)
    can_prepare = prefetch > 0 and backend.supports_prepare(method)
    chunk = (args.checkpoint_every if args.checkpoint or can_prepare
             or isinstance(clusters, StreamedClusters) else 0
             ) or len(todo_idx) or 1

    if not todo_idx:
        # still produce an output file ('a' creates without truncating)
        write_mgf([], args.output, append=not first_write)

    # failures recorded by an interrupted earlier attempt stay recorded
    failed: dict[str, None] = dict.fromkeys(prior_failed)
    qc_failed: dict[str, None] = {}
    worklist = [
        (chunk_index, todo_idx[start : start + chunk])
        for chunk_index, start in enumerate(range(0, len(todo_idx), chunk))
    ]
    # overlap needs two chunks: a one-chunk run takes the serial path
    pipelined = prefetch > 0 and len(worklist) > 1
    n_workers = (_default_pack_workers() if args.pack_workers is None
                 else max(int(args.pack_workers), 0))
    lanes: dict = {"pack_busy_s": [], "reorder_stall_s": 0.0}
    if pipelined:
        # --pack-workers 0 (the JAX package's single packer) is one worker
        items = _pooled_chunks(clusters, worklist, backend, method, args,
                               prefetch, qc is not None, max(n_workers, 1),
                               lanes, harness)
    else:
        items = _serial_chunks(clusters, worklist)
    h2d_slots = max(int(args.h2d_buffer or 0), 0)
    h2d_active = pipelined and h2d_slots > 0 and can_prepare
    if h2d_active:
        items = _h2d_staged_chunks(items, backend, h2d_slots, lanes)
    committer = (
        _Committer(args, qc if qc is not None else [], done, first_write,
                   depth=max(prefetch, 1), integrity=integ, harness=harness,
                   journal=journal)
        if worklist and (args.async_write == "on"
                         or (args.async_write == "auto" and pipelined))
        else None
    )
    idle_s = 0.0
    loop_t0 = time.perf_counter()
    try:
        for item in items:
            part = item.part
            idle_s += item.wait_s
            if item.pack_stats is not None:
                # pack-lane time lands in `pack`, not in the dispatch
                # lane's `compute`
                stats.merge(item.pack_stats)
            chunk_t0 = time.perf_counter()
            journal.emit("chunk_start", chunk_index=item.index,
                         n_clusters=len(item.idxs))
            # the chunk's QC rows reach the shared list only at commit
            chunk_qc: list | None = [] if qc is not None else None
            try:
                if item.error is not None:
                    raise item.error
                reps = _dispatch_chunk(backend, method, item, part, args,
                                       stats, scores, chunk_qc, harness)
            except (ValueError, RuntimeError, OSError) as e:
                # --on-error skip: retry the chunk cluster by cluster, so
                # only the offending clusters are dropped, and record them
                # (OSError here includes an I/O fault or a lane hang that
                # outlived its retries); a sticky CUDA error always aborts:
                # the context is dead, and every cluster would fail
                if args.on_error != "skip" or errors.is_sticky(e):
                    raise
                if part is None:
                    part = [clusters[i] for i in item.idxs]
                logger.warning("chunk of %d clusters failed (%s); retrying "
                               "one by one", len(part), e)
                if chunk_qc is not None:
                    chunk_qc.clear()  # rows of halves that got through
                reps, bad = [], []
                with stats.phase("compute"):
                    for c in part:
                        try:
                            reps.extend(_run_method(
                                backend, method, [c], method_config(args),
                                scores, chunk_qc, _cosine_config(args)))
                        except (ValueError, RuntimeError, OSError) as ce:
                            logger.warning("skipping cluster %s: %s",
                                           c.cluster_id, ce)
                            bad.append(c.cluster_id)
                failed.update(dict.fromkeys(bad))
                stats.count("clusters_failed", len(bad))
            if chunk_qc is not None and not chunk_qc and reps:
                # the QC of every non-fused method, on the dispatch lane:
                # reps align to clusters by id (best drops the scoreless);
                # under --on-error skip a QC failure omits the chunk's rows
                # and keeps its representatives, else it aborts the run
                try:
                    by_id = {r.cluster_id: r for r in reps}
                    kept = [c for c in part if c.cluster_id in by_id]

                    def _qc_pass(kept=kept, by_id=by_id):
                        with stats.phase("compute"):
                            faults.check("qc")
                            return backend.average_cosines(
                                [by_id[c.cluster_id] for c in kept], kept,
                                _cosine_config(args))

                    # a transient QC failure retries like any lane; what
                    # outlives the retries is handled below
                    _append_qc_rows(chunk_qc, kept,
                                    harness.retry_call("qc", _qc_pass))
                except (ValueError, RuntimeError, OSError) as e:
                    if args.on_error != "skip" or errors.is_sticky(e):
                        raise
                    logger.warning("QC cosines failed for a %d-cluster chunk "
                                   "(%s); their rows are omitted from the "
                                   "report", len(part), e)
                    qc_failed.update(dict.fromkeys(c.cluster_id
                                                   for c in part))
                    journal.emit("qc_failure",
                                 cluster_ids=[c.cluster_id for c in part],
                                 error=str(e))
            commit_item = _CommitItem(item.index, reps,
                                      [c.cluster_id for c in part], chunk_qc,
                                      sorted(failed) if failed else None,
                                      chunk_t0)
            if committer is not None:
                committer.submit(commit_item)
            else:
                _commit_chunk(commit_item, args, stats,
                              qc if qc is not None else [], done,
                              first_write, integ, harness, journal)
                first_write = False
        if committer is not None:
            # flush before the lane summary, so the write lane's time is
            # inside the wall and the output is whole before the QC report
            committer.finish(stats)
    finally:
        close = getattr(items, "close", None)
        if close is not None:
            close()  # stop the pack lanes now on an abort
        if committer is not None:
            committer.shutdown(stats)
    if pipelined or committer is not None:
        # device_idle_s: the dispatch lane's waits on the pack lanes, the
        # overlap shortfall: overlap_efficiency = 1 - idle / wall
        wall = time.perf_counter() - loop_t0
        stats.pipeline = {
            "prefetch": prefetch,
            "pack_workers": len(lanes["pack_busy_s"]),
            "async_write": committer is not None,
            "n_chunks": len(worklist),
            "device_idle_s": round(idle_s, 4),
            "wall_s": round(wall, 4),
            "overlap_efficiency": (round(1.0 - idle_s / wall, 4)
                                   if wall > 0 else None),
            "pack_busy_s": [round(b, 4) for b in lanes["pack_busy_s"]],
            "write_busy_s": (round(committer.busy_s, 4)
                             if committer is not None else 0.0),
            "reorder_stall_s": round(lanes["reorder_stall_s"], 4),
        }
        if h2d_active:
            # the staging lane: its bytes and busy time, the dispatch
            # lane's waits it caused (all waits less its own waits on the
            # pack lanes) and the share of its time hidden
            h2d_busy = lanes["h2d_busy_s"][0]
            h2d_stall = max(0.0, idle_s - lanes["h2d_upstream_wait_s"][0])
            stats.pipeline["h2d"] = {
                "slots": h2d_slots,
                "busy_s": round(h2d_busy, 4),
                "bytes": int(lanes["h2d_bytes"][0]),
                "stall_s": round(h2d_stall, 4),
                "overlap_efficiency": (
                    round(max(0.0, 1.0 - h2d_stall / h2d_busy), 4)
                    if h2d_busy > 0 else 1.0),
            }
    if failed:
        logger.warning("%d clusters failed and were skipped: %s%s",
                       len(failed), ", ".join(list(failed)[:5]),
                       "..." if len(failed) > 5 else "")
        # the journal carries the whole list
        journal.emit("skipped_clusters", cluster_ids=sorted(failed))
    return resumed_ids, list(failed), list(qc_failed)


def _is_mzml(path: str) -> bool:
    return path.lower().endswith((".mzml", ".mzml.gz"))


def _clusters_from_mzml(path: str, args) -> list[Cluster]:
    """Direct mzML + MaRaCluster input (ref src/binning.py:33-118): read
    the cluster list, read exactly the clustered scans, title them
    ``cluster;usi`` (with the peptide when ``--msms`` gives one) and
    group them, as the JAX CLI's ``_clusters_from_mzml`` does."""
    if not args.clusters:
        raise SystemExit(
            "an .mzML input needs --clusters <MaRaCluster TSV> (or run "
            "`specpride convert` first)"
        )
    cluster_of = scan_to_cluster(args.clusters)
    spectra = read_mzml_scans(path, scans=set(cluster_of))
    peptides = read_msms_peptides(args.msms) if args.msms else {}
    raw = args.raw_name or os.path.basename(path).split(".")[0]
    out = []
    for scan in sorted(spectra):
        s = spectra[scan]
        s.title = build_title(
            cluster_of[scan], args.px_accession, raw, scan,
            peptides.get(scan),
            s.precursor_charge if peptides.get(scan) else None,
        )
        out.append(s)
    return group_into_clusters(out)


# --stream-clusters auto streams an input larger than this
_STREAM_AUTO_BYTES = 256 * 1024 * 1024


def _load_mgf_clusters(path: str, stream: str,
                       quarantine: Quarantine | None):
    """The clusters of a clustered MGF: a list (the C++ parser), or a
    bounded-memory ``StreamedClusters`` view (``--stream-clusters``:
    "off", "auto" = only for inputs over ``_STREAM_AUTO_BYTES``, or a
    window of N clusters).  A ``.gz`` input has no byte index and loads
    whole, with a warning.

    With a ``quarantine`` (``--on-error skip``) malformed records go to
    ``<output>.quarantine.mgf`` instead of stopping the run: a whole read
    goes through the tolerant Python parser; a streamed one hands over the
    index's truncated spans once here, and its window parses hand over
    every record they reject."""
    mode = (stream or "off").lower()
    window = int(mode) if mode not in ("off", "auto") else 0
    eager = window <= 0 and (mode == "off"
                             or os.path.getsize(path) < _STREAM_AUTO_BYTES)
    if not eager and path.endswith(".gz"):
        logger.warning("--stream-clusters needs a plain MGF (gz has no byte "
                       "index); loading eagerly")
        eager = True
    if eager:
        return group_into_clusters(read_mgf(
            path, malformed=quarantine.add if quarantine is not None
            else None))
    clusters = StreamedClusters(path, window=window or 512)
    if quarantine is not None:
        clusters.on_malformed = quarantine.add
        clusters.drain_malformed(quarantine.add)
    logger.info("streaming %d clusters (%d spectra) in windows of %d",
                len(clusters), clusters.n_spectra, clusters.window)
    return clusters


def load_clusters(args, quarantine: Quarantine | None = None):
    """The clusters of a consensus or select run: an MGF (whole, or
    streamed by ``--stream-clusters``), or an mzML with ``--clusters``;
    ``consensus --single`` makes the whole input one cluster titled with
    the output path (ref average_spectrum_clustering.py:203-205), and no
    spectra no cluster."""
    if _is_mzml(args.input):
        clusters = _clusters_from_mzml(args.input, args)
    else:
        clusters = _load_mgf_clusters(args.input, args.stream_clusters,
                                      quarantine)
    if args.command == "consensus" and args.single:
        spectra = [s for c in clusters for s in c.members]
        clusters = [Cluster(args.output, spectra)] if spectra else []
    return clusters


def _shard_for_process(clusters, args, rank: int, world: int,
                       quarantine: Quarantine | None):
    """Multi-host input sharding (``--coordinator``): rank ``rank`` of
    ``world`` takes the rank-th contiguous block of the clusters (block
    order makes ``merge-parts`` give the single-process bytes) and writes
    ``<output>.part<rank>``; its ``--checkpoint``, ``--qc-report``,
    ``--journal``, ``--metrics-out`` and quarantine file get the same
    suffix, so ranks never share a file.
    Without a coordinator the clusters and output pass through.  Returns
    ``(clusters, output)``."""
    if not args.coordinator:
        return clusters, args.output
    chunk = -(-len(clusters) // max(world, 1))
    lo = min(rank * chunk, len(clusters))
    mine = clusters[lo : min(lo + chunk, len(clusters))]
    part = part_path(args.output, rank)
    if args.checkpoint:
        args.checkpoint = part_path(args.checkpoint, rank)
    if args.qc_report:
        args.qc_report = part_path(args.qc_report, rank)
    if quarantine is not None:
        # every rank parses the whole input before sharding
        quarantine.rename(part_path(quarantine.path, rank))
    if args.journal:
        args.journal = part_path(args.journal, rank)
    if args.metrics_out:
        args.metrics_out = part_path(args.metrics_out, rank)
    logger.info("process %d/%d: %d of %d clusters -> %s", rank, world,
                len(mine), len(clusters), part)
    return mine, part


def _open_run_journal(args, backend: TorchBackend, n_clusters: int):
    """The ``--journal`` stream (a ``NullJournal`` without one), hooked
    into the backend's dispatch events, with ``run_start`` and a clock
    anchor written."""
    journal = open_journal(args.journal)
    backend.journal = journal
    journal.emit("run_start", command=args.command, method=args.method,
                 backend="torch", n_clusters=int(n_clusters),
                 output=args.output, device=str(backend.device),
                 precision=backend.precision)
    if journal.enabled:
        emit_clock_anchor(journal)
    return journal


def _finish_run(args, backend: TorchBackend, stats: RunStats,
                journal) -> None:
    """``run_end`` (the summary and the device counters, the JAX
    package's keys) and, with ``--metrics-out``, the Prometheus
    textfile."""
    device = device_summary(backend.metrics)
    extra = {}
    for key in ("pipeline", "robustness", "precision"):
        value = getattr(stats, key)
        if value:
            extra[key] = value
    journal.emit(
        "run_end", counters=dict(stats.counters),
        phases_s={k: round(v, 4) for k, v in stats.phases.items()},
        elapsed_s=round(stats.elapsed, 4),
        representatives_written=stats.counters.get("representatives", 0),
        clusters_per_sec=round(stats.throughput("clusters"), 2),
        device=device, **extra,
    )
    if args.metrics_out:
        export_run_metrics(backend.metrics, stats, device)
        backend.metrics.write_textfile(args.metrics_out)
        logger.info("metrics -> %s", args.metrics_out)


def _run_pipeline_command(args, backend: TorchBackend, rank: int = 0,
                          world: int = 1) -> dict:
    """THE consensus/select body: parse, the rank's block of the clusters
    (``_shard_for_process``), the journal, the chunked run (under
    ``--trace-dir``'s capture), the QC report, then the precision gate
    (after the outputs, so a breach leaves them on disk to diagnose) and
    ``run_end``.  Returns the run summary."""
    stats = RunStats()
    # --on-error skip arms the quarantine: fresh for each run
    quarantine = (Quarantine(args.output + ".quarantine.mgf")
                  if args.on_error == "skip" else None)
    journal = NullJournal()
    try:
        with stats.phase("parse"):
            clusters = load_clusters(args, quarantine)
        scores = load_scores(args) if args.method == "best" else None
        clusters, args.output = _shard_for_process(clusters, args, rank,
                                                   world, quarantine)
        journal = _open_run_journal(args, backend, len(clusters))
        if quarantine is not None:
            quarantine.bind(journal)  # the blocks found while parsing
        qc = [] if args.qc_report is not None else None
        with device_trace(args.trace_dir, backend.device):
            resumed, failed, qc_failed = _checkpointed_run(
                backend, args.method, clusters, args, stats, scores, qc=qc,
                quarantine=quarantine, journal=journal)
        if qc is not None:
            _write_qc_report(args, backend, clusters, qc, resumed, failed,
                             qc_failed)
        stats.precision = precision_gate(
            backend, args.method, clusters, method_config(args),
            _cosine_config(args), journal)
        _finish_run(args, backend, stats, journal)
    finally:
        journal.close()
        if quarantine is not None:
            quarantine.close()
    return {
        **stats.summary(),
        "clusters_per_sec": round(stats.throughput("clusters"), 3),
        "backend": {
            "device": str(backend.device), "precision": backend.precision,
            "layout": "bucketized" if backend.bucketized else "flat",
            "devices": [str(d) for d in backend.mesh.devices]
            if backend.mesh is not None else [str(backend.device)],
            **({"process": [rank, world]} if args.coordinator else {}),
            "chunks": backend.chunks, "cos_chunks": backend.cos_chunks,
            "phase_s": {k: round(v, 6)
                        for k, v in backend.phase_seconds.items()},
            "h2d_bytes": backend.h2d_bytes, "d2h_bytes": backend.d2h_bytes,
            # this process's kernel launches
            "launches": dict(kernels.launches),
        },
        **({"precision_gate": stats.precision} if stats.precision else {}),
        **({"skipped_cluster_ids": sorted(failed)} if failed else {}),
    }


def run_convert(args) -> dict:
    """``convert``: an mzML input through ``convert_mzml``, else the MGF
    through ``convert_mgf``.  Returns the run summary."""
    stats = RunStats()
    config = BestSpectrumConfig(px_accession=args.px_accession)
    with stats.phase("convert"):
        if _is_mzml(args.input):
            n = convert.convert_mzml(args.input, args.msms, args.clusters,
                                     args.output, args.raw_name, config)
        else:
            n = convert.convert_mgf(
                args.input, args.msms, args.clusters, args.output,
                args.raw_name
                or os.path.basename(args.input).rsplit(".", 1)[0],
                config,
            )
    stats.count("spectra_out", n)
    return stats.summary()


def run_evaluate(args, backend: TorchBackend) -> dict:
    """``evaluate``: each cluster of ``args.clustered`` with a
    representative in ``args.representatives`` scored on ``backend`` (its
    ``--layout`` / ``--mesh``), under ``--trace-dir``'s capture; the
    per-cluster report written if asked.  Returns the summary."""
    reps = {s.cluster_id: s for s in read_mgf(args.representatives)}
    clusters = group_into_clusters(read_mgf(args.clustered))
    pairs = [(reps[c.cluster_id], c) for c in clusters
             if c.cluster_id in reps]
    with device_trace(args.trace_dir, backend.device):
        results = metrics.evaluate(
            [r for r, _ in pairs], [c for _, c in pairs], backend,
            cosine_config=CosineConfig(normalization=args.normalization),
        )
    if args.report:
        metrics.write_report(results, args.report, args.format)
    return metrics.summarize(results)


def run_merge_parts(args) -> int:
    """``merge-parts``: the parts joined (``parallel.parts.merge_parts``);
    1 with the reason on stderr when it refuses."""
    problem = merge_parts(args.output, args.num_processes, args.checkpoint,
                          args.qc_report, args.remove_parts)
    if problem is not None:
        print(problem, file=sys.stderr)
        return 1
    return 0


def _make_backend(args) -> TorchBackend:
    """The backend of a consensus, select or evaluate run: on
    ``--device``, with ``--precision`` and ``--layout``; ``--mesh`` and
    ``--coordinator`` split the (B, K) batches over every visible card of
    the device type (the one CPU under ``--device cpu``)."""
    mesh = None
    if getattr(args, "mesh", False) or getattr(args, "coordinator", None):
        mesh = DeviceMesh.local(args.device)
    return TorchBackend(device=args.device,
                        precision=getattr(args, "precision", "f32"),
                        layout=getattr(args, "layout", "auto"), mesh=mesh)


def run_plot(args) -> int:
    """``plot``: one mirror plot per member of ``args.cluster_id``,
    against its representative in ``--consensus``, else against the
    theoretical spectrum of ``--peptide`` or of the first peptide a
    member's USI names; prints the PNG paths.  Host work only."""
    from specpride_tpu_torch import viz
    from specpride_tpu_torch.data.peaks import peptide_from_usi

    if _is_mzml(args.clustered):
        cluster_list = _clusters_from_mzml(args.clustered, args)
    else:
        cluster_list = group_into_clusters(read_mgf(args.clustered))
    clusters = {c.cluster_id: c for c in cluster_list}
    if args.cluster_id not in clusters:
        print(f"cluster {args.cluster_id!r} not found", file=sys.stderr)
        return 1
    cluster = clusters[args.cluster_id]
    if args.consensus:
        reps = {s.cluster_id: s for s in read_mgf(args.consensus)}
        paths = viz.plot_cluster_vs_consensus(
            cluster.members, reps[args.cluster_id], args.out_prefix)
    else:
        peptide = args.peptide
        charge = cluster.members[0].precursor_charge
        if not peptide:
            for s in cluster.members:
                pep, z = peptide_from_usi(s.usi)
                if pep:
                    peptide, charge = pep, z or charge
                    break
        if not peptide:
            print("no peptide known for cluster; pass --peptide",
                  file=sys.stderr)
            return 1
        paths = viz.plot_cluster_vs_theoretical(
            cluster.members, peptide, charge, args.out_prefix)
    print("\n".join(paths))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.verbose or args.log_json:
        # only when asked: a process that calls main() keeps its logging
        configure_logging(args.verbose, args.log_json)
    if args.command == "plot":
        return run_plot(args)
    if args.command == "stats":
        from specpride_tpu_torch.observability.stats_cli import run_stats

        return run_stats(args.journals, json_out=args.json)
    if args.command == "convert":
        print(json.dumps(run_convert(args)), file=sys.stderr)
        return 0
    if args.command == "merge-parts":
        return run_merge_parts(args)
    try:
        backend = _make_backend(args)
    except RuntimeError as exc:  # no CUDA for the default --device cuda
        ap.error(f"{exc} (here: --device cpu)")
    if args.command == "evaluate":
        print(json.dumps(run_evaluate(args, backend)))
        return 0
    try:
        rank, world = initialize_distributed(
            args.coordinator, args.num_processes, args.process_id)
    except ValueError as exc:
        ap.error(str(exc))
    try:
        # the run summary: one JSON line on stderr
        summary = _run_pipeline_command(args, backend, rank, world)
    finally:
        shutdown_distributed()
    print(json.dumps(summary), file=sys.stderr)
    return 0
