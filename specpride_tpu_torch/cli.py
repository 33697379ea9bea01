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
        [--checkpoint BASE | --elastic DIR|URL] [--qc-report QC.json] \
        [--remove-parts]
    python -m specpride_tpu_torch fleet [--ranks N] [--spares M] \
        [--journal F] -- consensus IN OUT --elastic DIR|URL [...]
    python -m specpride_tpu_torch cas-server [--host H] [--port P] \
        [--url-file F]
    python -m specpride_tpu_torch plot CLUSTERED CLUSTER_ID OUT_PREFIX \
        [--consensus REPS.mgf | --peptide PEPTIDE]
    python -m specpride_tpu_torch stats JOURNAL [JOURNAL ...] [--json F] \
        [--top-spans N] [--trace TRACE_ID] [--incidents]
    python -m specpride_tpu_torch incident-replay JOURNAL [--json F]
    python -m specpride_tpu_torch incidents list|show|export INCIDENT_DIR \
        [INCIDENT_ID]
    python -m specpride_tpu_torch trace JOURNAL [JOURNAL ...] [-o T.json] \
        [--trace-id TRACE_ID | --job JOBID]
    python -m specpride_tpu_torch serve [--socket S] [--workers N] \
        [--batch-window MS] [--journal J] [--metrics-port P] [...]
    python -m specpride_tpu_torch submit [--socket S] -- consensus IN OUT ...
    python -m specpride_tpu_torch profile [--socket S] [--seconds T] \
        [--trace-dir DIR]
    python -m specpride_tpu_torch lint [ROOT] [--select IDS] [--list] \
        [--json F] [--baseline F | --no-baseline | --update-baseline]

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

With ``--elastic DIR|URL`` the ranks instead claim chunk ranges (twice
``--checkpoint-every`` clusters, ``--elastic-range``) under leases from a
shared directory or an object store (``cas-server`` is the in-tree one),
each range run by the same executor and committed once as
``OUT.part<range>``: a dead rank's range goes to a survivor, which
resumes its committed chunks, and a live rank with nothing to claim
steals the tail of a slow one's (``parallel/coordinator.py``).
``merge-parts --elastic`` joins the parts in cluster order; ``fleet``
keeps N such ranks running (``parallel/fleet.py``).  ``--result-store``
adds the result cache's shared tier on such a store, and an elastic
rank's ``--metrics-port`` serves its live ``/metrics``.

The flight recorder (``observability/flightrec.py``): ``--flightrec
observe|on`` on an elastic rank, on ``serve`` and on ``fleet`` taps the
host's journal with a ring of recent records and seven health detectors;
a firing is journaled as an ``incident`` and, with ``on``, dumped as an
atomic bundle under ``--incident-dir``.  As in the JAX CLI, a one-shot
``consensus`` or ``select`` takes the flag and builds no recorder.
``incident-replay`` re-derives every journaled incident from the stream
and ``incidents`` reads the bundles (both torch-free,
``observability/incident_cli.py``); ``stats --incidents`` renders the
incident log.

``evaluate`` scores representatives against their clusters (the mean
binned cosine on the card, flat or with ``--layout bucketized`` / ``--mesh``
on the (B, K) layout, and the b/y-ion fraction on the host) and prints
the summary on stdout (with ``--coordinator``, every rank scores the
whole input, as the JAX CLI's ranks do); ``convert`` builds the
clustered MGF (or mzML) from raw spectra, MaxQuant peptides and
MaRaCluster clusters; ``plot``
draws a cluster's members mirrored against a peptide's theoretical
spectrum or against its representative (matplotlib, no card).  Every MGF
is read and written through the host library (``io/native.py``).

Telemetry, in the JAX package's formats: ``--journal FILE`` appends the
run's events (``run_start``, chunk heartbeats, ``compile`` / ``dispatch``,
``checkpoint_write``, ``resume``, the robustness events, ``precision``,
the spans, ``run_end``) as JSON lines, each with the run's ``trace_id``,
which ``stats`` summarizes (``--top-spans``, ``--trace``) and ``trace``
turns into a Chrome trace; ``--chrome-trace FILE`` writes the run's spans
(parse, pack lanes, chunks, method and ``kernel:*`` dispatches, writes)
as a Chrome trace directly; ``--metrics-out FILE`` writes the run's
metrics as a Prometheus textfile; ``--trace-dir DIR`` captures the run's
compute with ``torch.profiler`` as a Chrome trace, every lane's spans as
ranges beside the card's kernels and copies; the global ``-v`` and
``--log-json`` set the logging.  ``--result-cache DIR[:MB]`` keeps each
computed representative (and its QC cosine) under a digest of its
cluster and the run's method, config and precision; a rerun replays the
stored ones with the bytes of a run without it, and computes only the
clusters it has not seen.

``serve`` keeps the port resident (``serve/daemon.py``): it loads the
libraries and makes each lane's CUDA context, stream and backend once,
then runs ``consensus`` and ``select`` jobs sent by ``submit`` (the
one-shot CLI's argv, its bytes) until SIGTERM drains it; ``profile``
captures a ``torch.profiler`` trace of a running daemon.  ``submit`` and
``profile`` start without torch (``serve/client.py``).

``lint`` is the port's static analyzer (``analysis/``, torch-free): the
JAX package's checkers aimed at the port's own tree and anchors, with
``kernel-hygiene`` in place of ``jit-hygiene``, gated by the port's
baseline ``lint-baseline.torch.json``.
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
from specpride_tpu_torch.analysis import runner as lint_runner
from specpride_tpu_torch.autotune.cli import (
    AUTOTUNE_COMMANDS,
    add_replay_parser,
)
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
from specpride_tpu_torch.observability import tracing
from specpride_tpu_torch.observability.incident_cli import (
    INCIDENT_COMMANDS,
    add_flightrec_flags,
    add_incident_parsers,
)
from specpride_tpu_torch.observability.journal import (
    NullJournal,
    emit_clock_anchor,
    expand_parts,
    open_journal,
)
from specpride_tpu_torch.observability.registry import (
    device_counters_snapshot,
    device_summary,
    export_run_metrics,
)
from specpride_tpu_torch.observability.stats import (
    Lap,
    RunStats,
    add_cpu,
    configure_logging,
    cpu_pair,
    cpu_span,
    device_trace,
)
from specpride_tpu_torch.observability.tracing import TraceContext, Tracer
from specpride_tpu_torch.ops import kernels, quantize
from specpride_tpu_torch.parallel.mesh import (
    DeviceMesh,
    broadcast_from_rank0,
    initialize_distributed,
    shutdown_distributed,
)
from specpride_tpu_torch.parallel.coordinator import Coordinator
from specpride_tpu_torch.parallel.elastic import sha256_file
from specpride_tpu_torch.parallel.fleet import (
    FLEET_COMMANDS,
    add_fleet_parsers,
)
from specpride_tpu_torch.parallel.parts import merge_parts, part_path
from specpride_tpu_torch.parallel.store import is_remote_spec
from specpride_tpu_torch.robustness import errors, faults
from specpride_tpu_torch.robustness.harness import Harness
from specpride_tpu_torch.robustness.integrity import (
    OutputIntegrity,
    manifest_payload,
)
from specpride_tpu_torch.robustness.quarantine import Quarantine
from specpride_tpu_torch.serve.client import add_client_parsers

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
    _add_coordinator(pe, "every process scores the whole input and "
                     "prints the whole summary, as the JAX CLI's ranks do")
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
    pm.add_argument(
        "--elastic", metavar="DIR|URL",
        help="the coordinator store of an --elastic run: its effective "
        "ranges (stolen tails included) give the part ids and their "
        "cluster order, and each part is verified against its range's "
        "commit marker (size and sha256)",
    )
    add_fleet_parsers(sub)

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
    pst.add_argument(
        "--top-spans", type=int, default=0, metavar="N",
        help="also render the N slowest tracing spans (self time, count, "
        "p50/p99) from the journals' span events",
    )
    pst.add_argument(
        "--trace", metavar="HEX32", default=None,
        help="render the critical path of one causal trace (by trace_id) "
        "across the given journal shards: per-hop exclusive seconds on "
        "one clock-anchored axis",
    )
    pst.add_argument(
        "--follow", action="store_true",
        help="tail ONE live journal (a serving daemon's or a running "
        "job's) and render the summary again as events land; Ctrl-C exits",
    )
    pst.add_argument("--interval", type=float, default=1.0, metavar="S",
                     help="poll interval for --follow (default 1s)")
    pst.add_argument(
        "--slo", action="store_true",
        help="also render the per-method SLO table (objective, jobs, "
        "breaches, burn) from a serving daemon's job_done events",
    )
    pst.add_argument(
        "--autotune", action="store_true",
        help="also render the controller's decision log (knob, old -> new, "
        "acted, reason) from the journals' autotune events; works with "
        "--follow",
    )
    pst.add_argument(
        "--incidents", action="store_true",
        help="also render the flight recorder's incident log (detector, "
        "clock, reason, bundled, dedup suppression) from the journals' "
        "incident events; works with --follow",
    )
    add_incident_parsers(sub)
    add_replay_parser(sub)
    lint_runner.add_lint_parser(sub)

    pwu = sub.add_parser(
        "warmup",
        help="dispatch every shape class of a shape manifest once on the "
        "card (the kernel library, the stream's workspace, the device "
        "code of the path's torch ops), so the next run's first chunk "
        "pays none of it",
    )
    pwu.add_argument(
        "manifest",
        help="shape manifest JSON, written by consensus/select runs with "
        "--warmup-manifest (the JAX package's manifests read too)",
    )
    pwu.add_argument(
        "--jobs", type=int, default=0, metavar="N",
        help="entries warmed at once: the port warms one at a time on its "
        "stream, so 0 (the default) and 1 are taken and more is refused",
    )
    pwu.add_argument(
        "--journal", metavar="FILE",
        help="append warmup events (per-kernel status, seconds, launches) "
        "to this JSONL journal",
    )
    pwu.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="where the shape classes are dispatched (default: "
                     "the GPU)")

    pt = sub.add_parser(
        "trace",
        help="reconstruct a Chrome trace-event JSON from run journals "
        "(multi-host .part<rank> shards merge onto one timeline, pid = "
        "rank; view in Perfetto or chrome://tracing)",
    )
    pt.add_argument(
        "journals", nargs="+",
        help="journal file(s) or base paths from --journal runs (a base "
        "path expands to its .part<rank> shards)",
    )
    pt.add_argument("-o", "--out", default="trace.json",
                    help="trace-event JSON output path (default trace.json)")
    pt.add_argument(
        "--job", type=int, default=None, metavar="JOBID",
        help="causal mode: the one trace of this served job (resolved "
        "through a serving daemon journal's job events), every shard's "
        "spans aligned on one wall axis by the clock anchors, with flow "
        "arrows across process tracks",
    )
    pt.add_argument(
        "--trace-id", default=None, metavar="HEX32",
        help="causal mode with an explicit trace id (e.g. a journal "
        "event's trace_id)",
    )
    _add_serve(sub)
    add_client_parsers(sub)
    return ap


def _add_serve(sub) -> None:
    """The ``serve`` subcommand: the JAX CLI's flags the port has."""
    psv = sub.add_parser(
        "serve",
        help="resident daemon: boot once (libraries loaded, each lane's "
        "CUDA context, stream and backend made), then serve consensus and "
        "select jobs over a local unix socket (submit with `submit`; "
        "SIGTERM drains)",
    )
    psv.add_argument("--socket", metavar="PATH", default=None,
                     help="unix socket to serve on (default: "
                     "$SPECPRIDE_SOCKET or "
                     "~/.cache/specpride_tpu_torch/serve.sock)")
    psv.add_argument("--max-queue", type=int, default=16, metavar="N",
                     help="admission bound over all clients; at capacity a "
                     "submit is rejected retriable (default 16)")
    psv.add_argument("--workers", type=int, default=0, metavar="N",
                     help="execution lanes, each with its own backend and "
                     "CUDA stream, round robin over the cards (default 0 = "
                     "min(#cards, 4))")
    psv.add_argument("--batch-window", type=float, default=0.0, metavar="MS",
                     help="cross-job micro-batching: a lane popping an "
                     "eligible job waits up to MS milliseconds for "
                     "compatible queued jobs and computes them in one "
                     "shared pass, each job's bytes its solo run's "
                     "(default 0 = off)")
    psv.add_argument("--batch-max-clusters", type=int, default=4096,
                     metavar="N",
                     help="stop collecting a batch once its clusters reach "
                     "N (default 4096)")
    psv.add_argument("--quota", metavar="CLIENT=WEIGHT[:MAX_INFLIGHT],...",
                     help="per-client scheduling quotas, e.g. "
                     "'teamA=3:2,teamB=1,*=1:1': WEIGHT biases the fair "
                     "queue, MAX_INFLIGHT caps queued + running jobs "
                     "(beyond it a submit is rejected retriable)")
    _add_layout(psv, mesh=False)
    psv.add_argument("--precision", choices=list(quantize.PRECISIONS),
                     default="f32",
                     help="the lanes' packed channel precision (jobs cannot "
                     "override it)")
    psv.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="where the lanes run (default: the GPU; cpu for "
                     "the tests)")
    psv.add_argument("--watchdog-timeout", type=float, default=0.0,
                     metavar="S",
                     help="journal a watchdog_stall when a job holds a lane "
                     "longer than S seconds (default 0 = off)")
    psv.add_argument("--journal", metavar="FILE",
                     help="the daemon's journal: serve_start, job_queued / "
                     "job_start / job_done / job_rejected, batch_dispatch, "
                     "serve_drain (watch with `stats --follow`)")
    psv.add_argument("--journal-rotate-mb", type=float, default=0.0,
                     metavar="N",
                     help="rotate the journal into numbered segments "
                     "(<journal>.1, .2, ...) past N megabytes (default 0 = "
                     "never)")
    psv.add_argument("--metrics-port", type=int, default=None,
                     metavar="PORT",
                     help="serve a live Prometheus /metrics and /healthz on "
                     "this port (0 = ephemeral; default: off)")
    psv.add_argument("--metrics-host", default="127.0.0.1", metavar="HOST",
                     help="bind address for --metrics-port (default "
                     "127.0.0.1)")
    psv.add_argument("--metrics-out", metavar="FILE",
                     help="write the final Prometheus exposition here at "
                     "drain")
    psv.add_argument("--slo", metavar="METHOD=SECONDS,...",
                     help="per-method latency objectives, e.g. "
                     "'bin-mean=2,*=10': each job's queue wait + wall is "
                     "held to its objective, journaled on job_done and "
                     "counted on /metrics (`stats --slo` renders them)")
    psv.add_argument("--result-cache", metavar="DIR[:MB]",
                     help="the result cache every lane shares (jobs cannot "
                     "carry their own)")
    psv.add_argument("--result-store", metavar="DIR|URL",
                     help="(with --result-cache) the cache's shared tier: a "
                     "directory or an http(s):// object store (`cas-server`) "
                     "the whole fleet populates and consults")
    psv.add_argument(
        "--warmup", choices=["auto", "manifest", "off"], default="auto",
        help="boot-time warmup from --warmup-manifest, on every lane's own "
        "stream: auto warms when the file exists, manifest requires it, "
        "off skips (default auto)")
    psv.add_argument("--warmup-manifest", metavar="FILE",
                     help="shape manifest path (no default: the port has no "
                     "compile cache to keep one beside)")
    psv.add_argument(
        "--warmup-jobs", type=int, default=0, metavar="N",
        help="entries warmed at once per lane: each lane warms one at a "
        "time on its stream, so 0 (the default) and 1 are taken and more "
        "is refused")
    psv.add_argument(
        "--autotune", choices=["off", "observe", "on"], default="off",
        help="closed-loop controller over the daemon's live knobs (batch "
        "window, active worker lanes), driven by the journal's own "
        "telemetry: 'observe' journals every would-be decision without "
        "acting, 'on' also acts; every decision is an `autotune` journal "
        "event carrying its evidence.  Requires --journal; replay with "
        "`autotune-replay` (default off)")
    psv.add_argument("--autotune-interval", type=float, default=1.0,
                     metavar="S",
                     help="controller tick interval in seconds (default 1.0)")
    psv.add_argument(
        "--autotune-batch-window", metavar="LO:HI", default=None,
        help="clamp for the tuned batch window in milliseconds, e.g. 0:50: "
        "the controller never moves --batch-window outside [LO, HI] "
        "(default 0:50)")
    add_flightrec_flags(psv)


def _add_layout(p: argparse.ArgumentParser, mesh: bool = True) -> None:
    """``--layout``, and ``--mesh`` unless ``mesh`` is False (``serve``
    places one card per lane, and the JAX ``serve`` has no ``--mesh``)."""
    p.add_argument(
        "--layout", choices=["auto", "flat", "bucketized"], default="auto",
        help="mesh-less device layout (escape hatch: 'bucketized' forces "
        "the (B, K) paths mesh runs use)",
    )
    if not mesh:
        return
    p.add_argument(
        "--mesh", action="store_true",
        help="split each (B, K) batch's clusters over ALL visible cards, "
        "one stream each (single-host multi-card; implied by "
        "--coordinator)",
    )


def _add_coordinator(p: argparse.ArgumentParser, what: str) -> None:
    """``--coordinator``, ``--num-processes`` and ``--process-id``."""
    p.add_argument(
        "--coordinator", metavar="HOST:PORT",
        help="multi-host: torch.distributed (gloo) rendezvous address, "
        f"rank 0 listening; {what}",
    )
    p.add_argument("--num-processes", type=int,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int,
                   help="multi-host: this process's rank")


def _add_trace_dir(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument(
        "--trace-dir", metavar="DIR",
        help=f"capture a torch.profiler trace of {what} (CPU and, on the "
        "card, CUDA activity; the run's spans as ranges on every lane) "
        "into this directory as a Chrome trace (view with Perfetto or "
        "chrome://tracing)",
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
    _add_coordinator(p, "every process runs the same command with its own "
                     "--process-id and writes <output>.part<id> (merge "
                     "with `merge-parts`)")
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
        "--warmup", choices=["auto", "manifest", "off"], default="auto",
        help="shape-class warmup before the pack lane starts: 'auto' "
        "(default) dispatches every class of --warmup-manifest once when "
        "the file exists, and afterwards adds this run's classes to it; "
        "'manifest' requires the file and fails without it; 'off' "
        "disables both.  Each class is journaled as a warmup event (see "
        "`warmup`)",
    )
    p.add_argument(
        "--warmup-manifest", metavar="FILE",
        help="shape manifest path (no default: the port has no compile "
        "cache to keep one beside)",
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
    p.add_argument(
        "--chrome-trace", metavar="FILE",
        help="export the run's span timeline (parse, pack lanes, chunks, "
        "method and per-kernel dispatch, write) as Chrome trace-event "
        "JSON, loadable in Perfetto or chrome://tracing; multi-host runs "
        "write one <FILE>.part<rank> per rank (`trace` over the --journal "
        "shards merges them onto one timeline)",
    )
    p.add_argument(
        "--result-cache", metavar="DIR[:MB]",
        help="content-addressed result cache: per-cluster results keyed by "
        "(cluster content digest, method, config digest, precision, schema "
        "rev) in a bounded local LRU directory (default cap 256 MB; DIR:MB "
        "overrides).  Hits replay the stored representative and QC cosine, "
        "so the output and QC report bytes equal a run without the cache; "
        "a corrupt entry is quarantined and recomputed (bin-mean, "
        "gap-average and medoid)",
    )
    p.add_argument(
        "--result-store", metavar="DIR|URL",
        help="(with --result-cache) the cache's shared tier: a directory or "
        "an http(s):// conditional-put object store (`cas-server`) that "
        "every rank and host populates and consults",
    )
    _add_elastic(p)


def _add_elastic(p: argparse.ArgumentParser) -> None:
    """The elastic run's flags (``--elastic*``) and a rank's live
    ``/metrics``."""
    p.add_argument(
        "--elastic", metavar="DIR|URL",
        help="elastic multi-host mode: ranks claim chunk ranges under a "
        "lease from a shared directory or, with an http(s):// URL, a "
        "conditional-put object store (`cas-server`), and commit each "
        "range once as <output>.part<range> with a sha256 manifest; a dead "
        "rank's uncommitted chunks go to a survivor, a slow rank is "
        "relieved by work stealing (--elastic-steal), and `merge-parts "
        "OUTPUT --elastic DIR|URL` joins the single-process bytes.  The "
        "rank is --process-id, else the lowest free one",
    )
    p.add_argument(
        "--elastic-range", type=int, default=0, metavar="N",
        help="clusters per claimable range (default 0 = twice "
        "--checkpoint-every; a multiple of --checkpoint-every keeps the "
        "chunks, and so the f32 bytes, of a single-process run)",
    )
    p.add_argument(
        "--elastic-ttl", type=float, default=10.0, metavar="S",
        help="lease time-to-live: a rank silent for longer than S (+50%% "
        "grace for clock skew) loses its ranges to a survivor (default 10)",
    )
    p.add_argument(
        "--elastic-heartbeat", type=float, default=0.0, metavar="S",
        help="heartbeat and lease-renewal interval (default 0 = TTL/4)",
    )
    p.add_argument(
        "--elastic-steal", choices=["on", "off"], default="on",
        help="work stealing between live ranks (default on): a rank with "
        "nothing to claim proposes a split of the busiest peer's range, "
        "the donor cuts it at its next chunk boundary (lease_split) and "
        "the tail runs as a new range; 'off' moves only dead ranks' work",
    )
    p.add_argument(
        "--elastic-local", metavar="DIR",
        help="(object-store coordinator) the directory of the per-range "
        "resume manifests (default <output>.elastic); shared by the ranks "
        "of one host, a takeover resumes a dead rank's committed chunks",
    )
    p.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="(with --elastic) serve a live Prometheus /metrics and "
        "/healthz: each rank's heartbeat age "
        "(specpride_rank_heartbeat_age_seconds), the ranges committed, the "
        "lease expiry, reassignment, split and steal counters, and this "
        "rank's device series (0 = an ephemeral port)",
    )
    p.add_argument(
        "--metrics-host", default="127.0.0.1", metavar="HOST",
        help="bind address for --metrics-port (default 127.0.0.1)",
    )
    p.add_argument(
        "--autotune", choices=["off", "observe", "on"], default="off",
        help="(with --elastic) closed-loop controller sizing split-off "
        "ranges from the heartbeats' EWMA chunk walls: 'observe' journals "
        "every would-be --elastic-range decision without acting, 'on' "
        "also caps how much tail a donor cedes per steal; claimed ranges "
        "are never resized, so the merged output stays the same bytes.  "
        "Requires --journal; every decision is an `autotune` event "
        "(default off)",
    )
    add_flightrec_flags(p, "(with --elastic) ")


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
    with tracing.span("precision_gate", n_clusters=len(sample),
                      precision=precision):
        return _gate(backend, method, sample, config, cos_config, journal)


def _gate(backend: TorchBackend, method: str, sample, config,
          cos_config: CosineConfig, journal) -> dict:
    """``precision_gate``'s comparison of the run's precision against f32
    on ``sample``."""
    precision = backend.precision
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
                 "wait_s", "cached")

    def __init__(self, index: int, idxs: list[int]):
        self.index = index
        self.idxs = idxs
        self.part = None  # the chunk's clusters (None if packing died)
        self.prepared = None  # the backend's PreparedChunk (None: one-shot)
        # the result cache's consult of the chunk (None: not consulted)
        self.cached = None
        self.pack_stats = None  # the pack lane's RunStats, merged at handoff
        self.error = None  # the exception packing raised
        self.wait_s = 0.0  # the dispatch lane's wait for this item


def _serial_chunks(clusters, worklist):
    """``--prefetch 0``: each chunk made inline, its clusters (on a
    streamed input, the MGF window parse) timed as ``window_parse``."""
    for chunk_index, idxs in worklist:
        item = _ChunkItem(chunk_index, idxs)
        item.pack_stats = RunStats()
        lap = Lap()
        item.part = [clusters[i] for i in idxs]
        item.pack_stats.add("window_parse", lap.stop())
        yield item


def _pack_chunk(clusters, chunk_index: int, idxs: list, prepare,
                method: str, config, cos_config, harness: Harness,
                span_name: str, rc=None, **span_labels):
    """THE pack stage, the one copy every pack worker runs, under a
    ``span_name`` span (labelled with the attempt's thread CPU): the
    chunk's clusters (on a streamed input, the MGF window parse, timed
    into a private RunStats as the ``window_parse`` phase, whose interval
    the trace holds as ``parse:mgf_window``), the result cache's consult
    (``rc``), and the backend's host pack (``prepare_chunk``, timed in the
    prepared chunk's own stats) of the clusters it missed, retried whole
    at ``pack`` on a transient error (each step is a pure function of the
    chunk).  The ``parse`` site fires before the clusters are made,
    ``pack`` before the backend's pack, ``prepare`` inside it.  An error
    that outlives the retries is kept on the item for the dispatch lane's
    ``--on-error`` policy.  Returns ``(item, laps)``: each attempt's
    span's ``Lap``, the lane's busy time and its thread CPU (the backoff
    between attempts is in none)."""
    item = _ChunkItem(chunk_index, idxs)
    item.pack_stats = RunStats()
    laps = []

    def _stage() -> None:
        # the watchdog section covers one attempt: the backoff between
        # attempts is no stall
        with harness.section("pack"), cpu_span(
                span_name, chunk_index=chunk_index, n_clusters=len(idxs),
                **span_labels) as lap:
            laps.append(lap)
            faults.check("parse")
            parse = Lap()
            item.part = [clusters[i] for i in idxs]
            item.pack_stats.add("window_parse", parse.stop())
            faults.check("pack")
            if rc is not None and item.cached is None:
                # the consult rides the pack lane, so digesting overlaps
                # the dispatch lane; a retry keeps the first verdict
                item.cached = rc.consult(item.part)
            to_pack = item.part
            if item.cached:
                hit = rc.hit_ids(item.cached)
                to_pack = [c for c in item.part if c.cluster_id not in hit]
            if prepare is not None and to_pack:
                item.prepared = prepare(method, to_pack, config,
                                        cos_config=cos_config)

    try:
        harness.retry_call("pack", _stage)
    except Exception as e:  # noqa: BLE001 - raised on the dispatch lane
        item.error = e
    return item, laps


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
    ``lanes["pack_busy_s"][i]`` and its thread CPU over them, ``[user,
    sys]``, to ``lanes["pack_cpu_s"][i]``; the dispatch lane's waits for
    chunk s while later chunks sat finished go to
    ``lanes["reorder_stall_s"]``.
    Worker i packs under ``pipeline:pack[i]`` spans (``pipeline:pack``
    for the one packer of ``N = 0``), and a wait of the dispatch lane of
    a millisecond or more is a ``pipeline:idle`` span."""
    prepare, config, cos_config = _lane_inputs(backend, method, args,
                                               want_qc)
    rc = getattr(args, "_result_cache", None)
    single = n_workers == 0
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
    cpu = [[0.0, 0.0] for _ in range(n_workers)]
    lanes["pack_busy_s"] = busy
    lanes["pack_cpu_s"] = cpu
    # the lanes adopt the run's tracer, so their spans reach its journal
    # whatever scope installed it
    tracer = tracing.current()

    def _worker(wid: int) -> None:
        tracing.set_thread_current(tracer)
        span_name, labels = (("pipeline:pack", {}) if single
                             else (f"pipeline:pack[{wid}]", {"worker": wid}))
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
                item, laps = _pack_chunk(clusters, chunk_index, idxs,
                                         prepare, method, config,
                                         cos_config, harness, span_name,
                                         rc=rc, **labels)
                for lap in laps:
                    busy[wid] += lap.wall
                    add_cpu(cpu[wid], lap)
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
            if item.wait_s >= 1e-3:
                tracing.current().complete("pipeline:idle", t_wait,
                                           item.wait_s,
                                           chunk_index=item.index)
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
    lane.  Each copy is a ``pipeline:h2d`` span, a wait of the dispatch
    lane of a millisecond or more a ``pipeline:idle`` span."""
    q: queue.Queue = queue.Queue(maxsize=max(slots, 1))
    stop = threading.Event()
    tracer = tracing.current()
    busy, staged_bytes, upstream_wait = [0.0], [0], [0.0]
    lanes["h2d_busy_s"] = busy
    lanes["h2d_bytes"] = staged_bytes
    lanes["h2d_upstream_wait_s"] = upstream_wait
    upstream_error: list = [None]

    def _stager() -> None:
        tracing.set_thread_current(tracer)
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
                        with tracing.span("pipeline:h2d",
                                          chunk_index=item.index):
                            staged_bytes[0] += backend.stage_chunk(
                                item.prepared)
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
            if item.wait_s >= 1e-3:
                tracing.current().complete("pipeline:idle", t0, item.wait_s,
                                           chunk_index=item.index)
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
                 "chunk_t0", "max_idx", "populate")

    def __init__(self, index, reps, part_ids, qc_rows, failed, chunk_t0,
                 max_idx=None, populate=None):
        self.index = index
        self.reps = reps
        self.part_ids = part_ids
        self.qc_rows = qc_rows  # the chunk's QC rows (or None)
        self.failed = failed  # sorted failures at submit time (or None)
        self.chunk_t0 = chunk_t0  # perf_counter at the chunk's start
        # the chunk's highest cluster index in the run's input: what the
        # elastic commit fence holds against a ratified split cut
        self.max_idx = max_idx
        # the result cache's entries to commit after the append lands:
        # (key, rep, cluster, cosine) per cluster computed this run
        self.populate = populate


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
    twice); the manifest replace retries at ``checkpoint_write``.  The
    result cache's entries of the chunk are committed last, so a kill
    never leaves an entry for output a resume truncates away.

    An elastic range's run (``args._elastic_fence``) first proves that
    this rank still holds the range's lease and that the chunk lies below
    any ratified split cut: else ``LeaseExpiredError`` (permanent) before
    any byte lands, so a stalled or zombie rank never races the range's
    new owner."""
    fence = getattr(args, "_elastic_fence", None)
    if fence is not None:
        fence(item)
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
                with tracing.span("checkpoint_write", n_done=len(done)):
                    tmp = args.checkpoint + ".tmp"
                    with open(tmp, "w") as fh:
                        json.dump(manifest_payload(done, output_bytes,
                                                   integrity,
                                                   failed=item.failed), fh)
                    os.replace(tmp, args.checkpoint)

        harness.retry_call("checkpoint_write", _replace_manifest)
        journal.emit("checkpoint_write", n_done=len(done),
                     output_bytes=output_bytes)
    rc = getattr(args, "_result_cache", None)
    if rc is not None and item.populate:
        rc.populate(item.populate)  # contains its own failures


class _Committer:
    """The ordered write lane (``--async-write``): a thread commits
    finished chunks in order from a bounded queue, each through
    ``_commit_chunk``, so a kill at any point leaves a state a serial run
    can leave.  It owns ``done``, ``first_write`` and the QC list from
    construction on.  Its phase time and counters go to a private RunStats
    merged at ``finish``/``shutdown``, its busy seconds to ``busy_s`` and
    its thread CPU over them to ``cpu`` (``[user, sys]``); each commit is a
    ``pipeline:write`` span with its CPU; a commit error is raised on the
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
        self.cpu = [0.0, 0.0]
        self.error: BaseException | None = None
        self._merged = False
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._tracer = tracing.current()
        self._thread = threading.Thread(target=self._run,
                                        name="specpride-committer",
                                        daemon=True)
        self._thread.start()

    def submit(self, item: _CommitItem) -> None:
        if self.error is not None:
            self.finish(None)  # raises the commit error on this lane
        self._q.put(item)

    def _run(self) -> None:
        tracing.set_thread_current(self._tracer)
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.error is not None:
                continue  # drain; submit() re-raises
            lap = None
            try:
                with cpu_span("pipeline:write", chunk_index=item.index,
                              n_clusters=len(item.part_ids)) as lap:
                    _commit_chunk(item, self._args, self.stats, self._qc,
                                  self._done, self._first_write,
                                  self._integrity, self._harness,
                                  self._journal)
                self._first_write = False
            except BaseException as e:  # noqa: BLE001 - re-raised on submit
                self.error = e
            if lap is not None:
                self.busy_s += lap.wall
                add_cpu(self.cpu, lap)

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


def _run_chunk(backend: TorchBackend, method: str, item: _ChunkItem,
               clusters, args, stats: RunStats, scores, qc: list | None,
               failed: dict, qc_failed: dict, harness: Harness,
               journal) -> _CommitItem:
    """One chunk on the dispatch lane, up to its commit: the result
    cache's consult (unless a pack lane made it), the dispatch of the
    clusters it missed (``_dispatch_chunk``; with ``--on-error skip`` a
    failed chunk again cluster by cluster, the failures recorded in
    ``failed``), the QC of every non-fused method, and the hits replayed
    at their input positions.  Returns the chunk's ``_CommitItem``."""
    rc = getattr(args, "_result_cache", None)
    part = item.part
    chunk_t0 = time.perf_counter()
    # the chunk's QC rows reach the shared list only at commit
    chunk_qc: list | None = [] if qc is not None else None
    if (rc is not None and item.cached is None and item.error is None
            and part is not None):
        item.cached = rc.consult(part)
    hit_ids = rc.hit_ids(item.cached) if rc is not None else set()
    miss_part = ([c for c in part if c.cluster_id not in hit_ids]
                 if part is not None and hit_ids else part)
    try:
        if item.error is not None:
            raise item.error
        reps = (_dispatch_chunk(backend, method, item, miss_part, args,
                                stats, scores, chunk_qc, harness)
                if miss_part else [])  # every cluster a cache hit
    except (ValueError, RuntimeError, OSError) as e:
        # --on-error skip: retry the chunk cluster by cluster, so only the
        # offending clusters are dropped, and record them (OSError here
        # includes an I/O fault or a lane hang that outlived its retries);
        # a sticky CUDA error always aborts: the context is dead, and
        # every cluster would fail
        if args.on_error != "skip" or errors.is_sticky(e):
            raise
        if part is None:
            part = miss_part = [clusters[i] for i in item.idxs]
        logger.warning("chunk of %d clusters failed (%s); retrying one by "
                       "one", len(miss_part), e)
        if chunk_qc is not None:
            chunk_qc.clear()  # rows of halves that got through
        reps, bad = [], []
        with stats.phase("compute"):
            for c in miss_part:
                try:
                    reps.extend(_run_method(
                        backend, method, [c], method_config(args), scores,
                        chunk_qc, _cosine_config(args)))
                except (ValueError, RuntimeError, OSError) as ce:
                    logger.warning("skipping cluster %s: %s", c.cluster_id,
                                   ce)
                    bad.append(c.cluster_id)
        failed.update(dict.fromkeys(bad))
        stats.count("clusters_failed", len(bad))
    if chunk_qc is not None and not chunk_qc and reps:
        # the QC of every non-fused method, on the dispatch lane: reps
        # align to clusters by id (best drops the scoreless); under
        # --on-error skip a QC failure omits the chunk's rows and keeps
        # its representatives, else it aborts the run
        try:
            by_id = {r.cluster_id: r for r in reps}
            kept = [c for c in miss_part if c.cluster_id in by_id]

            def _qc_pass(kept=kept, by_id=by_id):
                with stats.phase("compute"), tracing.span(
                        "qc", n_clusters=len(kept)):
                    faults.check("qc")
                    return backend.average_cosines(
                        [by_id[c.cluster_id] for c in kept], kept,
                        _cosine_config(args))

            # a transient QC failure retries like any lane; what outlives
            # the retries is handled below
            _append_qc_rows(chunk_qc, kept,
                            harness.retry_call("qc", _qc_pass))
        except (ValueError, RuntimeError, OSError) as e:
            if args.on_error != "skip" or errors.is_sticky(e):
                raise
            logger.warning("QC cosines failed for a %d-cluster chunk (%s); "
                           "their rows are omitted from the report",
                           len(miss_part), e)
            qc_failed.update(dict.fromkeys(c.cluster_id for c in miss_part))
            journal.emit("qc_failure",
                         cluster_ids=[c.cluster_id for c in miss_part],
                         error=str(e))
    populate = None
    if rc is not None and part is not None:
        reps, populate = _merge_cache_hits(rc, part, miss_part, item.cached,
                                           hit_ids, reps, chunk_qc)
    return _CommitItem(item.index, reps, [c.cluster_id for c in part],
                       chunk_qc, sorted(failed) if failed else None,
                       chunk_t0, item.idxs[-1] if item.idxs else None,
                       populate)


def _merge_cache_hits(rc, part, miss_part, cached, hit_ids, reps,
                      chunk_qc):
    """The result cache's side of a chunk: the entries to commit for the
    clusters computed this run (a QC run's only with their cosine, so a
    later hit always replays a QC row), and the chunk's representatives
    with the hits' stored ones at their input positions and the hits' QC
    rows appended (the report is sorted by input order when written, so
    the bytes are those of a run without the cache).  Returns ``(reps,
    populate)``."""
    qc_by_id = ({row["cluster_id"]: row["avg_cosine"] for row in chunk_qc}
                if chunk_qc is not None else None)
    got = {r.cluster_id: r for r in reps}
    populate = []
    for c in miss_part:
        r = got.get(c.cluster_id)
        if r is None:
            continue  # dropped by the method or skipped
        cos = None
        if qc_by_id is not None:
            cos = qc_by_id.get(c.cluster_id)
            if cos is None:
                continue  # the QC failed: no partial entry
        key = (cached or {}).get(c.cluster_id)
        populate.append((key[2] if key is not None else rc.key_of(c),
                         r, c, cos))
    if not hit_ids:
        return reps, populate
    reps = [cached[c.cluster_id][0] if c.cluster_id in hit_ids
            else got[c.cluster_id]
            for c in part if c.cluster_id in hit_ids or c.cluster_id in got]
    if chunk_qc is not None:
        for c in part:
            cos = cached[c.cluster_id][1] if c.cluster_id in hit_ids else None
            if cos is not None:
                chunk_qc.append({"cluster_id": c.cluster_id,
                                 "n_members": c.n_members,
                                 "avg_cosine": float(cos)})
    return reps, populate


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


def chunk_clusters(args, can_prepare: bool, streamed: bool) -> int:
    """The executor's chunk size in clusters, 0 for one chunk of the
    whole input: ``--checkpoint-every`` with a checkpoint, when the pack
    lanes prepare this method ahead (``--prefetch`` > 0), or for a
    streamed input.  The chunks set the flat layouts the card's float32
    sums round by, so the serving batcher cuts a job's clusters by the
    same rule (``serve.batcher.solo_chunk``)."""
    if args.checkpoint or can_prepare or streamed:
        return int(args.checkpoint_every)
    return 0


def _checkpointed_run(backend: TorchBackend, method: str, clusters, args,
                      stats: RunStats, scores=None, qc: list | None = None,
                      quarantine: Quarantine | None = None,
                      journal=None, harness: Harness | None = None):
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
    ``finally``; an elastic rank passes its own ``harness`` instead, one
    for all its ranges (the fault plan's visit counts span them), and
    closes it itself.  ``journal`` (the run's, else none) receives the
    chunk, checkpoint, resume and robustness events.  Returns ``(resumed
    ids, failed ids, QC-failed ids)``."""
    journal = journal if journal is not None else NullJournal()
    owns_harness = harness is None
    if owns_harness:
        harness = Harness.from_args(args, journal)
    try:
        return _checkpointed_run_impl(backend, method, clusters, args, stats,
                                      scores, qc, harness, journal)
    finally:
        stats.robustness = harness.summary(
            quarantined=quarantine.count if quarantine is not None else 0)
        if owns_harness:
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
    chunk = chunk_clusters(args, can_prepare,
                           isinstance(clusters, StreamedClusters)
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
    lanes: dict = {"pack_busy_s": [], "pack_cpu_s": [],
                   "reorder_stall_s": 0.0}
    if pipelined:
        # --pack-workers 0 (the JAX package's single packer) is one worker
        items = _pooled_chunks(clusters, worklist, backend, method, args,
                               prefetch, qc is not None, n_workers, lanes,
                               harness)
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
    # the dispatch lane's thread CPU over its chunks' spans
    dispatch_cpu = [0.0, 0.0]
    loop_t0 = time.perf_counter()
    clip_fn = getattr(args, "_elastic_clip", None)
    try:
        for item in items:
            if clip_fn is not None and item.idxs:
                # an elastic range: before this chunk is dispatched, the
                # coordinator ratifies a pending steal at this boundary
                # (every chunk already dispatched commits below it) or
                # reports the cut; the chunks past it are the thief's
                clip = clip_fn(item.idxs[0])
                if clip is not None and item.idxs[0] >= clip:
                    logger.info("range split: stopping before cluster %d "
                                "of the range (%d chunk(s) ceded)", clip,
                                len(worklist) - item.index)
                    break  # the finally closes the pack and staging lanes
            idle_s += item.wait_s
            if item.pack_stats is not None:
                # pack-lane time lands in `pack`, not in the dispatch
                # lane's `compute`
                stats.merge(item.pack_stats)
            if item.prepared is not None:
                # the backend's pack stages and the staged copy, done
                # before the handoff
                stats.merge(item.prepared.stats)
            journal.emit("chunk_start", chunk_index=item.index,
                         n_clusters=len(item.idxs))
            # the chunk's span is the trace's unit of progress: its
            # compute, QC and (inline) write nest under it
            with cpu_span("chunk", chunk_index=item.index,
                          n_clusters=len(item.idxs)) as lap:
                commit_item = _run_chunk(
                    backend, method, item, clusters, args, stats, scores,
                    qc, failed, qc_failed, harness, journal)
            add_cpu(dispatch_cpu, lap)
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
        # device_idle_s: the dispatch lane's waits on the pack lanes (not
        # the card's idle time), the overlap shortfall:
        # overlap_efficiency = 1 - idle / wall
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
            # each lane's thread CPU, [user, sys], over its busy time
            "pack_cpu_s": [cpu_pair(c) for c in lanes["pack_cpu_s"]],
            "dispatch_cpu_s": cpu_pair(dispatch_cpu),
            "write_cpu_s": cpu_pair(committer.cpu if committer is not None
                                    else (0.0, 0.0)),
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


def _load_clusters_served(args, stats: RunStats,
                          quarantine: Quarantine | None):
    """An MGF's clusters (``_load_mgf_clusters``), on a serving lane
    (``args._serve_worker``) through the daemon's parsed-input residency
    (``serve.ingest_cache``) when the parse is eager, quarantine-free and
    not of a ``.gz``: a repeat job over an unchanged input skips its
    parse.  A one-shot run never consults it."""
    mode = (args.stream_clusters or "off").lower()
    eager = mode == "off" or (
        mode == "auto" and os.path.exists(args.input)
        and os.path.getsize(args.input) < _STREAM_AUTO_BYTES)
    cacheable = (getattr(args, "_serve_worker", None) is not None
                 and quarantine is None and eager
                 and not args.input.endswith(".gz"))
    if cacheable:
        from specpride_tpu_torch.serve import ingest_cache

        clusters, kind = ingest_cache.lookup(args.input)
        if clusters is not None:
            stats.count("ingest_cache_hits", 1)
            if kind == "content":
                stats.count("ingest_cache_content_hits", 1)
            return clusters
    clusters = _load_mgf_clusters(args.input, args.stream_clusters,
                                  quarantine)
    if cacheable and isinstance(clusters, list):
        from specpride_tpu_torch.serve import ingest_cache

        stats.count("ingest_cache_misses", 1)
        ingest_cache.put(args.input, clusters)
    return clusters


def load_clusters(args, quarantine: Quarantine | None = None,
                  stats: RunStats | None = None):
    """The clusters of a consensus or select run: an MGF (whole, or
    streamed by ``--stream-clusters``; on a serving lane through the
    ingest cache), or an mzML with ``--clusters``; ``consensus --single``
    makes the whole input one cluster titled with the output path (ref
    average_spectrum_clustering.py:203-205), and no spectra no
    cluster."""
    if _is_mzml(args.input):
        clusters = _clusters_from_mzml(args.input, args)
    else:
        clusters = _load_clusters_served(args, stats or RunStats(),
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
    ``--journal``, ``--metrics-out``, ``--chrome-trace`` and quarantine
    file get the same suffix, so ranks never share a file.
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
    if args.chrome_trace:
        args.chrome_trace = part_path(args.chrome_trace, rank)
    logger.info("process %d/%d: %d of %d clusters -> %s", rank, world,
                len(mine), len(clusters), part)
    return mine, part


_TRACER_UNSET = object()


def _served(args) -> bool:
    """True on a serving daemon's lane (``args._serve_worker``)."""
    return getattr(args, "_serve_worker", None) is not None


def _install_tracer_early(args) -> None:
    """With ``--journal`` or ``--chrome-trace``, install the run's span
    tracer before the input is parsed, so the parse phase is on the
    timeline too; its spans wait in memory until ``_open_run_journal``
    replays them into the journal.  With ``--trace-dir`` alone it is
    installed too, keeping no span: its spans are the device trace's
    ranges only.  Paired with ``_restore_tracer`` in a ``finally``: an
    early exit never leaves a tracer behind.  A served job installs it
    for its lane's thread only (the lane threads its run starts adopt
    it), so two lanes' spans never cross; a one-shot run process-wide.
    Without any of the three the tracer stays the no-op one."""
    keep = bool(args.journal or args.chrome_trace)
    if keep or getattr(args, "trace_dir", None):
        install = (tracing.set_thread_current if _served(args)
                   else tracing.set_current)
        args._prev_tracer = install(Tracer(keep=keep))


def _restore_tracer(args) -> None:
    """Restore the tracer ``_install_tracer_early`` replaced; idempotent
    (``_finish_run`` restores on success, the command's ``finally`` on
    every exit)."""
    prev = args.__dict__.pop("_prev_tracer", _TRACER_UNSET)
    if prev is not _TRACER_UNSET:
        if _served(args):
            tracing.set_thread_current(prev)
        else:
            tracing.set_current(prev)


def _open_run_journal(args, backend: TorchBackend, n_clusters: int):
    """The ``--journal`` stream (a ``NullJournal`` without one), hooked
    into the backend's dispatch events and bound to the run's trace
    context (``args._trace_ctx``, else ``SPECPRIDE_TRACE``'s, else a new
    one), with ``run_start`` and a clock anchor written; then the span
    tracer, which replays the parse phase's spans after ``run_start``
    and keeps its spans in memory for ``--chrome-trace``."""
    journal = open_journal(args.journal)
    backend.journal = journal
    # a serving lane's registry outlives the job: run_end reports the
    # counters' growth since here, and the shape manifest takes the
    # classes first dispatched since here
    args._device_snapshot = device_counters_snapshot(backend.metrics)
    args._shapes_snapshot = set(backend._seen_shapes)
    ctx = (getattr(args, "_trace_ctx", None) or TraceContext.from_env()
           or TraceContext.mint())
    args._trace_ctx = ctx
    journal.bind_trace(ctx.trace_id)
    journal.emit("run_start", command=args.command, method=args.method,
                 backend="torch", n_clusters=int(n_clusters),
                 output=args.output, device=str(backend.device),
                 precision=backend.precision)
    if journal.enabled:
        # right after run_start: the trace merger fits clocks per run
        emit_clock_anchor(journal)
    if hasattr(args, "_prev_tracer"):
        # parse-phase spans predate the context and carry no span ids;
        # every span from here on does
        tracer = tracing.current()
        tracer.ctx = ctx
        tracer.attach_journal(journal, keep=bool(args.chrome_trace))
    return journal


def _finish_run(args, backend: TorchBackend, stats: RunStats,
                journal) -> None:
    """The result cache's ``result_cache`` event (with a cache), then
    ``run_end`` (the summary and the device counters, the JAX package's
    keys, and on a serving lane the lane's ``worker``); the tracer
    restored, and with ``--chrome-trace`` its spans written; with
    ``--metrics-out``, the Prometheus textfile."""
    device = device_summary(backend.metrics,
                            since=getattr(args, "_device_snapshot", None))
    rc = args.__dict__.pop("_result_cache", None)
    if rc is not None:
        snap = rc.snapshot()
        journal.emit("result_cache", hits=snap["hits"],
                     misses=snap["misses"], populated=snap["populated"],
                     evictions=snap["evictions"],
                     bytes_saved=snap["bytes_saved"],
                     shared_hits=snap["shared_hits"],
                     corrupt=snap["corrupt"], entries=snap["entries"],
                     bytes=snap["bytes"])
        stats.count("result_cache_hits", snap["hits"])
        stats.count("result_cache_misses", snap["misses"])
    extra = {}
    for key in ("pipeline", "robustness", "stream", "precision", "elastic"):
        value = getattr(stats, key)
        if value:
            extra[key] = value
    journal.emit(
        "run_end", counters=dict(stats.counters),
        phases_s={k: round(v, 4) for k, v in stats.phases.items()},
        phases_cpu_s=stats.phases_cpu_s(), cpu_s=stats.cpu_s(),
        elapsed_s=round(stats.elapsed, 4),
        representatives_written=stats.counters.get("representatives", 0),
        clusters_per_sec=round(stats.throughput("clusters"), 2),
        device=device, **extra,
        **({"worker": args._serve_worker} if _served(args) else {}),
    )
    tracer = tracing.current()
    _restore_tracer(args)  # only what this run installed
    if args.chrome_trace and tracer.enabled:
        n = tracer.write_chrome_trace(
            args.chrome_trace, pid=tracing.rank_of_path(args.chrome_trace))
        logger.info("chrome trace (%d spans) -> %s", n, args.chrome_trace)
    if args.metrics_out:
        export_run_metrics(backend.metrics, stats, device)
        backend.metrics.write_textfile(args.metrics_out)
        logger.info("metrics -> %s", args.metrics_out)


def _elastic_range_paths(args, k: int) -> tuple[str, str | None]:
    """The output and QC shard range ``k`` commits: numbered by range,
    not by rank, so the parts in cluster order are the single-process
    output whichever rank ran what."""
    return (part_path(args.output, k),
            part_path(args.qc_report, k) if args.qc_report else None)


def _run_elastic_range(args, coord, claim, clusters, backend: TorchBackend,
                       scores, stats: RunStats, journal, harness: Harness,
                       quarantine: Quarantine | None) -> None:
    """One claimed range through the chunked executor, then its commit.

    The range has its own part, QC shard and resume manifest (in the
    coordinator's ``ck/``), so a takeover resumes like any checkpointed
    run: the dead rank's committed chunks are trusted by their sha256, a
    torn tail is truncated and only the rest is computed.  The executor's
    two hooks bind the range: the commit fence (``commit_fence``) and the
    dispatch lane's clip (``clip_or_ratify``), which stops at a ratified
    steal's cut.  A lost lease abandons the range; else the commit marker
    is created with the part's bytes and sha256 (a second marker of a
    range loses, and both parts hold the same bytes)."""
    k = claim.range.range_id
    sub = clusters[claim.range.start : claim.range.stop]
    args_k = argparse.Namespace(**vars(args))
    args_k.output, args_k.qc_report = _elastic_range_paths(args, k)
    args_k.checkpoint = coord.checkpoint_path(k)
    args_k.append = False
    args_k._elastic_fence = lambda item: coord.commit_fence(
        k, max_idx=item.max_idx, n_clusters=len(item.part_ids),
        chunk_t0=item.chunk_t0)
    args_k._elastic_clip = lambda next_idx: coord.clip_or_ratify(k, next_idx)
    qc: list | None = [] if args_k.qc_report else None
    try:
        resumed, failed, qc_failed = _checkpointed_run(
            backend, args.method, sub, args_k, stats, scores, qc=qc,
            quarantine=quarantine, journal=journal, harness=harness)
        # a split narrowed the range: the QC shard and the commit cover
        # [start, cut), the rest is the thief's range
        rng = coord.effective_range(k)
        if rng.stop < claim.range.stop:
            sub = clusters[claim.range.start : rng.stop]
        if qc is not None:
            _write_qc_report(args_k, backend, sub, qc, resumed, failed,
                             qc_failed)
    except errors.LeaseExpiredError as e:
        # another rank holds the range now (this one stalled past the
        # TTL, or a chunk reached past a cut): the partial state is what
        # its resume repairs
        logger.warning("rank %d abandoning range %d: %s", coord.rank, k, e)
        coord.release(k)
        return
    try:
        with open(args_k.checkpoint, encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (OSError, ValueError):
        manifest = {}
    output_bytes, sha = manifest.get("output_bytes"), manifest.get("sha256")
    if not isinstance(output_bytes, int) or not sha:
        # an empty range writes no chunk and so no manifest
        output_bytes = os.path.getsize(args_k.output)
        sha = sha256_file(args_k.output, output_bytes)
    if not coord.commit(k, {"start": rng.start, "stop": rng.stop,
                            "part": os.path.basename(args_k.output),
                            "output_bytes": output_bytes, "sha256": sha,
                            "n_clusters": rng.n_clusters}):
        logger.warning("rank %d: range %d was already committed by another "
                       "rank", coord.rank, k)
    coord.release(k)


def _warm_device(backend: TorchBackend) -> None:
    """The kernel library built and loaded and the CUDA context made
    before a rank takes any lease, so neither counts against one."""
    if backend.device.type == "cuda":
        import torch

        from specpride_tpu_torch.ops import _build

        _build.load()
        torch.cuda.synchronize(backend.device)


# kernel-name prefixes each method can dispatch: a run's warmup takes
# only what this run can use (the cosine kernels serve every method's
# --qc-report); `warmup` warms a whole manifest
_METHOD_KERNEL_PREFIXES = {
    "bin-mean": ("bin_mean", "cosine_"),
    "gap-average": ("gap_average", "cosine_"),
    "medoid": ("shared_bins", "cosine_"),
    "best": ("cosine_",),
}

# a run's warmup ceiling: a long-lived manifest unions every workload
# ever run, so the rest is logged, never warmed silently
_WARMUP_MAX_ENTRIES = 64


def _run_warmup(args, backend: TorchBackend, journal) -> None:
    """``--warmup``: dispatch each ``--warmup-manifest`` class this method
    can use once before the pack lane starts, journaled as ``warmup``
    events.  ``auto`` without the file does nothing (the run seeds it),
    ``manifest`` without it stops with the JAX CLI's message.  A served
    job skips it: its daemon warmed every lane at boot."""
    mode = args.warmup
    if mode == "off" or getattr(args, "_resident_warm", False):
        return
    path = args.warmup_manifest
    exists = path is not None and os.path.exists(path)
    if mode == "manifest" and not exists:
        raise SystemExit(
            "--warmup manifest: no shape manifest at "
            f"{path or '<no --warmup-manifest and no compile cache>'} "
            "(run the workload once with --warmup auto, or point "
            "--warmup-manifest at a saved one)")
    if not exists:
        return
    from specpride_tpu_torch.warmstart.manifest import load_manifest
    from specpride_tpu_torch.warmstart.warmup import warm_entries

    try:
        entries = load_manifest(path)
    except (OSError, ValueError) as e:
        if mode == "manifest":
            raise SystemExit(f"unreadable shape manifest {path}: {e}")
        logger.warning("ignoring shape manifest %s (%s)", path, e)
        return
    prefixes = _METHOD_KERNEL_PREFIXES.get(args.method)
    if prefixes is not None:
        kept = [e for e in entries if e.kernel.startswith(prefixes)]
        if len(kept) < len(entries):
            logger.info("warmup: %d of %d manifest entries apply to "
                        "--method %s", len(kept), len(entries), args.method)
        entries = kept
    if len(entries) > _WARMUP_MAX_ENTRIES:
        logger.warning("warmup: manifest has %d entries for this method; "
                       "warming the first %d (run `warmup %s` to warm them "
                       "all)", len(entries), _WARMUP_MAX_ENTRIES, path)
        entries = entries[:_WARMUP_MAX_ENTRIES]
    warm_entries(entries, journal=journal, backend=backend)


# serving lanes finish jobs, and so merge manifests, concurrently
_manifest_lock = threading.Lock()


def _save_shape_manifest(args, backend: TorchBackend) -> None:
    """Add the shape classes this run dispatched (those the backend had
    not dispatched before its journal opened: a serving lane's earlier
    jobs are not this run's) to ``--warmup-manifest``, so the next
    process can warm them.  Nothing with ``--warmup off`` or without a
    manifest path."""
    path = args.warmup_manifest
    if args.warmup == "off" or not path:
        return
    seen = set(getattr(backend, "_seen_shapes", ()) or ())
    seen -= getattr(args, "_shapes_snapshot", set())
    if not seen:
        return
    from specpride_tpu_torch.warmstart.manifest import (
        entries_from_seen,
        merge_manifest,
    )

    entries = entries_from_seen(seen, method_config(args))
    if not entries:
        return
    try:
        with _manifest_lock:
            n = merge_manifest(path, entries)
    except (OSError, ValueError) as e:
        logger.warning("could not update shape manifest %s (%s)", path, e)
        return
    logger.info("shape manifest: %d shape class(es) -> %s", n, path)


def run_warmup(args) -> int:
    """``warmup MANIFEST``: every class of the manifest dispatched once on
    ``--device``, each journaled as a ``warmup`` event; one JSON line of
    counts on stdout (the JAX CLI's keys; ``cache_dir`` is null, the port
    has no compile cache)."""
    from specpride_tpu_torch.warmstart.manifest import load_manifest
    from specpride_tpu_torch.warmstart.warmup import check_jobs, warm_entries

    try:
        check_jobs(args.jobs)
    except ValueError as e:
        raise SystemExit(str(e))
    try:
        entries = load_manifest(args.manifest)
    except (OSError, ValueError) as e:
        raise SystemExit(f"unreadable shape manifest {args.manifest}: {e}")
    backend = TorchBackend(device=args.device)
    _warm_device(backend)
    journal = open_journal(args.journal)
    journal.emit("run_start", command="warmup", method="warmup",
                 backend="torch", n_clusters=0, manifest=args.manifest,
                 device=str(backend.device))
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    results = warm_entries(entries, journal=journal, jobs=args.jobs,
                           backend=backend)
    elapsed = time.perf_counter() - t0
    n_hits = sum(r.cache_hit for r in results)
    n_compiled = sum(r.status == "compiled" for r in results)
    for r in results:
        if r.status == "error":
            logger.warning("warmup %s %s failed: %s", r.entry.kernel,
                           list(r.entry.shape_key), r.detail)
    journal.emit(
        "run_end",
        counters={"kernels_warmed": len(results),
                  "warmup_cache_hits": n_hits,
                  "warmup_compiled": n_compiled},
        phases_s={"warmup": round(elapsed, 4)},
        elapsed_s=round(elapsed, 4), device=device_summary(None))
    journal.close()
    print(json.dumps({
        "kernels": len(results), "compiled": n_compiled,
        "cache_hits": n_hits,
        "skipped_or_failed": len(results) - n_hits - n_compiled,
        "seconds": round(elapsed, 3), "cache_dir": None,
        "launches": {k: n - before.get(k, 0)
                     for k, n in kernels.launches.items()},
        "entries": [{"kernel": r.entry.kernel,
                     "shape_key": list(r.entry.shape_key),
                     "status": r.status, "seconds": round(r.seconds, 4),
                     **({"detail": r.detail} if r.detail else {})}
                    for r in results],
    }))
    return 0


def _elastic_rank(args, quarantine: Quarantine | None) -> None:
    """An elastic rank's identity, before its journal opens: the rank
    (``--process-id``, else the lowest free one in the store), the
    ``.part<rank>`` suffix of its ``--journal``, ``--metrics-out``,
    ``--chrome-trace`` and quarantine file, and its trace context (a
    fleet's ``SPECPRIDE_TRACE``, else the one the plan's creator
    registered, else a new one)."""
    if args.append:
        raise SystemExit("--append is not supported with --elastic (each "
                         "range owns its part file; merge with "
                         "`merge-parts`)")
    if args.checkpoint:
        raise SystemExit("--checkpoint is the coordinator's with --elastic "
                         "(per-range manifests under <DIR>/ck/, which a "
                         "takeover resumes from); drop the flag")
    if args.process_id is None:
        args.process_id = Coordinator.assign_rank(args.elastic)
    rank = args.process_id
    for attr in ("journal", "metrics_out", "chrome_trace"):
        if getattr(args, attr):
            setattr(args, attr, part_path(getattr(args, attr), rank))
    if quarantine is not None:
        quarantine.rename(part_path(quarantine.path, rank))
    if TraceContext.from_env() is None:
        plan = Coordinator.read_plan(args.elastic)
        args._trace_ctx = TraceContext.from_env((plan or {}).get("trace"))


def _run_elastic(args, clusters, backend: TorchBackend, scores,
                 stats: RunStats, journal,
                 quarantine: Quarantine | None) -> dict:
    """``--elastic DIR|URL``, the rank's loop: claim a range under a
    lease, run and commit it (``_run_elastic_range``), again; when
    nothing is claimable, steal the tail of a live peer's range, else wait
    as a warm spare until every range carries a commit marker (a peer's
    death is noticed by its lease's expiry).  ``--metrics-port`` serves
    the rank's live ``/metrics``; ``--autotune observe|on`` runs a
    controller over the split hint (``ElasticRangePolicy``);
    ``--flightrec observe|on`` taps the rank's journal with a flight
    recorder (its bundles carry the coordinator's counters and the
    controller's knobs), both stopped before the journal closes.  Returns
    the ``elastic`` summary: the rank, the store, the plan and the lease
    counters."""
    root, rank = args.elastic, args.process_id
    if args.autotune != "off" and not journal.enabled:
        raise SystemExit("--autotune observe|on requires --journal: every "
                         "decision must be journaled as evidence")
    if args.flightrec != "off":
        from specpride_tpu_torch.observability import flightrec

        if not journal.enabled:
            raise SystemExit("--flightrec observe|on requires --journal: "
                             "the detectors fold the journal stream")
        try:
            flightrec.check_mode(args.flightrec, args.incident_dir)
        except ValueError as e:
            raise SystemExit(str(e))
    local_dir = None
    if is_remote_spec(root):
        # the records live in the object store, the resume manifests (files
        # replaced atomically) on a filesystem, shared by a host's ranks
        local_dir = args.elastic_local or f"{args.output}.elastic"
        os.makedirs(local_dir, exist_ok=True)
    range_size = args.elastic_range
    if range_size <= 0:
        range_size = 2 * max(int(args.checkpoint_every), 1)
    _warm_device(backend)
    coord = Coordinator(
        root, rank, len(clusters), range_size, ttl=args.elastic_ttl,
        heartbeat_interval=args.elastic_heartbeat, journal=journal,
        local_dir=local_dir, steal=args.elastic_steal != "off",
        chunk_hint=max(int(args.checkpoint_every), 1),
        trace=args._trace_ctx.to_env())
    logger.info("elastic rank %d: %d ranges of <=%d clusters via %s (ttl "
                "%.1fs, steal %s)", rank, len(coord.ranges), range_size,
                coord.store.describe(), coord.ttl,
                "on" if coord.steal_enabled else "off")
    exporter = metrics_fn = recorder = ctl_thread = None
    if args.autotune != "off":
        from specpride_tpu_torch.autotune import (
            Controller,
            ControllerThread,
            ElasticRangePolicy,
        )

        chunk = max(int(args.checkpoint_every), 1)
        ctl = Controller(journal, mode=args.autotune)
        ctl.register(
            ElasticRangePolicy(lo=chunk, hi=4 * range_size, chunk_hint=chunk),
            get=lambda: coord.split_hint or range_size,
            set=coord.set_split_hint)
        ctl_thread = ControllerThread(ctl, interval=1.0).start()
        logger.info("elastic rank %d: autotune %s (elastic_range clamp [%d, "
                    "%d])", rank, args.autotune, chunk, 4 * range_size)
    if args.metrics_port is not None:
        from specpride_tpu_torch.observability.exporter import (
            ElasticTelemetry,
            MetricsExporter,
        )

        telemetry = ElasticTelemetry(coord,
                                     extra_registries=(backend.metrics,))
        metrics_fn = telemetry.exposition
        exporter = MetricsExporter(telemetry.exposition,
                                   host=args.metrics_host,
                                   port=args.metrics_port,
                                   health=telemetry.health).start()
        logger.info("elastic liveness metrics -> %s", exporter.url)
    if args.flightrec != "off":
        ctl = ctl_thread.controller if ctl_thread is not None else None
        recorder = flightrec.FlightRecorder(
            journal, mode=args.flightrec, incident_dir=args.incident_dir,
            metrics_fn=metrics_fn,
            autotune_fn=((lambda: {"status": ctl.status(),
                                   "knobs": ctl.knob_values()})
                         if ctl is not None else None),
            # the store-derived lease view a dead rank's journal cannot
            # rebuild
            extra_fn=coord.counters,
            config={"host": "elastic", "rank": rank,
                    "store": coord.store.describe(),
                    "n_ranges": len(coord.ranges), "range_size": range_size,
                    "ttl_s": coord.ttl, "steal": coord.steal_enabled,
                    "autotune": args.autotune, "flightrec": args.flightrec},
        ).start()
        logger.info("elastic rank %d: flightrec %s", rank, args.flightrec)
    # one harness for the rank's life: the fault plan's visit counts and
    # the retry accounting span its ranges
    harness = Harness.from_args(args, journal)
    try:
        while True:
            claim = coord.claim_next()
            if claim is None:
                if coord.all_committed():
                    break
                # every open range is leased by a live peer: steal the tail
                # of the busiest one before waiting as a warm spare
                claim = coord.try_steal()
            if claim is None:
                coord.wait_for_work()
                continue
            _run_elastic_range(args, coord, claim, clusters, backend, scores,
                               stats, journal, harness, quarantine)
    finally:
        harness.close()
        if ctl_thread is not None:
            # a last progress beat first (a rank done inside one heartbeat
            # interval gives the drain tick its chunk walls), then the
            # controller stops before the journal closes
            coord.flush_progress()
            ctl_thread.stop()
        if recorder is not None:
            # drains the queued firings into the journal before it closes
            recorder.stop()
        if exporter is not None:
            exporter.stop()
        coord.stop()
    return {"rank": rank, "backend": coord.store.describe(),
            "n_ranges": len(coord.ranges), "range_size": range_size,
            **coord.counters()}


def _run_pipeline_command(args, backend: TorchBackend, rank: int = 0,
                          world: int = 1) -> dict:
    """THE consensus/select body: the span tracer (with ``--journal`` or
    ``--chrome-trace``), parse, the result cache's run context
    (``--result-cache``, ``--result-store``), the rank's block of the
    clusters (``_shard_for_process``), the journal, the chunked run (under
    ``--trace-dir``'s capture), the QC report, then the precision gate
    (after the outputs, so a breach leaves them on disk to diagnose) and
    ``run_end``.  The ranks of a ``--coordinator`` run share rank 0's
    trace context unless ``SPECPRIDE_TRACE`` hands them one.  An
    ``--elastic`` run gates first, before its rank claims any range, then
    runs its ranges (``_run_elastic``).  Returns the run summary."""
    from specpride_tpu_torch.cache import result_cache

    stats = RunStats()
    if args.coordinator and TraceContext.from_env() is None:
        args._trace_ctx = TraceContext.from_env(broadcast_from_rank0(
            TraceContext.mint().to_env() if rank == 0 else None))
    _install_tracer_early(args)
    # --on-error skip arms the quarantine: fresh for each run
    quarantine = (Quarantine(args.output + ".quarantine.mgf")
                  if args.on_error == "skip" else None)
    journal = NullJournal()
    try:
        with stats.phase("parse"):
            clusters = load_clusters(args, quarantine, stats)
        scores = load_scores(args) if args.method == "best" else None
        args._result_cache = result_cache.runtime_for(args, args.command,
                                                      backend)
        clusters, args.output = _shard_for_process(clusters, args, rank,
                                                   world, quarantine)
        if args.metrics_port is not None and not args.elastic:
            logger.warning("--metrics-port serves an elastic rank's live "
                           "metrics; ignoring it without --elastic (the "
                           "run's metrics: --metrics-out)")
        if args.autotune != "off" and not args.elastic:
            logger.warning("--autotune tunes an elastic rank's split ranges "
                           "(serve has its own); ignoring it without "
                           "--elastic")
        if args.elastic:
            # the gate first: a reduced precision that fails it claims no
            # range (its verdict rides the rank's run_end)
            stats.precision = precision_gate(
                backend, args.method, clusters, method_config(args),
                _cosine_config(args))
            _elastic_rank(args, quarantine)
        journal = _open_run_journal(args, backend, len(clusters))
        if quarantine is not None:
            quarantine.bind(journal)  # the blocks found while parsing
        _run_warmup(args, backend, journal)
        failed = ()
        if args.elastic:
            with device_trace(args.trace_dir, backend.device):
                stats.elastic = _run_elastic(args, clusters, backend, scores,
                                             stats, journal, quarantine)
        else:
            qc = [] if args.qc_report is not None else None
            with device_trace(args.trace_dir, backend.device):
                resumed, failed, qc_failed = _checkpointed_run(
                    backend, args.method, clusters, args, stats, scores,
                    qc=qc, quarantine=quarantine, journal=journal)
            if qc is not None:
                _write_qc_report(args, backend, clusters, qc, resumed,
                                 failed, qc_failed)
            stats.precision = precision_gate(
                backend, args.method, clusters, method_config(args),
                _cosine_config(args), journal)
        if isinstance(clusters, StreamedClusters):
            stats.stream = clusters.counts.summary()
        _save_shape_manifest(args, backend)
        _finish_run(args, backend, stats, journal)
    finally:
        _restore_tracer(args)
        args.__dict__.pop("_result_cache", None)
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
        **({"elastic": stats.elastic} if args.elastic else {}),
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


def run_stats_command(args) -> int:
    """``stats``: the journals' summary (``--top-spans N`` adds the N
    slowest spans, ``--slo`` a serving daemon's SLO table), with
    ``--follow`` again as one live journal grows, or with ``--trace ID``
    the critical path of that causal trace across the journals."""
    from specpride_tpu_torch.observability import traceplane
    from specpride_tpu_torch.observability.stats_cli import run_stats

    if args.trace:
        view = traceplane.extract_trace(args.journals, args.trace)
        for w in view.warnings:
            print(f"warning: {w}", file=sys.stderr)
        traceplane.render_critical_path(view, sys.stdout)
        return 0 if view.spans else 1
    if args.follow:
        from specpride_tpu_torch.observability.stats_cli import follow_stats

        if len(args.journals) != 1:
            raise SystemExit("--follow tails exactly one journal")
        return follow_stats(args.journals[0], interval=args.interval,
                            top_spans=args.top_spans, slo=args.slo,
                            incidents=args.incidents, autotune=args.autotune)
    return run_stats(args.journals, json_out=args.json,
                     top_spans=args.top_spans, slo=args.slo,
                     incidents=args.incidents, autotune=args.autotune)


def run_trace(args) -> int:
    """``trace``: one Chrome trace from run journals, ``.part<rank>``
    shards merged onto one timeline (pid = rank).  Schema violations (a
    killed run's torn last line) are reported on stderr and dropped.
    ``--trace-id`` (or ``--job``, resolved through a serving daemon's job
    events) takes exactly one trace's spans from every shard instead,
    aligned on one wall axis by the clock anchors, with flow arrows
    across process tracks."""
    from specpride_tpu_torch.observability import traceplane

    if args.job is not None or args.trace_id:
        trace_id = args.trace_id
        if trace_id is None:
            files: list[str] = []
            for p in args.journals:
                got, warn = expand_parts(p)
                files.extend(got)
                for w in warn:
                    print(f"warning: {w}", file=sys.stderr)
            trace_id = traceplane.resolve_job_trace(files, args.job)
            if trace_id is None:
                print(f"no trace_id found for job {args.job} in the given "
                      "journals", file=sys.stderr)
                return 1
        view = traceplane.build_trace_chrome(args.journals, trace_id,
                                             args.out)
        for w in view.warnings:
            print(f"warning: {w}", file=sys.stderr)
        for v in view.violations:
            print(f"dropped: {v}", file=sys.stderr)
        if not view.spans and not view.instants:
            print(f"trace {trace_id}: no matching events in the given "
                  "journals", file=sys.stderr)
            return 1
        print(f"trace {trace_id}: {len(view.spans)} spans across "
              f"{len(view.shards)} process track(s), clock-skew bound "
              f"{view.skew_bound_s:.4f}s -> {args.out}", file=sys.stderr)
        return 0
    n_spans, n_files, warnings, violations = tracing.build_chrome_trace(
        args.journals, args.out)
    for w in warnings:
        print(f"warning: {w}", file=sys.stderr)
    for v in violations:
        print(f"dropped: {v}", file=sys.stderr)
    if n_files == 0:
        print("no journal files to read", file=sys.stderr)
        return 1
    if n_spans == 0 and violations:
        # every span line was invalid: almost always the wrong input
        print("no valid span events read: pass the --journal files, not "
              "the --chrome-trace output", file=sys.stderr)
        return 1
    print(f"{n_spans} spans -> {args.out}", file=sys.stderr)
    return 0


def run_merge_parts(args) -> int:
    """``merge-parts``: the parts joined (``parallel.parts.merge_parts``;
    with ``--elastic`` in the order of the run's effective ranges); 1
    with the reason on stderr when it refuses."""
    problem = merge_parts(args.output, args.num_processes, args.checkpoint,
                          args.qc_report, args.remove_parts, args.elastic)
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


def run_serve(args) -> int:
    """``serve``: boot the daemon and serve until SIGTERM (drain); 1
    after a sticky CUDA error."""
    from specpride_tpu_torch.observability.exporter import parse_slo_spec
    from specpride_tpu_torch.serve.daemon import ServeDaemon
    from specpride_tpu_torch.serve.scheduler import parse_quota_spec

    try:
        slo = parse_slo_spec(args.slo)
        quotas = parse_quota_spec(args.quota)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.workers < 0:
        raise SystemExit(f"--workers must be >= 0 (got {args.workers})")
    if args.batch_window < 0:
        raise SystemExit(
            f"--batch-window must be >= 0 ms (got {args.batch_window})")
    if args.batch_max_clusters < 1:
        raise SystemExit("--batch-max-clusters must be >= 1 "
                         f"(got {args.batch_max_clusters})")
    if args.autotune != "off" and not args.journal:
        raise SystemExit("serve --autotune observe|on requires --journal: "
                         "every decision must be journaled as evidence")
    autotune_bw = None
    if args.autotune_batch_window:
        from specpride_tpu_torch.autotune.policy import parse_clamp

        try:
            autotune_bw = parse_clamp(args.autotune_batch_window,
                                      "--autotune-batch-window")
        except ValueError as e:
            raise SystemExit(str(e))
    from specpride_tpu_torch.warmstart.warmup import check_jobs

    try:
        check_jobs(args.warmup_jobs, "--warmup-jobs")
    except ValueError as e:
        raise SystemExit(str(e))
    if args.flightrec != "off" and not args.journal:
        raise SystemExit("serve --flightrec observe|on requires --journal: "
                         "the detectors fold the journal stream")
    if args.flightrec == "on" and not args.incident_dir:
        raise SystemExit("serve --flightrec on dumps bundles and therefore "
                         "requires --incident-dir (use 'observe' to journal "
                         "firings without bundles)")
    if args.result_store and not args.result_cache:
        raise SystemExit("serve --result-store is the result cache's shared "
                         "tier; it needs --result-cache DIR[:MB] for the "
                         "local tier")
    return ServeDaemon(
        args.socket, device=args.device, max_queue=args.max_queue,
        workers=args.workers, batch_window=args.batch_window / 1000.0,
        batch_max_clusters=args.batch_max_clusters, quotas=quotas,
        layout=args.layout, precision=args.precision,
        watchdog_timeout=args.watchdog_timeout, journal_path=args.journal,
        journal_rotate_mb=args.journal_rotate_mb,
        metrics_port=args.metrics_port, metrics_host=args.metrics_host,
        metrics_out=args.metrics_out, slo=slo,
        result_cache=args.result_cache, result_store=args.result_store,
        flightrec=args.flightrec, incident_dir=args.incident_dir,
        autotune=args.autotune, autotune_interval=args.autotune_interval,
        autotune_batch_window=autotune_bw, warmup=args.warmup,
        warmup_manifest=args.warmup_manifest, warmup_jobs=args.warmup_jobs,
    ).run()


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.verbose or args.log_json:
        # only when asked: a process that calls main() keeps its logging
        configure_logging(args.verbose, args.log_json)
    if args.command in ("submit", "profile"):
        from specpride_tpu_torch.serve.client import CLIENT_COMMANDS

        return CLIENT_COMMANDS[args.command](args)
    if args.command == "serve":
        try:
            return run_serve(args)
        except RuntimeError as exc:  # no CUDA for the default --device cuda
            ap.error(f"{exc} (here: --device cpu)")
    if args.command == "plot":
        return run_plot(args)
    if args.command == "stats":
        return run_stats_command(args)
    if args.command == "trace":
        return run_trace(args)
    if args.command == "convert":
        print(json.dumps(run_convert(args)), file=sys.stderr)
        return 0
    if args.command == "merge-parts":
        return run_merge_parts(args)
    if args.command in FLEET_COMMANDS:
        return FLEET_COMMANDS[args.command](args)
    if args.command in INCIDENT_COMMANDS:
        return INCIDENT_COMMANDS[args.command](args)
    if args.command in AUTOTUNE_COMMANDS:
        return AUTOTUNE_COMMANDS[args.command](args)
    if args.command == "lint":
        return lint_runner.main(args)
    if args.command == "warmup":
        try:
            return run_warmup(args)
        except RuntimeError as exc:  # no CUDA for the default --device cuda
            ap.error(f"{exc} (here: --device cpu)")
    try:
        backend = _make_backend(args)
    except RuntimeError as exc:  # no CUDA for the default --device cuda
        ap.error(f"{exc} (here: --device cpu)")
    try:
        rank, world = initialize_distributed(
            args.coordinator, args.num_processes, args.process_id)
    except ValueError as exc:
        ap.error(str(exc))
    try:
        if args.command == "evaluate":
            # every rank scores the whole input, as the JAX CLI's do
            print(json.dumps(run_evaluate(args, backend)))
            return 0
        # the run summary: one JSON line on stderr
        summary = _run_pipeline_command(args, backend, rank, world)
    finally:
        shutdown_distributed()
    print(json.dumps(summary), file=sys.stderr)
    return 0
