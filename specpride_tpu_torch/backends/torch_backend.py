"""The port's device backend: binned-mean and gap-average consensus and
the QC cosine, on the flat layout.

``TorchBackend.run_bin_mean`` packs every kept peak flat on the host
(``data.packed.pack_flat_bin_mean``), computes per chunk on the host what
its sorted pass gives exactly (run counts, the integer quorum, the m/z
means), sends intensities and composite keys to the card, runs
``ops.binning.bin_mean_flat_intensity`` there and assembles the spectra
from the host m/z means and the card's intensity means.  At a reduced
``precision`` the intensities cross as bf16 or int8 codes and the keys as
a 1-byte run-start mask (``ops.binning.bin_mean_flat_q``).

``TorchBackend.run_gap_average`` sorts and groups every cluster's peaks
and takes each group's mean m/z on the host in float64
(``data.packed.pack_flat_gap``), and runs
``ops.gap_average.gap_average_groups`` (the intensity means, quorum and
dynamic-range floor) on the card per chunk.

``TorchBackend.medoid_indices`` bucketizes the clusters
(``data.packed.pack_bucketize``), bins and sorts each row by (bin, member)
on the host, counts every member pair's shared bins on the card
(``ops.similarity.shared_bins_packed``) and picks each medoid on the host
in float64 (``ops.similarity.medoid_finalize``).  ``run_best_spectrum``
is a host join and argmax (``numpy_backend.run_best_spectrum``).

``TorchBackend.average_cosines`` lays member and representative peaks
each along one flat axis sorted by (row, spectrum, bin) on the host,
gates intensities by each pair's grid cutoff, looks up each member peak's
rep bin, and runs ``ops.similarity.cosine_flat`` on the card per chunk,
always in f32.  ``run_bin_mean_with_cosines`` is the two in a row, on
one ``SpectraTable``.

With ``layout="bucketized"`` (or a ``mesh``) the binned mean, the gap
average and the QC cosine run on the JAX package's (B, K) layout instead:
clusters of like size share a batch, each row one cluster
(``data.packed.pack_bucketize_bin_mean``, ``pack_bucketize_gap``,
``pack_bucketize``), the binned mean's m/z means and float32 quorum on the
card (``ops.binning.bin_mean_deduped_compact``), the gap average's through
``ops.gap_average.gap_average_compact2d`` and the cosine through
``ops.similarity.cosine_packed``.  A ``parallel.mesh.DeviceMesh`` splits
each batch's rows over its devices, one stream each; without one the rows
run on ``device``.  ``layout="auto"`` is the flat layout on one device.

Each of the three card paths is two phases (``prepare_chunk``, host work
only, and ``run_prepared``, the dispatch and finalize), the protocol the
CLI's chunked executor drives from its pack and dispatch lanes; the
one-shot ``run_*`` entry points are the two in a row, so the executor and
the one-shot calls share one copy of each method.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from specpride_tpu_torch.backends import numpy_backend
from specpride_tpu_torch.config import (
    BatchConfig,
    BestSpectrumConfig,
    BinMeanConfig,
    CosineConfig,
    GapAverageConfig,
    MedoidConfig,
)
from specpride_tpu_torch.data.packed import (
    SENTINEL,
    _as_table,
    _grouped_arange,
    merge_cluster_sources,
    pack_bucketize,
    pack_bucketize_bin_mean,
    pack_bucketize_gap,
    pack_flat_bin_mean,
    pack_flat_gap,
)
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.data.table import SpectraTable
from specpride_tpu_torch.observability import tracing
from specpride_tpu_torch.observability.journal import NullJournal
from specpride_tpu_torch.observability.registry import MetricsRegistry
from specpride_tpu_torch.observability.stats import Lap, RunStats
from specpride_tpu_torch.ops import binning, gap_average, quantize, similarity
from specpride_tpu_torch.parallel.mesh import (
    DeviceMesh,
    row_align,
    shard_span,
)
from specpride_tpu_torch.robustness import faults
from specpride_tpu_torch.ops.segsort import (
    searchsorted_right_i32,
    seg_argsort,
)

PHASES = (
    "pack", "h2d", "kernel", "d2h", "finalize",
    "qc_pack", "qc_h2d", "qc_kernel", "qc_d2h",
)
PREPARED_METHODS = ("bin-mean", "gap-average", "medoid")
# the method span of a prepared chunk: the name of its one-shot entry's
# span (and of the JAX package's), so executor and one-shot traces read
# alike
_METHOD_SPANS = {"bin-mean": "method:bin_mean",
                 "gap-average": "method:gap_average",
                 "medoid": "method:medoid"}
LAYOUTS = ("auto", "flat", "bucketized")


def _add_time(phases: dict, phase: str, t0: float) -> None:
    phases[phase] = phases.get(phase, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass
class PreparedChunk:
    """Host product of ``TorchBackend.prepare_chunk``, phase 1 of the
    two-phase chunk protocol: numpy arrays and host tensors built with no
    device call and no write to the backend, so pack workers can build
    chunks while the dispatch lane runs an earlier one.  ``stats``, its
    own, holds the wall and thread CPU of its host stages (and of a
    staged copy, ``stage_chunk``); ``run_prepared`` adds their seconds to
    the backend's ``phase_seconds`` on the dispatch lane."""

    method: str  # one of PREPARED_METHODS
    clusters: list
    config: object
    cos_config: object | None = None
    data: dict = dataclasses.field(default_factory=dict)
    stats: RunStats = dataclasses.field(default_factory=RunStats)


def check_no_empty(clusters: list[Cluster]) -> None:
    """Zero-member clusters are rejected up front, so no output can be
    misaligned against its input."""
    for c in clusters:
        if c.n_members == 0:
            raise ValueError(f"empty cluster {c.cluster_id!r}")


def check_uniform_charge(table: SpectraTable) -> None:
    """All precursor charges in each cluster of ``table`` must be equal
    (ref src/binning.py:206 assert, a ValueError here)."""
    idx = table.cluster_order()
    charges = table.precursor_charge[idx.order]
    filled = idx.n_members > 0
    first = np.repeat(charges[idx.offsets[:-1][filled]],
                      idx.n_members[filled])
    if np.any(charges != first):
        raise ValueError("Not all precursor charges in cluster are equal")


def _iter_compacted(fused: np.ndarray, cap: int, n_rows: int):
    """``(row, mz, intensity)`` of a compacted ``[flat_mz (cap) |
    flat_intensity (cap) | n_out (rows)]`` output
    (``ops.binning.compact_rows``), float64 copies, in row order."""
    flat_mz = fused[:cap]
    flat_int = fused[cap : 2 * cap]
    n_out = fused[2 * cap :].astype(np.int64)
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(n_out[:n_rows], out=offsets[1:])
    for ci in range(n_rows):
        o0, o1 = int(offsets[ci]), int(offsets[ci + 1])
        yield (ci, flat_mz[o0:o1].astype(np.float64),
               flat_int[o0:o1].astype(np.float64))


class TorchBackend:
    """Runs the consensus on ``device`` ("cuda" unless the caller asks for
    "cpu").  ``max_grid_elements // 4`` bounds the peaks of one chunk.
    ``precision`` ("f32", "bf16" or "int8") is the encoding of the
    consensus channels sent to the card; the QC cosine is always f32.
    ``layout`` ("auto" or "flat": the flat layout; "bucketized": the (B,
    K) rows of ``batch_config``'s buckets) and ``mesh`` (a
    ``DeviceMesh`` the rows are split over; it implies "bucketized")
    choose where the consensus and the QC run.

    ``phase_seconds`` accumulates wall seconds per phase over calls (the
    kernel phases from CUDA events on the card); the ``qc_*`` phases are
    the QC cosine's, the others the consensus's or the medoid's.
    ``h2d_bytes`` counts the bytes of the arrays copied to ``device`` in
    the ``h2d`` and ``qc_h2d`` phases, ``d2h_bytes`` those fetched back in
    the ``d2h`` and ``qc_d2h`` phases.  ``chunks`` counts the consensus or
    medoid chunks run (a bucketized chunk per device block) and
    ``cos_chunks`` the cosine chunks; ``bucket_elements`` the real and
    padded peak slots of the bucketized consensus chunks;
    ``medoid_encodings`` counts the medoid chunks by the integer width of
    the bins and member ids they shipped ("i32", or "i16" narrowed at a
    reduced ``precision``).  These are written on the dispatch lane only
    (``run_prepared`` and the one-shot calls); ``prepare_chunk`` and
    ``stage_chunk`` (the pack workers' and the H2D stager's calls) write
    none of them.  A backend belongs to one lane: the one-shot CLI's main
    lane, or one serve worker lane, whose backend the daemon builds and
    warms on its main thread before that worker's thread starts.  The
    lint's lane-safety check sees the class written from both lanes and
    is told so at each write (``# lint: ok[lane-safety]``)."""

    def __init__(
        self, device: str | torch.device = "cuda",
        max_grid_elements: int = 64 * 1024 * 1024,
        precision: str = "f32",
        layout: str = "auto",
        mesh: DeviceMesh | None = None,
        batch_config: BatchConfig | None = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend: CUDA is not available on this host; pass "
                "device='cpu' to run on the CPU"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if precision not in quantize.PRECISIONS:
            raise ValueError(f"precision must be one of {quantize.PRECISIONS}"
                             f", got {precision!r}")
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got "
                             f"{layout!r}")
        self.max_grid_elements = int(max_grid_elements)
        self.precision = precision
        self.layout = layout
        # the devices the bucketized rows are split over: the mesh, else
        # ``device`` on its current stream
        self.mesh = mesh
        self._rows = (mesh if mesh is not None
                      else DeviceMesh([self.device], own_streams=False))
        self.batch_config = batch_config or BatchConfig()
        self.reset_run_counters()
        # the staging lane's copy stream (stage_chunk); kernels never run
        # on it, so the per-(device, stream) workspaces stay one per lane
        self._h2d_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        # run telemetry (the CLI's --journal and --metrics-out): the
        # device counters, the dispatch events and the kernel shape
        # classes seen, each one's first dispatch counted as a compile
        self.metrics = MetricsRegistry()
        self.journal = NullJournal()
        self._seen_shapes: set[tuple] = set()

    def reset_run_counters(self) -> None:
        """Zero the per-run accounting (``phase_seconds``, the H2D and D2H
        bytes, the chunk counts, ``bucket_elements``,
        ``medoid_encodings``): a serving lane's backend runs many jobs,
        and each job's summary reports its own.  The metrics registry,
        the shape classes seen and the streams stay."""
        # real and padded peak slots of the bucketized consensus dispatches
        self.bucket_elements = {"real": 0, "padded": 0}
        self.phase_seconds = dict.fromkeys(PHASES, 0.0)
        self.h2d_bytes = {"h2d": 0, "qc_h2d": 0}  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        self.d2h_bytes = {"d2h": 0, "qc_d2h": 0}  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        self.chunks = 0  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        self.cos_chunks = 0  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        self.medoid_encodings = {"i32": 0, "i16": 0}  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker

    # -- two-phase chunk protocol (the CLI's chunked executor) ----------

    @property
    def bucketized(self) -> bool:
        """True when the consensus and the QC cosine run on the (B, K)
        layout: ``layout="bucketized"`` or a mesh."""
        return self.mesh is not None or self.layout == "bucketized"

    def supports_prepare(self, method: str) -> bool:
        """True for the methods with a host pack stage (the three card
        paths, at every precision); ``best`` is a host join and has none.
        On the bucketized layout the consensus packs per bucket inside its
        dispatch, as the JAX package's does, and has none either."""
        if self.bucketized and method in ("bin-mean", "gap-average"):
            return False
        return method in PREPARED_METHODS

    def prepare_chunk(
        self, method: str, clusters: list[Cluster], config,
        cos_config: CosineConfig | None = None,
    ) -> PreparedChunk | None:
        """Phase 1: every host input ``method`` needs for ``clusters``:
        validation, the packs, their sorts and host run passes, and, for
        bin-mean with ``cos_config``, the QC member prep on the same
        ``SpectraTable``.  No device call and no write to the backend, so
        pack workers may call it side by side on distinct chunks.  Its
        stages' wall and thread CPU go to the chunk's own ``stats``.
        None for a method without a pack stage.
        The ``prepare`` fault site."""
        if not self.supports_prepare(method):
            return None
        faults.check("prepare")
        return self._prepare(method, clusters, config, cos_config)

    def _prepare(self, method, clusters, config,
                 cos_config=None) -> PreparedChunk:
        prepared = PreparedChunk(method, clusters, config, cos_config)
        if method == "bin-mean":
            self._prepare_bin_mean(prepared)
        elif method == "gap-average":
            self._prepare_gap_average(prepared)
        else:
            self._prepare_medoid(prepared)
        return prepared

    def run_prepared(
        self, prepared: PreparedChunk
    ) -> tuple[list[Spectrum], np.ndarray | None]:
        """Phase 2, on the dispatch lane: the chunk's device work and
        finalize.  Returns ``(representatives, cosines or None)``; cosines
        for bin-mean prepared with a ``cos_config``.  The ``dispatch``
        fault site."""
        faults.check("dispatch")
        name = _METHOD_SPANS[prepared.method]
        if prepared.method == "bin-mean" and prepared.cos_config is not None:
            name = "method:bin_mean_with_cosines"
        with tracing.span(name, backend="torch", prepared=True):
            return self._run_prepared(prepared)

    def _run_prepared(self, prepared: PreparedChunk):
        self._merge_prepared(prepared)
        if prepared.method == "bin-mean":
            return self._finish_bin_mean(prepared)
        if prepared.method == "gap-average":
            return self._finish_gap_average(prepared), None
        indices = self._finish_medoid(prepared)
        return [c.members[i] for c, i in zip(prepared.clusters, indices)], None

    def _merge_prepared(self, prepared: PreparedChunk) -> None:
        for phase, seconds in prepared.stats.phases.items():
            self.phase_seconds[phase] += seconds
        staged = prepared.data.pop("staged_bytes", 0)
        self.h2d_bytes["h2d"] += staged  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        self._note_h2d(staged)

    def supports_h2d_stage(self, prepared: PreparedChunk | None) -> bool:
        """True when ``stage_chunk`` can copy the chunk's device inputs
        ahead of its dispatch: the flat bin-mean's."""
        return prepared is not None and prepared.method == "bin-mean"

    def stage_chunk(self, prepared: PreparedChunk) -> int:
        """The H2D staging lane's step (``--h2d-buffer``): copy a prepared
        bin-mean chunk's device inputs now, from pinned host tensors on the
        backend's side stream, and wait on that copy's own event (never on
        the device, which would wait for the dispatch lane's kernels too).
        The dispatch lane's stream waits on the event before its kernel
        (``_take_staged``).  Returns the bytes staged; they and the seconds
        go to the chunk, merged by ``run_prepared``."""
        lap = Lap()
        staged, total = [], 0
        hosts = [tensors for _, tensors, _, _ in prepared.data["chunks"]]
        if self.device.type == "cuda":
            with torch.cuda.stream(self._h2d_stream):
                copies = [[t.pin_memory().to(self.device, non_blocking=True)
                           for t in tensors] for tensors in hosts]
                event = torch.cuda.Event()
                event.record(self._h2d_stream)
            event.synchronize()
        else:
            copies = [[t.to(self.device) for t in ts] for ts in hosts]
            event = None
        for tensors, dev in zip(hosts, copies):
            total += sum(t.numel() * t.element_size() for t in tensors)
            staged.append((dev, event))
        prepared.data["staged"] = staged
        prepared.data["staged_bytes"] = total
        prepared.stats.add("h2d", lap.stop())
        return total

    def _take_staged(self, staged) -> list:
        """A staged chunk's device tensors, ready for the current stream:
        it waits on the copy's event, and the caching allocator is told the
        tensors are used there (they were allocated on the side stream)."""
        tensors, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    # -- binned-mean consensus -------------------------------------------

    @tracing.traced("method:bin_mean", backend="torch")
    def run_bin_mean(
        self, clusters: list[Cluster], config: BinMeanConfig = BinMeanConfig()
    ) -> list[Spectrum]:
        """One consensus spectrum per cluster, in input order (ref
        src/binning.py:291-297)."""
        return self._one_shot("bin-mean", clusters, config)[0]

    def _one_shot(self, method: str, clusters, config, cos_config=None):
        """A one-shot entry: one ``dispatch`` fault-site visit (as the
        JAX package's ``run_*``), then both phases, or on the bucketized
        layout the consensus's bucket loop (and the QC cosine after it)."""
        faults.check("dispatch")
        if self.bucketized and method == "bin-mean":
            reps = self._run_bin_mean_bucketized(clusters, config)
            if cos_config is None:
                return reps, None
            return reps, self.average_cosines(reps, clusters, cos_config)
        if self.bucketized and method == "gap-average":
            return self._run_gap_average_bucketized(clusters, config), None
        return self._run_prepared(
            self._prepare(method, clusters, config, cos_config))

    def _prepare_bin_mean(self, prepared: PreparedChunk) -> None:
        """The flat pack and each chunk's host run pass and host tensors;
        with a ``cos_config``, the QC member prep on the same table."""
        clusters, config = prepared.clusters, prepared.config
        check_no_empty(clusters)
        lap = Lap()
        table = _as_table(clusters)
        check_uniform_charge(table)
        prepared.data["table"] = table
        prepared.data["chunks"] = [
            (batch, *self._flat_chunk_host_args(batch, config))
            for batch in pack_flat_bin_mean(
                table, config, max_elements=self.max_grid_elements // 4,
                precision=self.precision,
            )
        ]
        prepared.stats.add("pack", lap.stop())
        if prepared.cos_config is not None:
            lap = Lap()
            prepared.data["mprep"] = self._prep_cosine_members(
                table, prepared.cos_config)
            prepared.stats.add("qc_pack", lap.stop())

    def _finish_bin_mean(
        self, prepared: PreparedChunk
    ) -> tuple[list[Spectrum], np.ndarray | None]:
        clusters = prepared.clusters
        staged = prepared.data.pop("staged", None)
        out: list[Spectrum | None] = [None] * len(clusters)
        for i, (batch, *host) in enumerate(prepared.data["chunks"]):
            fused, aux = self._flat_chunk_dispatch(
                batch, host, staged=staged[i] if staged else None,
            )
            t0 = time.perf_counter()
            self._emit_bin_mean_rows(batch, fused, aux,
                                     prepared.data["table"], out)
            self.phase_seconds["finalize"] += time.perf_counter() - t0
        if prepared.cos_config is None:
            return out, None
        return out, self._cosines_from_members(
            out, prepared.data["mprep"], prepared.cos_config)

    def _sync(self, device: torch.device | None = None) -> None:
        device = device or self.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _put(self, phase: str, tensors: list[torch.Tensor],
             device: torch.device | None = None) -> list:
        """Host tensors copied to ``device`` (default: the backend's),
        synchronized; the time goes to ``phase_seconds[phase]`` and the
        bytes to ``h2d_bytes[phase]``."""
        t0 = time.perf_counter()
        out = [t.to(device or self.device) for t in tensors]
        self._sync(device)
        self.phase_seconds[phase] += time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        self.h2d_bytes[phase] += nbytes  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        self._note_h2d(nbytes)
        return out

    def _fetch(self, phase: str, t: torch.Tensor) -> np.ndarray:
        """``t`` copied to the host; the time goes to
        ``phase_seconds[phase]`` and the bytes to ``d2h_bytes[phase]``.
        The ``d2h`` fault site."""
        faults.check("d2h")
        t0 = time.perf_counter()
        out = t.cpu().numpy()
        self.phase_seconds[phase] += time.perf_counter() - t0
        self.d2h_bytes[phase] += out.nbytes  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        self.metrics.counter(
            "specpride_bytes_d2h_total", "bytes fetched device->host",
        ).inc(out.nbytes)
        self._note_device_memory(t.device)
        return out

    # -- telemetry hooks (the JAX package's metric names and events) -----

    def _note_h2d(self, nbytes: int) -> None:
        self.metrics.counter(
            "specpride_bytes_h2d_total", "bytes shipped host->device",
        ).inc(nbytes)

    def _note_dispatch(self, kernel: str, shape_key: tuple,
                       dispatch: tuple, *, rows: int, padded_rows: int,
                       real_elems: int | None = None,
                       padded_elems: int | None = None) -> None:
        """One device dispatch, on the dispatch lane: the per-kernel
        dispatch counters, the real and padded rows and (given) elements,
        the ``specpride_dispatch_seconds`` histogram of the host seconds,
        the journal's ``dispatch`` event and a ``kernel:<kernel>`` span
        over ``dispatch``, the host's ``(t0, seconds)`` of the call (as
        ``_timed`` returns it; asynchronous to the card, as the JAX
        package's dispatch seconds are); the first dispatch of a
        (kernel, shape class) counts in ``specpride_compiles_total`` and
        journals ``compile``, as the JAX package's first XLA compile of a
        shape does (the port compiles nothing per shape: the counter
        keeps the JAX package's name and meaning of a new shape class).
        The port pads nothing to a shape class: a class is what changes
        the kernels' instantiation or a padded width, the channel
        precision of the flat paths and the bucket widths of the (B, K)
        ones."""
        m = self.metrics
        key = (kernel, *shape_key)
        is_new_shape = key not in self._seen_shapes
        if is_new_shape:
            self._seen_shapes.add(key)
            m.counter(
                "specpride_compiles_total",
                "first dispatch of a (kernel, shape class)",
                labels=("kernel",),
            ).inc(1, kernel=kernel)
            self.journal.emit("compile", kernel=kernel,
                              shape_key=list(shape_key))
        m.counter("specpride_dispatches_total", "device kernel dispatches",
                  labels=("kernel",)).inc(1, kernel=kernel)
        m.counter("specpride_rows_real_total",
                  "real cluster rows dispatched",
                  labels=("kernel",)).inc(rows, kernel=kernel)
        m.counter("specpride_rows_padded_total",
                  "dispatched cluster rows incl. shape padding",
                  labels=("kernel",)).inc(padded_rows, kernel=kernel)
        pack = {}
        if real_elems is not None and padded_elems:
            m.counter("specpride_pack_real_elements_total",
                      "real packed elements shipped",
                      labels=("kernel",)).inc(real_elems, kernel=kernel)
            m.counter("specpride_pack_padded_elements_total",
                      "packed elements shipped incl. padding",
                      labels=("kernel",)).inc(padded_elems, kernel=kernel)
            pack = {"real_elems": int(real_elems),
                    "padded_elems": int(padded_elems)}
        m.histogram("specpride_dispatch_seconds",
                    "dispatch-call host wall time (asynchronous: "
                    "excludes device execution)",
                    labels=("kernel",)).observe(dispatch[1], kernel=kernel)
        self.journal.emit("dispatch", kernel=kernel, rows=rows,
                          padded_rows=padded_rows, **pack)
        tracing.current().complete(
            f"kernel:{kernel}", *dispatch, kernel=kernel,
            shape_key=list(shape_key), rows=rows, padded_rows=padded_rows,
            compile=is_new_shape, **pack)

    def _note_device_memory(self, device: torch.device) -> None:
        """The device memory high-water gauge: the caching allocator's
        ``max_memory_allocated`` on the card, 0 on the CPU."""
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        g = self.metrics.gauge(
            "specpride_device_peak_bytes_in_use",
            "high-water device memory (bytes) observed at collect time",
        )
        g.set(max(float(peak), g.value()))

    def _timed(self, phase: str, fn, device: torch.device | None = None):
        """``fn()``, its time added to ``phase``: CUDA events around it on
        the current stream of the card (the caller has synchronized, so
        only ``fn``'s work is timed), the host clock on the CPU.  Returns
        ``(fn's result, (t0, seconds))``: the host's call of ``fn``, its
        dispatch on the card (the ``kernel:*`` span's interval)."""
        if (device or self.device).type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            self.phase_seconds[phase] += dt
            return out, (t0, dt)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        end.record()
        end.synchronize()
        self.phase_seconds[phase] += start.elapsed_time(end) / 1e3
        return out, (t0, dt)

    def _host_run_pass(self, batch, config: BinMeanConfig) -> dict:
        """Per-run host pass over one chunk's sorted composite: counts,
        the oracle-exact integer quorum (int(n*frac)+1, ref
        src/binning.py:183), per-bin m/z means (f32 reduceat in the
        oracle's accumulation order) and per-row output extents."""
        g = batch.gbin
        n = g.size
        rows = len(batch.source_indices)
        starts_idx = batch.run_starts
        counts = np.diff(np.append(starts_idx, n))
        mz_sums = (
            np.add.reduceat(batch.mz, starts_idx)
            if starts_idx.size
            else np.zeros(0, np.float32)
        )
        row_of_run = g[starts_idx].astype(np.int64) // np.int64(
            config.n_bins + 1
        )
        if config.apply_peak_quorum:
            quorum = (
                batch.n_members[row_of_run].astype(np.float64)
                * config.quorum_fraction
            ).astype(np.int64) + 1
        else:
            quorum = np.ones_like(counts)
        keep = counts >= quorum
        # oracle dtype chain: f32 sum promoted to f64 by the int division
        kept_mz = (mz_sums.astype(np.float64) / counts)[keep]
        n_out = np.bincount(row_of_run[keep], minlength=rows)
        row_out_offsets = np.zeros(rows + 1, dtype=np.int64)
        np.cumsum(n_out, out=row_out_offsets[1:])
        return dict(
            kept_mz=kept_mz, row_out_offsets=row_out_offsets, rows=rows,
            keep=keep,
        )

    def _flat_chunk_host_args(self, batch, config: BinMeanConfig):
        """One chunk's host side: the host run pass, the host tensors the
        kernel takes, and the kernel.  A batch that carries codes (reduced
        precision) sends them and a 1-byte run-start mask in place of the
        f32 intensities and the int32 composite keys."""
        aux = self._host_run_pass(batch, config)
        keep = torch.from_numpy(aux["keep"])
        if batch.codes is None:
            return ([torch.from_numpy(batch.intensity),
                     torch.from_numpy(batch.gbin), keep], aux,
                    binning.bin_mean_flat_intensity)
        run_start = np.zeros(batch.gbin.size, dtype=np.uint8)
        run_start[batch.run_starts] = 1
        return ([quantize.codes_tensor(batch.codes),
                 torch.from_numpy(run_start), keep], aux,
                binning.bin_mean_flat_q)

    def _flat_chunk_dispatch(self, batch, host, staged=None):
        """One chunk: the copy to the card of ``host``'s tensors (the pack
        made them with ``_flat_chunk_host_args``; unless ``staged`` brings
        them), the kernel and the copy back.  Returns ``(kept intensity
        means (f32 numpy), aux)``; the means are exactly ``aux``'s kept
        runs."""
        tensors, aux, kernel = host
        args = (self._put("h2d", tensors) if staged is None
                else self._take_staged(staged))
        total_cap = int(aux["row_out_offsets"][-1])
        fused, dispatch = self._timed("kernel", lambda: kernel(
            *args, total_cap=total_cap, rcap=batch.n_distinct_total
        ))
        fused = self._fetch("d2h", fused)
        self.chunks += 1  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        rows = len(batch.source_indices)
        self._note_dispatch(
            "bin_mean_flat_intensity" if batch.codes is None
            else "bin_mean_flat_q", (batch.precision,), dispatch,
            rows=rows, padded_rows=rows)
        return fused, aux

    def _emit_bin_mean_rows(self, batch, fused, aux, table, out) -> None:
        """Assemble one chunk's spectra from the host m/z means and the
        card's intensity means (of int8 codes: rescaled here by each
        cluster's scale, which never crosses to the card); precursor m/z
        and charge from the pack's table."""
        idx = table.cluster_order()
        off = aux["row_out_offsets"]
        if batch.scale is not None:
            fused = fused.astype(np.float64)
            fused[: int(off[-1])] *= np.repeat(batch.scale, np.diff(off))
        kept_mz = aux["kept_mz"]
        for ci in range(aux["rows"]):
            o0, o1 = int(off[ci]), int(off[ci + 1])
            gi = batch.source_indices[ci]
            members = idx.members(table, gi)
            out[gi] = Spectrum(
                # copies: slices would pin the chunk-wide buffers alive
                mz=kept_mz[o0:o1].copy(),
                intensity=fused[o0:o1].astype(np.float64),
                # exact f64 mean, as the oracle (ref src/binning.py:224)
                precursor_mz=float(np.mean(members.precursor_mz)),
                precursor_charge=int(members.precursor_charge[0]),
                title=batch.cluster_ids[ci],
            )

    # -- the bucketized (B, K) layout ---------------------------------

    def _map_rows(self, lo: int, hi: int, host, kernel, align: int,
                  qc: bool = False) -> list:
        """Rows [lo, hi) of a bucketized batch, block by block over the
        devices (``DeviceMesh.map_rows``, each on its own stream):
        ``host(b0, b1)``'s tensors copied to the block's device,
        ``kernel(args, b0, b1)`` timed there, its tensor fetched.  Returns
        ``[(b0, b1, numpy result, dispatch interval)]`` in row order.  The
        ``qc_`` phases when ``qc``, else the consensus's."""
        pre = "qc_" if qc else ""

        def run(dev, b0, b1):
            tensors = host(b0, b1)
            with shard_span(tensors):
                args = self._put(pre + "h2d", tensors, dev)
            res, dispatch = self._timed(
                pre + "kernel", lambda: kernel(args, b0, b1), dev)
            return b0, b1, self._fetch(pre + "d2h", res), dispatch

        return self._rows.map_rows(lo, hi, run, align)

    def _encode_bucketized(self, mz: np.ndarray, intensity: np.ndarray):
        """A (B, K) batch's m/z and intensity at ``precision``, as the
        tensors the kernel takes: ``(mz, intensity, scale)``; m/z as bf16
        only where exact, int8 intensity against a per-row ``scale`` the
        host applies to the fetched means (None otherwise)."""
        enc_mz, _ = quantize.encode_mz(mz, self.precision)
        enc_int, scale = quantize.encode_intensity_rows(intensity,
                                                        self.precision)
        return enc_mz, enc_int, scale

    def _chunk_rows(self, b: int, k: int):
        """Row ranges of a (B, K) batch's dispatches: ``max_grid_elements
        // (4 K)`` rows each (the JAX package's cut)."""
        chunk = max(1, self.max_grid_elements // max(k * 4, 1))
        for lo in range(0, b, chunk):
            yield lo, min(lo + chunk, b)

    def _run_bin_mean_bucketized(self, clusters: list[Cluster],
                                 config: BinMeanConfig) -> list[Spectrum]:
        """The bucketized branch of the JAX package's ``run_bin_mean``
        (``tpu_backend.py:683-752``): per bucket batch and row chunk, one
        ``bin_mean_deduped_compact`` per device block, its output sized by
        the rows' distinct bins."""
        check_no_empty(clusters)
        t0 = time.perf_counter()
        table = _as_table(clusters)
        check_uniform_charge(table)
        idx = table.cluster_order()
        batches = pack_bucketize_bin_mean(table, config, self.batch_config)
        _add_time(self.phase_seconds, "pack", t0)
        out: list[Spectrum | None] = [None] * len(clusters)
        for batch in batches:
            t0 = time.perf_counter()
            b, k = batch.bins.shape
            enc_mz, enc_int, scale = self._encode_bucketized(
                batch.mz, batch.intensity)
            heads = np.ones((b, k), dtype=bool)
            heads[:, 1:] = batch.bins[:, 1:] != batch.bins[:, :-1]
            distinct = (heads & (batch.bins < config.n_bins)).sum(axis=1)
            _add_time(self.phase_seconds, "pack", t0)

            def host(b0, b1):
                return [quantize.codes_tensor(enc_mz[b0:b1]),
                        quantize.codes_tensor(enc_int[b0:b1]),
                        torch.from_numpy(batch.bins[b0:b1]),
                        torch.from_numpy(batch.n_members[b0:b1])]

            def kernel(args, b0, b1):
                return binning.bin_mean_deduped_compact(
                    *args, n_bins=config.n_bins,
                    quorum_fraction=config.quorum_fraction,
                    apply_quorum=config.apply_peak_quorum,
                    total_cap=int(distinct[b0:b1].sum()))

            for lo, hi in self._chunk_rows(b, k):
                for b0, b1, fused, dispatch in self._map_rows(
                        lo, hi, host, kernel, row_align(k)):
                    self._count_block("bin_mean_bucketized",
                                      batch.n_valid[b0:b1], k, dispatch)
                    t0 = time.perf_counter()
                    cap = int(distinct[b0:b1].sum())
                    for ci, r_mz, r_int in _iter_compacted(fused, cap,
                                                           b1 - b0):
                        gi = batch.source_indices[b0 + ci]
                        if scale is not None:
                            # int8 codes were averaged on the card: rescale
                            # the means by the row's scale (linear)
                            r_int = r_int * float(scale[b0 + ci])
                        members = idx.members(table, gi)
                        out[gi] = Spectrum(
                            mz=r_mz, intensity=r_int,
                            # exact f64 mean, as the oracle (ref
                            # src/binning.py:224)
                            precursor_mz=float(
                                np.mean(members.precursor_mz)),
                            precursor_charge=int(
                                members.precursor_charge[0]),
                            title=batch.cluster_ids[b0 + ci],
                        )
                    _add_time(self.phase_seconds, "finalize", t0)
        return out

    def _count_block(self, kernel: str, n_valid: np.ndarray, k: int,
                     dispatch: tuple) -> None:
        """One bucketized consensus dispatch: a chunk, its real and padded
        peak slots."""
        self.chunks += 1  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
        real, b = int(n_valid.sum()), int(n_valid.size)
        self.bucket_elements["real"] += real
        self.bucket_elements["padded"] += b * k
        self._note_dispatch(kernel, (k, self.precision), dispatch, rows=b,
                            padded_rows=b, real_elems=real,
                            padded_elems=b * k)

    def _run_gap_average_bucketized(self, clusters: list[Cluster],
                                    config: GapAverageConfig
                                    ) -> list[Spectrum]:
        """The JAX package's ``_run_gap_average_mesh``
        (``tpu_backend.py:1453``): per bucket batch and row chunk, one
        ``gap_average_compact2d`` per device block, its output sized by the
        rows' exact group counts; at a reduced precision the segment ids
        cross as int16 where they fit."""
        check_no_empty(clusters)
        get_pepmass, get_rt = numpy_backend.resolve_gap_estimators(config)
        t0 = time.perf_counter()
        table = _as_table(clusters)
        idx = table.cluster_order()
        batches = pack_bucketize_gap(table, config, self.batch_config)
        _add_time(self.phase_seconds, "pack", t0)
        out: list[Spectrum | None] = [None] * len(clusters)
        for batch in batches:
            t0 = time.perf_counter()
            b, k = batch.mz.shape
            enc_mz, enc_int, scale = self._encode_bucketized(
                batch.mz, batch.intensity)
            enc_seg = batch.seg
            if self.precision != "f32":
                seg16 = quantize.narrow_i32_to_i16(batch.seg,
                                                   max_valid=k - 1)
                if seg16 is not None:
                    enc_seg = seg16
            _add_time(self.phase_seconds, "pack", t0)

            def host(b0, b1):
                return [quantize.codes_tensor(enc_mz[b0:b1]),
                        quantize.codes_tensor(enc_int[b0:b1]),
                        torch.from_numpy(enc_seg[b0:b1]),
                        torch.from_numpy(batch.n_valid[b0:b1]),
                        torch.from_numpy(batch.quorum[b0:b1]),
                        torch.from_numpy(batch.n_members[b0:b1])]

            def kernel(args, b0, b1):
                return gap_average.gap_average_compact2d(
                    *args, dyn_range=config.dyn_range,
                    total_cap=int(batch.n_groups[b0:b1].sum()))

            for lo, hi in self._chunk_rows(b, k):
                for b0, b1, fused, dispatch in self._map_rows(
                        lo, hi, host, kernel, row_align(k)):
                    self._count_block("gap_average_compact",
                                      batch.n_valid[b0:b1], k, dispatch)
                    t0 = time.perf_counter()
                    cap = int(batch.n_groups[b0:b1].sum())
                    for ci, r_mz, r_int in _iter_compacted(fused, cap,
                                                           b1 - b0):
                        gi = batch.source_indices[b0 + ci]
                        if scale is not None:
                            r_int = r_int * float(scale[b0 + ci])
                        members = idx.members(table, gi)
                        pep_mz, pep_z = get_pepmass(members)
                        out[gi] = Spectrum(
                            mz=r_mz, intensity=r_int,
                            precursor_mz=pep_mz, precursor_charge=pep_z,
                            rt=get_rt(members),
                            title=batch.cluster_ids[b0 + ci],
                        )
                    _add_time(self.phase_seconds, "finalize", t0)
        return out

    # -- gap-average consensus --------------------------------------------

    @tracing.traced("method:gap_average", backend="torch")
    def run_gap_average(
        self,
        clusters: list[Cluster],
        config: GapAverageConfig = GapAverageConfig(),
    ) -> list[Spectrum]:
        """One gap-average consensus spectrum per cluster, in input order
        (ref src/average_spectrum_clustering.py:158-164): groups decided on
        the host in float64, their means, quorum and dynamic-range floor on
        the card; precursor m/z, charge and RT from the configured
        estimators."""
        return self._one_shot("gap-average", clusters, config)[0]

    def _prepare_gap_average(self, prepared: PreparedChunk) -> None:
        check_no_empty(prepared.clusters)
        lap = Lap()
        table = prepared.data["table"] = _as_table(prepared.clusters)
        prepared.data["batches"] = [
            (batch, [quantize.codes_tensor(a) for a in (
                batch.intensity, batch.group_start, batch.quorum,
                batch.n_members, batch.n_groups,
            )])
            for batch in pack_flat_gap(
                table, prepared.config,
                max_elements=self.max_grid_elements // 4,
                precision=self.precision,
            )
        ]
        prepared.stats.add("pack", lap.stop())

    def _finish_gap_average(self, prepared: PreparedChunk) -> list[Spectrum]:
        """Each chunk's group intensities and keep marks from the card
        (``gap_average_groups``), joined on the host to the pack's float64
        group m/z; at f32 the singletons' intensities pass through;
        precursor m/z, charge and RT from the pack's table."""
        clusters, config = prepared.clusters, prepared.config
        table = prepared.data["table"]
        idx = table.cluster_order()
        get_pepmass, get_rt = numpy_backend.resolve_gap_estimators(config)
        out: list[Spectrum | None] = [None] * len(clusters)
        for batch, host in prepared.data["batches"]:
            total = int(batch.n_groups.sum())
            args = self._put("h2d", host)
            fused, dispatch = self._timed("kernel", lambda: (
                gap_average.gap_average_groups(
                    *args, dyn_range=config.dyn_range, total_cap=total
                )
            ))
            fused = self._fetch("d2h", fused)
            self.chunks += 1  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
            self._note_dispatch("gap_average_compact", (batch.precision,),
                                dispatch, rows=len(batch.source_indices),
                                padded_rows=len(batch.source_indices))

            t0 = time.perf_counter()
            group_int = fused[:total].astype(np.float64)
            keep = fused[total:] != 0
            if batch.scale is not None:
                # int8 codes were averaged on the card: rescale (linear)
                group_int *= np.repeat(batch.scale, batch.n_groups)
            if batch.single_groups is not None:
                group_int[batch.single_groups] = batch.single_int
            goff = np.zeros(batch.n_groups.size + 1, dtype=np.int64)
            np.cumsum(batch.n_groups, out=goff[1:])
            for ci, gi in enumerate(batch.source_indices):
                g0, g1 = int(goff[ci]), int(goff[ci + 1])
                sel = keep[g0:g1]
                members = idx.members(table, gi)
                pep_mz, pep_z = get_pepmass(members)
                out[gi] = Spectrum(
                    mz=batch.group_mz[g0:g1][sel],
                    intensity=group_int[g0:g1][sel],
                    precursor_mz=pep_mz,
                    precursor_charge=pep_z,
                    rt=get_rt(members),
                    title=batch.cluster_ids[ci],
                )
            self.phase_seconds["finalize"] += time.perf_counter() - t0
        return out

    # -- medoid and best-spectrum representatives -----------------------

    def medoid_indices(
        self, clusters: list[Cluster], config: MedoidConfig = MedoidConfig()
    ) -> list[int]:
        """Per-cluster medoid member index (ref
        src/most_similar_representative.py:87-110), as the JAX package's
        bucketized path with ``medoid_device_select=False`` computes it:
        shared-bin counts on the card, exact integers, and the pick on the
        host in float64 (``medoid_finalize``), so ties go to the lowest
        index as in the oracle.  A batch is cut into chunks whose (rows, R,
        M) float32 occupancy stays within ``max_grid_elements``."""
        prepared = self._prepare("medoid", clusters, config)
        self._merge_prepared(prepared)
        return self._finish_medoid(prepared)

    def _prepare_medoid(self, prepared: PreparedChunk) -> None:
        """The bucketized batches, each row's channels sorted by (bin,
        member) (``_medoid_sorted``)."""
        check_no_empty(prepared.clusters)
        lap = Lap()
        batches = pack_bucketize(prepared.clusters, self.batch_config,
                                 bucket_members=True)
        for batch in batches:
            # the JAX package's bound: its counts cross as uint16
            if int(batch.n_peaks.max(initial=0)) >= 1 << 16:
                raise ValueError(
                    "medoid kernel: a member has >= 2**16 peaks; uint16 "
                    "shared-bin counts would overflow"
                )
        prepared.data["batches"] = [
            (batch, *self._medoid_sorted(batch, prepared.config))
            for batch in batches
        ]
        prepared.stats.add("pack", lap.stop())

    def _finish_medoid(self, prepared: PreparedChunk) -> list[int]:
        ph = self.phase_seconds
        out = [0] * len(prepared.clusters)
        for batch, sbins, smm, runs, encoding in prepared.data["batches"]:
            m = batch.m
            chunk = max(1, self.max_grid_elements // (int(runs.max()) * m))
            for lo in range(0, batch.n_clusters, chunk):
                hi = min(lo + chunk, batch.n_clusters)
                # integer counts: any cut of the rows gives the same bytes
                for b0, b1, shared, dispatch in self._map_rows(
                    lo, hi,
                    lambda b0, b1: [torch.from_numpy(sbins[b0:b1]),
                                    torch.from_numpy(smm[b0:b1])],
                    lambda args, b0, b1: similarity.shared_bins_packed(
                        *args, m=m, runs=int(runs[b0:b1].max())),
                    1,
                ):
                    self.chunks += 1  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
                    self.medoid_encodings[encoding] += 1  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
                    self._note_dispatch("shared_bins_packed",
                                        (sbins.shape[1], m, encoding),
                                        dispatch, rows=b1 - b0, padded_rows=b1 - b0)
                    t0 = time.perf_counter()
                    picks = similarity.medoid_finalize(
                        shared, batch.n_peaks[b0:b1],
                        batch.member_mask[b0:b1], batch.n_members[b0:b1],
                    )
                    for ci, pick in enumerate(picks):
                        out[batch.source_indices[b0 + ci]] = int(pick)
                    ph["finalize"] += time.perf_counter() - t0
        return out

    def _medoid_sorted(self, batch, config: MedoidConfig):
        """One batch's medoid channels: global bins and member ids (padding
        member ``m``), each row sorted by (bin, member); each row's run
        count (padding's run included); and the encoding: at a reduced
        ``precision`` both narrowed to int16 when the grid and ``m`` fit,
        which is exact, else int32."""
        bins = quantize.medoid_bins_packed(batch, config)
        b, k = bins.shape
        m = batch.m
        mm = np.where(batch.member_id >= 0, batch.member_id, m)
        # a row's real peaks fill its first n_peaks_total columns and its
        # padding (bin sentinel, member m) sorts last anyway: sort only the
        # real peaks, stably, by (bin, member)
        valid = np.arange(k) < batch.n_peaks_total[:, None]
        offsets = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(batch.n_peaks_total, out=offsets[1:])
        vbins, vmm = bins[valid], mm[valid]
        perm = seg_argsort(vbins.astype(np.int64) * (m + 1) + vmm, offsets)
        sbins = bins.copy()
        sbins[valid] = vbins[perm]
        smm = mm.astype(np.int32)
        smm[valid] = vmm[perm]
        runs = 1 + np.count_nonzero(sbins[:, 1:] != sbins[:, :-1], axis=1)
        if self.precision != "f32":
            real_max = int(sbins[sbins < quantize.MEDOID_SENTINEL]
                           .max(initial=0))
            b16 = quantize.narrow_i32_to_i16(sbins, real_max)
            if b16 is not None and m < 2**15 - 1:
                return b16, smm.astype(np.int16), runs, "i16"
        return sbins, smm, runs, "i32"

    @tracing.traced("method:medoid", backend="torch")
    def run_medoid(
        self, clusters: list[Cluster], config: MedoidConfig = MedoidConfig()
    ) -> list[Spectrum]:
        """The medoid member of each cluster, in input order."""
        return self._one_shot("medoid", clusters, config)[0]

    def run_shared(self, method: str, parts, config, cos_config=None
                   ) -> list:
        """One method over the clusters of several sources in one pass
        (the device half of the serving micro-batcher; the JAX package's
        ``tpu_backend.py:1786``).  Every method is per cluster, so each
        source's representatives and QC cosines (with ``cos_config``) are
        those of a run over that source alone.  On the (B, K) layout the
        sources are merged (``merge_cluster_sources``) and share its
        dispatches: every row starts a run at a tile-aligned offset, so
        the card's float32 sums do not depend on a row's neighbours.  On
        the flat layout they do (a run's sum rounds by its offset within
        the scan's tiles), so each source keeps its own flat layout and
        dispatches, and its bytes are those of a run over it alone.
        Returns one ``(representatives, cosines or None)`` per source."""
        if method not in PREPARED_METHODS:
            raise ValueError(f"method {method!r} is not batchable")
        if not self.bucketized:
            return [self._run_source(method, part, config, cos_config)
                    for part in parts]
        merged, spans = merge_cluster_sources(parts)
        reps, cosines = self._run_source(method, merged, config, cos_config)
        return [(reps[a:b], None if cosines is None else cosines[a:b])
                for a, b in spans]

    def _run_source(self, method: str, clusters, config, cos_config):
        cosines = None
        if method == "bin-mean" and cos_config is not None:
            reps, cosines = self.run_bin_mean_with_cosines(clusters, config,
                                                           cos_config)
        elif method == "bin-mean":
            reps = self.run_bin_mean(clusters, config)
        elif method == "gap-average":
            reps = self.run_gap_average(clusters, config)
        else:
            reps = self.run_medoid(clusters, config)
        if len(reps) != len(clusters):
            raise RuntimeError(f"shared {method} dispatch returned "
                               f"{len(reps)} representatives for "
                               f"{len(clusters)} clusters")
        if cos_config is not None and cosines is None:
            cosines = self.average_cosines(reps, clusters, cos_config)
        return reps, cosines

    def run_best_spectrum(
        self,
        clusters: list[Cluster],
        scores: dict[str, float],
        config: BestSpectrumConfig = BestSpectrumConfig(),
    ) -> list[Spectrum]:
        """The best-scored member of each cluster, scoreless clusters
        dropped: a join and an argmax, on the host by design."""
        return numpy_backend.run_best_spectrum(clusters, scores, config)

    # -- QC cosine -------------------------------------------------------

    @tracing.traced("method:bin_mean_with_cosines", backend="torch")
    def run_bin_mean_with_cosines(
        self,
        clusters: list[Cluster],
        bin_config: BinMeanConfig = BinMeanConfig(),
        cos_config: CosineConfig = CosineConfig(),
    ) -> tuple[list[Spectrum], np.ndarray]:
        """Consensus and QC: the bin-mean representatives and each one's
        mean binned cosine to its cluster's members, the QC member prep on
        the consensus pack's ``SpectraTable``."""
        return self._one_shot("bin-mean", clusters, bin_config, cos_config)

    @tracing.traced("method:cosine", backend="torch")
    def average_cosines(
        self,
        representatives: list[Spectrum],
        clusters: list[Cluster],
        config: CosineConfig = CosineConfig(),
    ) -> np.ndarray:
        """(C,) float64 mean binned cosine of each representative to its
        cluster's members (ref src/benchmark.py:31-38)."""
        if len(representatives) != len(clusters):
            raise ValueError("representatives and clusters must align")
        check_no_empty(clusters)
        if self.bucketized:
            return self._average_cosines_bucketized(representatives,
                                                    clusters, config)
        t0 = time.perf_counter()
        mprep = self._prep_cosine_members(clusters, config)
        self.phase_seconds["qc_pack"] += time.perf_counter() - t0
        return self._cosines_from_members(representatives, mprep, config)

    def _cosine_rows(self, representatives, clusters, batch,
                     config: CosineConfig):
        """The host arrays of ``similarity.cosine_packed`` for one
        ``pack_bucketize`` batch, as the JAX package's ``average_cosines``
        builds them: rep rows of ``Pr`` (a power of two, at least 256)
        sorted by bin, member rows sorted by (member, bin), both with the
        host library's stable segmented sort."""
        idxs = batch.source_indices
        b, k = batch.mz.shape
        m = batch.m
        space = config.mz_space
        pr_raw = max(max((representatives[i].n_peaks for i in idxs),
                         default=1), 1)
        pr = max(256, 1 << (pr_raw - 1).bit_length())
        rep_mz = np.zeros((b, pr), np.float64)
        rep_int = np.zeros((b, pr), np.float32)
        rep_valid = np.zeros((b, pr), bool)
        mem_edges = np.zeros((b, m), np.int32)
        for ci, gi in enumerate(idxs):
            r = representatives[gi]
            rep_mz[ci, : r.n_peaks] = r.mz
            rep_int[ci, : r.n_peaks] = quantize.cosine_normalize(
                r.intensity, config)
            rep_valid[ci, : r.n_peaks] = True
            for mi, mem in enumerate(clusters[gi].members):
                if mem.n_peaks:
                    # per-member edge count off the LAST peak (ref
                    # src/benchmark.py:20 assumes sorted spectra)
                    mem_edges[ci, mi] = quantize.cosine_edge_count(
                        mem.mz[-1], space)
        rep_bins, rep_edges = quantize.cosine_bins(rep_mz, rep_valid, config)
        mem_bins, _ = quantize.cosine_bins(batch.mz64, batch.member_id >= 0,
                                           config)
        r_order = seg_argsort(rep_bins.reshape(-1),
                              np.arange(b + 1, dtype=np.int64) * pr)
        rep_bins = rep_bins.reshape(-1)[r_order].reshape(b, pr)
        rep_int = rep_int.reshape(-1)[r_order].reshape(b, pr)
        mm = np.where(batch.member_id >= 0, batch.member_id, m).astype(
            np.int64)
        key = mm * (1 << 31) + mem_bins
        m_order = seg_argsort(key.reshape(-1),
                              np.arange(b + 1, dtype=np.int64) * k)
        mem_bins = mem_bins.reshape(-1)[m_order].reshape(b, k)
        mem_int = quantize.cosine_normalize(batch.intensity, config).astype(
            np.float32).reshape(-1)[m_order].reshape(b, k)
        mem_mm = mm.astype(np.int32).reshape(-1)[m_order].reshape(b, k)
        return [rep_bins, rep_int, rep_edges, mem_bins, mem_int, mem_mm,
                mem_edges, batch.member_mask], pr

    def _average_cosines_bucketized(self, representatives, clusters,
                                    config: CosineConfig) -> np.ndarray:
        """The bucketized branch of the JAX package's ``average_cosines``
        (``tpu_backend.py:1883-1981``): per ``pack_bucketize`` batch and
        row chunk, one ``cosine_packed`` per device block; each row's mean
        over its members on the host."""
        out = np.zeros(len(clusters), dtype=np.float64)
        t0 = time.perf_counter()
        batches = pack_bucketize(clusters, self.batch_config)
        _add_time(self.phase_seconds, "qc_pack", t0)
        for batch in batches:
            t0 = time.perf_counter()
            arrays, pr = self._cosine_rows(representatives, clusters, batch,
                                           config)
            _add_time(self.phase_seconds, "qc_pack", t0)
            b, k = batch.mz.shape
            m = batch.m
            chunk = max(1, self.max_grid_elements // max((k + pr) * 6, 1))
            for lo in range(0, b, chunk):
                hi = min(lo + chunk, b)
                for b0, b1, cos, dispatch in self._map_rows(
                    lo, hi,
                    lambda b0, b1: [torch.from_numpy(a[b0:b1])
                                    for a in arrays],
                    lambda args, b0, b1: similarity.cosine_packed(
                        *args, m=m),
                    row_align(k, pr), qc=True,
                ):
                    self.cos_chunks += 1  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
                    self._note_dispatch("cosine_packed", (k, pr, m),
                                        dispatch, rows=b1 - b0, padded_rows=b1 - b0)
                    nm = np.maximum(batch.n_members[b0:b1], 1)
                    mean = cos.astype(np.float64).sum(axis=1) / nm
                    for ci in range(b1 - b0):
                        out[batch.source_indices[b0 + ci]] = mean[ci]
        return out

    def _cosines_from_members(self, representatives, mprep: dict,
                              config: CosineConfig) -> np.ndarray:
        """The rep half of the cosine prep, then one ``cosine_flat`` per
        chunk."""
        t0 = time.perf_counter()
        prep = self._prep_cosine_reps(representatives, mprep, config)
        self.phase_seconds["qc_pack"] += time.perf_counter() - t0
        return self._dispatch_cosine_flat(prep)

    def _prep_cosine_members(self, clusters_or_table,
                             config: CosineConfig) -> dict:
        """Representative-independent half of the cosine prep: member peaks
        along one flat axis sorted by (row, member, bin), with float64
        grid bins, normalized f32 intensities and each spectrum's edge
        count."""
        table = _as_table(clusters_or_table)
        idx = table.cluster_order()
        space = config.mz_space

        order = idx.order  # spectrum ids grouped by cluster code
        sorted_code = table.cluster_code[order]
        cnt = table.peak_counts[order]
        src = np.repeat(table.peak_offsets[order], cnt) + _grouped_arange(cnt)
        inten = quantize.cosine_normalize(
            table.intensity[src], config
        ).astype(np.float32)
        cbin = np.maximum(
            np.floor((table.mz[src] + space / 2.0) / space).astype(np.int64),
            0,
        )
        # per-spectrum edge count off the LAST peak in file order, not the
        # max (ref src/benchmark.py:20 assumes sorted spectra)
        last_mz = np.full(order.size, -np.inf)
        has = cnt > 0
        last_mz[has] = table.mz[table.peak_offsets[order][has] + cnt[has] - 1]
        spec_edges = quantize.cosine_edge_count(last_mz, space)

        # spectra are (row, member)-grouped already: sort each one's peaks
        # by bin; the cumsum doubles as the per-spectrum extent table
        spec_start = np.zeros(order.size + 1, dtype=np.int64)
        np.cumsum(cnt, out=spec_start[1:])
        perm = seg_argsort(cbin, spec_start)
        return dict(
            idx=idx, c=table.n_clusters, sorted_code=sorted_code,
            cbin=cbin[perm], inten=inten[perm], spec_start=spec_start,
            spec_edges=spec_edges, row_elem=np.repeat(sorted_code, cnt),
            spec_elem=np.repeat(np.arange(order.size, dtype=np.int64), cnt),
        )

    def _prep_cosine_reps(
        self, representatives, mprep: dict, config: CosineConfig
    ) -> dict:
        """Representative-dependent half: rep peaks sorted by (row, bin),
        the edge gating of member intensities and the composite-key
        budget."""
        c = mprep["c"]
        cbin = mprep["cbin"]
        space = config.mz_space

        reps = representatives
        rep_counts = np.array([r.n_peaks for r in reps], dtype=np.int64)
        if rep_counts.sum():
            rep_mz = np.concatenate([np.asarray(r.mz, np.float64)
                                     for r in reps])
            rep_in = quantize.cosine_normalize(
                np.concatenate([np.asarray(r.intensity, np.float64)
                                for r in reps]),
                config,
            ).astype(np.float32)
        else:
            rep_mz = np.zeros(0, np.float64)
            rep_in = np.zeros(0, np.float32)
        rep_row = np.repeat(np.arange(c, dtype=np.int64), rep_counts)
        rbin = np.maximum(
            np.floor((rep_mz + space / 2.0) / space).astype(np.int64), 0
        )
        rep_last = np.array(
            [r.mz[-1] if r.n_peaks else -np.inf for r in reps],
            dtype=np.float64,
        )
        rep_edges = quantize.cosine_edge_count(rep_last, space)
        rep_offsets = np.zeros(c + 1, dtype=np.int64)
        np.cumsum(rep_counts, out=rep_offsets[1:])
        # reps lie row by row already: sort each row's peaks by bin
        rperm = seg_argsort(rbin, rep_offsets)
        row_peak_offsets = np.zeros(c + 1, dtype=np.int64)
        np.cumsum(mprep["idx"].total_peaks, out=row_peak_offsets[1:])

        # composite key row * shift + bin: shift the least power of two
        # (at least 2^16) above every bin and cutoff + 1, and few enough
        # rows per chunk (a power of two) that the key fits int32
        max_bin = int(max(
            cbin.max(initial=0), rbin.max(initial=0),
            int(np.max(mprep["spec_edges"], initial=0)),
            int(np.max(rep_edges, initial=0)),
        ))
        shift = max(1 << 16, 1 << (max_bin + 1).bit_length())
        max_rows_cap = max((2**31 - 2) // shift, 1)
        max_rows = 1 << (max_rows_cap.bit_length() - 1)

        # the pair cutoff (max of rep and member edge counts - 2, ref
        # src/benchmark.py:20-22) zeroes failing member peaks on the host
        cut_spec = (
            np.maximum(rep_edges[mprep["sorted_code"]], mprep["spec_edges"])
            - 2
        )
        cut_at = cut_spec[mprep["spec_elem"]]
        inten_gated = np.where(
            cbin <= cut_at, mprep["inten"], 0.0
        ).astype(np.float32)
        return dict(
            mprep, inten_gated=inten_gated, rep_row=rep_row[rperm],
            rbin=rbin[rperm], rep_in=rep_in[rperm], rep_offsets=rep_offsets,
            row_peak_offsets=row_peak_offsets, cut_spec=cut_spec,
            shift=shift, max_rows=max_rows,
        )

    def _cosine_chunk_arrays(self, prep: dict, lo: int, hi: int) -> list:
        """The twelve host arrays of ``similarity.cosine_flat`` for rows
        [lo, hi).  Each peak axis ends in one sentinel slot, so no gather
        runs on an empty axis (a chunk whose reps or members have no
        peaks); the member slot belongs to no spectrum's extent."""
        shift = prep["shift"]
        sorted_code = prep["sorted_code"]
        p0 = int(prep["row_peak_offsets"][lo])
        p1 = int(prep["row_peak_offsets"][hi])
        n = p1 - p0
        # this chunk's spectra: sorted_code is non-decreasing over them
        s0 = int(np.searchsorted(sorted_code, lo, side="left"))
        s1 = int(np.searchsorted(sorted_code, hi, side="left"))
        spec_offsets = (prep["spec_start"][s0 : s1 + 1] - p0).astype(np.int32)
        spec_row = (sorted_code[s0:s1] - lo).astype(np.int32)
        row_spec_offsets = (
            np.searchsorted(sorted_code, np.arange(lo, hi + 1)) - s0
        ).astype(np.int32)
        r0 = int(prep["rep_offsets"][lo])
        r1 = int(prep["rep_offsets"][hi])
        rkey = np.full(r1 - r0 + 1, SENTINEL, dtype=np.int32)
        rkey[:-1] = (
            (prep["rep_row"][r0:r1] - lo) * np.int64(shift)
            + prep["rbin"][r0:r1]
        ).astype(np.int32)
        rint = np.zeros(r1 - r0 + 1, dtype=np.float32)
        rint[:-1] = prep["rep_in"][r0:r1]
        rep_offsets = (prep["rep_offsets"][lo : hi + 1] - r0).astype(np.int32)
        mkey = np.full(n + 1, SENTINEL, dtype=np.int32)
        mkey[:-1] = (
            (prep["row_elem"][p0:p1] - lo) * np.int64(shift)
            + prep["cbin"][p0:p1]
        ).astype(np.int32)
        mint = np.zeros(n + 1, dtype=np.float32)
        mint[:-1] = prep["inten_gated"][p0:p1]
        spec_elem = np.full(n + 1, s1 - s0, dtype=np.int32)
        spec_elem[:-1] = prep["spec_elem"][p0:p1] - s0
        # rep lookup: the last element of the matching rep run
        pos = (searchsorted_right_i32(rkey, mkey) - 1).astype(np.int32)
        # rep-norm cutoff position per spectrum
        npos = np.searchsorted(
            rkey,
            (sorted_code[s0:s1] - lo) * np.int64(shift)
            + prep["cut_spec"][s0:s1] + 1,
        ).astype(np.int32)
        nm = prep["idx"].n_members[lo:hi].astype(np.int32)
        return [
            rkey, rint, mkey, mint, spec_elem, pos, spec_offsets, spec_row,
            npos, rep_offsets, row_spec_offsets, nm,
        ]

    def _cosine_chunks(self, prep: dict):
        """Row ranges [lo, hi) of the cosine chunks: under the
        composite-key row cap and the ``max_grid_elements // 4``
        member-peak budget, at least one row each."""
        c = prep["c"]
        row_peak_offsets = prep["row_peak_offsets"]
        budget = self.max_grid_elements // 4
        lo = 0
        while lo < c:
            hi = min(lo + prep["max_rows"], c)
            if row_peak_offsets[hi] - row_peak_offsets[lo] > budget:
                hi = lo + max(int(np.searchsorted(
                    row_peak_offsets[lo + 1 : hi + 1],
                    row_peak_offsets[lo] + budget, side="right",
                )), 1)
            yield lo, hi
            lo = hi

    def _dispatch_cosine_flat(self, prep: dict) -> np.ndarray:
        """One ``cosine_flat`` per chunk."""
        ph = self.phase_seconds
        out = np.zeros(prep["c"], dtype=np.float64)
        for lo, hi in self._cosine_chunks(prep):
            t0 = time.perf_counter()
            arrays = self._cosine_chunk_arrays(prep, lo, hi)
            ph["qc_pack"] += time.perf_counter() - t0

            args = self._put("qc_h2d", [torch.from_numpy(a) for a in arrays])
            mean, dispatch = self._timed(
                "qc_kernel",
                lambda: similarity.cosine_flat(*args, shift=prep["shift"]))

            out[lo:hi] = self._fetch("qc_d2h", mean)
            self.cos_chunks += 1  # lint: ok[lane-safety] owned by one lane: CLI main or one serve worker
            self._note_dispatch("cosine_flat", (), dispatch, rows=hi - lo,
                                padded_rows=hi - lo)
        return out
