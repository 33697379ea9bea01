"""``serve``: the resident consensus daemon of the port (the counterpart of
the JAX package's ``serve/daemon.py``).

Lifecycle:

* **boot** pays every start-up cost once, before the socket exists: it
  loads the kernel library (``ops/_build.load``, on the card) and the
  host library (``load_host``), and for each execution lane creates its
  CUDA context on its card, its own stream (``serve.placement``) and its
  resident ``TorchBackend``.  The first job then pays no build, no load
  and no context.  With ``--warmup-manifest`` (``--warmup auto|manifest``)
  each lane then dispatches every shape class of the manifest once on
  its own stream (``warmstart.warmup``), so its first job pays no first
  dispatch either; ``serve_start.warmed_kernels`` counts the entries.
* **serve**: each connection is one job.  A reader thread validates the
  argv with the CLI's own parser and offers it to the bounded
  weighted-fair ``AdmissionQueue`` (``--quota``); the worker lanes
  (``--workers N``) pop jobs and run each through the CLI's own body
  (``cli._run_pipeline_command``) on the lane's backend, inside the
  lane's card and stream, so a served job writes the one-shot CLI's
  bytes.  Jobs writing distinct files run concurrently; the queue's
  output guard serializes jobs on one file.
* **drain**: SIGTERM or SIGINT stops the accept loop; queued jobs are
  rejected retriable, every lane's in-flight job commits, the journal
  gets ``serve_drain`` and ``run_end``, ``--metrics-out`` the final
  exposition, and the socket is removed; exit 0.

Per-job hygiene on the lane's own backend: its per-run accounting is
zeroed (``TorchBackend.reset_run_counters``) and its journal hook reset;
the metrics registry stays resident and monotone for ``/metrics``, and
each job's ``run_end`` diffs a snapshot of it.  A served job's span
tracer is installed for its lane's thread only.

Cross-job micro-batching (``--batch-window MS``, ``serve.batcher``): a
lane that pops a batch-eligible job collects further compatible jobs for
up to the window, computes their clusters in one shared pass on its
backend, and runs each job's pipeline against the precomputed results;
the pass is journaled as ``batch_dispatch``.  A failed shared pass runs
its members solo on the same lane, on the card.

A sticky CUDA error (``robustness.errors.STICKY_CUDA_ERRORS``) poisons
the CUDA context: the job's terminal line says ``retriable: false``,
``/healthz`` turns degraded, no lane starts another job, and the daemon
drains and exits non-zero.  It never serves on a broken context and
never moves to the CPU.

The live telemetry plane (``observability.exporter``): ``--metrics-port``
serves ``/metrics`` and ``/healthz``; ``--slo`` arms per-job latency
objectives; the ``profile`` op captures a bounded ``torch.profiler``
trace of the running daemon; ``--metrics-out`` writes the final
exposition at drain.  ``--flightrec observe|on`` taps the daemon's
journal with the flight recorder (``observability.flightrec``): its
detectors journal ``incident`` events, count them on ``/metrics``
(``specpride_incidents_*``) and, in mode ``on``, dump bundles under
``--incident-dir``; the recorder drains before the final exposition.

``--autotune observe|on`` boots a controller (``autotune.Controller``)
on the daemon's journal with two knobs: the batch window
(``BatchWindowPolicy``, clamped by ``--autotune-batch-window``) and the
active lanes (``WorkerPolicy``: lanes ``wid >= active_workers`` park,
their backends stay warm).  Each knob is read under ``_live_lock``; in
mode ``on`` the lanes poll the queue every 0.2 s so a parked lane sees
its unparking.  ``off`` builds no controller and keeps the blocking pop.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time

from specpride_tpu_torch.observability.journal import (
    NullJournal,
    emit_clock_anchor,
    open_journal,
)
from specpride_tpu_torch.observability.registry import (
    device_counters_snapshot,
    device_summary,
)
from specpride_tpu_torch.observability.tracing import (
    TraceContext,
    new_span_id,
)
from specpride_tpu_torch.robustness import errors as rb_errors
from specpride_tpu_torch.robustness.watchdog import Watchdog
from specpride_tpu_torch.serve import placement, protocol
from specpride_tpu_torch.serve.scheduler import AdmissionQueue, QuotaExceeded

logger = logging.getLogger("specpride_tpu_torch")

# how often the daemon journal re-anchors its wall<->mono clock (on job
# completions), so a long journal stays alignable across clock steps
CLOCK_ANCHOR_INTERVAL_S = 60.0


class Job:
    """One admitted request: its parsed args and the connection awaiting
    the terminal line."""

    __slots__ = (
        "job_id", "client", "argv", "args", "command", "conn", "fh",
        "t_enqueued", "ack", "batch_key", "trace_id", "span_id",
        "parent_span_id",
    )

    def __init__(self, job_id, client, argv, args, command, conn, fh,
                 trace: TraceContext | None = None):
        self.job_id = job_id
        self.client = client
        self.argv = argv
        self.args = args
        self.command = command
        self.conn = conn
        self.fh = fh
        self.t_enqueued = time.perf_counter()
        # the v4 envelope: adopt the client's trace (its submit span the
        # parent) or mint a root; span_id is the job's serve:job span
        ctx = trace if trace is not None else TraceContext.mint()
        self.trace_id = ctx.trace_id
        self.parent_span_id = ctx.span_id if trace is not None else None
        self.span_id = new_span_id()
        # set once the reader wrote "accepted": the worker (or the drain)
        # waits on it, so two threads never write one connection at once
        self.ack = threading.Event()
        # the micro-batching key (serve.batcher), None for a solo job
        self.batch_key = None


def _job_claimed_paths(job: Job) -> list[str]:
    """The files a job writes: the output guard's tokens."""
    paths = []
    for attr in ("output", "qc_report", "checkpoint", "journal",
                 "chrome_trace"):
        p = getattr(job.args, attr, None)
        if p:
            paths.append(os.path.abspath(p))
    return paths


class ServeDaemon:
    def __init__(
        self,
        socket_path: str | None = None,
        *,
        device: str = "cuda",
        max_queue: int = 16,
        workers: int = 0,
        quotas: dict | None = None,
        layout: str = "auto",
        precision: str = "f32",
        watchdog_timeout: float = 0.0,
        journal_path: str | None = None,
        journal_rotate_mb: float = 0.0,
        metrics_port: int | None = None,
        metrics_host: str = "127.0.0.1",
        metrics_out: str | None = None,
        slo: dict | None = None,
        batch_window: float = 0.0,
        batch_max_clusters: int = 4096,
        result_cache: str | None = None,
        result_store: str | None = None,
        flightrec: str = "off",
        incident_dir: str | None = None,
        autotune: str = "off",
        autotune_interval: float = 1.0,
        autotune_batch_window: tuple | None = None,
        warmup: str = "auto",
        warmup_manifest: str | None = None,
        warmup_jobs: int = 0,
    ):
        if flightrec not in ("off", "observe", "on"):
            raise ValueError(f"flightrec mode {flightrec!r} must be off, "
                             "observe or on")
        if autotune not in ("off", "observe", "on"):
            raise ValueError(f"autotune mode {autotune!r} must be off, "
                             "observe or on")
        self.socket_path = socket_path or protocol.default_socket_path()
        self.device = device
        self.result_cache = result_cache
        self.result_store = result_store
        self.layout = layout
        self.precision = precision
        self.quotas = dict(quotas or {})
        self.queue = AdmissionQueue(max_queue, quotas=self.quotas,
                                    conflict_key=_job_claimed_paths)
        self.journal_path = journal_path
        self.journal_rotate_mb = max(float(journal_rotate_mb), 0.0)
        self.journal = None
        self._anchor_lock = threading.Lock()
        self._last_anchor_mono = 0.0
        self.workers_requested = int(workers)
        self.slots: list = []
        self.worker_backends: list = []
        self.metrics_port = metrics_port
        self.metrics_host = metrics_host
        self.metrics_out = metrics_out
        self.slo = dict(slo or {})
        self.telemetry = None  # ServeTelemetry, built at boot
        self.exporter = None  # MetricsExporter with --metrics-port
        self._profile_lock = threading.Lock()  # one capture at a time
        self.watchdog = Watchdog(watchdog_timeout)
        # the flight recorder: off builds none (a recorder-free daemon)
        self.flightrec = flightrec
        self.incident_dir = incident_dir
        self.recorder = None  # flightrec.FlightRecorder, built at boot
        # boot's warmup: the manifest's entries warmed on every lane
        self.warmup = warmup
        self.warmup_manifest = warmup_manifest
        self.warmup_jobs = int(warmup_jobs)
        self.warmed_kernels = 0
        self.jobs_done = 0
        self.jobs_failed = 0
        self.jobs_rejected = 0
        # the live knobs the autotune controller moves, read under this
        # lock at every use (a leaf lock, never held while calling out);
        # with --autotune off nothing writes them after boot
        self._live_lock = threading.Lock()
        self.batch_window = max(float(batch_window), 0.0)
        self.batch_max_clusters = max(int(batch_max_clusters), 1)
        # the controller: off builds none (a controller-free daemon)
        self.autotune = autotune
        self._active_workers_v: int | None = None  # None: every lane
        self.autotune_interval = max(float(autotune_interval), 0.05)
        self.autotune_batch_window = (tuple(autotune_batch_window)
                                      if autotune_batch_window is not None
                                      else (0.0, 50.0))
        self.controller = None  # autotune.Controller, built at boot
        self._controller_thread = None
        # parking needs lanes that poll the pop; every other mode keeps
        # the blocking pop
        self._pop_timeout = 0.2 if autotune == "on" else None
        self.batches_dispatched = 0
        self.jobs_batched = 0
        self._batch_ids = iter(range(1, 1 << 62)).__next__
        # worker -> jobs collected into its batch, not yet executing
        self._batch_backlog: dict[int, list] = {}
        # every client ever admitted: the drain snapshot renders their
        # queue depths at 0 instead of dropping the rows
        self._clients_seen: set[str] = set()
        self._rejected_lock = threading.Lock()
        self._counts_lock = threading.Lock()
        self._job_ids = iter(range(1, 1 << 62)).__next__
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        self._draining = False
        self._drain_lock = threading.Lock()
        self._t_boot = 0.0
        self._worker_threads: list[threading.Thread] = []
        # the sticky CUDA error that poisoned the context, or None
        self.poisoned: str | None = None
        # test seam: every worker waits on this gate between popping a job
        # and running it (set: production never waits); _inflight_by maps
        # worker -> its popped, not yet answered job
        self._gate = threading.Event()
        self._gate.set()
        self._inflight_by: dict[int, Job] = {}

    @property
    def _inflight(self) -> Job | None:
        """Any in-flight job (the single-lane view)."""
        return next(iter(self._inflight_by.values()), None)

    # -- live knobs (the autotune controller's actuators) ----------------

    @property
    def batch_window(self) -> float:
        """The micro-batch window in seconds, read under the live lock at
        every use (admission's eligibility, the collector's deadline)."""
        with self._live_lock:
            return self._batch_window_v

    @batch_window.setter
    def batch_window(self, value) -> None:
        with self._live_lock:
            self._batch_window_v = max(float(value), 0.0)

    @property
    def active_workers(self) -> int:
        """Lanes taking work: lanes ``wid >= active_workers`` park (each
        finishes its job, then idles with its backend warm)."""
        with self._live_lock:
            n = self._active_workers_v
        return n if n is not None else max(len(self.slots), 1)

    @active_workers.setter
    def active_workers(self, value) -> None:
        with self._live_lock:
            self._active_workers_v = min(max(int(value), 1),
                                         max(len(self.slots), 1))

    # -- boot -----------------------------------------------------------

    def boot(self) -> "ServeDaemon":
        """Pay every start-up cost once, before the socket exists."""
        import torch

        from specpride_tpu_torch.backends.torch_backend import TorchBackend
        from specpride_tpu_torch.observability.exporter import (
            MetricsExporter,
            ServeTelemetry,
        )
        from specpride_tpu_torch.ops import _build

        self._t_boot = time.perf_counter()
        # placement first: without CUDA (and without device="cpu") the
        # daemon raises before it writes or binds anything
        n_workers = (self.workers_requested if self.workers_requested >= 1
                     else placement.default_workers(self.device))
        self.slots = placement.plan_placement(n_workers, self.device)
        if os.path.exists(self.socket_path) and self._socket_alive():
            raise SystemExit(f"another daemon is serving on "
                             f"{self.socket_path} (pass a different "
                             "--socket, or stop it first)")
        self.journal = open_journal(self.journal_path,
                                    rotate_mb=self.journal_rotate_mb)
        self.journal.emit("run_start", command="serve", method="serve",
                          backend="torch", n_clusters=0,
                          socket=self.socket_path)
        # the daemon journal holds many traces and binds none: job events
        # name theirs; the anchor ties this process's clock to the wall
        emit_clock_anchor(self.journal)
        with self._anchor_lock:
            self._last_anchor_mono = time.perf_counter()
        self.watchdog.journal = self.journal
        if self.result_cache:
            from specpride_tpu_torch.cache import result_cache as rc_mod

            cache = rc_mod.configure(self.result_cache, self.result_store)
            logger.info("result cache: %s (cap %d MB)%s", cache.local.root,
                        cache.local.max_bytes // (1024 * 1024),
                        ", shared " + cache.shared.describe()
                        if cache.shared is not None else "")
        _build.load_host()
        if self.slots[0].device.type == "cuda":
            _build.load()
        for slot in self.slots:
            with placement.device_scope(slot):
                backend = TorchBackend(device=slot.device,
                                       precision=self.precision,
                                       layout=self.layout)
                if slot.device.type == "cuda":
                    # the lane's context and stream exist before a job
                    torch.empty(1, device=slot.device).add_(1)
                    slot.stream.synchronize()
            self.worker_backends.append(backend)
        # before the exporter binds: a refused manifest leaves no port open
        self._boot_warmup()
        if len(self.worker_backends) == 1:
            # one lane: its registry rides the exposition unlabeled
            self.telemetry = ServeTelemetry(
                slo=self.slo,
                extra_registries=(self.worker_backends[0].metrics,))
        else:
            # lanes' registries share names: one TYPE line, worker labels
            self.telemetry = ServeTelemetry(
                slo=self.slo,
                worker_registries={
                    str(slot.worker): backend.metrics
                    for slot, backend in zip(self.slots,
                                             self.worker_backends)})
        self.telemetry.sampler = self._sample_live
        if self.metrics_port is not None:
            self.exporter = MetricsExporter(
                self.telemetry.exposition, host=self.metrics_host,
                port=self.metrics_port, health=self._healthz).start()
        self._boot_autotune()
        self._boot_flightrec()
        sock_dir = os.path.dirname(self.socket_path)
        if sock_dir:
            os.makedirs(sock_dir, exist_ok=True)
        if os.path.exists(self.socket_path):
            # a stale socket of a dead daemon blocks bind(); a live one
            # is never evicted
            if self._socket_alive():
                raise SystemExit(f"another daemon is serving on "
                                 f"{self.socket_path}")
            os.unlink(self.socket_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(64)
        # a blocked accept() is not reliably woken by close() from another
        # thread: poll so the stop flag is seen promptly
        self._listener.settimeout(0.5)
        boot_s = time.perf_counter() - self._t_boot
        self.journal.emit(
            "serve_start", socket=self.socket_path,
            max_queue=self.queue.capacity,
            warmed_kernels=self.warmed_kernels, boot_s=round(boot_s, 4),
            workers=len(self.slots),
            placement=[slot.describe() for slot in self.slots],
            device=str(self.slots[0].device.type), layout=self.layout,
            precision=self.precision,
            **({"batch_window_s": self.batch_window,
                "batch_max_clusters": self.batch_max_clusters}
               if self.batch_window > 0 else {}),
            **({"metrics_port": self.exporter.port}
               if self.exporter is not None else {}),
            **({"slo": self.slo} if self.slo else {}),
            **({"quota": {c: repr(q) for c, q in self.quotas.items()}}
               if self.quotas else {}),
            **({"autotune": self.autotune,
                "autotune_interval_s": self.autotune_interval,
                "autotune_batch_window_ms": list(
                    self.autotune_batch_window)}
               if self.autotune != "off" else {}),
            **({"flightrec": self.flightrec,
                **({"incident_dir": self.incident_dir}
                   if self.incident_dir else {})}
               if self.flightrec != "off" else {}),
        )
        logger.info("serving on %s (boot %.2fs, %d shape classes warmed, "
                    "queue depth %d, %d worker lane(s): %s)",
                    self.socket_path, boot_s, self.warmed_kernels,
                    self.queue.capacity, len(self.slots),
                    " ".join(slot.describe() for slot in self.slots))
        if self.exporter is not None:
            logger.info("live metrics on %s", self.exporter.url)
        return self

    def _boot_warmup(self) -> None:
        """Every lane dispatches each ``--warmup-manifest`` class once, on
        its own card and stream (a warm is per card and per stream), so
        no lane's first job pays a first dispatch.  The port keeps no
        manifest by default: ``auto`` without the flag does nothing,
        ``manifest`` without a readable file stops the boot."""
        if self.warmup == "off":
            return
        from specpride_tpu_torch.warmstart.manifest import load_manifest
        from specpride_tpu_torch.warmstart.warmup import warm_entries

        path = self.warmup_manifest
        if path is None or not os.path.exists(path):
            if self.warmup == "manifest":
                raise SystemExit(
                    "serve --warmup manifest: no shape manifest at "
                    f"{path or '<no --warmup-manifest and no compile cache>'}")
            if path is not None:
                logger.info("serve: no shape manifest yet (%s); jobs with "
                            "--warmup-manifest will seed it", path)
            return
        try:
            entries = load_manifest(path)
        except (OSError, ValueError) as e:
            if self.warmup == "manifest":
                raise SystemExit(f"unreadable shape manifest {path}: {e}")
            logger.warning("ignoring shape manifest %s (%s)", path, e)
            return
        for slot, backend in zip(self.slots, self.worker_backends):
            with placement.device_scope(slot):
                warm_entries(entries, journal=self.journal,
                             jobs=self.warmup_jobs, backend=backend)
        self.warmed_kernels = len(entries)

    def _boot_autotune(self) -> None:
        """The controller (``--autotune observe|on``) on the daemon's
        journal, with the batch-window and active-lane policies bound to
        the live knobs.  ``off`` builds nothing."""
        if self.autotune == "off":
            return
        if not self.journal.enabled:
            raise SystemExit("serve --autotune observe|on requires "
                             "--journal: every decision must be journaled "
                             "as evidence")
        from specpride_tpu_torch.autotune import (
            BatchWindowPolicy,
            Controller,
            ControllerThread,
            WorkerPolicy,
        )

        lo_ms, hi_ms = self.autotune_batch_window
        ctl = Controller(self.journal, mode=self.autotune,
                         telemetry=self.telemetry)
        ctl.register(BatchWindowPolicy(lo_ms=lo_ms, hi_ms=hi_ms),
                     get=lambda: round(self.batch_window * 1000.0, 3),
                     set=lambda ms: setattr(self, "batch_window",
                                            float(ms) / 1000.0))
        ctl.register(WorkerPolicy(lo=1, hi=len(self.slots)),
                     get=lambda: self.active_workers,
                     set=lambda n: setattr(self, "active_workers", int(n)))
        self.controller = ctl
        self._controller_thread = ControllerThread(
            ctl, interval=self.autotune_interval).start()
        logger.info("autotune %s: knobs %s, tick %.2fs, batch-window clamp "
                    "[%g, %g] ms", self.autotune,
                    ",".join(ctl.status()["knobs"]), self.autotune_interval,
                    lo_ms, hi_ms)

    def _boot_flightrec(self) -> None:
        """The flight recorder (``--flightrec observe|on``): a ring of
        recent journal records and the detector set, tapping the daemon's
        journal; its bundles carry the ``/metrics`` exposition and the
        daemon's config."""
        if self.flightrec == "off":
            return
        if not self.journal.enabled:
            raise SystemExit("serve --flightrec observe|on requires "
                             "--journal: the detectors fold the journal "
                             "stream")
        from specpride_tpu_torch.observability.flightrec import (
            FlightRecorder,
        )

        ctl = self.controller
        self.recorder = FlightRecorder(
            self.journal, mode=self.flightrec,
            incident_dir=self.incident_dir,
            metrics_fn=self.telemetry.exposition,
            autotune_fn=((lambda: {"status": ctl.status(),
                                   "knobs": ctl.knob_values()})
                         if ctl is not None else None),
            config={"host": "serve", "socket": self.socket_path,
                    "workers": len(self.slots),
                    "max_queue": self.queue.capacity,
                    "batch_window_s": self.batch_window,
                    "batch_max_clusters": self.batch_max_clusters,
                    "precision": self.precision, "layout": self.layout,
                    "device": self.device,
                    "watchdog_timeout_s": self.watchdog.timeout_s,
                    "warmup": self.warmup,
                    "slo": self.slo, "autotune": self.autotune,
                    "flightrec": self.flightrec},
            telemetry=self.telemetry).start()
        logger.info("flightrec %s: %d detectors, ring %d%s", self.flightrec,
                    len(self.recorder.detect.detectors),
                    self.recorder.ring.capacity,
                    f", bundles under {self.incident_dir}"
                    if self.incident_dir else "")

    def _sample_live(self, telemetry) -> None:
        """Scrape-time gauges: every ``/metrics`` read (and the drain
        textfile) sees the current queue and lanes."""
        telemetry.queue_depth.set(len(self.queue))
        # per-client depths: clear-and-set, so departed clients do not
        # linger; at drain every client ever admitted renders at 0
        telemetry.queue_depth_client.clear()
        if self._draining:
            for client in sorted(self._clients_seen):
                telemetry.queue_depth_client.set(0, client=client)
        for client, n in self.queue.depths().items():
            telemetry.queue_depth_client.set(n, client=str(client))
        telemetry.inflight.zero_all()
        inflight = dict(self._inflight_by)
        backlog = sum(len(v) for v in list(self._batch_backlog.values()))
        telemetry.inflight_total.set(len(inflight) + backlog)
        counts: dict[tuple, int] = {}
        for job in inflight.values():
            key = (job.command, str(getattr(job.args, "method", None)
                                    or "-"), "torch")
            counts[key] = counts.get(key, 0) + 1
        for (command, method, backend), n in counts.items():
            telemetry.inflight.set(n, command=command, method=method,
                                   backend=backend)
        telemetry.inflight_worker.clear()
        telemetry.workers.set(len(self.slots))
        for slot in self.slots:
            telemetry.inflight_worker.set(
                1 if slot.worker in inflight else 0,
                worker=str(slot.worker))
        telemetry.uptime.set(round(time.perf_counter() - self._t_boot, 3))

    def _healthz(self) -> tuple[bool, str]:
        """``/healthz``: ok while no lane is stalled; degraded (HTTP 503)
        after a sticky CUDA error, while draining, or naming the lanes the
        watchdog flagged."""
        bits = [f"workers={len(self.slots)}",
                f"inflight={len(self._inflight_by)}"]
        if self.poisoned is not None:
            return False, "cuda_error " + " ".join(bits)
        if self._draining or self._stop.is_set():
            return False, "draining " + " ".join(bits)
        stalled = self.watchdog.stalled()
        if stalled:
            lanes = ",".join(sorted({lane for lane, _ in stalled}))
            worst = max(e for _, e in stalled)
            return False, (f"stalled={lanes} worst_stall_s={worst} "
                           + " ".join(bits))
        if not self.watchdog.enabled:
            bits.append("watchdog=off")
        return True, " ".join(bits)

    def _maybe_anchor(self) -> None:
        """Re-journal the clock anchor, at most once per interval."""
        now = time.perf_counter()
        with self._anchor_lock:
            if now - self._last_anchor_mono < CLOCK_ANCHOR_INTERVAL_S:
                return
            self._last_anchor_mono = now
        emit_clock_anchor(self.journal)

    def _socket_alive(self) -> bool:
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        probe.settimeout(1.0)
        try:
            probe.connect(self.socket_path)
            return True
        except OSError:
            return False
        finally:
            probe.close()

    # -- request loop ---------------------------------------------------

    def run(self) -> int:
        """Boot, then serve until SIGTERM or SIGINT (or :meth:`drain` from
        another thread).  Returns 0, or 1 after a sticky CUDA error."""
        self.boot()
        if threading.current_thread() is threading.main_thread():
            import signal

            signal.signal(signal.SIGTERM, self._on_signal)
            signal.signal(signal.SIGINT, self._on_signal)
        self._worker_threads = [
            threading.Thread(target=self._worker_loop, args=(slot.worker,),
                             name=f"specpride-serve-worker-{slot.worker}",
                             daemon=True)
            for slot in self.slots
        ]
        for t in self._worker_threads:
            t.start()
        try:
            self._accept_loop()
        finally:
            self.drain()
        return 1 if self.poisoned is not None else 0

    def _on_signal(self, signum, frame) -> None:
        logger.info("signal %d: draining", signum)
        self._stop_accepting()

    def _stop_accepting(self) -> None:
        """End the accept loop; ``run()``'s ``finally`` drains."""
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except TimeoutError:
                continue  # poll tick: check the stop flag
            except OSError as e:
                if self._stop.is_set():
                    return
                if rb_errors.is_transient(e):
                    logger.warning("accept failed transiently (%s)", e)
                    time.sleep(0.1)
                    continue
                raise
            threading.Thread(target=self._handle_conn, args=(conn,),
                             name="specpride-serve-reader",
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        # bound the admission read: a silent client must not pin a reader
        conn.settimeout(60.0)
        fh = conn.makefile("rw", encoding="utf-8", newline="\n")
        keep_open = False
        try:
            try:
                msg = protocol.read_msg(fh)
            except ValueError as e:
                protocol.write_msg(fh, ok=False, status="rejected",
                                   reason=f"bad message: {e}",
                                   retriable=False)
                return
            if msg is None:
                return
            op = msg.get("op")
            if op == "ping":
                protocol.write_msg(fh, ok=True, status="pong",
                                   v=protocol.PROTOCOL_VERSION)
            elif op == "status":
                protocol.write_msg(fh, ok=True, **self.status())
            elif op == "profile":
                # on this reader thread: a capture never blocks admission
                self._profile(msg, fh)
            elif op == "submit":
                keep_open = self._admit(msg, conn, fh)
            else:
                protocol.write_msg(fh, ok=False, status="rejected",
                                   reason=f"unknown op {op!r}",
                                   retriable=False)
        except OSError as e:
            logger.warning("connection died during admission: %s", e)
        finally:
            if not keep_open:
                self._close(conn, fh)

    def _admit(self, msg: dict, conn, fh) -> bool:
        """Validate and enqueue one submit.  True when a worker now owns
        the connection (it writes the terminal line)."""
        argv = msg.get("argv")
        job_id = self._job_ids()

        def reject(reason: str, retriable: bool) -> bool:
            with self._rejected_lock:
                self.jobs_rejected += 1
            # bounded label values: parser messages count as "invalid"
            self.telemetry.job_rejected(
                reason if reason in ("draining", "queue_full")
                else "quota" if reason.startswith("quota ")
                else "invalid")
            self.journal.emit("job_rejected", job_id=job_id, reason=reason,
                              retriable=retriable)
            protocol.write_msg(fh, ok=False, status="rejected",
                               job_id=job_id, reason=reason,
                               retriable=retriable)
            return False

        if not isinstance(argv, list) or not all(
                isinstance(a, str) for a in argv):
            return reject("argv must be a list of strings", False)
        client = msg.get("client")
        if client is not None and not isinstance(client, str):
            return reject("client must be a string", False)
        if self._draining or self._stop.is_set():
            return reject("draining", True)
        if not argv or argv[0] not in protocol.SERVABLE_COMMANDS:
            return reject(f"command must be one of "
                          f"{list(protocol.SERVABLE_COMMANDS)}", False)
        forbidden = protocol.forbidden_flags(argv)
        if forbidden:
            return reject(f"daemon-owned flags on a job: {forbidden} (set "
                          "them on `serve` at boot)", False)
        try:
            args = _parse_job_argv(argv)
        except ValueError as e:
            return reject(str(e), False)
        overridden = protocol.overridden_daemon_flags(args)
        if overridden:
            # a prefix spelling (--layou) the token scan cannot see
            return reject(f"daemon-owned flags on a job: {overridden} (set "
                          "them on `serve` at boot)", False)
        try:
            trace = TraceContext.from_wire(msg.get("trace"))
        except ValueError as e:
            return reject(str(e), False)
        job = Job(job_id, client or id(conn), argv, args, argv[0], conn,
                  fh, trace=trace)
        if self.batch_window > 0:
            from specpride_tpu_torch.serve import batcher

            job.batch_key = batcher.batch_key(args, job.command)
        try:
            admitted = self.queue.offer(job.client, job)
        except QuotaExceeded as e:
            return reject(str(e), True)
        if not admitted:
            return reject("draining" if self._draining else "queue_full",
                          True)
        self._clients_seen.add(str(job.client))
        self.journal.emit(
            "job_queued", job_id=job_id, client=str(job.client),
            command=job.command, method=getattr(args, "method", None),
            trace_id=job.trace_id,
            **({"batch_eligible": job.batch_key is not None}
               if self.batch_window > 0 else {}))
        try:
            protocol.write_msg(fh, ok=True, status="accepted",
                               job_id=job_id, queue_depth=len(self.queue),
                               trace_id=job.trace_id)
        finally:
            job.ack.set()  # even for a dead client: the worker must not wait
        return True

    # -- on-demand profiling --------------------------------------------

    def _profile(self, msg: dict, fh) -> None:
        """``profile``: one bounded ``torch.profiler`` capture of the
        running daemon (``--trace-dir``'s trace: CPU activity and, on the
        card, its kernels and copies), plus the daemon journal's events
        inside the window in ``<trace_dir>/journal_window.jsonl``.  One
        capture at a time; a second is rejected retriable."""
        seconds = msg.get("seconds", 3.0)
        if not isinstance(seconds, (int, float)) or not (
                0 < seconds <= protocol.PROFILE_MAX_SECONDS):
            protocol.write_msg(fh, ok=False, status="rejected",
                               reason=f"seconds must be in (0, "
                               f"{protocol.PROFILE_MAX_SECONDS}]",
                               retriable=False)
            return
        trace_dir = msg.get("trace_dir")
        chrome_trace = msg.get("chrome_trace")
        for name, val in (("trace_dir", trace_dir),
                          ("chrome_trace", chrome_trace)):
            if val is not None and not isinstance(val, str):
                protocol.write_msg(fh, ok=False, status="rejected",
                                   reason=f"{name} must be a string path",
                                   retriable=False)
                return
        if not self._profile_lock.acquire(blocking=False):
            protocol.write_msg(fh, ok=False, status="rejected",
                               reason="a profile capture is already running",
                               retriable=True)
            return
        try:
            import shutil
            import tempfile

            from specpride_tpu_torch.observability.stats import (
                device_trace,
                trace_path,
            )

            if trace_dir is None:
                trace_dir = tempfile.mkdtemp(prefix="specpride_profile_")
            with device_trace(trace_dir, self.slots[0].device):
                # the window opens once the profiler runs (its first start
                # in a process takes seconds)
                mono0 = time.perf_counter()
                self.journal.emit("profile_start", seconds=seconds,
                                  trace_dir=trace_dir)
                deadline = mono0 + float(seconds)
                while not self._stop.is_set():
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    time.sleep(min(0.2, remaining))
                mono1 = time.perf_counter()
            trace = trace_path(trace_dir)
            if chrome_trace:
                shutil.copyfile(trace, chrome_trace)
            window = self._journal_window(trace_dir, mono0, mono1)
            artifacts = sorted(
                os.path.relpath(os.path.join(d, f), trace_dir)
                for d, _, files in os.walk(trace_dir) for f in files)
            self.journal.emit("profile_done",
                              seconds=round(mono1 - mono0, 4),
                              trace_dir=trace_dir,
                              n_artifacts=len(artifacts))
            logger.info("profile: %.2fs window, %d artifact(s) -> %s",
                        mono1 - mono0, len(artifacts), trace_dir)
            protocol.write_msg(fh, ok=True, status="profiled",
                               seconds=round(mono1 - mono0, 4),
                               trace_dir=trace_dir, trace=trace,
                               artifacts=artifacts,
                               chrome_trace=chrome_trace or None, **window)
        except Exception as e:  # noqa: BLE001 - reported to the client
            logger.warning("profile capture failed: %s", e)
            try:
                protocol.write_msg(fh, ok=False, status="error",
                                   error=f"{type(e).__name__}: {e}",
                                   retriable=False)
            except OSError:
                pass
        finally:
            self._profile_lock.release()

    def _journal_window(self, trace_dir: str, mono0: float,
                        mono1: float) -> dict:
        """The daemon journal's events whose ``mono`` fell inside the
        capture, written beside the trace and counted by event."""
        path = getattr(self.journal, "path", None)
        if not path:
            return {"window_events": {}}
        counts: dict[str, int] = {}
        out_path = os.path.join(trace_dir, "journal_window.jsonl")
        try:
            with open(path, encoding="utf-8") as src, \
                    open(out_path, "w", encoding="utf-8") as dst:
                for line in src:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # the torn tail of a line being written
                    mono = rec.get("mono")
                    if isinstance(mono, (int, float)) and \
                            mono0 <= mono <= mono1:
                        dst.write(line)
                        ev = rec.get("event", "?")
                        counts[ev] = counts.get(ev, 0) + 1
        except OSError as e:
            logger.warning("journal window slice failed: %s", e)
            return {"window_events": {}}
        return {"journal_window": out_path, "window_events": counts}

    # -- execution lanes ------------------------------------------------

    def _worker_loop(self, wid: int) -> None:
        while True:
            if self._pop_timeout is not None and wid >= self.active_workers:
                # a parked lane (the autotune workers knob, mode on): its
                # backend idles warm until it is unparked or the daemon
                # drains
                if self._stop.wait(self._pop_timeout):
                    return
                continue
            job = self.queue.pop(timeout=self._pop_timeout)
            if job is None:
                if self._pop_timeout is not None and \
                        not self._stop.is_set():
                    continue  # a poll tick: check parking again
                return  # the queue was drained
            self._inflight_by[wid] = job
            self._gate.wait()
            if self.poisoned is not None:
                # the context is broken: never run another job on it
                self._refuse(job, wid)
                continue
            batch, parsed, window_wait = self._collect_batch(job, wid)
            if parsed is None:
                self._run_job(job, wid)
            else:
                self._batch_backlog[wid] = list(batch[1:])
                shared, batch_info = self._shared_dispatch(
                    batch, parsed, wid, window_wait)
                for j in batch:
                    self._inflight_by[wid] = j
                    backlog = self._batch_backlog.get(wid)
                    if backlog and j in backlog:
                        backlog.remove(j)
                    if self.poisoned is not None:
                        self._refuse(j, wid)
                        continue
                    # a member the pass did not serve runs solo and does
                    # not report itself batched
                    s = (shared or {}).get(j.job_id)
                    self._run_job(j, wid, shared=s,
                                  batch_info=batch_info if s is not None
                                  else None)
                self._batch_backlog.pop(wid, None)
            self._inflight_by.pop(wid, None)

    def _refuse(self, job: Job, wid: int) -> None:
        """Answer a popped job without running it: the daemon is going
        down after a sticky CUDA error (retriable: another daemon can run
        it)."""
        with self._rejected_lock:
            self.jobs_rejected += 1
        self.telemetry.job_rejected("draining")
        self.journal.emit("job_rejected", job_id=job.job_id,
                          reason="draining", retriable=True)
        job.ack.wait(timeout=10.0)
        try:
            protocol.write_msg(job.fh, ok=False, status="rejected",
                               job_id=job.job_id, reason="draining",
                               retriable=True)
        except (OSError, ValueError):
            pass
        self._close(job.conn, job.fh)
        self._inflight_by.pop(wid, None)
        self.queue.release(job)

    def _collect_batch(self, leader: Job, wid: int):
        """The leader lane's window: pull further compatible queued jobs
        (the fair order, quotas and output guard of a normal pop) and
        parse each member's input through the ingest cache, until the
        merged clusters reach ``--batch-max-clusters`` or the window
        closes.  The window bounds the wait for the first companion;
        once one is aboard an empty queue dispatches at once.  Returns
        ``(batch, parsed, window_wait_s)``; ``parsed`` is None for the
        solo path, else ``{job_id: clusters or None}`` (None: the parse
        failed and the member runs solo)."""
        key = leader.batch_key
        if key is None or self.batch_window <= 0:
            return [leader], None, 0.0
        from specpride_tpu_torch.serve import batcher

        t0 = time.perf_counter()
        parsed: dict[int, list | None] = {}
        try:
            parsed[leader.job_id] = batcher.parse_batch_input(leader.args,
                                                              wid)
        except Exception:  # noqa: BLE001 - the solo run reports it
            return [leader], None, 0.0
        batch = [leader]
        total = len(parsed[leader.job_id])
        # anchored after the leader's parse, so a parse longer than the
        # window does not close it before the wait begins
        deadline = time.perf_counter() + self.batch_window
        while total < self.batch_max_clusters:
            nxt = self.queue.pop_compatible(lambda j: j.batch_key == key)
            if nxt is not None:
                batch.append(nxt)
                try:
                    clusters = batcher.parse_batch_input(nxt.args, wid)
                except Exception:  # noqa: BLE001 - the member runs solo
                    parsed[nxt.job_id] = None
                else:
                    parsed[nxt.job_id] = clusters
                    total += len(clusters)
                continue
            if len(batch) > 1 or self._stop.is_set() or self._draining:
                break
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            time.sleep(min(0.002, remaining))
        window_wait = time.perf_counter() - t0
        if len(batch) == 1:
            # the window closed empty: solo (the parse stays resident)
            return [leader], None, window_wait
        return batch, parsed, window_wait

    def _shared_dispatch(self, batch, parsed, wid: int, window_wait):
        """The batch's one shared pass on this lane's backend, journaled
        as ``batch_dispatch`` (jobs, clusters, window wait, the device
        counters' growth).  Returns ``(shared, batch_info)``; ``shared``
        is None when the pass failed, and every member then runs solo on
        this lane."""
        from specpride_tpu_torch.serve import batcher

        leader = batch[0]
        backend = self.worker_backends[wid]
        slot = self.slots[wid]
        bid = self._batch_ids()
        entries = [(j, parsed[j.job_id]) for j in batch
                   if parsed.get(j.job_id) is not None]
        n_clusters = sum(len(c) for _, c in entries)
        batch_info = {"batch_id": bid, "n_jobs": len(batch),
                      "n_clusters": n_clusters,
                      "window_wait_s": round(window_wait, 4)}
        backend.reset_run_counters()
        backend.journal = NullJournal()
        dev0 = device_counters_snapshot(backend.metrics)
        t0 = time.perf_counter()
        shared, err = None, None
        try:
            with self.watchdog.section("serve:batch"), \
                    placement.device_scope(slot):
                shared = batcher.compute_shared(backend, leader.args,
                                                leader.command, entries)
        except Exception as e:  # noqa: BLE001 - the members run solo
            err = f"{type(e).__name__}: {e}"
            if rb_errors.is_sticky(e):
                self._poison(err)
            logger.warning("batch %d: shared pass failed (%s); %d job(s) "
                           "run solo", bid, e, len(batch))
        wall = time.perf_counter() - t0
        dev = device_summary(backend.metrics, since=dev0)
        status = "shared" if shared is not None else "fallback_solo"
        if shared is not None:
            with self._counts_lock:
                self.batches_dispatched += 1
                self.jobs_batched += len(shared)
        batch_span = new_span_id()
        self.journal.emit(
            "batch_dispatch", batch_id=bid, jobs=[j.job_id for j in batch],
            clients=sorted({str(j.client) for j in batch}),
            n_jobs=len(batch), n_clusters=n_clusters,
            method=getattr(leader.args, "method", None),
            key=list(leader.batch_key or ()),
            window_wait_s=round(window_wait, 4), wall_s=round(wall, 4),
            worker=wid, status=status, dispatches=dev["dispatches"],
            bucket_occupancy_frac=dev["bucket_occupancy_frac"],
            padding_waste_frac=dev["padding_waste_frac"],
            trace_ids=[j.trace_id for j in batch], span_id=batch_span,
            parent_span_id=leader.span_id,
            **({"error": err} if err else {}))
        self.journal.emit(
            "span", name="serve:batch", mono=t0 + wall,
            dur_s=round(wall, 6), depth=1, tid=wid,
            trace_id=leader.trace_id, span_id=batch_span,
            parent_span_id=leader.span_id,
            labels={"batch_id": bid, "n_jobs": len(batch),
                    "n_clusters": n_clusters, "status": status,
                    "worker": wid})
        if shared is not None:
            self.telemetry.batch_dispatch(
                n_jobs=len(shared), n_clusters=n_clusters,
                window_wait_s=window_wait,
                occupancy_frac=dev["bucket_occupancy_frac"])
        return shared, batch_info

    def _poison(self, err: str) -> None:
        """A sticky CUDA error: stop serving (the accept loop ends, and
        ``run()`` drains and returns 1)."""
        if self.poisoned is None:
            self.poisoned = err
            logger.error("sticky CUDA error (%s): the CUDA context is "
                         "unusable; draining", err)
        self._stop_accepting()

    def _run_job(self, job: Job, wid: int, shared=None,
                 batch_info=None) -> None:
        batch_fields = ({"batch_id": batch_info["batch_id"],
                         "batch_jobs": batch_info["n_jobs"]}
                        if batch_info is not None else {})
        self._maybe_anchor()
        wait_s = time.perf_counter() - job.t_enqueued
        self.journal.emit("job_start", job_id=job.job_id,
                          command=job.command,
                          method=getattr(job.args, "method", None),
                          queue_wait_s=round(wait_s, 4), worker=wid,
                          trace_id=job.trace_id, **batch_fields)
        t0 = time.perf_counter()
        span_kwargs = ({"parent_span_id": job.parent_span_id}
                       if job.parent_span_id else {})
        self.journal.emit("span", name="serve:queue", mono=t0,
                          dur_s=round(wait_s, 6), depth=0, tid=wid,
                          trace_id=job.trace_id, span_id=new_span_id(),
                          labels={"job_id": job.job_id, "worker": wid},
                          **span_kwargs)
        status, rc, err, retriable, summary = "done", 0, None, False, None
        try:
            with self.watchdog.section("serve:job"):
                summary = self._execute(job, wid, shared=shared)
        except SystemExit as e:
            # a CLI usage or abort error: permanent for the daemon
            status, rc = "error", 1
            err = (str(e.code) if not isinstance(e.code, int)
                   else f"exit {e.code}")
        except Exception as e:  # noqa: BLE001 - reported to the client
            status, rc = "error", 1
            err = f"{type(e).__name__}: {e}"
            retriable = rb_errors.is_transient(e)
            if rb_errors.is_sticky(e):
                self._poison(err)
        wall = time.perf_counter() - t0
        with self._counts_lock:
            if status == "done":
                self.jobs_done += 1
            else:
                self.jobs_failed += 1
        self.journal.emit(
            "span", name="serve:job", mono=time.perf_counter(),
            dur_s=round(wall, 6), depth=0, tid=wid, trace_id=job.trace_id,
            span_id=job.span_id,
            labels={"job_id": job.job_id, "worker": wid,
                    "command": job.command, "status": status,
                    **({"method": job.args.method}
                       if getattr(job.args, "method", None) else {})},
            **span_kwargs)
        slo_fields = self.telemetry.job_done(
            command=job.command, method=getattr(job.args, "method", None),
            status=status, wall_s=wall, queue_wait_s=wait_s,
            summary=summary if isinstance(summary, dict) else None,
            worker=wid, trace_id=job.trace_id)
        counters = (summary or {}).get("counters", {})
        self.journal.emit(
            "job_done", job_id=job.job_id, status=status,
            wall_s=round(wall, 4), queue_wait_s=round(wait_s, 4),
            command=job.command, method=getattr(job.args, "method", None),
            fresh_compiles=0, worker=wid, trace_id=job.trace_id,
            **batch_fields, **slo_fields,
            **({"result_cache_hits": counters["result_cache_hits"]}
               if "result_cache_hits" in counters else {}),
            **({"error": err} if err else {}))
        job.ack.wait(timeout=10.0)  # the admission line strictly first
        try:
            if status == "done":
                protocol.write_msg(
                    job.fh, ok=True, status="done", job_id=job.job_id,
                    rc=rc, wall_s=round(wall, 4),
                    queue_wait_s=round(wait_s, 4), stats=summary,
                    worker=wid, trace_id=job.trace_id,
                    **({"batch": batch_fields} if batch_fields else {}))
            else:
                protocol.write_msg(job.fh, ok=False, status="error",
                                   job_id=job.job_id, error=err,
                                   retriable=retriable)
        except (OSError, ValueError):
            # the client left while its job ran; the output is on disk
            logger.warning("job %d: client disconnected before the "
                           "terminal response", job.job_id)
        self._close(job.conn, job.fh)
        self._inflight_by.pop(wid, None)
        # the quota slot and output paths free only after the terminal
        # write: a same-output successor must not start earlier
        self.queue.release(job)

    def _execute(self, job: Job, wid: int, shared=None) -> dict:
        """One job through the CLI's own body on worker ``wid``'s backend,
        inside the lane's card and stream, after the per-job resets.
        ``shared`` (a ``batcher.SharedResults``) wraps the backend in the
        batch's read-only view."""
        from specpride_tpu_torch import cli

        slot = self.slots[wid]
        # the CLI stamps the worker into run_end and installs the job's
        # tracer for this thread only
        job.args._serve_worker = wid
        # every span of the job parents under its serve:job span
        job.args._trace_ctx = TraceContext(job.trace_id, job.span_id)
        backend = self.worker_backends[wid]
        backend.reset_run_counters()
        backend.journal = NullJournal()
        # boot warmed the lanes: a job's --warmup warms nothing again (its
        # --warmup-manifest still takes the job's new shape classes)
        job.args._resident_warm = True
        if shared is not None:
            from specpride_tpu_torch.serve.batcher import BatchResultBackend

            backend = BatchResultBackend(backend, shared)
        with placement.device_scope(slot):
            return cli._run_pipeline_command(job.args, backend)

    # -- shutdown -------------------------------------------------------

    def drain(self) -> None:
        """Graceful shutdown: reject queued jobs (retriable), let every
        lane's in-flight job commit, close everything.  Idempotent, from
        any thread."""
        with self._drain_lock:
            if self._draining:
                return
            self._draining = True
        self._stop.set()
        if self.journal is None:
            return  # boot never completed
        # the controller stops first: a tick racing the drain's last
        # events (or the journal's close) would land inside them
        if self._controller_thread is not None:
            self._controller_thread.stop()
            self._controller_thread = None
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        rejected = self.queue.drain()
        for job in rejected:
            with self._rejected_lock:
                self.jobs_rejected += 1
            if self.telemetry is not None:
                self.telemetry.job_rejected("draining")
            self.journal.emit("job_rejected", job_id=job.job_id,
                              reason="draining", retriable=True)
            job.ack.wait(timeout=10.0)
            try:
                protocol.write_msg(job.fh, ok=False, status="rejected",
                                   job_id=job.job_id, reason="draining",
                                   retriable=True)
            except (OSError, ValueError):
                pass  # the client is gone
            self._close(job.conn, job.fh)
        self._gate.set()  # a held test gate must not deadlock the drain
        for t in self._worker_threads:
            if t.is_alive():
                t.join()
        # an in-flight capture ends within a sleep quantum of _stop; its
        # profile_done must land before run_end (bounded wait)
        if self._profile_lock.acquire(timeout=60):
            self._profile_lock.release()
        else:
            logger.warning("drain: a profile capture did not finish within "
                           "60s")
        self.watchdog.stop()
        # after the lanes joined (their last events still fold) and before
        # the exporter stops and --metrics-out flushes: stop() journals
        # every queued firing, so a drain swallows no incident
        if self.recorder is not None:
            self.recorder.stop()
        if self.exporter is not None:
            self.exporter.stop()
        if self.metrics_out and self.telemetry is not None:
            try:
                self.telemetry.write_textfile(self.metrics_out)
                logger.info("final metrics -> %s", self.metrics_out)
            except OSError as e:
                logger.warning("final metrics flush to %s failed: %s",
                               self.metrics_out, e)
        uptime = time.perf_counter() - self._t_boot
        self.journal.emit("serve_drain", n_rejected=len(rejected),
                          jobs_done=self.jobs_done,
                          jobs_failed=self.jobs_failed,
                          **({"cuda_error": self.poisoned}
                             if self.poisoned is not None else {}))
        self.journal.emit(
            "run_end",
            counters={"jobs_done": self.jobs_done,
                      "jobs_failed": self.jobs_failed,
                      "jobs_rejected": self.jobs_rejected},
            phases_s={"serve": round(uptime, 4)},
            elapsed_s=round(uptime, 4), device=device_summary(None))
        self.journal.close()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        if self.result_cache:
            from specpride_tpu_torch.cache import result_cache as rc_mod

            rc_mod.configure(None)
        logger.info("drained: %d done, %d failed, %d rejected",
                    self.jobs_done, self.jobs_failed, self.jobs_rejected)

    def status(self) -> dict:
        return {
            "status": "serving" if not self._draining else "draining",
            "socket": self.socket_path,
            "queue_depth": len(self.queue),
            "max_queue": self.queue.capacity,
            "jobs_done": self.jobs_done,
            "jobs_failed": self.jobs_failed,
            "jobs_rejected": self.jobs_rejected,
            "warmed_kernels": self.warmed_kernels,
            "workers": len(self.slots),
            "placement": [slot.describe() for slot in self.slots],
            "inflight": len(self._inflight_by),
            "uptime_s": round(time.perf_counter() - self._t_boot, 2),
            **({"cuda_error": self.poisoned}
               if self.poisoned is not None else {}),
            **({"batching": {
                "window_s": self.batch_window,
                "max_clusters": self.batch_max_clusters,
                "batches_dispatched": self.batches_dispatched,
                "jobs_batched": self.jobs_batched}}
               if self.batch_window > 0 else {}),
            **({"quota": {c: repr(q) for c, q in self.quotas.items()}}
               if self.quotas else {}),
            **({"metrics_port": self.exporter.port,
                "metrics_url": self.exporter.url}
               if self.exporter is not None else {}),
            **({"slo": self.slo} if self.slo else {}),
            **({"autotune": {
                **self.controller.status(),
                "batch_window_ms": round(self.batch_window * 1000.0, 3),
                "active_workers": self.active_workers}}
               if self.controller is not None else {}),
            **({"flightrec": self.recorder.status()}
               if self.recorder is not None else {}),
            **self._result_cache_status(),
        }

    @staticmethod
    def _result_cache_status() -> dict:
        from specpride_tpu_torch.cache import result_cache as rc_mod

        cache = rc_mod.active()
        if cache is None:
            return {}
        return {"result_cache": {**cache.local.info(), **rc_mod.totals()}}

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until no job is queued, batched or in flight (a reply is
        written before the worker drops the job from ``_inflight_by``).
        False on timeout."""
        deadline = time.perf_counter() + max(float(timeout), 0.0)
        while time.perf_counter() < deadline:
            if (not self._inflight_by and len(self.queue) == 0
                    and not any(self._batch_backlog.values())):
                return True
            time.sleep(0.002)
        return False

    @staticmethod
    def _close(conn, fh) -> None:
        for closer in (fh, conn):
            try:
                closer.close()
            except OSError:
                pass


_parser_lock = threading.Lock()
_job_parser = None


def _build_job_parser():
    """The port CLI's own parser with every ``error()`` (top level and each
    subparser) raising ``ValueError`` instead of printing and exiting:
    admission runs on concurrent reader threads, where redirecting the
    process's stderr would mix clients' messages."""
    from specpride_tpu_torch.cli import build_parser

    ap = build_parser()

    def _raise(message: str):
        raise ValueError(f"argv rejected by the CLI parser: {message}")

    ap.error = _raise
    if ap._subparsers is not None:
        for action in ap._subparsers._group_actions:
            for sub in (getattr(action, "choices", None) or {}).values():
                sub.error = _raise
    return ap


def _parse_job_argv(argv: list[str]):
    """A job argv through the (cached) CLI parser, so a served job takes
    exactly what a one-shot run takes.  Raises ``ValueError`` with the
    parser's message; ``--help`` is a rejection too."""
    global _job_parser
    with _parser_lock:
        if _job_parser is None:
            _job_parser = _build_job_parser()
        try:
            return _job_parser.parse_args(argv)
        except SystemExit:
            raise ValueError(f"argv rejected by the CLI parser: "
                             f"{json.dumps(argv)}") from None
