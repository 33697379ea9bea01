"""Live telemetry plane of the serving daemon: an in-process Prometheus
exporter and SLO accounting (the port's copy of the JAX package's
``observability/exporter.py``).

* :class:`ServeTelemetry`: the daemon's resident registry, the event
  hooks (``job_done``, ``job_rejected``, ``batch_dispatch``, the flight
  recorder's ``incident``, the autotune controller's
  ``autotune_decision``) and the
  scrape-time samplers (queue depth, in flight, lanes, the ingest and
  result caches' process totals, the lanes' H2D and D2H bytes);
* :class:`MetricsExporter`: ``/metrics`` and ``/healthz`` on a background
  ``http.server`` (``serve --metrics-port``, loopback by default);
* :func:`parse_slo_spec`: ``--slo method=seconds,...``;
* :func:`parse_exposition` / :func:`validate_exposition`: the strict text
  format checker the tests and the smoke hold the exposition to.

:class:`ElasticTelemetry` is an elastic rank's ``/metrics`` (``consensus``
or ``select`` with ``--elastic`` and ``--metrics-port``).  Series whose
source the port has not got are left out: the XLA
compile-cache counters (``specpride_compile_cache_*``, no XLA) and the bucket
plan cache's (``specpride_plan_cache_*``).  Counters are cumulative over
the daemon's life; per-job attribution stays with the journal's
snapshot-and-diff deltas.
"""

from __future__ import annotations

import http.server
import os
import re
import threading

from specpride_tpu_torch.observability.detect import DETECTOR_NAMES
from specpride_tpu_torch.observability.registry import (
    MetricsRegistry,
    render_labeled,
)
from specpride_tpu_torch.observability.stats import logger

# seconds buckets sized for served jobs (queue wait + execution wall)
JOB_SECONDS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


# -- SLO specification --------------------------------------------------


def parse_slo_spec(spec: str | None) -> dict[str, float]:
    """``--slo method=seconds,...`` -> ``{method: objective_seconds}``.

    ``*`` is the catch-all objective for methods not named explicitly.
    Raises ``ValueError`` on malformed entries (the CLI turns it into a
    usage error at boot, never mid-serve)."""
    out: dict[str, float] = {}
    if not spec:
        return out
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        method, sep, value = item.partition("=")
        method = method.strip()
        if not sep or not method:
            raise ValueError(
                f"--slo entry {item!r} is not method=seconds"
            )
        try:
            seconds = float(value)
        except ValueError:
            raise ValueError(
                f"--slo {method}: {value!r} is not a number of seconds"
            ) from None
        if not seconds > 0:
            raise ValueError(
                f"--slo {method}: objective must be > 0 (got {seconds})"
            )
        out[method] = seconds
    return out


def slo_objective(slo: dict[str, float], method: str | None) -> float | None:
    """The objective that applies to ``method`` (explicit beats ``*``),
    or None when no SLO covers it."""
    if method is not None and method in slo:
        return slo[method]
    return slo.get("*")


# -- the daemon's live registry ------------------------------------------


# families whose counters and gauges ServeTelemetry sets to 0 at start, so
# the series exist from the first scrape to the drain snapshot: a 0-valued
# row beats an absent one for rate() and for auditing that a feature never
# fired (histograms appear with their first observation)
ZERO_AT_START_FAMILIES = (
    "specpride_serve_batch_*",
    "specpride_h2d_bytes_total",
    "specpride_d2h_bytes_total",
    "specpride_autotune_*",
    "specpride_incidents_*",
    "specpride_result_cache_*",
)

# the daemon's autotune knobs: a value gauge and decision counters (both
# values of ``acted``) per knob from the first scrape, so "the controller
# never moved this knob" is a 0-valued series, not an absent one
AUTOTUNE_KNOBS = ("batch_window_ms", "workers")

# the result cache's process totals, mirrored by delta at scrape time:
# (metric name, key of cache.result_cache.totals(), help)
_RESULT_CACHE_SERIES = (
    ("specpride_result_cache_hits_total", "hits",
     "consensus clusters served from the result cache (compute skipped)"),
    ("specpride_result_cache_misses_total", "misses",
     "consulted clusters the result cache could not serve"),
    ("specpride_result_cache_populated_total", "populated",
     "result-cache entries written after QC"),
    ("specpride_result_cache_evictions_total", "evictions",
     "local-tier LRU evictions forced by the size cap"),
    ("specpride_result_cache_bytes_saved_total", "bytes_saved",
     "peak bytes result-cache hits did not recompute"),
    ("specpride_result_cache_shared_hits_total", "shared_hits",
     "result-cache hits served by the shared store tier"),
    ("specpride_result_cache_corrupt_total", "corrupt",
     "result-cache entries quarantined on digest mismatch (served as "
     "misses, never as results)"),
)


class ServeTelemetry:
    """Resident metric state of one serving daemon.

    The daemon calls the ``job_*`` hooks from its worker and reader
    threads as events happen; scrape-time state (queue depth, in flight,
    uptime, the process-wide caches) is pulled by :meth:`exposition`
    through the ``sampler`` the daemon installs, so a scrape is current.

    ``extra_registries`` ride along in the exposition (a one-lane daemon
    passes its backend's registry: the per-kernel dispatch counters, the
    dispatch-latency histogram and the device memory watermark, live);
    ``worker_registries`` are the lanes' registries of a worker pool,
    rendered with a ``worker`` label per series."""

    def __init__(self, slo: dict[str, float] | None = None,
                 extra_registries: tuple = (),
                 worker_registries: "dict[str, MetricsRegistry] | None"
                 = None):
        self.slo = dict(slo or {})
        self.extra_registries = tuple(extra_registries)
        self.worker_registries = dict(worker_registries or {})
        # fn(telemetry), called before each render to refresh live gauges
        self.sampler = None
        self._lock = threading.Lock()  # guards the mirrored totals
        # one render at a time: a sampler's clear-then-set must not
        # interleave with another scrape's render
        self._render_lock = threading.Lock()
        self._totals_last: dict[str, float] = {}
        r = self.registry = MetricsRegistry()
        self.jobs_done = r.counter(
            "specpride_serve_jobs_done_total",
            "served jobs that completed successfully",
            labels=("command", "method"))
        self.jobs_failed = r.counter(
            "specpride_serve_jobs_failed_total", "served jobs that errored",
            labels=("command", "method"))
        self.jobs_rejected = r.counter(
            "specpride_serve_jobs_rejected_total",
            "submissions rejected at admission (by reason)",
            labels=("reason",))
        self.job_wall = r.histogram(
            "specpride_serve_job_wall_seconds",
            "execution wall seconds per served job",
            labels=("method",), buckets=JOB_SECONDS_BUCKETS)
        self.job_queue_wait = r.histogram(
            "specpride_serve_job_queue_wait_seconds",
            "admission-to-execution queue wait per served job",
            labels=("method",), buckets=JOB_SECONDS_BUCKETS)
        self.lane_busy = r.counter(
            "specpride_serve_lane_busy_seconds_total",
            "per-lane busy seconds across served jobs (pack worker pool / "
            "dispatch / ordered write lane)",
            labels=("lane",))
        self.queue_depth = r.gauge(
            "specpride_serve_queue_depth", "jobs queued for execution")
        self.queue_depth_client = r.gauge(
            "specpride_serve_queue_depth_client",
            "queued jobs per scheduling client", labels=("client",))
        self.inflight_total = r.gauge(
            "specpride_serve_inflight",
            "jobs on the execution lanes right now")
        self.inflight = r.gauge(
            "specpride_serve_inflight_jobs",
            "jobs on the execution lanes right now, by job labels",
            labels=("command", "method", "backend"))
        self.uptime = r.gauge(
            "specpride_serve_uptime_seconds", "seconds since daemon boot")
        self.workers = r.gauge(
            "specpride_serve_workers", "execution lanes in the worker pool")
        self.inflight_worker = r.gauge(
            "specpride_serve_inflight_worker",
            "jobs executing on each worker lane right now (0 or 1)",
            labels=("worker",))
        self.worker_busy = r.counter(
            "specpride_serve_worker_busy_seconds_total",
            "execution wall seconds each worker lane spent on served jobs",
            labels=("worker",))
        self.slo_jobs = r.counter(
            "specpride_serve_slo_jobs_total",
            "served jobs evaluated against a latency objective",
            labels=("method",))
        self.slo_breaches = r.counter(
            "specpride_serve_slo_breaches_total",
            "served jobs whose latency (queue wait + wall) exceeded their "
            "objective — the SLO burn counter",
            labels=("method",))
        slo_objective_g = r.gauge(
            "specpride_serve_slo_objective_seconds",
            "configured per-method latency objective", labels=("method",))
        for method, seconds in self.slo.items():
            slo_objective_g.set(seconds, method=method)
        # cross-job micro-batching: the shared passes
        self.batch_dispatches = r.counter(
            "specpride_serve_batch_dispatches_total",
            "shared passes computing the clusters of several jobs")
        self.batch_jobs = r.counter(
            "specpride_serve_batch_jobs_total",
            "served jobs whose compute rode a shared batch dispatch")
        self.batch_clusters = r.counter(
            "specpride_serve_batch_clusters_total",
            "clusters computed through shared batch dispatches")
        self.batch_jobs_hist = r.histogram(
            "specpride_serve_batch_jobs_per_dispatch",
            "jobs coalesced into each shared dispatch",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32))
        self.batch_window_wait = r.histogram(
            "specpride_serve_batch_window_wait_seconds",
            "batch-collection time per shared dispatch (companion wait "
            "bounded by --batch-window, plus member input parses)",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0))
        self.batch_occupancy = r.gauge(
            "specpride_serve_batch_occupancy",
            "bucket occupancy (real rows / padded rows) of the most recent "
            "shared dispatch")
        self.batch_dispatches.inc(0)
        self.batch_jobs.inc(0)
        self.batch_clusters.inc(0)
        self.batch_occupancy.set(0.0)
        # the autotune controller's knobs, mirrored from every journaled
        # ``autotune`` event
        self.autotune_knob = r.gauge(
            "specpride_autotune_knob",
            "current value of each controller-managed knob",
            labels=("knob",))
        self.autotune_decisions = r.counter(
            "specpride_autotune_decisions_total",
            "autotune decisions journaled, by knob and whether the "
            "controller acted (mode on) or only observed",
            labels=("knob", "acted"))
        for knob in AUTOTUNE_KNOBS:
            self.autotune_knob.set(0.0, knob=knob)
            self.autotune_decisions.inc(0, knob=knob, acted="true")
            self.autotune_decisions.inc(0, knob=knob, acted="false")
        # the flight recorder's incidents and dedup suppressions, one
        # series per detector of the catalog from the first scrape
        self.incidents = r.counter(
            "specpride_incidents_total",
            "flight-recorder incidents journaled, by detector",
            labels=("detector",))
        self.incidents_suppressed = r.counter(
            "specpride_incidents_suppressed_total",
            "detector firings suppressed by the flight recorder's "
            "per-detector dedup cooldown, by detector",
            labels=("detector",))
        for det in DETECTOR_NAMES:
            self.incidents.inc(0, detector=det)
            self.incidents_suppressed.inc(0, detector=det)
        # the lanes' transfer totals, mirrored by delta at scrape time
        r.counter(
            "specpride_h2d_bytes_total",
            "bytes shipped host->device across all worker lanes",
        ).inc(0)
        r.counter(
            "specpride_d2h_bytes_total",
            "bytes fetched device->host across all worker lanes",
        ).inc(0)
        for name, _, help_ in _RESULT_CACHE_SERIES:
            r.counter(name, help_).inc(0)

    # -- event hooks (worker and reader threads) -------------------------

    def job_rejected(self, reason: str) -> None:
        self.jobs_rejected.inc(1, reason=reason)

    def autotune_decision(self, *, knob: str, value, acted: bool) -> None:
        """Mirror one journaled ``autotune`` event: the knob gauge holds
        the value in effect after the decision (the old value when the
        controller only observed)."""
        if isinstance(value, (int, float)):
            self.autotune_knob.set(float(value), knob=knob)
        self.autotune_decisions.inc(
            1, knob=knob, acted="true" if acted else "false")

    def incident(self, *, detector: str, suppressed: int = 0) -> None:
        """Mirror one journaled ``incident`` event; its ``suppressed``
        count (the firings the cooldown swallowed since the last one)
        lands with it, as in the event."""
        self.incidents.inc(1, detector=detector)
        if suppressed:
            self.incidents_suppressed.inc(int(suppressed),
                                          detector=detector)

    def batch_dispatch(self, *, n_jobs: int, n_clusters: int,
                       window_wait_s: float,
                       occupancy_frac: float) -> None:
        """Fold one shared pass in (the journal's ``batch_dispatch``
        event carries the same numbers)."""
        self.batch_dispatches.inc(1)
        self.batch_jobs.inc(int(n_jobs))
        self.batch_clusters.inc(int(n_clusters))
        self.batch_jobs_hist.observe(float(n_jobs))
        self.batch_window_wait.observe(float(window_wait_s))
        self.batch_occupancy.set(float(occupancy_frac))

    def job_done(self, *, command: str, method: str | None, status: str,
                 wall_s: float, queue_wait_s: float,
                 summary: dict | None = None, worker: int | None = None,
                 trace_id: str | None = None) -> dict:
        """Fold one finished job in; returns the SLO fields for the
        daemon's ``job_done`` event (empty when no objective covers the
        method).  ``trace_id`` rides the latency histograms as an
        exemplar."""
        m = method or "-"
        exemplar = {"trace_id": trace_id} if trace_id else None
        if status == "done":
            self.jobs_done.inc(1, command=command, method=m)
        else:
            self.jobs_failed.inc(1, command=command, method=m)
        self.job_wall.observe(wall_s, exemplar=exemplar, method=m)
        self.job_queue_wait.observe(queue_wait_s, exemplar=exemplar,
                                    method=m)
        if worker is not None:
            self.worker_busy.inc(max(float(wall_s), 0.0),
                                 worker=str(worker))
        self._fold_lanes(summary or {})
        objective = slo_objective(self.slo, method)
        if objective is None:
            return {}
        latency = wall_s + queue_wait_s
        ok = latency <= objective
        self.slo_jobs.inc(1, method=m)
        if not ok:
            self.slo_breaches.inc(1, method=m)
        return {"slo_objective_s": objective,
                "slo_latency_s": round(latency, 4), "slo_ok": ok}

    def _fold_lanes(self, summary: dict) -> None:
        """Per-lane busy seconds of one job's summary: the executor's
        ``pipeline`` busy seconds when it pipelined, the phase timers
        otherwise; the dispatch lane is the ``compute`` phase."""
        phases = summary.get("phases_s") or {}
        pipeline = summary.get("pipeline") or {}
        pack = (sum(pipeline["pack_busy_s"]) if pipeline.get("pack_busy_s")
                else phases.get("pack", 0.0))
        write = (pipeline["write_busy_s"] if pipeline.get("async_write")
                 else phases.get("write", 0.0))
        for lane, busy in (("pack", pack),
                           ("dispatch", phases.get("compute", 0.0)),
                           ("write", write)):
            if busy and busy > 0:
                self.lane_busy.inc(float(busy), lane=lane)

    # -- scrape-time state ------------------------------------------------

    def sync_totals(self) -> None:
        """Mirror the process-wide totals into counters by delta since the
        last scrape (a counter is never set): the ingest cache's, the
        result cache's, and the lanes' H2D and D2H bytes."""
        from specpride_tpu_torch.cache import result_cache
        from specpride_tpu_torch.serve import ingest_cache

        ic = ingest_cache.info()
        rc = result_cache.totals()
        totals = {
            "specpride_serve_ingest_cache_hits_total": (
                ic["hits"], "served jobs whose parsed input was resident "
                "(parse skipped)"),
            "specpride_serve_ingest_cache_misses_total": (
                ic["misses"], "served eager parses that populated the "
                "ingest cache"),
        }
        for name, key, help_ in _RESULT_CACHE_SERIES:
            totals[name] = (rc[key], help_)
        byte_srcs = [*self.extra_registries,
                     *self.worker_registries.values()]
        totals["specpride_h2d_bytes_total"] = (
            sum(r.sum_counter("specpride_bytes_h2d_total")
                for r in byte_srcs),
            "bytes shipped host->device across all worker lanes")
        totals["specpride_d2h_bytes_total"] = (
            sum(r.sum_counter("specpride_bytes_d2h_total")
                for r in byte_srcs),
            "bytes fetched device->host across all worker lanes")
        with self._lock:
            for name, (total, help_) in totals.items():
                last = self._totals_last.get(name, 0.0)
                if total > last:
                    self.registry.counter(name, help_).inc(total - last)
                self._totals_last[name] = max(float(total), last)

    def exposition(self) -> str:
        """The full Prometheus text exposition, sampled now."""
        with self._render_lock:
            if self.sampler is not None:
                self.sampler(self)
            self.sync_totals()
            parts = [self.registry.to_prometheus_text()]
            parts.extend(r.to_prometheus_text()
                         for r in self.extra_registries)
            if self.worker_registries:
                parts.append(render_labeled(self.worker_registries,
                                            label="worker"))
            return "".join(parts)

    def write_textfile(self, path: str) -> None:
        """Atomic snapshot of the exposition: the daemon's ``--metrics-out``
        at drain."""
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(self.exposition())
        os.replace(tmp, path)


# -- the HTTP endpoint --------------------------------------------------


class MetricsExporter:
    """Background ``/metrics`` HTTP endpoint over a render callback.

    Binds ``host:port`` (port 0 = ephemeral; read the bound port back
    from ``.port``), serves ``GET /metrics`` with the Prometheus text
    content type and ``GET /healthz`` with a one-line readiness body, on
    a daemon thread pool (``ThreadingHTTPServer``) so a slow scraper
    never blocks the next one.  Loopback by default: the telemetry
    plane is an OPERATOR surface, exposing it beyond the host is an
    explicit ``--metrics-host`` decision.

    ``health`` (optional): a callback returning ``(ok, detail)`` —
    ``/healthz`` answers ``200 ok <detail>`` or ``503 degraded
    <detail>``, so a fleet supervisor or load balancer gets a REAL
    per-lane readiness signal (the serving daemon wires its watchdog's
    stalled-lane view in; without a callback the endpoint stays the
    old unconditional liveness 200)."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, render, host: str = "127.0.0.1", port: int = 0,
                 health=None):
        self._render = render
        self._health = health
        self.host = host
        self._requested_port = port
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self._requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsExporter":
        render = self._render
        health = self._health
        content_type = self.CONTENT_TYPE

        class _Handler(http.server.BaseHTTPRequestHandler):
            # the exporter must never spam the daemon's stderr per scrape
            def log_message(self, fmt, *args):  # noqa: A002 - stdlib sig
                pass

            def _reply(self, body: bytes, ctype: str,
                       code: int = 200) -> None:
                # a scraper with a short timeout may drop the connection
                # mid-body: that's its problem, not a stderr traceback
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass

            def do_GET(self):  # noqa: N802 - stdlib naming
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    try:
                        body = render().encode("utf-8")
                    except Exception as e:  # noqa: BLE001 - 500, not a crash
                        logger.warning("metrics render failed: %s", e)
                        self.send_error(500, f"render failed: {e}")
                        return
                    self._reply(body, content_type)
                elif path == "/healthz":
                    if health is None:
                        self._reply(b"ok\n", "text/plain")
                        return
                    try:
                        ok, detail = health()
                    except Exception as e:  # noqa: BLE001 - report, not crash
                        ok, detail = False, f"health probe failed: {e}"
                    body = (
                        ("ok" if ok else "degraded")
                        + (f" {detail}" if detail else "") + "\n"
                    ).encode("utf-8")
                    # 503 on degraded: the readiness semantics load
                    # balancers and fleet supervisors key off
                    self._reply(
                        body, "text/plain", code=200 if ok else 503
                    )
                else:
                    self.send_error(404, "only /metrics and /healthz")

        class _Server(http.server.ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # socketserver prints a full traceback here by default —
                # an aborted scrape (BrokenPipeError past the handler's
                # own guard) must stay silent on the daemon's stderr
                pass

        self._httpd = _Server((self.host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="specpride-metrics-exporter", daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._httpd = None
        self._thread = None


# -- an elastic rank's liveness -----------------------------------------------


class ElasticTelemetry:
    """An elastic rank's live view (``--elastic`` with ``--metrics-port``),
    sampled from the coordinator's store at each scrape, in the JAX
    package's families: each rank's heartbeat age (a dying rank's climbs
    past the lease TTL before any work is lost), the plan's ranges and
    those committed, this rank's id, and the expiries, reassignments,
    splits and steals this rank made.  ``extra_registries`` ride along
    (the CLI passes the backend's, so the rank's device series are
    scrapeable too)."""

    def __init__(self, coordinator, extra_registries: tuple = ()):
        self.coord = coordinator
        self.extra_registries = tuple(extra_registries)
        self._render_lock = threading.Lock()
        self._counters_last = {"expires": 0.0, "reassigns": 0.0,
                               "splits": 0.0, "steals": 0.0}
        r = self.registry = MetricsRegistry()
        self.hb_age = r.gauge(
            "specpride_rank_heartbeat_age_seconds",
            "seconds since each rank's last heartbeat (sampled from the "
            "coordinator store at scrape time; past the lease TTL the rank "
            "is presumed dead)", labels=("rank",))
        self.ranges_total = r.gauge("specpride_elastic_ranges",
                                    "chunk ranges in this run's work plan")
        self.ranges_committed = r.gauge(
            "specpride_elastic_ranges_committed",
            "chunk ranges with a commit marker (the run is complete at "
            "committed == total)")
        self.rank_gauge = r.gauge(
            "specpride_elastic_rank",
            "this process's rank id (constant; a join key for alerts)")
        self.lease_expires = r.counter(
            "specpride_elastic_lease_expires_total",
            "expired peer leases this rank observed")
        self.reassigns = r.counter(
            "specpride_elastic_reassignments_total",
            "dead ranks' chunk ranges this rank took over")
        self.splits = r.counter(
            "specpride_elastic_lease_splits_total",
            "work-stealing splits this rank ratified as the donor")
        self.steals = r.counter(
            "specpride_elastic_steals_total",
            "split-off tails this rank claimed from slower peers")

    def health(self) -> tuple[bool, str]:
        """``/healthz``: degraded while a peer's heartbeat is stale past
        TTL + grace with ranges left uncommitted; a peer that stopped
        cleanly (its final ``stopped`` heartbeat) is not stale."""
        coord = self.coord
        threshold = coord.ttl + coord.grace
        stale = sorted(r for r, (age, stopped)
                       in coord.rank_heartbeat_states().items()
                       if age > threshold and not stopped)
        done, total = coord.done_count(), len(coord.ranges)
        bits = f"rank={coord.rank} ranges_committed={done}/{total}"
        if stale and done < total:
            return False, ("stale_ranks=" + ",".join(map(str, stale))
                           + " " + bits)
        return True, bits

    def exposition(self) -> str:
        with self._render_lock:
            coord = self.coord
            # clear-and-set: a departed rank's series goes away instead of
            # lingering at its last age
            self.hb_age.clear()
            for rank, age in coord.rank_heartbeat_ages().items():
                self.hb_age.set(round(age, 3), rank=str(rank))
            self.ranges_total.set(len(coord.ranges))
            self.ranges_committed.set(coord.done_count())
            self.rank_gauge.set(coord.rank)
            for counter, attr, key in (
                    (self.lease_expires, "lease_expires_observed",
                     "expires"),
                    (self.reassigns, "reassignments", "reassigns"),
                    (self.splits, "lease_splits", "splits"),
                    (self.steals, "steals", "steals")):
                total = float(getattr(coord, attr, 0))
                last = self._counters_last[key]
                # inc(0) too: every counter exists from the first scrape
                counter.inc(max(total - last, 0.0))
                self._counters_last[key] = max(total, last)
            return "".join([self.registry.to_prometheus_text()]
                           + [x.to_prometheus_text()
                              for x in self.extra_registries])


# -- strict text-format checker (tests + CI) ----------------------------

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>\S+)(?: (?P<ts>-?\d+))?$"
)
_LABEL_RE = re.compile(
    r'(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"'
)
# OpenMetrics exemplar (after the ` # ` split): {labels} value [ts]
_EXEMPLAR_RE = re.compile(
    r"^\{(?P<labels>.*)\} (?P<value>\S+)(?: (?P<ts>-?[\d.]+))?$"
)
_TYPES = frozenset({"counter", "gauge", "histogram", "summary", "untyped"})


def _split_exemplar(line: str) -> tuple[str, str | None]:
    """Split a sample line at its OpenMetrics exemplar marker (`` # ``)
    — but only OUTSIDE quoted label values: a client id like
    ``team # 1`` is a legal label value and must stay part of the
    sample (label values are user-controlled; a naive split would
    reject previously-valid exposition)."""
    in_quotes = False
    i = 0
    n = len(line)
    while i < n:
        c = line[i]
        if in_quotes:
            if c == "\\":
                i += 1  # skip the escaped char
            elif c == '"':
                in_quotes = False
        elif c == '"':
            in_quotes = True
        elif c == " " and line[i:i + 3] == " # ":
            return line[:i], line[i + 3:]
        i += 1
    return line, None


def _parse_value(tok: str) -> float | None:
    if tok in ("+Inf", "Inf"):
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    try:
        return float(tok)
    except ValueError:
        return None


def _parse_labels(raw: str, problems: list, lineno: int) -> tuple | None:
    """``a="x",b="y"`` -> sorted ((name, value), ...) or None on error."""
    out = []
    pos = 0
    raw = raw.strip()
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            problems.append(f"line {lineno}: malformed label at {raw[pos:]!r}")
            return None
        out.append((m.group("name"), m.group("value")))
        pos = m.end()
        if pos < len(raw):
            if raw[pos] != ",":
                problems.append(
                    f"line {lineno}: expected ',' between labels"
                )
                return None
            pos += 1
    names = [n for n, _ in out]
    if len(names) != len(set(names)):
        problems.append(f"line {lineno}: duplicate label name")
        return None
    return tuple(sorted(out))


def parse_exposition(text: str) -> tuple[dict, list[str]]:
    """Strictly parse a Prometheus text exposition (see
    :func:`parse_exposition_full`; this keeps the original two-value
    signature for callers that don't read exemplars)."""
    samples, _exemplars, problems = parse_exposition_full(text)
    return samples, problems


def parse_exposition_full(
    text: str,
) -> tuple[dict, dict, list[str]]:
    """Strictly parse a Prometheus text exposition.

    Returns ``(samples, exemplars, problems)`` — ``samples`` maps
    ``(metric_name, ((label, value), ...))`` to the float value;
    ``exemplars`` maps the same keys to ``{label: value}`` dicts for
    every ``_bucket`` line carrying an OpenMetrics exemplar suffix
    (`` # {trace_id="..."} <value>``).  ``problems`` is empty for a
    conforming exposition; the checks cover what a real scraper
    enforces plus the histogram invariants: TYPE before (and at most
    once per) metric, valid metric/label names, parseable values, no
    duplicate series, cumulative non-decreasing ``_bucket`` counts with
    a ``+Inf`` bucket equal to ``_count``, exemplars only on bucket
    lines with well-formed labels and values, and a trailing newline."""
    problems: list[str] = []
    samples: dict[tuple, float] = {}
    exemplars: dict[tuple, dict] = {}
    typed: dict[str, str] = {}
    seen_sample_of: set[str] = set()
    if text and not text.endswith("\n"):
        problems.append("exposition does not end with a newline")
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] in ("HELP", "TYPE"):
                if len(parts) < 3 or not _NAME_RE.fullmatch(parts[2]):
                    problems.append(
                        f"line {lineno}: malformed {parts[1]} comment"
                    )
                    continue
                if parts[1] == "TYPE":
                    name = parts[2]
                    mtype = parts[3].strip() if len(parts) > 3 else ""
                    if mtype not in _TYPES:
                        problems.append(
                            f"line {lineno}: unknown TYPE {mtype!r}"
                        )
                    if name in typed:
                        problems.append(
                            f"line {lineno}: duplicate TYPE for {name}"
                        )
                    if name in seen_sample_of:
                        problems.append(
                            f"line {lineno}: TYPE for {name} after its "
                            "samples"
                        )
                    typed[name] = mtype
            # other comments are allowed and ignored
            continue
        # OpenMetrics exemplar suffix: split it off before the sample
        # grammar match, validate it separately (bucket lines only)
        sample_part, exemplar_raw = _split_exemplar(line)
        m = _SAMPLE_RE.match(sample_part)
        if m is None:
            problems.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name = m.group("name")
        value = _parse_value(m.group("value"))
        if value is None:
            problems.append(
                f"line {lineno}: bad value {m.group('value')!r}"
            )
            continue
        labels = _parse_labels(m.group("labels") or "", problems, lineno)
        if labels is None:
            continue
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        seen_sample_of.add(name)
        seen_sample_of.add(base)
        key = (name, labels)
        if key in samples:
            problems.append(f"line {lineno}: duplicate series {key}")
        samples[key] = value
        if exemplar_raw is not None:
            if not name.endswith("_bucket"):
                problems.append(
                    f"line {lineno}: exemplar on a non-bucket sample "
                    f"{name}"
                )
                continue
            em = _EXEMPLAR_RE.fullmatch(exemplar_raw.strip())
            if em is None:
                problems.append(
                    f"line {lineno}: malformed exemplar "
                    f"{exemplar_raw!r}"
                )
                continue
            ex_labels = _parse_labels(
                em.group("labels") or "", problems, lineno
            )
            if ex_labels is None:
                continue
            if _parse_value(em.group("value")) is None:
                problems.append(
                    f"line {lineno}: bad exemplar value "
                    f"{em.group('value')!r}"
                )
                continue
            exemplars[key] = dict(ex_labels)
    # histogram invariants per (base name, non-le label set)
    for name, mtype in typed.items():
        if mtype != "histogram":
            continue
        series: dict[tuple, list] = {}
        counts: dict[tuple, float] = {}
        for (sname, labels), value in samples.items():
            rest = tuple(kv for kv in labels if kv[0] != "le")
            if sname == f"{name}_bucket":
                le = dict(labels).get("le")
                if le is None:
                    problems.append(f"{name}_bucket missing le label")
                    continue
                series.setdefault(rest, []).append(
                    (_parse_value(le), value)
                )
            elif sname == f"{name}_count":
                counts[labels] = value
        for rest, buckets in series.items():
            buckets.sort(key=lambda b: b[0])
            cum = [v for _, v in buckets]
            if any(b > a for a, b in zip(cum[1:], cum)):
                problems.append(
                    f"{name}{dict(rest)}: bucket counts not cumulative"
                )
            if not buckets or buckets[-1][0] != float("inf"):
                problems.append(f"{name}{dict(rest)}: no +Inf bucket")
            elif counts.get(rest) is not None and (
                buckets[-1][1] != counts[rest]
            ):
                problems.append(
                    f"{name}{dict(rest)}: +Inf bucket != _count"
                )
            if rest not in counts:
                problems.append(f"{name}{dict(rest)}: missing _count")
    return samples, exemplars, problems


def validate_exposition(text: str) -> list[str]:
    """Problems list (empty = conforming); see :func:`parse_exposition`."""
    return parse_exposition(text)[1]
