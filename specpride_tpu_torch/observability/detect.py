"""Health detectors: fold the journal stream into incident firings (the
port's copy of the JAX package's ``observability/detect.py``; the same
firings on the same stream, so either package's ``incident-replay``
accepts the other's journals).

The flight recorder (``flightrec.py``) taps its host's journal and
feeds every record through a :class:`DetectorSet`.  Each detector is a
pure, replayable function of the event stream: no wall-clock reads, no
randomness, no state outside the records, so ``incident-replay`` can
refold a finished journal through the same code and re-derive every
firing (and every dedup suppression) bit-exact.  Every float that lands
in an evidence payload goes through the 6-decimal rounding rule so live
and replayed incidents compare equal through a JSON round-trip.

Detector catalog (all fed by events the system already emits):

==================  ===================================================
detector            fires when
==================  ===================================================
``slo_breach``      ``streak`` consecutive ``job_done`` events broke
                    their latency objective (``slo_ok: false``)
``latency_spike``   a ``job_done`` wall exceeds ``factor`` x the
                    windowed EWMA of recent walls (after ``min_jobs``
                    observations seeded the estimate)
``queue_sat``       live queue depth (queued-not-started fold) reaches
                    ``frac`` of the admission bound announced by
                    ``serve_start``
``watchdog``        a ``watchdog_stall`` event lands (a lane exceeded
                    its armed timeout)
``retry_exhaust``   a ``retry`` event's attempt count reaches
                    ``attempts`` at one site (the backoff ladder is
                    nearly spent)
``solo_burst``      ``count`` ``batch_dispatch`` events with
                    ``status: fallback_solo`` inside ``window_s`` (the
                    shared dispatch path is failing repeatedly)
``lease_churn``     ``count`` lease lifecycle events (``lease_expire``
                    / ``chunk_reassign`` / ``lease_split``) inside
                    ``window_s`` (ranks dying or thrashing work)
==================  ===================================================

Dedup: one cooldown window per detector, keyed on the TRIGGERING
record's ``mono`` (never the wall clock), so a flapping detector
journals one incident per window with a ``suppressed`` count instead
of bundle-storming — and the suppression decisions replay exactly.
"""

from __future__ import annotations

import collections
import hashlib

# one deterministic parameter set for every construction site (live
# recorder and offline replay build detectors from the same table, so
# they cannot disagree); hosts override per-key via `params`
DEFAULT_PARAMS: dict[str, dict] = {
    "slo_breach": {"streak": 3},
    "latency_spike": {"factor": 4.0, "min_jobs": 8, "alpha": 0.2},
    "queue_sat": {"frac": 0.9},
    "watchdog": {},
    "retry_exhaust": {"attempts": 3},
    "solo_burst": {"count": 3, "window_s": 60.0},
    "lease_churn": {"count": 6, "window_s": 60.0},
    "cooldown_s": 30.0,
}


def _r(x) -> float:
    """The snapshot rounding rule (the JAX package's): six
    decimals survives a JSON round-trip exactly, so live and replayed
    evidence payloads compare equal."""
    return round(float(x), 6)


def incident_id(detector: str, clock: float) -> str:
    """Content-derived incident identity: any process refolding the
    same stream mints the same id (the replay bit-parity contract),
    and the id doubles as the bundle directory's name component."""
    key = f"{detector}:{_r(clock):.6f}"
    return hashlib.sha256(key.encode("utf-8")).hexdigest()[:16]


def derived_trace_id(detector: str, clock: float) -> str:
    """A 32-hex trace id for an incident whose evidence carried none —
    content-derived so replay reproduces it, and syntactically exactly
    what the v4 trace envelope requires."""
    key = f"incident:{detector}:{_r(clock):.6f}"
    return hashlib.sha256(key.encode("utf-8")).hexdigest()[:32]


class _Detector:
    """One pure stream fold.  ``observe(rec, mono)`` mutates state
    deterministically and returns ``(reason, evidence)`` on a firing,
    else None."""

    name = "?"

    def __init__(self, params: dict):
        self.params = params

    def observe(self, rec: dict, mono: float):
        raise NotImplementedError


class SloBreachDetector(_Detector):
    name = "slo_breach"

    def __init__(self, params: dict):
        super().__init__(params)
        self.streak = 0

    def observe(self, rec, mono):
        if rec.get("event") != "job_done":
            return None
        ok = rec.get("slo_ok")
        if ok is True:
            self.streak = 0
            return None
        if ok is not False:
            return None  # no objective covered this job
        self.streak += 1
        need = int(self.params["streak"])
        if self.streak < need:
            return None
        reason = (
            f"{self.streak} consecutive SLO breaches "
            f"(threshold {need})"
        )
        evidence = {
            "streak": self.streak,
            "job_id": rec.get("job_id"),
            "slo_latency_s": _r(rec.get("slo_latency_s") or 0.0),
            "slo_objective_s": _r(rec.get("slo_objective_s") or 0.0),
        }
        return reason, evidence


class LatencySpikeDetector(_Detector):
    name = "latency_spike"

    def __init__(self, params: dict):
        super().__init__(params)
        self.ewma: float | None = None
        self.n = 0

    def observe(self, rec, mono):
        if rec.get("event") != "job_done":
            return None
        wall = rec.get("wall_s")
        if not isinstance(wall, (int, float)):
            return None
        wall = float(wall)
        prev, n = self.ewma, self.n
        alpha = float(self.params["alpha"])
        # fold FIRST (a spike still updates the estimate — one outlier
        # must not keep the baseline stale forever), fire on the
        # estimate as it stood BEFORE this job
        self.ewma = wall if prev is None else (
            prev + alpha * (wall - prev)
        )
        self.n = n + 1
        if prev is None or n < int(self.params["min_jobs"]):
            return None
        factor = float(self.params["factor"])
        if prev <= 0 or wall <= factor * prev:
            return None
        reason = (
            f"job wall {_r(wall)}s is {_r(wall / prev)}x the EWMA "
            f"{_r(prev)}s (threshold {factor}x)"
        )
        evidence = {
            "wall_s": _r(wall),
            "ewma_s": _r(prev),
            "ratio": _r(wall / prev),
            "jobs_seen": n,
            "job_id": rec.get("job_id"),
        }
        return reason, evidence


class QueueSaturationDetector(_Detector):
    name = "queue_sat"

    def __init__(self, params: dict):
        super().__init__(params)
        self.queued = 0
        self.capacity: int | None = None

    def observe(self, rec, mono):
        event = rec.get("event")
        if event == "serve_start":
            cap = rec.get("max_queue")
            if isinstance(cap, int) and cap > 0:
                self.capacity = cap
            return None
        if event == "job_start":
            if self.queued > 0:
                self.queued -= 1
            return None
        if event != "job_queued":
            return None
        self.queued += 1
        if self.capacity is None:
            return None
        frac = float(self.params["frac"])
        if self.queued < frac * self.capacity:
            return None
        reason = (
            f"queue depth {self.queued}/{self.capacity} reached "
            f"{int(frac * 100)}% of the admission bound"
        )
        evidence = {
            "queue_depth": self.queued,
            "max_queue": self.capacity,
            "frac": _r(self.queued / self.capacity),
        }
        return reason, evidence


class WatchdogDetector(_Detector):
    name = "watchdog"

    def observe(self, rec, mono):
        if rec.get("event") != "watchdog_stall":
            return None
        lane = rec.get("lane")
        elapsed = rec.get("elapsed_s")
        reason = f"lane {lane!r} stalled {elapsed}s past its watchdog"
        evidence = {
            "lane": lane,
            "elapsed_s": _r(elapsed or 0.0),
            "timeout_s": _r(rec.get("timeout_s") or 0.0),
        }
        return reason, evidence


class RetryExhaustionDetector(_Detector):
    name = "retry_exhaust"

    def observe(self, rec, mono):
        if rec.get("event") != "retry":
            return None
        attempt = rec.get("attempt")
        if not isinstance(attempt, int):
            return None
        need = int(self.params["attempts"])
        # `attempt` is 0-based: attempt N means N+1 tries are burnt
        if attempt + 1 < need:
            return None
        site = rec.get("site")
        reason = (
            f"retry attempt {attempt + 1} at site {site!r} "
            f"(exhaustion threshold {need})"
        )
        evidence = {
            "site": site,
            "attempt": attempt,
            "backoff_s": _r(rec.get("backoff_s") or 0.0),
        }
        return reason, evidence


class _WindowedBurstDetector(_Detector):
    """Shared shape for count-inside-window detectors: a deque of
    trigger monos, cut at the window bound on every observation."""

    events: frozenset = frozenset()

    def __init__(self, params: dict):
        super().__init__(params)
        self._hits: collections.deque = collections.deque()

    def _match(self, rec) -> bool:
        return rec.get("event") in self.events

    def _fire(self, rec, n: int):
        raise NotImplementedError

    def observe(self, rec, mono):
        if not self._match(rec):
            return None
        window = float(self.params["window_s"])
        self._hits.append(mono)
        cut = mono - window
        while self._hits and self._hits[0] < cut:
            self._hits.popleft()
        n = len(self._hits)
        if n < int(self.params["count"]):
            return None
        return self._fire(rec, n)


class FallbackSoloBurstDetector(_WindowedBurstDetector):
    name = "solo_burst"
    events = frozenset({"batch_dispatch"})

    def _match(self, rec) -> bool:
        return (
            rec.get("event") == "batch_dispatch"
            and rec.get("status") == "fallback_solo"
        )

    def _fire(self, rec, n):
        window = float(self.params["window_s"])
        reason = (
            f"{n} fallback_solo batch dispatches inside {window:g}s "
            "(shared dispatch path failing repeatedly)"
        )
        evidence = {
            "fallbacks": n,
            "window_s": _r(window),
            "batch_id": rec.get("batch_id"),
            "error": rec.get("error"),
        }
        return reason, evidence


class LeaseChurnDetector(_WindowedBurstDetector):
    name = "lease_churn"
    events = frozenset({"lease_expire", "chunk_reassign", "lease_split"})

    def _fire(self, rec, n):
        window = float(self.params["window_s"])
        reason = (
            f"{n} lease lifecycle events (expire/reassign/split) "
            f"inside {window:g}s — ranks dying or thrashing work"
        )
        evidence = {
            "churn": n,
            "window_s": _r(window),
            "last_event": rec.get("event"),
            "rank": rec.get("rank"),
            "range": rec.get("range"),
        }
        return reason, evidence


DETECTORS: tuple = (
    SloBreachDetector,
    LatencySpikeDetector,
    QueueSaturationDetector,
    WatchdogDetector,
    RetryExhaustionDetector,
    FallbackSoloBurstDetector,
    LeaseChurnDetector,
)

# the stable detector-name order metric pre-registration and the docs
# catalog key off (derived, never hand-maintained)
DETECTOR_NAMES: tuple = tuple(d.name for d in DETECTORS)


class DetectorSet:
    """Every detector plus the per-detector dedup fold, over one
    process's journal stream.

    Not internally locked: the journal tap calls :meth:`observe` under
    the journal's write lock (replay is single-threaded).

    ``observe`` returns the list of POST-DEDUP incident payloads this
    record triggered (usually empty) — each a dict ready to journal as
    an ``incident`` event modulo the host-owned fields (``mode``,
    ``bundled``, ``bundle_dir``).  Suppressed firings only bump the
    per-detector counter; the count rides the NEXT journaled incident
    as its ``suppressed`` field, so a flapping window is still fully
    accounted for in the stream."""

    def __init__(self, params: dict | None = None):
        merged = {
            k: dict(v) if isinstance(v, dict) else v
            for k, v in DEFAULT_PARAMS.items()
        }
        for key, val in (params or {}).items():
            if isinstance(val, dict) and isinstance(merged.get(key), dict):
                merged[key].update(val)
            else:
                merged[key] = val
        self.params = merged
        self.cooldown_s = float(merged["cooldown_s"])
        self.detectors = [cls(merged[cls.name]) for cls in DETECTORS]
        # detector -> trigger clock of the last JOURNALED incident
        self._last_fire: dict[str, float] = {}
        # detector -> firings swallowed since that incident
        self._suppressed: dict[str, int] = {}
        self.fired = 0
        self.suppressed = 0

    def observe(self, rec) -> list[dict]:
        """Fold one journal record; returns the incidents to journal.
        ``incident`` events themselves are ignored — the recorder's own
        output must never feed back into the detectors."""
        if not isinstance(rec, dict) or rec.get("event") == "incident":
            return []
        mono = rec.get("mono")
        if not isinstance(mono, (int, float)):
            return []
        out: list[dict] = []
        for det in self.detectors:
            try:
                got = det.observe(rec, float(mono))
            except Exception:  # noqa: BLE001 - a detector bug must not
                continue       # take the stream fold down
            if got is None:
                continue
            reason, evidence = got
            clock = _r(mono)
            last = self._last_fire.get(det.name)
            if last is not None and clock - last < self.cooldown_s:
                # dedup window: swallow, account, move on — keyed on
                # the trigger clock so replay reproduces the decision
                self._suppressed[det.name] = (
                    self._suppressed.get(det.name, 0) + 1
                )
                self.suppressed += 1
                continue
            self._last_fire[det.name] = clock
            self.fired += 1
            tid = rec.get("trace_id") or derived_trace_id(
                det.name, clock
            )
            out.append({
                "detector": det.name,
                "incident_id": incident_id(det.name, clock),
                "reason": reason,
                "clock": clock,
                "evidence": evidence,
                "trace_id": tid,
                "suppressed": self._suppressed.pop(det.name, 0),
            })
        return out

    def status(self) -> dict:
        """Live counters for ``serve status`` / the recorder."""
        return {
            "fired": self.fired,
            "suppressed": self.suppressed,
            "detectors": list(DETECTOR_NAMES),
            "cooldown_s": self.cooldown_s,
        }
