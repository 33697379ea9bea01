"""Policy modules: pure functions from a signal snapshot to a proposed
knob value (the JAX package's ``autotune/policy.py``; the same params,
thresholds and reason strings, so either package replays the other's
decisions).

Every policy is a small object with a ``knob`` name, a ``params`` dict
(clamps, thresholds, hysteresis — recorded verbatim on each ``autotune``
event, so replay can rebuild the policy without the original CLI
flags), and one method::

    decide(signal, current) -> (new_value, reason) | None

``decide`` must be PURE over ``(signal, current, params)``: no clocks,
no randomness, no hidden state.  Hysteresis lives in the shared gating
(:func:`specpride_tpu_torch.autotune.controller.evaluate`): a per-knob
``cooldown_s`` measured against the snapshot clock of the last
journaled decision, and a relative ``deadband`` below which a proposed
change is dropped — both derivable from the recorded decisions alone,
which is what keeps ``autotune-replay`` exact.
"""

from __future__ import annotations

MODES = ("off", "observe", "on")


def parse_clamp(spec: str, what: str = "clamp") -> tuple[float, float]:
    """``LO:HI`` -> ``(lo, hi)`` with ``0 <= lo <= hi``.  ``ValueError``
    on anything else — the CLI turns it into a usage error at boot,
    never mid-serve (same convention as ``--slo``/``--quota``)."""
    lo_s, sep, hi_s = spec.partition(":")
    if not sep:
        raise ValueError(f"{what} {spec!r} is not LO:HI")
    try:
        lo, hi = float(lo_s), float(hi_s)
    except ValueError:
        raise ValueError(
            f"{what} {spec!r}: bounds must be numbers"
        ) from None
    if not (0 <= lo <= hi):
        raise ValueError(f"{what} {spec!r}: need 0 <= LO <= HI")
    return lo, hi


class BatchWindowPolicy:
    """``--batch-window`` (ms) from queue depth + coalescing yield.

    Widen (double, from the clamp floor when off) while admitted jobs
    are stacking up — a deep queue is exactly the regime where a longer
    collection window converts queue wait into shared dispatches.
    Shrink (halve toward the floor) when the queue is idle and recent
    dispatches ran solo anyway: then the window is pure added latency
    on every lone job."""

    knob = "batch_window_ms"

    def __init__(self, lo_ms: float = 0.0, hi_ms: float = 50.0,
                 queue_hi: int = 3, cooldown_s: float = 2.0,
                 deadband: float = 0.2):
        self.params = {
            "lo_ms": float(lo_ms), "hi_ms": float(hi_ms),
            "queue_hi": int(queue_hi), "cooldown_s": float(cooldown_s),
            "deadband": float(deadband),
        }

    def decide(self, signal: dict, current):
        p = self.params
        lo, hi = p["lo_ms"], p["hi_ms"]
        depth = int(signal.get("queue_depth") or 0)
        if depth >= p["queue_hi"] and current < hi:
            # a 0 floor would make "widen from the floor" a no-op at
            # window 0 forever: seed the first widen at 1ms instead
            seed = lo if lo > 0 else min(hi, 1.0)
            new = min(hi, max(lo, current * 2.0 if current > 0 else seed))
            if new <= current:
                return None
            return round(new, 3), (
                f"queue depth {depth} >= {p['queue_hi']}: widen window "
                "to coalesce queued jobs"
            )
        batch = signal.get("batch") or {}
        jobs = signal.get("jobs") or {}
        if (
            depth == 0 and current > lo and jobs.get("n", 0) > 0
            and (not batch or batch.get("jobs_mean", 0.0) <= 1.5)
        ):
            new = max(lo, current / 2.0)
            if new >= current:
                return None
            yld = batch.get("jobs_mean")
            return round(new, 3), (
                "queue idle and window not coalescing "
                f"(jobs/dispatch {yld if yld is not None else 'n/a'}): "
                "shrink window toward floor"
            )
        return None


class WorkerPolicy:
    """Active execution lanes (within the boot-built pool) from SLO
    burn + busy fraction.  Unpark a lane while the SLO burn fraction is
    over threshold; park one when the pool is provably oversized — no
    queue, no burn, and summed busy seconds a small fraction of
    ``lanes * window``."""

    knob = "workers"

    def __init__(self, lo: int = 1, hi: int = 1,
                 burn_hi: float = 0.1, busy_lo: float = 0.25,
                 min_slo_jobs: int = 3, cooldown_s: float = 5.0):
        self.params = {
            "lo": int(lo), "hi": int(hi), "burn_hi": float(burn_hi),
            "busy_lo": float(busy_lo), "min_slo_jobs": int(min_slo_jobs),
            "cooldown_s": float(cooldown_s), "deadband": 0.0,
        }

    def decide(self, signal: dict, current):
        p = self.params
        current = int(current)
        jobs = signal.get("jobs") or {}
        slo_jobs = int(jobs.get("slo_jobs") or 0)
        breaches = int(jobs.get("slo_breaches") or 0)
        burn = breaches / slo_jobs if slo_jobs else 0.0
        if (
            slo_jobs >= p["min_slo_jobs"] and burn >= p["burn_hi"]
            and current < p["hi"]
        ):
            return current + 1, (
                f"SLO burn {breaches}/{slo_jobs} jobs in window: "
                "unpark a lane"
            )
        window = float(signal.get("window_s") or 0.0)
        busy_frac = (
            float(jobs.get("busy_s") or 0.0) / (window * current)
            if window and current else 0.0
        )
        if (
            jobs.get("n", 0) > 0 and breaches == 0
            and int(signal.get("queue_depth") or 0) == 0
            and busy_frac < p["busy_lo"] and current > p["lo"]
        ):
            return current - 1, (
                f"busy fraction {round(busy_frac, 3)} < {p['busy_lo']} "
                "with idle queue and no SLO burn: park a lane"
            )
        return None


class ElasticRangePolicy:
    """``--elastic-range`` from the heartbeat EWMA chunk walls (ROADMAP
    item 4b): size new (split-off) ranges so one range costs about
    ``target_s`` of wall time at the fleet's measured per-cluster rate.
    Already-claimed ranges are never resized — byte parity vs a serial
    run is untouched; actuation only caps how much tail a donor cedes
    on a live steal."""

    knob = "elastic_range"

    def __init__(self, lo: int = 0, hi: int = 0, target_s: float = 30.0,
                 chunk_hint: int = 1, cooldown_s: float = 5.0,
                 deadband: float = 0.25):
        self.params = {
            "lo": int(lo), "hi": int(hi), "target_s": float(target_s),
            "chunk_hint": max(int(chunk_hint), 1),
            "cooldown_s": float(cooldown_s), "deadband": float(deadband),
        }

    def decide(self, signal: dict, current):
        p = self.params
        hb = signal.get("heartbeats") or {}
        mean = hb.get("chunk_s_mean")
        if not mean or mean <= 0:
            return None  # no fresh walls: never move on stale evidence
        chunk = p["chunk_hint"]
        per_cluster = float(mean) / chunk
        desired = p["target_s"] / per_cluster
        aligned = max(int(desired // chunk), 1) * chunk
        new = int(min(p["hi"], max(p["lo"], aligned)))
        if new == int(current):
            return None
        return new, (
            f"EWMA chunk wall {mean}s over {hb.get('ranks')} rank(s) "
            f"(~{round(per_cluster, 6)}s/cluster): size split ranges "
            f"for ~{p['target_s']}s each"
        )


class FleetSparesPolicy:
    """Warm spares from steal pressure.  The supervisor's poll loop
    passes its store-derived view (live split proposals, stale
    heartbeats) as snapshot extras — recorded as evidence like every
    other signal, though not journal-derivable, so replay re-runs the
    policy on the recorded snapshot."""

    knob = "spares"

    def __init__(self, lo: int = 0, hi: int = 0, pressure_hi: int = 1,
                 cooldown_s: float = 10.0):
        self.params = {
            "lo": int(lo), "hi": int(hi),
            "pressure_hi": int(pressure_hi),
            "cooldown_s": float(cooldown_s), "deadband": 0.0,
        }

    def decide(self, signal: dict, current):
        p = self.params
        current = int(current)
        store = signal.get("store") or {}
        proposals = int(store.get("steal_proposals") or 0)
        stale = int(store.get("stale_ranks") or 0)
        if (
            (proposals >= p["pressure_hi"] or stale > 0)
            and current < p["hi"]
        ):
            return current + 1, (
                f"steal pressure (proposals={proposals}, "
                f"stale_ranks={stale}): add a warm spare"
            )
        if proposals == 0 and stale == 0 and current > p["lo"]:
            return current - 1, (
                "no steal pressure in window: retire a warm spare"
            )
        return None


_POLICY_TYPES = {
    p.knob: p for p in (
        BatchWindowPolicy, WorkerPolicy, ElasticRangePolicy,
        FleetSparesPolicy,
    )
}


def policy_from_params(knob: str, params: dict):
    """Rebuild the policy an ``autotune`` event recorded — replay's
    constructor.  Unknown params are ignored (additive schema), unknown
    knobs raise (a journal from a newer version than this reader)."""
    cls = _POLICY_TYPES.get(knob)
    if cls is None:
        raise ValueError(f"unknown autotune knob {knob!r}")
    policy = cls()
    policy.params.update({
        k: v for k, v in dict(params or {}).items()
        if k in policy.params
    })
    return policy
