"""Seeded, deterministic fault injection at named pipeline sites (the
port's copy of the JAX package's ``robustness/faults.py``).

A :class:`FaultPlan` is parsed from ``--inject-faults``
``SITE:KIND:RATE[:AFTER[:MAX]],...`` (or the ``SPECPRIDE_FAULTS`` env
var, so a test can arm a child process without threading flags through):

* ``SITE``: one of :data:`SITES`, the executor's lane boundaries:
  ``parse`` (a chunk's clusters materialized: the MGF window parse on a
  streamed input), ``pack`` (the host pack stage), ``prepare``
  (``TorchBackend.prepare_chunk``), ``dispatch`` (a chunk's device work),
  ``d2h`` (a result copied back from the card), ``qc`` (the cosine QC
  pass), ``write`` (the MGF append), ``checkpoint_write`` (the manifest
  replace).
  The elastic coordinator's compare-and-swap steps add ``cas`` (visited
  only by ``--elastic`` runs).
* ``KIND``: the error raised there: ``io`` (``OSError``), ``oom`` (a
  ``RuntimeError`` that ``errors.is_oom`` takes for a real CUDA OOM, so it
  takes the same split branch), ``malformed`` (``ValueError``), or
  ``hang`` (the site blocks until the watchdog cancels it, or a hard bound
  expires, then raises a transient ``LaneHangError``); and the elastic
  kinds: ``rank_kill`` (SIGKILL of the process at the site),
  ``rank_slow`` (a stall of ``SPECPRIDE_SLOW_S`` seconds, default 0.5,
  that raises nothing, so a peer's work stealing relieves the rank) and
  ``cas_conflict`` (a lost compare-and-swap the coordinator absorbs).
* ``RATE``: firing probability per eligible visit, drawn from
  ``sha256(seed, site, visit)``, so a plan and seed fire at the same
  visits on every run whatever the threads do.
* ``AFTER``: skip the first AFTER visits of the site (default 0).
* ``MAX``: cap on the entry's fires (default 1): ``RATE=1`` then means
  "fire exactly once, as early as possible", and a bounded retry policy
  always sees a clean attempt in the end.

The plan is installed process-wide (:func:`install`) because the sites
live in both the CLI executor and the backend; :func:`check` costs one
global read when no plan is armed.  Every fired fault is journaled as a
``fault`` event before its error is raised, and
:func:`audit_fault_recovery` pairs each with the recovery that followed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time

from specpride_tpu_torch.robustness.errors import InjectedFault, LaneHangError

# the chunk executor's lane-boundary sites: every chunked run visits them.
# Not named FAULT_SITES, as in the JAX package: its lint (`specpride lint`)
# finds its fault-site anchor by that name, which must stay unique in the
# repository.
EXECUTOR_SITES = (
    "parse", "pack", "prepare", "dispatch", "d2h", "qc", "write",
    "checkpoint_write",
)

# every injectable site: the executor's and the elastic coordinator's
# compare-and-swap steps (`cas` fires only in --elastic runs)
SITES = EXECUTOR_SITES + ("cas",)

KINDS = ("io", "oom", "malformed", "hang", "rank_kill", "rank_slow",
         "cas_conflict")

# the stall of one `rank_slow` visit when SPECPRIDE_SLOW_S is unset: a
# slow but live rank (throttled, a noisy neighbour) that fails nothing
DEFAULT_SLOW_S = 0.5

# kinds that fail nothing, so no recovery event follows them: a slow rank
# commits every chunk late, and the lease_split it forces is audited by
# parallel.elastic.audit_elastic
_SELF_RECOVERING_KINDS = frozenset({"rank_slow"})

# the retry wrappers whose ``retry`` events recover a fault fired at a
# site: the pack lane's covers everything the pack stage runs, the
# dispatch lane's the result fetch (the JAX package's map), and the QC
# pass's its own fetch: the port's QC cosine runs on the card
_RECOVERY_SITES = {
    "parse": ("pack",),
    "pack": ("pack",),
    "prepare": ("pack",),
    "dispatch": ("dispatch",),
    "d2h": ("dispatch", "qc"),
    "qc": ("qc",),
    "write": ("write",),
    "checkpoint_write": ("checkpoint_write",),
    # a lost compare-and-swap: the coordinator's own handler recovers it
    # (loses gracefully and scans again), journaled as a retry at `cas`
    "cas": ("cas",),
}


def recovery_sites_for(site: str) -> tuple[str, ...]:
    return _RECOVERY_SITES.get(site, (site,))

# a hang with no watchdog armed must still end: hard bound on the block
MAX_HANG_S = 5.0


class InjectedOSError(OSError, InjectedFault):
    pass


class InjectedOutOfMemory(RuntimeError, InjectedFault):
    """Shaped like a CUDA allocation failure: its message carries the
    "out of memory" that ``errors.is_oom`` keys on."""


class InjectedValueError(ValueError, InjectedFault):
    pass


class InjectedHang(LaneHangError, InjectedFault):
    pass


class InjectedCasConflict(RuntimeError, InjectedFault):
    """A coordinator compare-and-swap that lost its race (the stand-in
    for a real 412 or EEXIST under contention); the coordinator catches
    it at the step and never lets it reach the executor."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    kind: str
    rate: float
    after: int = 0
    max_fires: int = 1

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        parts = text.strip().split(":")
        if not 3 <= len(parts) <= 5:
            raise ValueError(
                f"fault spec {text!r}: want SITE:KIND:RATE[:AFTER[:MAX]]"
            )
        site, kind, rate = parts[0], parts[1], float(parts[2])
        if site not in SITES:
            raise ValueError(
                f"fault spec {text!r}: unknown site {site!r} "
                f"(sites: {', '.join(SITES)})"
            )
        if kind not in KINDS:
            raise ValueError(
                f"fault spec {text!r}: unknown kind {kind!r} "
                f"(kinds: {', '.join(KINDS)})"
            )
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault spec {text!r}: rate must be in [0, 1]")
        after = int(parts[3]) if len(parts) >= 4 else 0
        max_fires = int(parts[4]) if len(parts) == 5 else 1
        if after < 0 or max_fires < 0:
            raise ValueError(f"fault spec {text!r}: AFTER/MAX must be >= 0")
        return cls(site, kind, rate, after, max_fires)


class FaultPlan:
    """The armed fault specs and their per-site visit and fire counts.

    Thread-safe: pack workers, the dispatch lane and the write lane call
    ``check`` at once.  The visit counter advances under the lock and the
    fire decision is a pure function of ``(seed, site, visit)``, so
    threads change which thread trips a fault, never which visit does."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._by_site: dict[str, list[int]] = {}
        for i, s in enumerate(self.specs):
            self._by_site.setdefault(s.site, []).append(i)
        self._lock = threading.Lock()
        self._visits: dict[str, int] = {}
        self._fires: dict[int, int] = {}  # spec index -> fire count
        self.fired_by_site: dict[str, int] = {}
        self._hang_cancel = threading.Event()
        self.journal = None  # set by install(); may stay None

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        specs = [FaultSpec.parse(part) for part in text.split(",")
                 if part.strip()]
        if not specs:
            raise ValueError(f"empty fault plan {text!r}")
        return cls(specs, seed=seed)

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        """``SPECPRIDE_FAULTS`` / ``SPECPRIDE_FAULT_SEED``: arm a child
        process's run without flags on its command line."""
        spec = os.environ.get("SPECPRIDE_FAULTS", "").strip()
        if not spec:
            return None
        seed = int(os.environ.get("SPECPRIDE_FAULT_SEED", "0") or 0)
        return cls.parse(spec, seed=seed)

    @property
    def fired_total(self) -> int:
        return sum(self.fired_by_site.values())

    def summary(self) -> dict:
        return {
            "plan": [dataclasses.asdict(s) for s in self.specs],
            "seed": self.seed,
            "fired_total": self.fired_total,
            "fired_by_site": dict(sorted(self.fired_by_site.items())),
        }

    def _draw(self, site: str, visit: int) -> float:
        digest = hashlib.sha256(f"{self.seed}:{site}:{visit}".encode()
                                ).digest()
        return int.from_bytes(digest[:8], "big") / float(1 << 64)

    def cancel_hangs(self) -> None:
        """Break every current and future injected hang: the watchdog's
        lever.  One-way: once the watchdog has seen a lane stall, later
        hangs would only measure the same timeout again."""
        self._hang_cancel.set()

    def check(self, site: str) -> None:
        """Fire at most one armed fault for this visit of ``site``."""
        fired: FaultSpec | None = None
        with self._lock:
            visit = self._visits.get(site, 0)
            self._visits[site] = visit + 1
            for idx in self._by_site.get(site, ()):
                s = self.specs[idx]
                if visit < s.after or self._fires.get(idx, 0) >= s.max_fires:
                    continue
                if self._draw(site, visit) < s.rate:
                    self._fires[idx] = self._fires.get(idx, 0) + 1
                    self.fired_by_site[site] = (
                        self.fired_by_site.get(site, 0) + 1)
                    fired = s
                    break
        if fired is None:
            return
        if self.journal is not None:
            self.journal.emit("fault", site=site, kind=fired.kind,
                              visit=visit)
        self._raise(site, fired, visit)

    def _raise(self, site: str, spec: FaultSpec, visit: int) -> None:
        msg = f"injected {spec.kind} fault at {site} (visit {visit})"
        if spec.kind == "rank_slow":
            # slow but alive: stall, then carry on.  Nothing fails, the
            # heartbeat keeps the lease, and the watchdog does not break
            # it: slowness is no stall a lane can cancel
            try:
                slow_s = float(os.environ.get("SPECPRIDE_SLOW_S", "") or 0)
            except ValueError:
                slow_s = 0.0
            time.sleep(slow_s if slow_s > 0 else DEFAULT_SLOW_S)
            return
        if spec.kind == "cas_conflict":
            raise InjectedCasConflict(msg)
        if spec.kind == "rank_kill":
            # the rank dies at the site: no handler, no flush beyond the
            # fault line above (the journal writes whole lines).  The
            # recovery is a surviving rank's lease_expire + chunk_reassign
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(MAX_HANG_S)  # not reached: SIGKILL is not caught
        if spec.kind == "io":
            raise InjectedOSError(msg)
        if spec.kind == "oom":
            raise InjectedOutOfMemory(f"CUDA out of memory: {msg}")
        if spec.kind == "malformed":
            raise InjectedValueError(msg)
        # hang: block until the watchdog cancels it (or the bound expires),
        # then raise the transient lane hang the enclosing retry recovers
        deadline = time.perf_counter() + MAX_HANG_S
        while time.perf_counter() < deadline:
            if self._hang_cancel.wait(timeout=0.02):
                break
        raise InjectedHang(f"{msg}: lane unblocked after stall")


_active: FaultPlan | None = None
_suppress = threading.local()


class _Suppressed:
    """Disables injection on this thread inside the block."""

    def __enter__(self):
        self._prev = getattr(_suppress, "on", False)
        _suppress.on = True
        return self

    def __exit__(self, *exc):
        _suppress.on = self._prev


def suppressed() -> _Suppressed:
    return _Suppressed()


def install(plan: FaultPlan | None, journal=None) -> FaultPlan | None:
    """Arm ``plan`` process-wide (None disarms), its fired faults
    journaled to ``journal`` when one is given; returns the previous plan,
    so the caller can restore it."""
    global _active
    prev = _active
    if plan is not None and journal is not None:
        plan.journal = journal
    _active = plan
    return prev


def active_plan() -> FaultPlan | None:
    return _active


def check(site: str) -> None:
    """The injection point, called at every site on every chunk."""
    plan = _active
    if plan is not None and not getattr(_suppress, "on", False):
        plan.check(site)


def audit_fault_recovery(events: list[dict]) -> list[dict]:
    """Pair every journaled ``fault`` with a later recovery event: a
    ``retry`` at the fault site's wrapper (``recovery_sites_for``), a
    ``degrade``, a ``quarantine``, a ``resume_repair``, a
    ``skipped_clusters`` record (the ``--on-error skip`` outcome) or, for
    a ``rank_kill`` only, a ``chunk_reassign`` (a surviving elastic rank
    took the dead rank's range: feed the ranks' journals merged, the
    reassignment is never in the dead rank's file).  Each recovery backs
    at most one fault, and an in-process one must follow it (``mono``).
    A ``rank_slow`` fails nothing and needs no recovery.  Returns the
    faults left unmatched: empty when every fault recovered."""
    fired = [e for e in events if e.get("event") == "fault"
             and e.get("kind") not in _SELF_RECOVERING_KINDS]
    recoveries = [
        e for e in events
        if e.get("event") in ("retry", "degrade", "quarantine",
                              "resume_repair", "skipped_clusters",
                              "chunk_reassign")
    ]
    used: set[int] = set()
    unmatched = []
    for f in fired:
        sites = recovery_sites_for(f.get("site", ""))
        for i, r in enumerate(recoveries):
            if i in used:
                continue
            if r["event"] == "chunk_reassign":
                # only a rank's death moves its range; no mono check: the
                # reassignment is in another process's journal
                if f.get("kind") != "rank_kill":
                    continue
            elif r.get("mono", 0) < f.get("mono", 0):
                continue
            if r["event"] == "retry" and r.get("site") not in sites:
                continue
            used.add(i)
            break
        else:
            unmatched.append(f)
    return unmatched
