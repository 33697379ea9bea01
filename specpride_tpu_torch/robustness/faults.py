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
* ``KIND``: the error raised there: ``io`` (``OSError``), ``oom`` (a
  ``RuntimeError`` that ``errors.is_oom`` takes for a real CUDA OOM, so it
  takes the same split branch), ``malformed`` (``ValueError``), or
  ``hang`` (the site blocks until the watchdog cancels it, or a hard bound
  expires, then raises a transient ``LaneHangError``).
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
SITES = (
    "parse", "pack", "prepare", "dispatch", "d2h", "qc", "write",
    "checkpoint_write",
)

KINDS = ("io", "oom", "malformed", "hang")

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
    ``degrade``, a ``quarantine``, a ``resume_repair`` or a
    ``skipped_clusters`` record (the ``--on-error skip`` outcome).  Each
    recovery backs at most one fault, and must follow it (``mono``).
    Returns the faults left unmatched: empty when every fault recovered.
    The JAX package's audit, without its elastic rank kinds."""
    fired = [e for e in events if e.get("event") == "fault"]
    recoveries = [
        e for e in events
        if e.get("event") in ("retry", "degrade", "quarantine",
                              "resume_repair", "skipped_clusters")
    ]
    used: set[int] = set()
    unmatched = []
    for f in fired:
        sites = recovery_sites_for(f.get("site", ""))
        for i, r in enumerate(recoveries):
            if i in used or r.get("mono", 0) < f.get("mono", 0):
                continue
            if r["event"] == "retry" and r.get("site") not in sites:
                continue
            used.add(i)
            break
        else:
            unmatched.append(f)
    return unmatched
