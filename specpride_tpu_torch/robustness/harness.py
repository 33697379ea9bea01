"""Per-run robustness harness (the port's copy of the JAX package's
``robustness/harness.py``): the armed :class:`FaultPlan` (if any), the
:class:`RetryPolicy`, the lane :class:`Watchdog` and the degradation
switch, with the split and repair counts that go into the run summary;
each fault, retry, split and stall is also a journal event.

Construction arms the fault plan process-wide (the backend reaches it
through ``faults.check``); :meth:`close` disarms it and stops the
watchdog.  The CLI pairs the two in a ``finally``, so an aborted run never
leaves a plan armed for the next ``main()`` in the same process.
``degrade`` (``--no-degrade`` clears it) gates the OOM split and nothing
else: the port never reroutes a chunk off the card.
"""

from __future__ import annotations

import contextlib
import threading

from specpride_tpu_torch.robustness import faults
from specpride_tpu_torch.robustness.faults import FaultPlan
from specpride_tpu_torch.robustness.retry import RetryPolicy
from specpride_tpu_torch.robustness.watchdog import Watchdog


class Harness:
    def __init__(self, plan: FaultPlan | None, policy: RetryPolicy,
                 watchdog: Watchdog | None, degrade: bool, journal=None):
        self.plan = plan
        self.policy = policy
        self.watchdog = watchdog
        self.degrade = degrade
        self.journal = journal
        self._lock = threading.Lock()
        self.degrade_splits = 0
        self.degrade_reroutes = 0  # never grows: the port has no reroute
        self.resume_repairs = 0
        self._prev_plan = faults.install(plan, journal=journal)

    @classmethod
    def from_args(cls, args, journal=None) -> "Harness":
        """From the execution flags; ``--inject-faults`` wins over
        ``SPECPRIDE_FAULTS``.  ``journal`` (the run's) receives the
        ``fault``, ``retry``, ``degrade`` and ``watchdog_stall`` events."""
        spec = getattr(args, "inject_faults", None)
        seed = int(getattr(args, "fault_seed", 0) or 0)
        plan = (FaultPlan.parse(spec, seed=seed) if spec
                else FaultPlan.from_env())
        policy = RetryPolicy(retries=getattr(args, "retries", 0),
                             backoff=getattr(args, "retry_backoff", 0.05),
                             seed=seed, journal=journal)
        timeout = float(getattr(args, "watchdog_timeout", 0.0) or 0.0)
        watchdog = (
            Watchdog(timeout,
                     on_stall=plan.cancel_hangs if plan is not None else None,
                     journal=journal)
            if timeout > 0 else None
        )
        return cls(plan, policy, watchdog,
                   degrade=not getattr(args, "no_degrade", False),
                   journal=journal)

    @property
    def armed(self) -> bool:
        return self.plan is not None

    def check(self, site: str) -> None:
        if self.plan is not None:
            self.plan.check(site)

    def retry_call(self, site: str, fn, *, before_retry=None):
        return self.policy.call(site, fn, before_retry=before_retry)

    def section(self, lane: str):
        if self.watchdog is not None:
            return self.watchdog.section(lane)
        return contextlib.nullcontext()

    def note_degrade(self, action: str, reason: str, chunk_index: int,
                     n_clusters: int) -> None:
        with self._lock:
            if action == "split":
                self.degrade_splits += 1
            else:
                self.degrade_reroutes += 1
        if self.journal is not None:
            self.journal.emit("degrade", action=action, reason=reason,
                              chunk_index=chunk_index, n_clusters=n_clusters)

    def note_repair(self) -> None:
        with self._lock:
            self.resume_repairs += 1

    def summary(self, quarantined: int = 0) -> dict | None:
        """The run summary's ``robustness`` dict, with the JAX package's
        ``run_end.robustness`` keys; None while the layer stayed dormant
        (nothing armed, nothing fired)."""
        out: dict = {}
        if self.plan is not None:
            out["faults"] = self.plan.summary()
        retries = self.policy.summary()
        if self.armed or retries["retries"]:
            out.update(retries)
        if self.degrade_splits or self.degrade_reroutes:
            out["degrade_splits"] = self.degrade_splits
            if self.degrade_reroutes:
                out["degrade_reroutes"] = self.degrade_reroutes
        if self.resume_repairs:
            out["resume_repairs"] = self.resume_repairs
        if quarantined:
            out["quarantined"] = quarantined
        if self.watchdog is not None and self.watchdog.stall_count:
            out["watchdog_stalls"] = self.watchdog.stall_count
        return out or None

    def close(self) -> None:
        faults.install(self._prev_plan)
        self._prev_plan = None
        if self.watchdog is not None:
            self.watchdog.stop()
