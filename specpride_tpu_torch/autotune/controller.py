"""The Controller: journal-tapped signal fold + policies + actuators
(the JAX package's ``autotune/controller.py``).

One controller owns one journal's :class:`~.signals.SignalState` (it
installs itself as the journal tap) and any number of registered
policies, each bound to a ``get`` (read the live knob) and optional
``set`` (actuate it) callable on the host — the daemon's locked live
batch window, its active-lane count, the coordinator's split hint, the
fleet supervisor's spare count.

A tick runs every policy through ``Journal.emit_atomic``: the signal
snapshot, the policy evaluation and the ``autotune`` decision line are
ONE critical section with respect to the journal's write lock, so no
concurrent worker event can land between the evidence snapshot and the
decision in the file — the invariant ``specpride autotune-replay``
depends on.  Actuation happens after the line is written (an acted
decision is always journaled first), and only in mode ``on``:
``observe`` journals the would-be decision with ``acted: false``.
"""

from __future__ import annotations

import logging
import threading
import time

from specpride_tpu_torch.autotune.signals import SignalState

logger = logging.getLogger("specpride_tpu_torch")


def evaluate(policy, signal: dict, current, last_clock):
    """Shared gating + policy evaluation — the ONE code path live ticks
    and offline replay both run, so they cannot disagree.

    Returns ``(new, reason)`` or None.  Gating order: cooldown (clock
    distance from the last JOURNALED decision on this knob), then the
    policy's pure ``decide``, then no-op and deadband suppression."""
    params = policy.params
    cooldown = float(params.get("cooldown_s", 0.0))
    now = float(signal.get("now") or 0.0)
    if last_clock is not None and now - last_clock < cooldown:
        return None
    got = policy.decide(signal, current)
    if got is None:
        return None
    new, reason = got
    if new == current:
        return None
    deadband = float(params.get("deadband", 0.0))
    if deadband > 0 and current and (
        abs(new - current) / abs(current) < deadband
    ):
        return None
    return new, reason


class Controller:
    """Mode-gated decision engine over one journal.

    ``mode``: ``observe`` (default — journal would-be decisions,
    actuate nothing) or ``on``.  ``off`` never constructs a controller
    at all: the kill switch is the absence of this object, so an off
    run is byte-identical to a controller-free one.
    """

    def __init__(
        self,
        journal,
        *,
        mode: str = "observe",
        window_s: float = 30.0,
        telemetry=None,
        clock=time.perf_counter,
    ):
        if mode not in ("observe", "on"):
            raise ValueError(
                f"autotune mode {mode!r} must be observe or on"
            )
        self.journal = journal
        self.mode = mode
        self.clock = clock
        self.telemetry = telemetry  # ServeTelemetry (or None)
        self.signals = SignalState(window_s)
        # attach WITH catch-up: records already in the file (a host may
        # journal warmup/parse spans before the controller boots) fold
        # into the signal state first, so live state == fold(file) —
        # the invariant the replay refold audit holds decisions to
        journal.attach_tap(self.signals.observe)
        # knob -> (policy, get, set|None); insertion order is tick order
        self._policies: dict = {}
        self._last: dict = {}  # knob -> snapshot clock of last decision
        self.decisions = 0
        self.acted = 0

    def register(self, policy, get, set=None) -> None:
        """Bind ``policy`` to the host's live knob accessors.  ``set``
        is only called in mode ``on``, after the decision is journaled;
        its absence makes the knob observe-only whatever the mode."""
        self._policies[policy.knob] = (policy, get, set)  # lint: ok[lane-safety] boot-time only: every register() precedes the tick thread, which reads via a list() snapshot
        if self.telemetry is not None:
            value = get()
            if isinstance(value, (int, float)):
                self.telemetry.autotune_knob.set(
                    float(value), knob=policy.knob
                )

    def tick(self, extras: dict | None = None) -> list[dict]:
        """Run every registered policy once; returns the decisions
        journaled this tick.  A policy raising is logged and skipped —
        a controller bug must degrade to 'no tuning', never take the
        serving plane down."""
        out = []
        for knob, (policy, get, set_) in list(self._policies.items()):
            try:
                rec = self.journal.emit_atomic(
                    lambda p=policy, g=get, s=set_, e=extras:
                        self._decide_locked(p, g, s, e)
                )
            except Exception:
                logger.exception("autotune: %s policy tick failed", knob)
                continue
            if rec is None:
                continue
            out.append(rec)
            if rec.get("acted") and set_ is not None:
                try:
                    set_(rec["new"])
                except Exception:
                    logger.exception(
                        "autotune: actuating %s=%r failed",
                        knob, rec.get("new"),
                    )
            if self.telemetry is not None:
                self.telemetry.autotune_decision(
                    knob=knob,
                    value=rec["new"] if rec.get("acted") else rec["old"],
                    acted=bool(rec.get("acted")),
                )
        return out

    def _decide_locked(self, policy, get, set_, extras):
        """The ``emit_atomic`` build callback: runs under the journal
        write lock, so the snapshot cannot drift before the decision
        line is written.  Returns ``(event, fields)`` or None."""
        now = self.clock()
        current = get()
        signal = self.signals.snapshot(now, extras=extras)
        decision = evaluate(
            policy, signal, current, self._last.get(policy.knob)
        )
        if decision is None:
            return None
        new, reason = decision
        acted = self.mode == "on" and set_ is not None
        self._last[policy.knob] = signal["now"]
        self.decisions += 1
        if acted:
            self.acted += 1
        return "autotune", {
            "knob": policy.knob,
            "mode": self.mode,
            "old": current,
            "new": new,
            "reason": reason,
            "signal": signal,
            "acted": acted,
            "params": dict(policy.params),
            "clock": signal["now"],
            "trace_ids": self.signals.recent_traces(),
        }

    def status(self) -> dict:
        """The live counters ``serve status`` / ``stats`` surface."""
        return {
            "mode": self.mode,
            "decisions": self.decisions,
            "acted": self.acted,
            "knobs": sorted(self._policies),
        }

    def knob_values(self) -> dict:
        """Current value of every registered knob, read through its
        live accessor — the flight recorder's bundle snapshot of the
        autotune plane at incident time.  A failing accessor reads
        None: a diagnostic dump must never raise into its host."""
        out: dict = {}
        for knob, (_policy, get, _set) in list(self._policies.items()):
            try:
                out[knob] = get()
            except Exception:  # noqa: BLE001 - diagnostic best effort
                out[knob] = None
        return out

    def close(self) -> None:
        """Detach from the journal (the host is draining).  Only THIS
        controller's tap: a flight recorder tapping the same journal
        keeps observing until its own stop."""
        self.journal.detach_tap(self.signals.observe)


class ControllerThread:
    """Background tick loop for hosts with their own threads (the
    serving daemon; elastic ranks).  The fleet supervisor ticks its
    controller synchronously from its poll loop instead."""

    def __init__(self, controller: Controller, interval: float = 1.0,
                 extras_fn=None):
        self.controller = controller
        self.interval = max(float(interval), 0.05)
        self.extras_fn = extras_fn
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ControllerThread":
        self._thread = threading.Thread(
            target=self._run, name="autotune", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            extras = self.extras_fn() if self.extras_fn else None
            self.controller.tick(extras)

    def stop(self) -> None:
        """Stop ticking, run ONE final drain tick, then detach the tap.
        The drain tick is what makes short-lived hosts observable: an
        elastic rank that finishes its whole workload inside the first
        interval would otherwise journal no decision at all.  Called
        BEFORE the host closes its journal: a tick racing a closed
        journal would lose the decision line an operator expects to
        find."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        try:
            extras = self.extras_fn() if self.extras_fn else None
            self.controller.tick(extras)
        except Exception:
            logger.exception("autotune: drain tick failed")
        self.controller.close()
