"""Per-lane stall watchdog (``--watchdog-timeout``; the port's copy of the
JAX package's ``robustness/watchdog.py``).

Each executor lane runs its work inside a watched *section*
(``with watchdog.section("dispatch"): ...``); a monitor thread checks the
open sections, and one that outlasts the timeout is counted, logged,
journaled (``watchdog_stall``) and handed to ``on_stall`` (``FaultPlan.cancel_hangs``, which breaks an
injected hang so the lane raises a transient ``LaneHangError`` its retry
recovers).  Sections, not heartbeats: a lane parked on an empty queue is
idle, not stalled.  A real runaway (a wedged stream) cannot be
interrupted from another thread; the stall count and the log name the
lane and its time.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time

logger = logging.getLogger("specpride_tpu_torch")


class Watchdog:
    """Monitor thread over named lane sections.  ``timeout_s <= 0`` gives
    a disabled instance whose ``section`` costs nothing."""

    def __init__(self, timeout_s: float, on_stall=None, journal=None):
        self.timeout_s = float(timeout_s)
        self.journal = journal
        self.enabled = self.timeout_s > 0
        self.on_stall = on_stall
        self.stall_count = 0
        self._sections: dict[int, tuple[str, float]] = {}
        self._flagged: set[int] = set()
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self.enabled:
            self._thread = threading.Thread(
                target=self._monitor, name="specpride-watchdog", daemon=True)
            self._thread.start()

    class _Section:
        __slots__ = ("_wd", "_key")

        def __init__(self, wd: "Watchdog | None", key: int | None):
            self._wd, self._key = wd, key

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            if self._wd is not None:
                with self._wd._lock:
                    self._wd._sections.pop(self._key, None)
                    self._wd._flagged.discard(self._key)

    def section(self, lane: str) -> "_Section":
        """Mark this thread as doing ``lane`` work until the block ends."""
        if not self.enabled:
            return self._Section(None, None)
        key = next(self._ids)
        with self._lock:
            self._sections[key] = (lane, time.perf_counter())
        return self._Section(self, key)

    def _monitor(self) -> None:
        # a few polls per timeout: detection within a fraction of it
        step = min(max(self.timeout_s / 5.0, 0.02), 0.5)
        while not self._stop.wait(step):
            now = time.perf_counter()
            stalled: list[tuple[str, float]] = []
            with self._lock:
                for key, (lane, t0) in self._sections.items():
                    if key not in self._flagged and now - t0 >= self.timeout_s:
                        # once per section: a stall is an event
                        self._flagged.add(key)
                        stalled.append((lane, now - t0))
            for lane, elapsed in stalled:
                self.stall_count += 1
                logger.warning("lane %s stalled for %.2fs (watchdog timeout "
                               "%.2fs)", lane, elapsed, self.timeout_s)
                if self.journal is not None:
                    self.journal.emit("watchdog_stall", lane=lane,
                                      elapsed_s=round(elapsed, 4),
                                      timeout_s=self.timeout_s)
                if self.on_stall is not None:
                    self.on_stall()

    def stalled(self) -> list[tuple[str, float]]:
        """The open sections the monitor flagged, ``(lane, elapsed_s)``:
        the serving daemon's ``/healthz`` view (a section that ended
        clears itself)."""
        if not self.enabled:
            return []
        now = time.perf_counter()
        with self._lock:
            return [(lane, round(now - t0, 3))
                    for key, (lane, t0) in self._sections.items()
                    if key in self._flagged]

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
