"""Run counters, phase timers, logging and the device trace (the port's
copy of the JAX package's ``observability/stats.py``).

``configure_logging`` sets the global ``-v`` / ``--log-json`` logging;
``RunStats`` holds one CLI run's counters and phase seconds, each phase
also a tracing span;
``device_trace`` is ``--trace-dir``: a ``torch.profiler`` capture of the
run (CPU activity, and the card's kernels and copies on CUDA) written as
a Chrome trace, the counterpart of the JAX package's ``jax.profiler``
capture.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from collections import defaultdict

from specpride_tpu_torch.observability import tracing

logger = logging.getLogger("specpride_tpu_torch")


def configure_logging(verbose: int = 0, structured: bool = False) -> None:
    """Root logging at WARNING, INFO (``-v``) or DEBUG (``-vv``) on
    stderr, one JSON object a line with ``structured`` (``--log-json``).
    It replaces the root logger's handlers (``force=True``), as the JAX
    package's does."""
    level = logging.WARNING
    if verbose == 1:
        level = logging.INFO
    elif verbose >= 2:
        level = logging.DEBUG
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_JsonFormatter() if structured else logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logging.basicConfig(level=level, handlers=[handler], force=True)


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return json.dumps({
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        })


class RunStats:
    """Counters and phase timers of one CLI run.  Not thread-safe: each
    pack worker and the write lane fill a private one, merged on the
    dispatch lane."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = defaultdict(int)
        self.phases: dict[str, float] = defaultdict(float)
        # the executor's lane summary (``_checkpointed_run``), or None
        self.pipeline: dict | None = None
        # the robustness layer's counts (``Harness.summary``), or None
        self.robustness: dict | None = None
        # the precision gate's result (``precision_gate``), or None
        self.precision: dict | None = None
        # an elastic rank's summary (``cli._run_elastic``), or None
        self.elastic: dict | None = None
        self._start = time.perf_counter()

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def merge(self, other: "RunStats") -> None:
        for k, v in other.counters.items():
            self.counters[k] += v
        for k, v in other.phases.items():
            self.phases[k] += v

    @contextlib.contextmanager
    def phase(self, name: str):
        # every phase is also a span, and the span wraps the timer, so its
        # own exit (the journal write) never makes the phase exceed it
        with tracing.span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.phases[name] += time.perf_counter() - t0

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def throughput(self, counter: str = "clusters") -> float:
        """Clusters/s over the work phases (compute + write), or the wall
        when none was timed."""
        dt = self.phases.get("compute", 0.0) + self.phases.get("write", 0.0)
        if dt <= 0.0:
            dt = self.elapsed
        return self.counters[counter] / dt if dt > 0 else 0.0

    def summary(self) -> dict:
        return {
            "elapsed_s": round(self.elapsed, 3),
            "counters": dict(self.counters),
            "phases_s": {k: round(v, 3) for k, v in self.phases.items()},
            **({"pipeline": self.pipeline} if self.pipeline else {}),
            **({"robustness": self.robustness} if self.robustness else {}),
            **({"elastic": self.elastic} if self.elastic else {}),
        }


def trace_path(trace_dir: str) -> str:
    """The Chrome trace file a ``device_trace`` into ``trace_dir``
    writes: one per process, so ranks sharing a directory never collide."""
    return os.path.join(trace_dir, f"specpride_torch.{os.getpid()}"
                                   ".pt.trace.json")


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device):
    """``--trace-dir``: a ``torch.profiler`` capture of the block, CPU
    activity and, on a CUDA ``device``, the card's kernels and copies,
    written to ``trace_path(trace_dir)`` as a Chrome trace when the block
    ends (also when it raises).  Nothing without a directory."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if getattr(device, "type", str(device)) == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = trace_path(trace_dir)
        prof.export_chrome_trace(path)
        logger.info("device trace -> %s", path)
