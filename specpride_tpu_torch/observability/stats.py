"""Run counters, phase timers, logging and the device trace (the port's
copy of the JAX package's ``observability/stats.py``).

``configure_logging`` sets the global ``-v`` / ``--log-json`` logging;
``RunStats`` holds one CLI run's counters and phase seconds, each phase
with its thread's CPU seconds (user, system) and, opened by ``phase``,
also a tracing span; ``Lap`` is one timed interval's wall and thread CPU;
``device_trace`` is ``--trace-dir``: a ``torch.profiler`` capture of the
run (CPU activity on every thread, the port's spans as ranges, and the
card's kernels and copies on CUDA) written as a Chrome trace, the
counterpart of the JAX package's ``jax.profiler`` capture.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import resource
import sys
import threading
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


def thread_cpu() -> tuple[float, float]:
    """The calling thread's user and system CPU seconds (Linux advances
    them at the scheduler's tick)."""
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    return ru.ru_utime, ru.ru_stime


def process_cpu() -> tuple[float, float]:
    """The process's user and system CPU seconds, every thread's."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime


class Lap:
    """One interval on one thread: started at construction, ``stop()``
    sets its wall seconds and the thread's CPU seconds (user, system)
    over it.  Stopped on the thread that started it."""

    __slots__ = ("t0", "cpu0", "wall", "user", "sys")

    def __init__(self) -> None:
        self.cpu0 = thread_cpu()
        self.t0 = time.perf_counter()
        self.wall = self.user = self.sys = 0.0

    def stop(self) -> "Lap":
        self.wall = time.perf_counter() - self.t0
        user, sys_ = thread_cpu()
        self.user, self.sys = user - self.cpu0[0], sys_ - self.cpu0[1]
        return self

    def labels(self) -> dict:
        """The span labels of its CPU seconds."""
        return {"cpu_user_s": round(self.user, 6),
                "cpu_sys_s": round(self.sys, 6)}


def add_cpu(pair: list, lap: Lap) -> None:
    """Add a lap's CPU seconds to a ``[user, sys]`` pair."""
    pair[0] += lap.user
    pair[1] += lap.sys


def cpu_pair(pair) -> list:
    """A ``[user, sys]`` pair as the summaries report it."""
    return [round(pair[0], 4), round(pair[1], 4)]


@contextlib.contextmanager
def cpu_span(name: str, **labels):
    """A tracing span labelled with its thread's CPU seconds
    (``cpu_user_s``, ``cpu_sys_s``, when tracing is on); yields its
    ``Lap``, stopped before the span closes."""
    with tracing.span(name, **labels) as sp:
        lap = Lap()
        try:
            yield lap
        finally:
            lap.stop()
            if sp.enabled:
                sp.note(**lap.labels())


class RunStats:
    """Counters and phase timers of one CLI run.  Not thread-safe: each
    pack worker and the write lane fill a private one, merged on the
    dispatch lane.  Each phase holds its wall seconds (``phases``) and
    the CPU seconds, ``[user, sys]``, of the thread that ran it
    (``phase_cpu``); ``cpu_s()`` is the process's CPU since creation,
    which also holds threads no phase runs on (the window parse's native
    threads, torch's)."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = defaultdict(int)
        self.phases: dict[str, float] = defaultdict(float)
        self.phase_cpu: dict[str, list[float]] = defaultdict(
            lambda: [0.0, 0.0])
        # the executor's lane summary (``_checkpointed_run``), or None
        self.pipeline: dict | None = None
        # the robustness layer's counts (``Harness.summary``), or None
        self.robustness: dict | None = None
        # the precision gate's result (``precision_gate``), or None
        self.precision: dict | None = None
        # an elastic rank's summary (``cli._run_elastic``), or None
        self.elastic: dict | None = None
        # a streamed input's window parses (``io.mgf.StreamCounts``), or
        # None
        self.stream: dict | None = None
        self._start = time.perf_counter()
        self._cpu0 = process_cpu()

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def merge(self, other: "RunStats") -> None:
        for k, v in other.counters.items():
            self.counters[k] += v
        for k, v in other.phases.items():
            self.phases[k] += v
        for k, (user, sys_) in other.phase_cpu.items():
            pair = self.phase_cpu[k]
            pair[0] += user
            pair[1] += sys_

    def add(self, name: str, lap: Lap) -> None:
        """Account a stopped lap to phase ``name`` (a stage timed with no
        span of its own, or inside ``phase``)."""
        self.phases[name] += lap.wall
        add_cpu(self.phase_cpu[name], lap)

    @contextlib.contextmanager
    def phase(self, name: str):
        # every phase is also a span, and the span wraps the timer, so its
        # own exit (the journal write) never makes the phase exceed it
        lap = None
        try:
            with cpu_span(name) as lap:
                yield
        finally:
            if lap is not None:
                self.add(name, lap)

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def throughput(self, counter: str = "clusters") -> float:
        """``counter`` per second of the run's wall (``elapsed``)."""
        dt = self.elapsed
        return self.counters[counter] / dt if dt > 0 else 0.0

    def cpu_s(self) -> dict:
        """The process's CPU seconds since this object was made."""
        user, sys_ = process_cpu()
        return {"user": round(user - self._cpu0[0], 4),
                "sys": round(sys_ - self._cpu0[1], 4)}

    def phases_cpu_s(self) -> dict:
        return {k: cpu_pair(v) for k, v in self.phase_cpu.items()}

    def summary(self) -> dict:
        return {
            "elapsed_s": round(self.elapsed, 3),
            "counters": dict(self.counters),
            "phases_s": {k: round(v, 3) for k, v in self.phases.items()},
            "phases_cpu_s": self.phases_cpu_s(),
            "cpu_s": self.cpu_s(),
            **({"pipeline": self.pipeline} if self.pipeline else {}),
            **({"robustness": self.robustness} if self.robustness else {}),
            **({"stream": self.stream} if self.stream else {}),
            **({"elastic": self.elastic} if self.elastic else {}),
        }


def trace_path(trace_dir: str) -> str:
    """The Chrome trace file a ``device_trace`` into ``trace_dir``
    writes: one per process, so ranks sharing a directory never collide."""
    return os.path.join(trace_dir, f"specpride_torch.{os.getpid()}"
                                   ".pt.trace.json")


def _range_hook(all_threads: bool):
    """A capture's span-open hook (``tracing.set_range_hook``): each span
    opened on a thread the profiler records becomes a ``record_function``
    range there.  Without ``all_threads`` the profiler records only the
    thread that started it."""
    from torch.autograd.profiler import record_function

    owner = threading.get_ident()

    def open_range(name: str):
        if not all_threads and threading.get_ident() != owner:
            return None
        rng = record_function(name)
        rng.__enter__()
        return rng

    return open_range


def _all_threads_config():
    """The profiler's option to record every thread, or None where the
    installed torch lacks it."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device):
    """``--trace-dir``: a ``torch.profiler`` capture of the block, CPU
    activity and, on a CUDA ``device``, the card's kernels and copies,
    written to ``trace_path(trace_dir)`` as a Chrome trace when the block
    ends (also when it raises).  Every thread is recorded where the
    installed torch can (``profile_all_threads``; else the calling thread
    only, logged), and while it runs each span the run's tracer opens is
    a range of the same name on its thread, on the kernels' clock.
    Nothing without a directory."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if getattr(device, "type", str(device)) == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    config = _all_threads_config()
    if config is None:
        logger.warning("this torch profiles the calling thread only: the "
                       "pack and write lanes' spans are not in the device "
                       "trace")
        prof = profile(activities=activities)
    else:
        prof = profile(activities=activities, experimental_config=config)
    prof.start()
    prev = tracing.set_range_hook(_range_hook(config is not None))
    try:
        yield
    finally:
        tracing.set_range_hook(prev)
        prof.stop()
        path = trace_path(trace_dir)
        prof.export_chrome_trace(path)
        logger.info("device trace -> %s", path)
