"""Shape-class warmup: dispatch every manifest entry once before the first
chunk (the JAX package's ``warmstart/warmup.py``).

The JAX package compiles each entry ahead of time on a thread pool.  The
port has nothing to compile per shape: a first dispatch on a card pays
the kernel library's load, the lane's workspace, the device code of the
torch ops around the kernels and the allocator's first blocks, and a warm
pays them before the run does.  ``warm_entries`` runs each entry's
registry inputs through the port's own path once, on the caller's device
and current CUDA stream (a serving lane warms inside its own
``device_scope``), on a backend of its own, so the resident backend's
counters, shape classes and journal are what they would be cold.

Statuses are the JAX package's words: ``compiled`` (the entry was
dispatched), ``cache_hit`` (the backend given had already dispatched that
class: nothing is dispatched), ``skipped`` (a kernel the port has not
got, or a key it cannot read) and ``error``.  Each outcome
is journaled as a ``warmup`` event with the JAX fields, plus the kernel
launches the warm made (``launches``).

One card has one warm in flight: ``jobs`` above 1 is refused by name
(``check_jobs``), never accepted silently; 0 (the default) and 1 warm the
entries one after another.
"""

from __future__ import annotations

import dataclasses
import logging
import time

from specpride_tpu_torch.observability import tracing
from specpride_tpu_torch.observability.journal import NullJournal
from specpride_tpu_torch.warmstart import registry
from specpride_tpu_torch.warmstart.manifest import ShapeEntry

logger = logging.getLogger("specpride_tpu_torch")


@dataclasses.dataclass
class WarmResult:
    entry: ShapeEntry
    status: str  # "compiled" | "cache_hit" | "skipped" | "error"
    seconds: float
    detail: str = ""
    launches: dict = dataclasses.field(default_factory=dict)

    @property
    def cache_hit(self) -> bool:
        return self.status == "cache_hit"


def check_jobs(jobs: int, flag: str = "--jobs") -> None:
    """Refuse a warm of more than one entry at once: the port warms on
    the caller's one stream (a served lane warms its own)."""
    if jobs > 1:
        raise ValueError(
            f"{flag} {jobs}: the port warms one entry at a time on each "
            "lane's own CUDA stream (there are no compiles to run in a "
            f"pool); pass {flag} 0 or 1")
    if jobs < 0:
        raise ValueError(f"{flag} must be >= 0 (got {jobs})")


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.current_stream(device).synchronize()


def _warm_one(entry: ShapeEntry, device, seen: set) -> WarmResult:
    from specpride_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    try:
        built = registry.build(entry)
    except (ValueError, TypeError) as e:
        return WarmResult(entry, "skipped", 0.0, f"bad entry: {e}")
    if built is None:
        return WarmResult(entry, "skipped", 0.0,
                          "kernel not in warmup registry")
    fn, args, statics = built
    if (entry.kernel, *entry.shape_key) in seen:
        return WarmResult(entry, "cache_hit", time.perf_counter() - t0)
    before = dict(kernels.launches)
    # the warm's own method and kernel spans stay out of the run's trace
    prev = tracing.set_thread_current(tracing.NullTracer())
    try:
        fn(device, *args, **statics)
        _sync(device)
    except Exception as e:  # noqa: BLE001 - one bad entry, not the run
        return WarmResult(entry, "error", time.perf_counter() - t0,
                          f"{type(e).__name__}: {e}")
    finally:
        tracing.set_thread_current(prev)
    launches = {k: n - before.get(k, 0) for k, n in kernels.launches.items()
                if n != before.get(k, 0)}
    return WarmResult(entry, "compiled", time.perf_counter() - t0,
                      launches=launches)


def warm_entries(entries: list[ShapeEntry], journal=None, jobs: int = 0,
                 backend=None, device=None) -> list[WarmResult]:
    """Warm every entry on ``backend``'s device (else ``device``, else
    the card) and the current stream, in entry order; journal one
    ``warmup`` event per entry and return the results."""
    import torch

    check_jobs(jobs)
    journal = journal if journal is not None else NullJournal()
    if not entries:
        return []
    if backend is not None:
        device = backend.device
    device = torch.device(device if device is not None else "cuda")
    seen = set(getattr(backend, "_seen_shapes", ()) or ())
    t0 = time.perf_counter()
    with tracing.span("warmup", n_entries=len(entries), jobs=1):
        results = [_warm_one(entry, device, seen) for entry in entries]
    for r in results:
        journal.emit("warmup", kernel=r.entry.kernel,
                     shape_key=list(r.entry.shape_key),
                     cache_hit=r.cache_hit, seconds=round(r.seconds, 4),
                     status=r.status,
                     **({"detail": r.detail} if r.detail else {}),
                     **({"launches": r.launches} if r.launches else {}))
    n_hit = sum(r.cache_hit for r in results)
    n_err = sum(r.status in ("error", "skipped") for r in results)
    logger.info("warmup: %d kernel variant(s) in %.2fs — %d compiled, %d "
                "cache hit(s)%s", len(results), time.perf_counter() - t0,
                sum(r.status == "compiled" for r in results), n_hit,
                f", {n_err} skipped/failed" if n_err else "")
    return results
