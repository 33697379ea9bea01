"""Lane placement for the serving daemon's worker pool (the port's
counterpart of the JAX package's ``serve/placement.py``).

``serve --workers N`` runs N execution lanes, each with its own resident
``TorchBackend``.  On the card (``device="cuda"``) the lanes go round
robin over the visible cards, and each lane gets a ``torch.cuda.Stream``
of its own on its card: PyTorch's current stream is per thread, the
kernel wrappers launch on the current stream of their inputs' device
(``ops/kernels.py``) with a workspace per (device, stream), and the
backend orders its H2D stream against that stream, so two lanes on one
card run on two streams as ``parallel/mesh.py`` does.  With
``device="cpu"`` (the tests) every lane shares the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

DEFAULT_MAX_WORKERS = 4


@dataclasses.dataclass(frozen=True)
class WorkerSlot:
    """One lane's placement: its device, and on a card its own stream."""

    worker: int
    device: torch.device
    stream: object | None = None

    def describe(self) -> str:
        if self.device.type == "cpu":
            return "cpu:shared"
        return f"cuda:{self.device.index}"


def local_devices(device: str = "cuda") -> list[torch.device]:
    """The cards a lane may take (``cuda:0`` ... ``cuda:<count - 1>``), or
    ``[]`` with ``device="cpu"``."""
    if torch.device(device).type == "cpu":
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def default_workers(device: str = "cuda") -> int:
    """``--workers`` 0: ``min(#cards, 4)``, at least 1."""
    return max(1, min(DEFAULT_MAX_WORKERS, len(local_devices(device))))


def plan_placement(n_workers: int, device: str = "cuda") -> list[WorkerSlot]:
    """``n_workers`` lanes: round robin over the cards, each with its own
    stream; with ``device="cpu"``, all on the CPU.  Raises without CUDA
    unless ``device="cpu"``, as ``TorchBackend()`` does."""
    n_workers = max(1, int(n_workers))
    if torch.device(device).type == "cpu":
        return [WorkerSlot(w, torch.device("cpu"))
                for w in range(n_workers)]
    devs = local_devices(device) if torch.cuda.is_available() else []
    if not devs:
        raise RuntimeError("serve: CUDA is not available on this host; "
                           "pass device='cpu' (serve --device cpu) to "
                           "serve on the CPU")
    slots = []
    for w in range(n_workers):
        dev = devs[w % len(devs)]
        slots.append(WorkerSlot(w, dev, torch.cuda.Stream(dev)))
    return slots


@contextlib.contextmanager
def device_scope(slot: WorkerSlot):
    """The lane's card and its stream made current on this thread (a
    no-op on the CPU)."""
    if slot.stream is None:
        yield
        return
    with torch.cuda.device(slot.device), torch.cuda.stream(slot.stream):
        yield
