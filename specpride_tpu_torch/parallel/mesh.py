"""The cluster axis over several devices, and the ranks of a multi-host
run: the counterpart of the JAX package's ``parallel/mesh.py``.

Clusters are independent, so the port parallelises over one axis, the
clusters.  ``DeviceMesh`` cuts each bucketized (B, K) batch's rows into
contiguous blocks, one per device, runs each block on its device's own
CUDA stream and hands the results back in cluster order.  No collective
runs in the hot loop: a block's inputs go to its device and its outputs
come back to the host, and nothing passes between devices.  The host
drives the devices one block after another.

Several hosts split the input instead: each process takes a contiguous
block of clusters and writes its own part file (``cli._shard_for_process``,
joined by ``merge-parts``).  ``initialize_distributed`` only finds the
ranks, through ``torch.distributed`` (gloo); the one thing that crosses
between processes is rank 0's trace context at start
(``broadcast_from_rank0``), so every rank's journal carries one trace.
"""

from __future__ import annotations

import contextlib
import datetime
import math

import torch

from specpride_tpu_torch.observability import tracing

# elements per tile of the card's scans (ops/csrc/seg_scan_core.cuh kTile):
# a row whose flattened offset keeps its residue modulo the tile is summed
# in the same order, so blocks cut at such rows give the unsplit bytes
SCAN_TILE = 2048

# how long a rank waits for the others to join
DISTRIBUTED_TIMEOUT_S = 300.0


class DeviceMesh:
    """A list of devices (the same device may repeat), each with its own
    CUDA stream when ``own_streams`` (a CPU entry has none), over which a
    batch's cluster axis is split."""

    def __init__(self, devices, own_streams: bool = True):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a device mesh needs at least one device")
        for dev in self.devices:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceMesh: CUDA is not available on this host; pass "
                    "cpu devices to run on the CPU")
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {dev}")
        self.streams = [
            torch.cuda.Stream(dev) if own_streams and dev.type == "cuda"
            else None
            for dev in self.devices
        ]

    @classmethod
    def local(cls, device_type: str = "cuda") -> "DeviceMesh":
        """Every visible card (``device_type="cuda"``), or the one CPU."""
        if device_type == "cpu":
            return cls(["cpu"])
        if not torch.cuda.is_available():
            raise RuntimeError("DeviceMesh.local: CUDA is not available on "
                               "this host; use --device cpu")
        return cls([f"cuda:{i}" for i in range(torch.cuda.device_count())])

    @property
    def size(self) -> int:
        return len(self.devices)

    def blocks(self, lo: int, hi: int, align: int = 1) -> list[tuple]:
        """Rows [lo, hi) cut into at most ``size`` contiguous blocks of
        near-equal length, every cut at ``lo`` plus a multiple of
        ``align``: ``(device index, block lo, block hi)``, in row order,
        empty blocks left out."""
        n = hi - lo
        units = -(-n // align)
        per = -(-units // self.size) if units else 0
        out = []
        for i in range(self.size):
            b0 = lo + min(i * per * align, n)
            b1 = lo + min((i + 1) * per * align, n)
            if b1 > b0:
                out.append((i, b0, b1))
        return out

    @contextlib.contextmanager
    def on(self, i: int):
        """Device ``i`` and its stream made current inside the block."""
        dev, stream = self.devices[i], self.streams[i]
        if dev.type != "cuda":
            yield dev
            return
        with torch.cuda.device(dev):
            if stream is None:
                yield dev
            else:
                with torch.cuda.stream(stream):
                    yield dev

    def map_rows(self, lo: int, hi: int, fn, align: int = 1) -> list:
        """``fn(device, block_lo, block_hi)`` for each block of rows [lo,
        hi), on its device and stream; the results in row order."""
        out = []
        for i, b0, b1 in self.blocks(lo, hi, align):
            with self.on(i) as dev:
                out.append(fn(dev, b0, b1))
        return out


def shard_span(tensors):
    """The ``h2d:shard`` span of one block's copy to its device: the
    array count, the bytes and each channel's dtype (with ``--precision``
    the channels cross narrowed, and a trace shows what was on the
    wire)."""
    return tracing.span(
        "h2d:shard", n_arrays=len(tensors),
        bytes=int(sum(t.numel() * t.element_size() for t in tensors)),
        dtypes=",".join(str(t.dtype).removeprefix("torch.")
                        for t in tensors),
    )


def row_align(*widths: int) -> int:
    """Rows per cut that keep every row's flattened offset at the same
    residue modulo ``SCAN_TILE``, for arrays of these row widths."""
    align = 1
    for w in widths:
        step = SCAN_TILE // math.gcd(int(w), SCAN_TILE)
        align = align * step // math.gcd(align, step)
    return align


def initialize_distributed(
    coordinator_address: str | None,
    num_processes: int | None,
    process_id: int | None,
    timeout_s: float = DISTRIBUTED_TIMEOUT_S,
) -> tuple[int, int]:
    """``(rank, world size)`` of this process: ``(0, 1)`` with no
    coordinator; else a gloo process group joined at
    ``tcp://HOST:PORT`` (rank 0 listens there) with the given world size
    and rank and a ``timeout``, kept for rank discovery only.  No-op
    beyond reading it when a group already exists."""
    import torch.distributed as dist

    if coordinator_address is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not a rank of "
                         f"{num_processes} processes")
    if not dist.is_initialized():
        dist.init_process_group(
            backend="gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    rank, world = dist.get_rank(), dist.get_world_size()
    if (rank, world) != (process_id, num_processes):
        raise RuntimeError(
            f"distributed bring-up failed: the group says rank {rank} of "
            f"{world}, the flags rank {process_id} of {num_processes}")
    return rank, world


def broadcast_from_rank0(value):
    """Rank 0's ``value`` (any picklable object) on every rank of the
    process group; ``value`` itself without a group.  A collective: every
    rank calls it at the same point."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
