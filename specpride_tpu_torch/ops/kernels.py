"""Hand-written CUDA kernels and their plain PyTorch versions: the
counterpart of the JAX package's ``ops/pallas_kernels.py``.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  ``launches`` counts kernel
launches per wrapper name, so a run can show that it went through them.

Every kernel is one launch of the single-pass scan in
``ops/csrc/seg_scan_core.cuh``.  Its scratch, the workspace, is allocated
here once per (device, stream) and kept: a wrapper call allocates only its
outputs.
"""

from __future__ import annotations

import threading

import torch

from specpride_tpu_torch.ops import segments

launches = {"seg_mean": 0, "seg_mean_heads": 0, "seg_scan": 0}

# A status word keeps a tile's ticket + 1 in 62 bits (seg_scan_core.cuh).
STAMP_LIMIT = 1 << 62


class Workspace:
    """Scratch of the single-pass scans on one (device, stream), kept
    between calls: the ticket counter and one record per tile
    (``ops/csrc/seg_scan_core.cuh``), zeroed once.  ``base`` is the
    counter's value before the next launch, and each launch adds its tile
    count, so no call clears anything.  Calls on one stream run in order
    and share it; another stream gets its own.  ``_launch`` holds
    ``workspace_lock`` from reading ``base`` to advancing it, so host
    threads that launch on one stream never share a range of tickets."""

    __slots__ = ("buf", "tiles", "base")

    def __init__(self, device, tiles: int, record_bytes: int):
        self.buf = torch.zeros((tiles + 1) * record_bytes, dtype=torch.uint8,
                               device=device)
        self.tiles = tiles
        self.base = 0


workspaces: dict[tuple, Workspace] = {}
# held across a launch's workspace lookup, its enqueue and its base bump
workspace_lock = threading.Lock()


def workspace(device, stream: int, tiles: int,
              record_bytes: int) -> Workspace:
    """The workspace of ``stream`` on ``device`` for a launch of ``tiles``
    tiles.  It grows (doubling, zeroed, counter at 0) when it is too small,
    and is zeroed with its counter back at 0 before a stamp would pass
    ``STAMP_LIMIT``.  The old buffer goes back to PyTorch's caching
    allocator, which reuses it only for work ordered after this stream's."""
    key = (device.index, stream)
    ws = workspaces.get(key)
    if ws is None or ws.tiles < tiles:
        grown = max(tiles, 2 * ws.tiles) if ws else tiles
        ws = workspaces[key] = Workspace(device, grown, record_bytes)
    elif ws.base + tiles >= STAMP_LIMIT:
        ws.buf.zero_()
        ws.base = 0
    return ws


def _launch(name, entry, lib, runs, ins, outs, count: int) -> None:
    """One launch of a kernel entry point on the current stream of the
    inputs' device, with that stream's workspace; raises if it failed.
    Not inside a CUDA graph: a replay would launch with the ``base`` of the
    capture."""
    dev = runs.device
    n = runs.numel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name} cannot be captured in a CUDA graph: "
                           "each launch needs the workspace's next base")
    tiles = -(-n // lib.tile)
    ins = [t.data_ptr() for t in ins] + [None] * (3 - len(ins))
    outs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
    with workspace_lock:
        ws = workspace(dev, stream, tiles, lib.record_bytes)
        rc = entry(runs.data_ptr(), *ins, *outs, n, count,
                   ws.buf.data_ptr(), ws.base, dev.index, stream)
        if rc != 0:
            # blocks of the failed launch may have taken tickets already,
            # so the device counter can stand past ``base``: drop the
            # workspace, and the next launch on this stream starts from a
            # zeroed one at base 0 instead of reading tiles of another range
            workspaces.pop((dev.index, stream), None)
            raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
        ws.base += tiles
        launches[name] += 1


def _check_args(name, runs, run_dtypes, channels, counts,
                value_dtypes=(torch.float32,)) -> None:
    """1-D tensors of one length on one device: ``runs`` of one of
    ``run_dtypes``, and ``channels`` of ``value_dtypes`` whose number is
    in ``counts``."""
    if len(channels) not in counts:
        raise ValueError(f"{name} takes {'/'.join(map(str, counts))} "
                         f"channels, got {len(channels)}")
    if runs.dtype not in run_dtypes:
        raise TypeError(f"{name} runs must be {run_dtypes}, got "
                        f"{runs.dtype}")
    for t in channels:
        if t.dtype not in value_dtypes:
            raise TypeError(f"{name} channels must be {value_dtypes}, got "
                            f"{t.dtype}")
    for t in (runs, *channels):
        if t.dim() != 1 or t.shape != runs.shape:
            raise ValueError(
                f"{name} needs 1-D tensors of one length, got "
                f"{[tuple(x.shape) for x in (runs, *channels)]}"
            )
        if t.device != runs.device:
            raise ValueError(f"{name} inputs lie on different devices")


def _on_card(name, tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA
    tensors, which must be contiguous (the kernel runs); any other device
    raises."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return True


def _prefix64(head: torch.Tensor, channels: list[torch.Tensor]):
    """Within-run inclusive prefixes in float64, one per channel; runs
    begin where ``head`` is True (element 0 always begins one).

    Run ids come from an int64 cumsum of the head flags.  Each run's head
    also subtracts the previous run's total (an ``index_add_``), so one
    global cumsum yields within-run prefixes while every partial sum it
    forms stays at the scale of a run: a plain global cumsum difference
    would carry rounding at the scale of the whole array's sum."""
    head = head.clone()
    head[0] = True
    run_id = torch.cumsum(head.to(torch.int64), 0) - 1
    (starts,) = torch.nonzero(head, as_tuple=True)
    outs = []
    for ch in channels:
        ch = ch.to(torch.float64)
        totals = torch.zeros(
            starts.numel(), dtype=torch.float64, device=ch.device
        ).index_add_(0, run_id, ch)
        ch = ch.clone()
        ch[starts[1:]] -= totals[:-1]
        outs.append(torch.cumsum(ch, 0))
    return outs


def seg_mean_plain(
    keys: torch.Tensor, w: torch.Tensor, *values: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``seg_mean``: the within-run prefixes are
    formed in float64 (``_prefix64``), divided, then cast to float32."""
    _check_args("seg_mean", keys, (torch.int32,), (w, *values), (2, 3))
    if keys.numel() == 0:
        return tuple(torch.zeros_like(w) for _ in range(1 + len(values)))
    w64 = w.to(torch.float64)
    outs = _prefix64(
        segments.run_starts(keys),
        [w64] + [v.to(torch.float64) * w64 for v in values],
    )
    cnt = outs[0]
    safe = torch.clamp(cnt, min=1.0)
    return (cnt.to(torch.float32),) + tuple(
        (s / safe).to(torch.float32) for s in outs[1:]
    )


def seg_mean(
    keys: torch.Tensor, w: torch.Tensor, *values: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Fused segmented mean, ``(count, mean_0[, mean_1])`` per element.

    Runs are maximal spans of equal adjacent ``keys`` (int32); ``w`` is
    the float32 weight (the 0/1 valid mask); ``values`` are 1 or 2
    float32 channels.  ``count[i]`` is the inclusive within-run prefix of
    ``w`` and ``mean_c[i] = prefix(values[c] * w)[i] / max(count[i], 1)``,
    so a run's last element holds its mean.  Exact for any run length.
    Replaces ``specpride_tpu/ops/pallas_kernels.py::seg_mean_pallas``."""
    _check_args("seg_mean", keys, (torch.int32,), (w, *values), (2, 3))
    if not _on_card("seg_mean", (keys, w, *values)):
        return seg_mean_plain(keys, w, *values)
    from specpride_tpu_torch.ops import _build

    lib = _build.load()
    outs = [torch.empty_like(w) for _ in range(1 + len(values))]
    if keys.numel():
        _launch("seg_mean", lib.seg_mean_f32, lib, keys, (w, *values), outs,
                len(values))
    return tuple(outs)


HEADS = (torch.bool, torch.uint8)  # head flags
# value dtype -> its code in seg_mean_heads' kinds argument (seg_mean.cu)
HEAD_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}
# the value dtypes seg_mean_heads takes: one channel (the flat gap
# average's f32, bf16 or int8 intensities, the binned mean's codes), or
# the bucketized gap average's m/z and intensity: f32 and f32 at f32, else
# f32 or (where exact) bf16 m/z beside bf16 or int8 codes
HEAD_CASES = (
    (torch.float32,), (torch.bfloat16,), (torch.int8,),
    (torch.float32, torch.float32),
    *((a, b) for a in (torch.float32, torch.bfloat16)
      for b in (torch.bfloat16, torch.int8)),
)


def _check_heads(head, values) -> None:
    _check_args("seg_mean_heads", head, HEADS, values, (1, 2),
                tuple(HEAD_KINDS))
    dtypes = tuple(v.dtype for v in values)
    if dtypes not in HEAD_CASES:
        raise TypeError(f"seg_mean_heads has no kernel for value dtypes "
                        f"{dtypes}")


def seg_mean_heads_plain(
    head: torch.Tensor, *values: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``seg_mean_heads``: float64 within-run
    prefixes (``_prefix64``) of 1 and of each upcast channel, divided,
    then cast to float32."""
    _check_heads(head, values)
    n = head.numel()
    if n == 0:
        return tuple(torch.zeros(0, device=head.device)
                     for _ in range(1 + len(values)))
    ones = torch.ones(n, dtype=torch.float64, device=head.device)
    outs = _prefix64(head != 0,
                     [ones] + [v.to(torch.float64) for v in values])
    cnt = outs[0]
    safe = torch.clamp(cnt, min=1.0)
    return (cnt.to(torch.float32),) + tuple(
        (s / safe).to(torch.float32) for s in outs[1:]
    )


def seg_mean_heads(
    head: torch.Tensor, *values: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Segmented mean over runs given by head flags, ``(count, mean_0[,
    mean_1])`` per element, all float32.

    ``head`` is bool or uint8, nonzero where a run begins (element 0
    always begins one); every element weighs 1.  ``values`` are one
    float32, bf16 or int8 channel, or two: float32 and float32, or float32
    or bf16, then bf16 or int8 (``HEAD_CASES``); they are upcast to float32 and summed in float32.
    ``count[i]`` is i's position in its run plus 1 and ``mean_c[i]`` the
    mean of ``values[c]`` over the run's head through i, so a run's last
    element holds its mean.  The entry of B1 (``seg_mean_pallas``, the JAX
    package's ``ops/pallas_kernels.py``) that the reduced-precision binned
    mean and the gap average feed through a cumsum or composite key."""
    _check_heads(head, values)
    if not _on_card("seg_mean_heads", (head, *values)):
        return seg_mean_heads_plain(head, *values)
    from specpride_tpu_torch.ops import _build

    lib = _build.load()
    n = head.numel()
    outs = [torch.empty(n, dtype=torch.float32, device=head.device)
            for _ in range(1 + len(values))]
    if n:
        kinds = 0
        for c, v in enumerate(values):
            kinds |= HEAD_KINDS[v.dtype] << (4 * c)
        _launch("seg_mean_heads", lib.seg_mean_heads, lib, head, values,
                outs, kinds)
    return tuple(outs)


SCAN_RUNS = HEADS + (torch.int32,)  # head flags or keys


def _heads(runs: torch.Tensor) -> torch.Tensor:
    if runs.dtype == torch.int32:
        return segments.run_starts(runs)
    return runs != 0


def seg_scan_plain(
    runs: torch.Tensor, *values: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``seg_scan``: float64 within-run prefixes
    (``_prefix64``), cast to float32."""
    _check_args("seg_scan", runs, SCAN_RUNS, values, (1, 2, 3))
    if runs.numel() == 0:
        return tuple(torch.zeros_like(v) for v in values)
    return tuple(
        p.to(torch.float32) for p in _prefix64(_heads(runs), list(values))
    )


def seg_scan(
    runs: torch.Tensor, *values: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Segmented inclusive prefix sums of 1 to 3 float32 channels: element
    i of output c is the sum of ``values[c]`` over i's run, from the run's
    head through i.  Exact for any run length.

    ``runs`` gives the runs either as head flags (bool or uint8, nonzero
    where a run begins; element 0 always begins one) or as sorted int32
    keys (a run per span of equal adjacent keys).  Replaces
    ``specpride_tpu/ops/pallas_kernels.py::seg_scan_pallas`` and the XLA
    ``specpride_tpu/ops/segments.py::seg_scan``."""
    _check_args("seg_scan", runs, SCAN_RUNS, values, (1, 2, 3))
    if not _on_card("seg_scan", (runs, *values)):
        return seg_scan_plain(runs, *values)
    from specpride_tpu_torch.ops import _build

    lib = _build.load()
    outs = [torch.empty_like(v) for v in values]
    if runs.numel():
        entry = (lib.seg_scan_keys_f32 if runs.dtype == torch.int32
                 else lib.seg_scan_flags_f32)
        _launch("seg_scan", entry, lib, runs, values, outs, len(values))
    return tuple(outs)
