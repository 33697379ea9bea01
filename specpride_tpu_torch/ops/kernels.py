"""Hand-written CUDA kernels and their plain PyTorch versions: the
counterpart of the JAX package's ``ops/pallas_kernels.py``.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  ``launches`` counts kernel
launches per wrapper name, so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes

import torch

from specpride_tpu_torch.ops import segments

launches = {"seg_mean": 0, "seg_scan": 0}


def _check_args(name, runs, run_dtypes, channels, counts) -> None:
    """1-D tensors of one length on one device: ``runs`` of one of
    ``run_dtypes``, and float32 ``channels`` whose number is in
    ``counts``."""
    if len(channels) not in counts:
        raise ValueError(f"{name} takes {'/'.join(map(str, counts))} "
                         f"float32 channels, got {len(channels)}")
    if runs.dtype not in run_dtypes:
        raise TypeError(f"{name} runs must be {run_dtypes}, got "
                        f"{runs.dtype}")
    for t in channels:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} channels must be float32, got "
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
    nv = len(values)
    n = keys.numel()
    dev = keys.device
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(1 + nv)]
    if n == 0:
        return tuple(outs)
    tile = lib.seg_mean_tile_size()
    n_tiles = -(-n // tile)
    tile_first = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tile_sum = torch.empty(n_tiles * (1 + nv), dtype=torch.float32,
                           device=dev)
    v1 = values[1] if nv == 2 else values[0]
    o2 = outs[2] if nv == 2 else outs[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_mean_f32(
            keys.data_ptr(), w.data_ptr(), values[0].data_ptr(),
            v1.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            o2.data_ptr(), ctypes.c_longlong(n), nv, tile_first.data_ptr(),
            tile_sum.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"seg_mean kernel launch failed: cudaError {rc}")
    launches["seg_mean"] += 1
    return tuple(outs)


SCAN_RUNS = (torch.bool, torch.uint8, torch.int32)  # head flags or keys


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
    nc = len(values)
    n = runs.numel()
    dev = runs.device
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(nc)]
    if n == 0:
        return tuple(outs)
    n_tiles = -(-n // lib.seg_scan_tile_size())
    tile_first = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tile_sum = torch.empty(n_tiles * nc, dtype=torch.float32, device=dev)
    ptrs = ctypes.c_void_p * nc
    entry = (lib.seg_scan_keys_f32 if runs.dtype == torch.int32
             else lib.seg_scan_flags_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(
            runs.data_ptr(), ptrs(*(v.data_ptr() for v in values)),
            ptrs(*(o.data_ptr() for o in outs)), ctypes.c_longlong(n), nc,
            tile_first.data_ptr(), tile_sum.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"seg_scan kernel launch failed: cudaError {rc}")
    launches["seg_scan"] += 1
    return tuple(outs)
