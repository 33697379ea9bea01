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

launches = {"seg_mean": 0}


def _check_seg_mean_args(keys, w, values):
    if len(values) not in (1, 2):
        raise ValueError(f"seg_mean takes 1 or 2 value channels, got "
                         f"{len(values)}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    for t in (w, *values):
        if t.dtype != torch.float32:
            raise TypeError(f"w and values must be float32, got {t.dtype}")
    for t in (keys, w, *values):
        if t.dim() != 1 or t.shape != keys.shape:
            raise ValueError(
                f"seg_mean needs 1-D tensors of one length, got "
                f"{[tuple(x.shape) for x in (keys, w, *values)]}"
            )
        if t.device != keys.device:
            raise ValueError("seg_mean inputs lie on different devices")


def seg_mean_plain(
    keys: torch.Tensor, w: torch.Tensor, *values: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``seg_mean``: the within-run prefixes are
    formed in float64, then cast to float32.

    Run ids come from an int64 cumsum of the head flags.  Each run's head
    also subtracts the previous run's total (an ``index_add_``), so one
    global cumsum yields within-run prefixes while every partial sum it
    forms stays at the scale of a run: a plain global cumsum difference
    would carry rounding at the scale of the whole array's sum."""
    _check_seg_mean_args(keys, w, values)
    n = keys.numel()
    if n == 0:
        return tuple(torch.zeros_like(w) for _ in range(1 + len(values)))
    head = segments.run_starts(keys)
    run_id = torch.cumsum(head.to(torch.int64), 0) - 1
    (starts,) = torch.nonzero(head, as_tuple=True)
    w64 = w.to(torch.float64)
    outs = []
    for ch in [w64] + [v.to(torch.float64) * w64 for v in values]:
        totals = torch.zeros(
            starts.numel(), dtype=torch.float64, device=keys.device
        ).index_add_(0, run_id, ch)
        ch = ch.clone()
        ch[starts[1:]] -= totals[:-1]
        outs.append(torch.cumsum(ch, 0))
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
    _check_seg_mean_args(keys, w, values)
    if keys.device.type == "cpu":
        return seg_mean_plain(keys, w, *values)
    if keys.device.type != "cuda":
        raise ValueError(f"seg_mean runs on cuda or cpu, not {keys.device}")
    for t in (keys, w, *values):
        if not t.is_contiguous():
            raise ValueError("seg_mean needs contiguous tensors")
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
