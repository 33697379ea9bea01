"""Host-side float64 m/z quantization to grid bins, the QC cosine's
intensity transform and grid edge count, and the reduced-precision
encoders of the packed channels (``--precision``).

The reference quantizes m/z on a float64 grid
(``((mz - min)/binsize).astype(int)``, ref src/binning.py:195); doing it
in float32 on the card would move peaks across bin edges.  So the grid
is computed here on the host and the card receives integer bins.
"""

from __future__ import annotations

import numpy as np
import torch

from specpride_tpu_torch.config import (
    BinMeanConfig,
    CosineConfig,
    MedoidConfig,
    ppm_bin_index,
)

MEDOID_SENTINEL = 2**30  # medoid bin of a padding slot


def bin_mean_bins(
    mz: np.ndarray, config: BinMeanConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Grid quantization in float64: ``(bins64, in_range)``.

    * ``"da"``: ``((mz - min_mz) / bin_size).astype(int64)``;
    * ``"ppm"``: ``floor(ln(mz / min_mz) / ln(1 + ppm*1e-6))``.

    ``in_range`` is the reference's ``[min_mz, max_mz)`` window; bins of
    out-of-range peaks are whatever the formula yields and must be masked
    by the caller."""
    mzf = np.asarray(mz, dtype=np.float64)
    in_range = (mzf >= config.min_mz) & (mzf < config.max_mz)
    if config.tolerance_mode == "ppm":
        bins = ppm_bin_index(mzf, config.min_mz, config.ppm)
    else:
        bins = ((mzf - config.min_mz) / config.bin_size).astype(np.int64)
    return bins, in_range


def medoid_bins_packed(batch, config: MedoidConfig) -> np.ndarray:
    """(B, K) int32 global occupancy-grid bins of a ``PackedBatch``:
    ``floor(mz / bin_size)`` in float64 (truncation), clipped to
    [0, 2^30), with ``MEDOID_SENTINEL`` in padding slots.  Pairwise shared
    bin counts do not depend on a per-cluster origin, so none is taken."""
    valid = batch.member_id >= 0
    bins = (batch.mz64 / config.bin_size).astype(np.int64)
    sent = np.int64(MEDOID_SENTINEL)
    return np.where(valid, np.clip(bins, 0, sent - 1), sent).astype(np.int32)


def cosine_normalize(intensity: np.ndarray, config: CosineConfig) -> np.ndarray:
    """Intensity transform before cosine binning: identity, sqrt, or
    log1p, in float64 for the two transforms."""
    if config.normalization == "sqrt":
        return np.sqrt(np.asarray(intensity, dtype=np.float64))
    if config.normalization == "log":
        return np.log1p(np.asarray(intensity, dtype=np.float64))
    return intensity


def cosine_bins(
    mz: np.ndarray, valid: np.ndarray, config: CosineConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Cosine-grid bins of (..., P) peaks and each spectrum's edge count,
    in float64, for the bucketized cosine: ``bins`` int32
    ``floor((mz + space/2) / space)``, 2^30 where not ``valid`` (so it
    sorts last); the edge count off the LAST valid peak's m/z (ref
    src/benchmark.py:20 takes ``mz[-1]``), 0 without one."""
    space = config.mz_space
    mzf = mz.astype(np.float64)
    bins = np.floor((mzf + space / 2.0) / space).astype(np.int64)
    sentinel = np.int32(2**30)
    bins = np.where(valid, np.clip(bins, 0, sentinel - 1), sentinel)
    n_valid = valid.sum(axis=-1)
    last_idx = np.maximum(n_valid - 1, 0)
    last_mz = np.take_along_axis(mzf, last_idx[..., None], axis=-1)[..., 0]
    last_mz = np.where(n_valid > 0, last_mz, -np.inf)
    return bins.astype(np.int32), cosine_edge_count(last_mz, space)


def cosine_edge_count(last_mz, space):
    """Edge count of the metric grid ``arange(-space/2, last_mz, space)``
    (numpy arange length = ceil((stop - start)/step)), float64; 0 for a
    non-finite ``last_mz`` (an empty spectrum's -inf)."""
    n = np.ceil((np.asarray(last_mz, dtype=np.float64) + space / 2.0) / space)
    return np.where(np.isfinite(n), np.maximum(n, 0), 0).astype(np.int32)


# ---------------------------------------------------------------------------
# Reduced-precision packed encodings (--precision {f32,bf16,int8})
# ---------------------------------------------------------------------------
#
# The consensus channels shipped to the card are encoded on the host at
# pack time, so fewer bytes cross to the card; the kernels upcast to f32 in
# registers.  The QC cosine always runs in f32: it is the judge of the
# precision gate.  f32 is the default and every encoder is an identity
# there.  bf16 codes are kept on the host as int16 bit patterns (numpy has
# no bfloat16); ``bf16_bits`` casts through ``torch.bfloat16``, which rounds
# to nearest even as the JAX package's cast does.

PRECISIONS = ("f32", "bf16", "int8")

# minimum rep-vs-f32 binned cosine the gate requires of a reduced run
# (cli precision gate).  int8 stores intensity as 7-bit codes against a
# per-cluster scale (relative error <= 1/254 of the row max), bf16 keeps 8
# mantissa bits (<= 2^-9 relative); the bounds leave an order of magnitude
# of slack over the drift the JAX package measured.
PRECISION_MIN_COSINE: dict[tuple[str, str], float] = {
    ("bin-mean", "bf16"): 0.9995,
    ("bin-mean", "int8"): 0.995,
    ("gap-average", "bf16"): 0.9995,
    ("gap-average", "int8"): 0.995,
    ("medoid", "bf16"): 0.999,
    ("medoid", "int8"): 0.999,
}


def precision_tolerance(method: str, precision: str) -> float:
    """Minimum gate cosine for (method, precision); f32 demands exact."""
    if precision == "f32":
        return 1.0
    return PRECISION_MIN_COSINE.get((method, precision), 0.995)


def bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest even), as int16 bit
    patterns."""
    x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return x.to(torch.bfloat16).view(torch.int16).numpy()


def bf16_values(bits: np.ndarray) -> np.ndarray:
    """float32 values of bfloat16 bit patterns (exact)."""
    wide = np.asarray(bits).view(np.uint16).astype(np.uint32) << 16
    return wide.view(np.float32)


def bf16_exact(arr: np.ndarray) -> bool:
    """True when every value round-trips f32 -> bf16 -> f32 exactly: the
    pack-time probe that lets m/z ship as bf16 only where nothing is
    lost."""
    a = np.asarray(arr, dtype=np.float32)
    return bool(np.array_equal(bf16_values(bf16_bits(a)), a))


def encode_mz(mz: np.ndarray, precision: str) -> tuple[np.ndarray, str]:
    """``(encoded, token)`` for a packed m/z channel: bf16 bit patterns
    only when the round trip is exact (token "bf16"), else the f32 input
    (token "f32").  f32 precision is an identity."""
    if precision == "f32" or not bf16_exact(mz):
        return np.asarray(mz, dtype=np.float32), "f32"
    return bf16_bits(mz), "bf16"


def encode_intensity_rows(
    intensity: np.ndarray, precision: str
) -> tuple[np.ndarray, np.ndarray | None]:
    """Encode a (B, K) bucketized intensity channel: ``(codes, scale)``
    as ``encode_intensity_flat`` does, each row a cluster: f32 the
    identity; bf16 bit patterns; int8 per-row codes ``round(x / scale)``,
    ``scale = rowmax / 127``, the scale kept on the host."""
    x = np.asarray(intensity, dtype=np.float32)
    if precision == "f32":
        return x, None
    if precision == "bf16":
        return bf16_bits(x), None
    if precision != "int8":
        raise ValueError(f"unknown precision {precision!r}")
    rowmax = np.abs(x).max(axis=-1)
    scale = np.where(rowmax > 0, rowmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(
        np.round(x / scale[..., None]), -127, 127
    ).astype(np.int8)
    return codes, scale


def encode_intensity_flat(
    intensity: np.ndarray, row_offsets: np.ndarray, precision: str
) -> tuple[np.ndarray, np.ndarray | None]:
    """Encode a flat intensity channel whose cluster rows are the
    ``row_offsets`` (len rows + 1) slices.  Returns ``(codes, scale)``:

    * f32: identity, scale None;
    * bf16: bf16 bit patterns, scale None;
    * int8: per-row symmetric 7-bit codes ``round(x / scale)`` with
      ``scale = rowmax / 127`` (f32, one per cluster).  The scale never
      ships: means are linear, so the host rescales the fetched means."""
    x = np.asarray(intensity, dtype=np.float32)
    if precision == "f32":
        return x, None
    if precision == "bf16":
        return bf16_bits(x), None
    if precision != "int8":
        raise ValueError(f"unknown precision {precision!r}")
    rows = row_offsets.size - 1
    if x.size:
        rowmax = np.maximum.reduceat(
            np.abs(np.append(x, np.float32(0.0))),
            np.minimum(row_offsets[:-1], x.size),
        )[:rows]
        # empty rows repeat a neighbour's start; force their max to 0
        rowmax = np.where(np.diff(row_offsets) > 0, rowmax, 0.0)
    else:
        rowmax = np.zeros(rows, dtype=np.float32)
    scale = np.where(rowmax > 0, rowmax / 127.0, 1.0).astype(np.float32)
    per_elem = np.repeat(scale, np.diff(row_offsets))
    codes = np.clip(np.round(x / per_elem), -127, 127).astype(np.int8)
    return codes, scale


def narrow_i32_to_i16(
    arr: np.ndarray, max_valid: int, sentinel: int | None = None
) -> np.ndarray | None:
    """int16 copy of an int32 index channel, or None when it cannot narrow
    losslessly.  ``max_valid`` is the largest real value the channel
    carries; values above it (the int32 sentinel) map to ``sentinel``
    (default int16 max).  Narrowing is exact, so the only failure is a
    grid too large for int16, and the caller then ships int32."""
    if max_valid >= 2**15 - 1:
        return None
    a = np.asarray(arr)
    sent = np.int16(2**15 - 1 if sentinel is None else sentinel)
    return np.where(a > max_valid, sent, a).astype(np.int16)


def codes_tensor(codes: np.ndarray) -> torch.Tensor:
    """A packed channel as the tensor its kernel takes: float32 and int8
    as they are, bf16 bit patterns (int16) as ``torch.bfloat16``."""
    t = torch.from_numpy(np.ascontiguousarray(codes))
    return t.view(torch.bfloat16) if t.dtype == torch.int16 else t
