"""Host-side float64 m/z quantization to grid bins, and the QC cosine's
intensity transform and grid edge count.

The reference quantizes m/z on a float64 grid
(``((mz - min)/binsize).astype(int)``, ref src/binning.py:195); doing it
in float32 on the card would move peaks across bin edges.  So the grid
is computed here on the host and the card receives integer bins.
"""

from __future__ import annotations

import numpy as np

from specpride_tpu_torch.config import (
    BinMeanConfig,
    CosineConfig,
    ppm_bin_index,
)


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


def cosine_normalize(intensity: np.ndarray, config: CosineConfig) -> np.ndarray:
    """Intensity transform before cosine binning: identity, sqrt, or
    log1p, in float64 for the two transforms."""
    if config.normalization == "sqrt":
        return np.sqrt(np.asarray(intensity, dtype=np.float64))
    if config.normalization == "log":
        return np.log1p(np.asarray(intensity, dtype=np.float64))
    return intensity


def cosine_edge_count(last_mz, space):
    """Edge count of the metric grid ``arange(-space/2, last_mz, space)``
    (numpy arange length = ceil((stop - start)/step)), float64; 0 for a
    non-finite ``last_mz`` (an empty spectrum's -inf)."""
    n = np.ceil((np.asarray(last_mz, dtype=np.float64) + space / 2.0) / space)
    return np.where(np.isfinite(n), np.maximum(n, 0), 0).astype(np.int32)
