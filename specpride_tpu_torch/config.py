"""Configuration of the binned-mean and gap-average consensus, the medoid
and best-spectrum selection, the bucketized packing, the QC cosine and
the b/y-ion annotation of ``evaluate``.

The port's own copies of ``BinMeanConfig``, ``GapAverageConfig``,
``MedoidConfig``, ``BestSpectrumConfig``, ``CosineConfig``,
``FragmentConfig``, ``BatchConfig`` and the ppm grid formula.  The
field names match the JAX package's, so a config converts with
``BinMeanConfig(**dataclasses.asdict(other))``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np


def ppm_bin_index(mz, min_mz: float, ppm: float):
    """The mass-proportional grid formula
    ``floor(ln(mz / min_mz) / ln(1 + ppm*1e-6))`` in float64, for a
    scalar or an array.  One home for ``BinMeanConfig.n_bins`` (the
    bound) and ``ops.quantize.bin_mean_bins`` (peak quantization), so the
    grid and its bound cannot drift apart."""
    width = np.log1p(ppm * 1e-6)
    mzf = np.maximum(np.asarray(mz, dtype=np.float64), 1e-300)
    return np.floor(np.log(mzf / min_mz) / width).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class BinMeanConfig:
    """Binned-mean consensus (ref src/binning.py:170 combine_bin_mean).

    ``min_mz``/``max_mz``/``bin_size`` reproduce the reference's call
    (100, 2000, 0.02); quorum = int(n_members * quorum_fraction) + 1.
    ``tolerance_mode="ppm"`` swaps the fixed-width grid for
    mass-proportional bins of ``ppm`` parts per million."""

    min_mz: float = 100.0
    max_mz: float = 2000.0
    bin_size: float = 0.02
    apply_peak_quorum: bool = True
    quorum_fraction: float = 0.25
    tolerance_mode: Literal["da", "ppm"] = "da"
    ppm: float = 20.0

    def __post_init__(self):
        if self.tolerance_mode == "ppm":
            if not self.ppm > 0:
                raise ValueError(
                    f"tolerance_mode='ppm' needs ppm > 0, got {self.ppm}"
                )
            if not self.min_mz > 0:
                raise ValueError(
                    "tolerance_mode='ppm' needs min_mz > 0 (the grid is "
                    f"logarithmic in mz/min_mz), got {self.min_mz}"
                )
        elif not self.bin_size > 0:
            raise ValueError(f"bin_size must be > 0, got {self.bin_size}")
        if not self.max_mz > self.min_mz:
            raise ValueError(
                f"max_mz ({self.max_mz}) must exceed min_mz ({self.min_mz})"
            )

    @property
    def n_bins(self) -> int:
        if self.tolerance_mode == "ppm":
            return int(ppm_bin_index(self.max_mz, self.min_mz, self.ppm)) + 1
        # ref src/binning.py:172: int((max-min)/binsize) + 1
        return int((self.max_mz - self.min_mz) / self.bin_size) + 1


@dataclasses.dataclass(frozen=True)
class GapAverageConfig:
    """Gap-clustered average consensus
    (ref src/average_spectrum_clustering.py:21-23,26-103).

    ``tail_mode="reference"`` reproduces the reference loop over
    ``ind_list[1:-1]`` (ref :79-87), which ignores a cluster's final m/z
    gap when it has two or more, merging its last two groups; ``"split"``
    honours every gap."""

    mz_accuracy: float = 0.01
    dyn_range: float = 1000.0
    min_fraction: float = 0.5
    tail_mode: Literal["reference", "split"] = "reference"
    pepmass: Literal["naive_average", "neutral_average", "lower_median"] = (
        "lower_median"
    )
    rt: Literal["median", "mass_lower_median"] = "median"


@dataclasses.dataclass(frozen=True)
class MedoidConfig:
    """Most-similar (medoid) representative
    (ref src/most_similar_representative.py:13-19,60-111).

    Similarity is an occupancy-grid binned dot product normalised by the
    smaller raw peak count, the capability pyOpenMS
    ``XQuestScores::xCorrelationPrescore(spec1, spec2, 0.1)`` supplies at
    ref src/most_similar_representative.py:15; ``bin_size`` is that 0.1 Da
    literal.  Bin index is ``floor(mz / bin_size)`` (truncation)."""

    bin_size: float = 0.1


@dataclasses.dataclass(frozen=True)
class BestSpectrumConfig:
    """Best-PSM-score representative (ref src/best_spectrum.py:43-100).

    ``px_accession`` replaces the hardcoded ``mzspec:PXD004732:`` prefix
    (ref src/best_spectrum.py:61-62)."""

    px_accession: str = "PXD004732"
    raw_suffix: str = ".raw"


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Bucketing of ragged clusters into (B, K) packed batches
    (``data.packed.pack_bucketize``): K from ``total_peak_buckets`` by a
    cluster's total peak count, M from ``member_buckets`` by its member
    count, at most ``clusters_per_batch`` clusters per batch (which bounds
    the host memory of one batch)."""

    member_buckets: tuple[int, ...] = (32, 128)
    total_peak_buckets: tuple[int, ...] = (2048, 8192, 32768)
    clusters_per_batch: int = 1024


@dataclasses.dataclass(frozen=True)
class CosineConfig:
    """Binned-cosine quality metric (ref src/benchmark.py:8-29).

    ``mz_unit``/``mz_space`` reproduce ref src/benchmark.py:8-9: bins of
    ~0.005 Da on a grid starting at -mz_space/2.  ``normalization`` is the
    intensity transform before binning: identity, ``sqrt`` (tempers
    dominant peaks) or ``log`` (log1p, flattens dynamic range)."""

    mz_unit: float = 1.000508
    mz_space_factor: float = 0.005
    normalization: Literal["none", "sqrt", "log"] = "none"

    @property
    def mz_space(self) -> float:
        return self.mz_unit * self.mz_space_factor


@dataclasses.dataclass(frozen=True)
class FragmentConfig:
    """b/y-ion annotation (ref src/benchmark.py:40-61 fraction_of_by).

    50 ppm tolerance and the [100, 1400] m/z preprocessing window reproduce
    ref src/benchmark.py:47-52.
    """

    tol: float = 50.0
    tol_mode: Literal["ppm", "Da"] = "ppm"
    min_mz: float = 100.0
    max_mz: float = 1400.0
    ion_types: str = "by"
