"""Pure-numpy helpers of the port: the reference's binned cosine of two
spectra (which the precision gate scores with) and its mean over a
cluster (``metrics.evaluate(backend="numpy")``), the gap-average's
precursor mass and RT estimators, and the medoid and best-spectrum
selections per cluster (the oracle the tests and the smoke hold the
card's picks to; ``run_best_spectrum`` is also the port's only
best-spectrum path).

The port's own trimmed copy of the JAX package's
``backends/numpy_backend.py``; every function reimplements the reference
function it cites.
"""

from __future__ import annotations

import numpy as np

from specpride_tpu_torch.config import (
    BestSpectrumConfig,
    CosineConfig,
    GapAverageConfig,
    MedoidConfig,
)
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.data.table import MemberColumns
from specpride_tpu_torch.observability import tracing
from specpride_tpu_torch.ops import quantize

PROTON_MASS = 1.00727646677


def binned_cosine(
    a: Spectrum, b: Spectrum, config: CosineConfig = CosineConfig()
) -> float:
    """Cosine similarity of two spectra on a shared ~0.005 Da grid
    (ref src/benchmark.py:11-29): bin edges ``arange(-mz_space/2, max_mz,
    mz_space)`` where max_mz is the larger LAST m/z of the pair; peaks at
    or beyond the last edge are excluded, as scipy ``binned_statistic``
    does.  Zero-norm inputs score 0 (ref :26-27)."""
    if a.n_peaks == 0 or b.n_peaks == 0:
        return 0.0
    space = config.mz_space
    max_mz = max(a.mz[-1], b.mz[-1])
    edges = np.arange(-space / 2.0, max_mz, space)
    if edges.size < 2:
        return 0.0

    def binned(s: Spectrum) -> np.ndarray:
        vec = np.zeros(edges.size - 1)
        idx = np.floor((s.mz - edges[0]) / space).astype(np.int64)
        ok = (s.mz >= edges[0]) & (s.mz <= edges[-1])
        # values equal to the last edge fall into the final bin
        idx = np.where(idx == edges.size - 1, edges.size - 2, idx)
        weights = quantize.cosine_normalize(s.intensity, config)
        np.add.at(vec, idx[ok], weights[ok])
        return vec

    va, vb = binned(a), binned(b)
    na, nb = float(va @ va), float(vb @ vb)
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(va @ vb) / np.sqrt(na * nb)


def average_cosine(
    representative: Spectrum,
    members: list[Spectrum],
    config: CosineConfig = CosineConfig(),
) -> float:
    """Mean binned cosine of a representative to the cluster members
    (ref src/benchmark.py:31-38); empty member list scores 0."""
    if not members:
        return 0.0
    return float(
        np.mean([binned_cosine(representative, m, config) for m in members])
    )


# --- precursor-mass / RT estimators
# (ref src/average_spectrum_clustering.py:106-148) -------------------------
# Each takes a cluster's members: a list of ``Spectrum``s, or their
# precursor columns (``MemberColumns``, rows of the consensus's
# ``SpectraTable``), which give the same float64 values in the same order.

def _member_columns(members) -> MemberColumns:
    if isinstance(members, MemberColumns):
        return members
    return MemberColumns(np.array([s.precursor_mz for s in members]),
                         np.array([s.precursor_charge for s in members]),
                         np.array([s.rt for s in members]))


def _neutral_masses(members) -> tuple[np.ndarray, np.ndarray]:
    """m*z - z*H per member (ref src/average_spectrum_clustering.py:134-138)."""
    cols = _member_columns(members)
    mzs, charges = cols.precursor_mz, cols.precursor_charge
    return mzs * charges - charges * PROTON_MASS, charges


def _lower_median_index(values: np.ndarray) -> int:
    """Index of the lower median: sorted rank (n-1)//2
    (ref src/average_spectrum_clustering.py:106-110)."""
    order = np.argsort(values)
    return int(order[(len(values) - 1) // 2])


def naive_average_mass_and_charge(members) -> tuple[float, int]:
    """Mean precursor m/z; all charges must agree
    (ref src/average_spectrum_clustering.py:127-132)."""
    cols = _member_columns(members)
    charges = np.unique(cols.precursor_charge)
    if len(charges) > 1:
        raise ValueError(
            "There are different charge states in the cluster. "
            "Cannot average precursor m/z."
        )
    return float(np.mean(cols.precursor_mz)), int(charges[0])


def neutral_average_mass_and_charge(members) -> tuple[float, int]:
    """Mean neutral mass re-charged at the rounded mean charge
    (ref src/average_spectrum_clustering.py:140-144)."""
    masses, charges = _neutral_masses(members)
    z = int(round(float(np.mean(charges))))
    return (float(np.mean(masses)) + z * PROTON_MASS) / z, z


def lower_median_mass_and_charge(members) -> tuple[float, int]:
    """Lower-median neutral mass, converted back at that member's charge
    (ref src/average_spectrum_clustering.py:112-116)."""
    masses, charges = _neutral_masses(members)
    i = _lower_median_index(masses)
    z = int(charges[i])
    return (float(masses[i]) + z * PROTON_MASS) / z, z


def median_rt(members) -> float:
    """(ref src/average_spectrum_clustering.py:146-148)"""
    return float(np.median(_member_columns(members).rt))


def lower_median_mass_rt(members) -> float:
    """RT of the lower-median-mass member
    (ref src/average_spectrum_clustering.py:118-122)."""
    masses, _ = _neutral_masses(members)
    return float(_member_columns(members).rt[_lower_median_index(masses)])


PEPMASS_ESTIMATORS = {
    "naive_average": naive_average_mass_and_charge,
    "neutral_average": neutral_average_mass_and_charge,
    "lower_median": lower_median_mass_and_charge,
}
RT_ESTIMATORS = {
    "median": median_rt,
    "mass_lower_median": lower_median_mass_rt,
}


def resolve_gap_estimators(config: GapAverageConfig):
    """(pepmass_fn, rt_fn) for a GapAverageConfig, including the coupled
    rule that lower_median pepmass forces the lower-median-mass member's RT
    (ref src/average_spectrum_clustering.py:190-191)."""
    rt_mode = config.rt
    if config.pepmass == "lower_median":
        rt_mode = "mass_lower_median"
    return PEPMASS_ESTIMATORS[config.pepmass], RT_ESTIMATORS[rt_mode]


# --- medoid representative
# (ref src/most_similar_representative.py:13-19,87-111) ---------------------

def xcorr_prescore(s1: Spectrum, s2: Spectrum, bin_size: float = 0.1) -> float:
    """Occupancy-grid binned dot product normalised by the smaller raw peak
    count, the capability of OpenMS ``XQuestScores::xCorrelationPrescore``
    used at ref src/most_similar_representative.py:15.  Bin index is
    ``floor(mz / bin_size)``; each occupied bin counts 1 however many peaks
    fall in it.  Empty spectra score 0."""
    if s1.n_peaks == 0 or s2.n_peaks == 0:
        return 0.0
    b1 = np.unique((s1.mz / bin_size).astype(np.int64))
    b2 = np.unique((s2.mz / bin_size).astype(np.int64))
    shared = np.intersect1d(b1, b2, assume_unique=True).size
    return float(shared) / min(s1.n_peaks, s2.n_peaks)


def xcorr_distance(s1: Spectrum, s2: Spectrum, bin_size: float = 0.1) -> float:
    """1 - xcorr (ref src/most_similar_representative.py:13-16)."""
    return 1.0 - xcorr_prescore(s1, s2, bin_size)


def medoid_index(
    members: list[Spectrum], config: MedoidConfig = MedoidConfig()
) -> int:
    """Index of the member with minimal total distance to all others.

    The reference fills an upper triangular matrix including the diagonal
    and sums row i + column i, so the self-distance counts twice; ties go
    to the lowest index (ref src/most_similar_representative.py:88-110).
    A singleton returns 0 (ref :79-81)."""
    n = len(members)
    if n == 0:
        raise ValueError("empty cluster")
    if n == 1:
        return 0
    dist = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            dist[i, j] = xcorr_distance(members[i], members[j], config.bin_size)
    sym = dist + dist.T  # row_i + col_i of the triangular fill, diag twice
    total = sym.sum(axis=1) / n
    return int(np.argmin(total))  # np.argmin: first (lowest-index) minimum


# --- best-spectrum representative (ref src/best_spectrum.py:67-100) --------

def _normalize_usi(usi: str) -> str:
    """Empty USI fields collapsed and any interpretation suffix dropped, so
    the scores join matches on (collection, run, scan): the reference
    builds score USIs with a double colon (``...raw::scan:N``, ref
    src/best_spectrum.py:61-62) while its converter writes single-colon
    USIs (ref src/convert_mgf_cluster.py:15)."""
    parts = [p for p in usi.split(":") if p != ""]
    if "scan" in parts:
        k = parts.index("scan")
        parts = parts[: k + 2]  # drop the :PEPTIDE/z suffix
    return ":".join(parts)


def best_spectrum_index(
    members: list[Spectrum],
    scores: dict[str, float],
    config: BestSpectrumConfig = BestSpectrumConfig(),
) -> int:
    """Index of the member with the highest PSM score; among tied maxima
    the lexicographically smallest (normalised) USI, as pandas ``idxmax``
    over the USI-sorted series of ref src/best_spectrum.py:64 picks.
    Raises ValueError when no member has a score (ref :98-99)."""
    return _best_index(members, _normalized_scores(scores))


def _normalized_scores(scores: dict[str, float]) -> dict[str, float]:
    return {_normalize_usi(k): v for k, v in scores.items()}


def _best_index(members: list[Spectrum], norm_scores: dict[str, float]) -> int:
    best_i: int | None = None
    best: tuple[float, str] | None = None
    for i, s in enumerate(members):
        usi = _normalize_usi(s.usi)
        if usi not in norm_scores:
            continue
        key = (-norm_scores[usi], usi)
        if best is None or key < best:
            best = key
            best_i = i
    if best_i is None:
        raise ValueError("No scores found for the given scan numbers")
    return best_i


@tracing.traced("method:medoid", backend="numpy")
def run_medoid(
    clusters: list[Cluster], config: MedoidConfig = MedoidConfig()
) -> list[Spectrum]:
    """Per-cluster loop of ref src/most_similar_representative.py:60-111."""
    return [c.members[medoid_index(c.members, config)] for c in clusters]


@tracing.traced("method:best", backend="numpy")
def run_best_spectrum(
    clusters: list[Cluster],
    scores: dict[str, float],
    config: BestSpectrumConfig = BestSpectrumConfig(),
) -> list[Spectrum]:
    """The best-scored member of each cluster; clusters without a scored
    member are dropped (ref src/best_spectrum.py:170-174).  The score
    USIs are normalised once for all clusters, not once per cluster."""
    norm_scores = _normalized_scores(scores)
    out = []
    for c in clusters:
        try:
            out.append(c.members[_best_index(c.members, norm_scores)])
        except ValueError:
            pass
    return out
