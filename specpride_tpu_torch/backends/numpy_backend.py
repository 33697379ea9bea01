"""Pure-numpy helpers of the port: the reference's binned cosine of two
spectra (which the precision gate scores with) and the gap-average's
precursor mass and RT estimators.

The port's own trimmed copy of the JAX package's
``backends/numpy_backend.py``; every function reimplements the reference
function it cites.
"""

from __future__ import annotations

import numpy as np

from specpride_tpu_torch.config import CosineConfig, GapAverageConfig
from specpride_tpu_torch.data.peaks import Spectrum
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


# --- precursor-mass / RT estimators
# (ref src/average_spectrum_clustering.py:106-148) -------------------------

def _neutral_masses(members: list[Spectrum]) -> tuple[np.ndarray, np.ndarray]:
    """m*z - z*H per member (ref src/average_spectrum_clustering.py:134-138)."""
    mzs = np.array([s.precursor_mz for s in members])
    charges = np.array([s.precursor_charge for s in members])
    return mzs * charges - charges * PROTON_MASS, charges


def _lower_median_index(values: np.ndarray) -> int:
    """Index of the lower median: sorted rank (n-1)//2
    (ref src/average_spectrum_clustering.py:106-110)."""
    order = np.argsort(values)
    return int(order[(len(values) - 1) // 2])


def naive_average_mass_and_charge(
    members: list[Spectrum],
) -> tuple[float, int]:
    """Mean precursor m/z; all charges must agree
    (ref src/average_spectrum_clustering.py:127-132)."""
    charges = {s.precursor_charge for s in members}
    if len(charges) > 1:
        raise ValueError(
            "There are different charge states in the cluster. "
            "Cannot average precursor m/z."
        )
    return float(np.mean([s.precursor_mz for s in members])), charges.pop()


def neutral_average_mass_and_charge(
    members: list[Spectrum],
) -> tuple[float, int]:
    """Mean neutral mass re-charged at the rounded mean charge
    (ref src/average_spectrum_clustering.py:140-144)."""
    masses, charges = _neutral_masses(members)
    z = int(round(float(np.mean(charges))))
    return (float(np.mean(masses)) + z * PROTON_MASS) / z, z


def lower_median_mass_and_charge(
    members: list[Spectrum],
) -> tuple[float, int]:
    """Lower-median neutral mass, converted back at that member's charge
    (ref src/average_spectrum_clustering.py:112-116)."""
    masses, charges = _neutral_masses(members)
    i = _lower_median_index(masses)
    z = int(charges[i])
    return (float(masses[i]) + z * PROTON_MASS) / z, z


def median_rt(members: list[Spectrum]) -> float:
    """(ref src/average_spectrum_clustering.py:146-148)"""
    return float(np.median([s.rt for s in members]))


def lower_median_mass_rt(members: list[Spectrum]) -> float:
    """RT of the lower-median-mass member
    (ref src/average_spectrum_clustering.py:118-122)."""
    masses, _ = _neutral_masses(members)
    return float(members[_lower_median_index(masses)].rt)


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
