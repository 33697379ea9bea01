"""Host-side peak data model: ``Spectrum`` and ``Cluster``.

Title convention of the clustered-MGF interchange format:
``TITLE=<cluster_id>;<usi>`` where the USI is
``mzspec:<PX>:<raw>:scan:<n>[:<PEPTIDE>/<z>]``.  Consensus spectra carry
a bare cluster id.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


def parse_title(title: str) -> tuple[str, str]:
    """Split an MGF TITLE into (cluster_id, usi) on the first ';'
    (ref src/binning.py:143-144).  A title without ';' is a bare cluster
    id with an empty USI."""
    cluster_id, _, usi = title.partition(";")
    return cluster_id, usi


def build_title(
    cluster_id: str,
    px_accession: str,
    raw_name: str,
    scan: int,
    peptide: str | None = None,
    charge: int | None = None,
) -> str:
    """Build the clustered-MGF TITLE (ref src/convert_mgf_cluster.py:14-18)."""
    usi = f"mzspec:{px_accession}:{raw_name}:scan:{scan}"
    if peptide is not None:
        usi = f"{usi}:{peptide}/{charge}"
    return f"{cluster_id};{usi}"


def scan_from_usi(usi: str) -> int | None:
    """Extract the scan number from a USI, or None if absent."""
    parts = usi.split(":")
    for i, part in enumerate(parts):
        if part == "scan" and i + 1 < len(parts):
            try:
                return int(parts[i + 1])
            except ValueError:
                return None
    return None


def peptide_from_usi(usi: str) -> tuple[str | None, int | None]:
    """Extract (peptide, charge) from a USI interpretation suffix, if any."""
    parts = usi.split(":")
    if len(parts) >= 6 and "/" in parts[-1]:
        pep, _, z = parts[-1].rpartition("/")
        try:
            return pep, int(z)
        except ValueError:
            return None, None
    return None, None


@dataclasses.dataclass
class Spectrum:
    """One MS/MS spectrum: parallel m/z / intensity arrays + precursor info."""

    mz: np.ndarray
    intensity: np.ndarray
    precursor_mz: float = 0.0
    precursor_charge: int = 0
    rt: float = 0.0
    title: str = ""
    extra: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.mz = np.asarray(self.mz, dtype=np.float64)
        self.intensity = np.asarray(self.intensity, dtype=np.float64)
        if self.mz.shape != self.intensity.shape:
            raise ValueError(
                f"mz and intensity must have equal length, got "
                f"{self.mz.shape} vs {self.intensity.shape}"
            )

    @property
    def n_peaks(self) -> int:
        return int(self.mz.size)

    @property
    def cluster_id(self) -> str:
        return parse_title(self.title)[0]

    @property
    def usi(self) -> str:
        return parse_title(self.title)[1]


@dataclasses.dataclass
class Cluster:
    """A cluster of member spectra sharing a cluster id."""

    cluster_id: str
    members: list[Spectrum]

    @property
    def n_members(self) -> int:
        return len(self.members)

    @property
    def total_peaks(self) -> int:
        return sum(s.n_peaks for s in self.members)


def group_into_clusters(spectra: Iterable[Spectrum]) -> list[Cluster]:
    """Group spectra by the cluster id in their titles, keeping first-seen
    cluster order and in-file member order (ref src/binning.py:159-165)."""
    by_id: dict[str, list[Spectrum]] = {}
    for s in spectra:
        by_id.setdefault(s.cluster_id, []).append(s)
    return [Cluster(cid, members) for cid, members in by_id.items()]
