"""Columnar spectra table: all peaks of all spectra in flat columns with
offset arrays, so that every host stage (grouping, quantization, packing)
is a vectorized numpy pass.  ``SpectraTable.from_clusters`` converts the
``Spectrum``/``Cluster`` objects at the boundary."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from specpride_tpu_torch.data.peaks import Cluster, Spectrum, parse_title


@dataclasses.dataclass
class SpectraTable:
    """S spectra / P peaks in flat columns, with per-spectrum cluster codes.

    Spectra keep file order.  ``cluster_code[s]`` indexes
    ``cluster_names``; codes follow first-seen order."""

    mz: np.ndarray  # (P,) f64 — all peaks, spectrum-major
    intensity: np.ndarray  # (P,) f64
    peak_offsets: np.ndarray  # (S+1,) i64
    precursor_mz: np.ndarray  # (S,) f64
    precursor_charge: np.ndarray  # (S,) i32
    rt: np.ndarray  # (S,) f64
    titles: list[str]  # (S,)
    cluster_code: np.ndarray  # (S,) i64 — index into cluster_names
    cluster_names: list[str]

    @property
    def n_spectra(self) -> int:
        return len(self.titles)

    @property
    def n_clusters(self) -> int:
        return len(self.cluster_names)

    @property
    def peak_counts(self) -> np.ndarray:
        """(S,) peaks per spectrum."""
        return np.diff(self.peak_offsets)

    @classmethod
    def from_spectra(cls, spectra: Sequence[Spectrum]) -> "SpectraTable":
        """Build from Spectrum objects, parsing cluster ids from titles."""
        s_count = len(spectra)
        counts = np.fromiter(
            (s.n_peaks for s in spectra), dtype=np.int64, count=s_count
        )
        offsets = np.zeros(s_count + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        if s_count:
            mz = np.concatenate([s.mz for s in spectra])
            inten = np.concatenate([s.intensity for s in spectra])
        else:
            mz = inten = np.zeros(0, np.float64)
        titles = [s.title for s in spectra]
        codes = np.zeros(s_count, dtype=np.int64)
        names: list[str] = []
        index: dict[str, int] = {}
        for i, t in enumerate(titles):
            cid = parse_title(t)[0]
            code = index.get(cid)
            if code is None:
                code = index[cid] = len(names)
                names.append(cid)
            codes[i] = code
        return cls(
            mz=np.ascontiguousarray(mz, dtype=np.float64),
            intensity=np.ascontiguousarray(inten, dtype=np.float64),
            peak_offsets=offsets,
            precursor_mz=np.array(
                [s.precursor_mz for s in spectra], dtype=np.float64
            ),
            precursor_charge=np.array(
                [s.precursor_charge for s in spectra], dtype=np.int32
            ),
            rt=np.array([s.rt for s in spectra], dtype=np.float64),
            titles=titles,
            cluster_code=codes,
            cluster_names=names,
        )

    @classmethod
    def from_clusters(cls, clusters: Sequence[Cluster]) -> "SpectraTable":
        """Build from Cluster objects.  Cluster codes follow the given list
        order (not the titles, which may be absent or disagree); members
        stay contiguous."""
        spectra: list[Spectrum] = []
        codes: list[int] = []
        for ci, c in enumerate(clusters):
            spectra.extend(c.members)
            codes.extend([ci] * len(c.members))
        table = cls.from_spectra(spectra)
        table.cluster_code = np.asarray(codes, dtype=np.int64)
        table.cluster_names = [c.cluster_id for c in clusters]
        return table

    def cluster_order(self) -> "ClusterIndex":
        """Spectrum ordering grouped by cluster + per-cluster extents (one
        stable argsort; cached)."""
        cached = getattr(self, "_cluster_index", None)
        if cached is None:
            cached = ClusterIndex.build(self)
            object.__setattr__(self, "_cluster_index", cached)
        return cached


@dataclasses.dataclass
class ClusterIndex:
    """Vectorized cluster structure over a SpectraTable.

    ``order`` lists spectrum indices grouped by cluster code (stable — file
    order within a cluster)."""

    order: np.ndarray  # (S,) spectrum indices, cluster-grouped
    n_members: np.ndarray  # (C,) members per cluster
    total_peaks: np.ndarray  # (C,) peaks per cluster

    @classmethod
    def build(cls, table: SpectraTable) -> "ClusterIndex":
        return cls(
            order=np.argsort(table.cluster_code, kind="stable"),
            n_members=np.bincount(
                table.cluster_code, minlength=table.n_clusters
            ).astype(np.int64),
            total_peaks=np.bincount(
                table.cluster_code, weights=table.peak_counts,
                minlength=table.n_clusters,
            ).astype(np.int64),
        )
