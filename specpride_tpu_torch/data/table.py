"""Columnar spectra table: all peaks of all spectra in flat columns with
offset arrays, so that every host stage (grouping, quantization, packing)
is a vectorized numpy pass.  ``SpectraTable.from_clusters`` converts the
``Spectrum``/``Cluster`` objects at the boundary, and takes the rows of
``ClusterView``s (the clusters of a table, ``TableClusters``) straight
from their table."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, NamedTuple, Sequence

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
        stay contiguous.  Views of tables (``ClusterView``) are taken from
        their tables' columns, each run of one table's views at once (its
        rows sliced where their codes run on), and no ``Spectrum`` is
        made."""
        if clusters and all(isinstance(c, ClusterView) for c in clusters):
            parts = [source.take([c.code for c in run])
                     for source, run in itertools.groupby(
                         clusters, key=lambda c: c.source)]
            return parts[0] if len(parts) == 1 else cls.concat(parts)
        spectra: list[Spectrum] = []
        codes: list[int] = []
        for ci, c in enumerate(clusters):
            spectra.extend(c.members)
            codes.extend([ci] * len(c.members))
        table = cls.from_spectra(spectra)
        table.cluster_code = np.asarray(codes, dtype=np.int64)
        table.cluster_names = [c.cluster_id for c in clusters]
        return table

    def slice_rows(self, r0: int, r1: int, cluster_code: np.ndarray,
                   cluster_names: list[str]) -> "SpectraTable":
        """Spectra ``r0:r1`` (views of these columns) under new codes."""
        p0, p1 = int(self.peak_offsets[r0]), int(self.peak_offsets[r1])
        return SpectraTable(
            mz=self.mz[p0:p1], intensity=self.intensity[p0:p1],
            peak_offsets=self.peak_offsets[r0 : r1 + 1] - p0,
            precursor_mz=self.precursor_mz[r0:r1],
            precursor_charge=self.precursor_charge[r0:r1],
            rt=self.rt[r0:r1], titles=self.titles[r0:r1],
            cluster_code=cluster_code, cluster_names=cluster_names,
        )

    def take(self, rows: np.ndarray, cluster_code: np.ndarray,
             cluster_names: list[str]) -> "SpectraTable":
        """Spectra ``rows``, in that order (copies), under new codes."""
        peaks, offsets = ragged_take(self.peak_offsets, rows)
        return SpectraTable(
            mz=self.mz[peaks], intensity=self.intensity[peaks],
            peak_offsets=offsets, precursor_mz=self.precursor_mz[rows],
            precursor_charge=self.precursor_charge[rows], rt=self.rt[rows],
            titles=[self.titles[r] for r in rows.tolist()],
            cluster_code=cluster_code, cluster_names=cluster_names,
        )

    @classmethod
    def concat(cls, tables: Sequence["SpectraTable"]) -> "SpectraTable":
        """The tables one after another, their cluster codes renumbered."""
        peak_base = np.cumsum([0] + [t.mz.size for t in tables])
        code_base = np.cumsum([0] + [t.n_clusters for t in tables])
        return cls(
            mz=np.concatenate([t.mz for t in tables]),
            intensity=np.concatenate([t.intensity for t in tables]),
            peak_offsets=np.concatenate(
                [t.peak_offsets[:-1] + b for t, b in zip(tables, peak_base)]
                + [peak_base[-1:]]).astype(np.int64),
            precursor_mz=np.concatenate([t.precursor_mz for t in tables]),
            precursor_charge=np.concatenate(
                [t.precursor_charge for t in tables]),
            rt=np.concatenate([t.rt for t in tables]),
            titles=[title for t in tables for title in t.titles],
            cluster_code=np.concatenate(
                [t.cluster_code + b for t, b in zip(tables, code_base)]
            ).astype(np.int64),
            cluster_names=[n for t in tables for n in t.cluster_names],
        )

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
    offsets: np.ndarray  # (C+1,) i64: cluster c is order[offsets[c]:...]
    contiguous: bool  # codes never fall: ``order`` is the identity

    @classmethod
    def build(cls, table: SpectraTable) -> "ClusterIndex":
        n_members = np.bincount(
            table.cluster_code, minlength=table.n_clusters
        ).astype(np.int64)
        offsets = np.zeros(table.n_clusters + 1, dtype=np.int64)
        np.cumsum(n_members, out=offsets[1:])
        return cls(
            order=np.argsort(table.cluster_code, kind="stable"),
            n_members=n_members,
            total_peaks=np.bincount(
                table.cluster_code, weights=table.peak_counts,
                minlength=table.n_clusters,
            ).astype(np.int64),
            offsets=offsets,
            contiguous=bool(np.all(table.cluster_code[1:]
                                   >= table.cluster_code[:-1])),
        )

    def members(self, table: SpectraTable, code: int) -> "MemberColumns":
        """Cluster ``code``'s members' precursor columns, in member order
        (views of ``table``'s where its clusters are contiguous)."""
        lo, hi = int(self.offsets[code]), int(self.offsets[code + 1])
        rows = slice(lo, hi) if self.contiguous else self.order[lo:hi]
        return MemberColumns(table.precursor_mz[rows],
                             table.precursor_charge[rows], table.rt[rows])


class MemberColumns(NamedTuple):
    """One cluster's members' precursor m/z, charge and RT, in member
    order: what the consensus reads of its members besides their peaks."""

    precursor_mz: np.ndarray
    precursor_charge: np.ndarray
    rt: np.ndarray


def ragged_take(offsets: np.ndarray, rows: np.ndarray):
    """``(index, new_offsets)`` of taking ``rows`` of a ragged column
    whose row r is ``offsets[r]:offsets[r + 1]``: the elements' index, in
    row order, and the taken rows' offsets."""
    rows = np.asarray(rows, dtype=np.int64)
    counts = offsets[rows + 1] - offsets[rows]
    new = np.zeros(rows.size + 1, dtype=np.int64)
    np.cumsum(counts, out=new[1:])
    index = (np.arange(int(new[-1]), dtype=np.int64)
             + np.repeat(offsets[rows] - new[:-1], counts))
    return index, new


class TableClusters:
    """The clusters of a cluster-contiguous ``SpectraTable`` (cluster
    ``k``'s members are rows ``offsets[k]:offsets[k + 1]``) as
    ``ClusterView``s that read its columns (``clusters()``).
    ``members_of(r0, r1)`` makes the ``Spectrum``s of rows ``r0:r1``, for
    a consumer that asks a view for its members.  The views refer to this
    object and nothing here to them, so no reference cycle holds a table:
    its memory goes with its last view."""

    def __init__(self, table: SpectraTable,
                 members_of: Callable[[int, int], list[Spectrum]]):
        self.table = table
        self.members_of = members_of
        self.offsets = np.zeros(table.n_clusters + 1, dtype=np.int64)
        np.cumsum(np.bincount(table.cluster_code,
                              minlength=table.n_clusters),
                  out=self.offsets[1:])

    def clusters(self) -> list["ClusterView"]:
        return [ClusterView(self, k) for k in range(self.table.n_clusters)]

    def take(self, codes: list[int]) -> SpectraTable:
        """The table of clusters ``codes``, in that order, coded from 0:
        this table itself for all of them, its rows sliced where the codes
        run on, else gathered."""
        table = self.table
        names = [table.cluster_names[c] for c in codes]
        c0, n = codes[0], len(codes)
        if codes == list(range(c0, c0 + n)):
            if n == table.n_clusters:
                return table
            r0, r1 = int(self.offsets[c0]), int(self.offsets[c0 + n])
            return table.slice_rows(r0, r1, table.cluster_code[r0:r1] - c0,
                                    names)
        rows, member_offsets = ragged_take(self.offsets, np.asarray(codes))
        return table.take(rows, np.repeat(np.arange(n, dtype=np.int64),
                                          np.diff(member_offsets)), names)


class ClusterView(Cluster):
    """Cluster ``code`` of a ``TableClusters``: its id, member count and
    peak count read off the table; ``members``, the member ``Spectrum``s,
    made on the first read (``TableClusters.members_of``)."""

    def __init__(self, source: TableClusters, code: int):
        self.source = source
        self.code = code
        self.cluster_id = source.table.cluster_names[code]
        self._members: list[Spectrum] | None = None

    @property
    def members(self) -> list[Spectrum]:
        if self._members is None:
            offsets = self.source.offsets
            self._members = self.source.members_of(
                int(offsets[self.code]), int(offsets[self.code + 1]))
        return self._members

    @property
    def n_members(self) -> int:
        offsets = self.source.offsets
        return int(offsets[self.code + 1] - offsets[self.code])

    @property
    def total_peaks(self) -> int:
        offsets = self.source.offsets
        peaks = self.source.table.peak_offsets
        return int(peaks[offsets[self.code + 1]] - peaks[offsets[self.code]])
