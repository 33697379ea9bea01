"""Flat packing of clusters for the binned-mean kernel.

Every kept peak of every cluster lies along ONE axis, sorted by
(cluster, bin): the host quantizes m/z on the float64 grid, drops
duplicate (member, bin) peaks (the reference's buffered ``+=``
semantics, ref src/binning.py:197-199) and sorts, so the card only runs
the segmented reduction.  All passes are vectorized numpy over a
``SpectraTable``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from specpride_tpu_torch.data.table import SpectraTable
from specpride_tpu_torch.ops import quantize
from specpride_tpu_torch.ops.segsort import seg_argsort

SENTINEL = 2**31 - 1  # gbin of a padding slot: past every real composite


def _as_table(clusters_or_table) -> SpectraTable:
    if isinstance(clusters_or_table, SpectraTable):
        return clusters_or_table
    return SpectraTable.from_clusters(clusters_or_table)


def _grouped_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (vectorized ragged arange)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def _dedup_keep_mask(
    spec_of_peak: np.ndarray,  # (P,) i64 spectrum id per peak
    bins: np.ndarray,  # (P,) i64, -1 = out of range
    mz: np.ndarray,  # (P,) f64 — sortedness probe for the fast path
) -> np.ndarray:
    """Keep-mask: last occurrence of each (spectrum, bin) pair in array
    order, matching numpy's buffered fancy-index ``+=`` semantics.

    Fast path: when every spectrum's m/z is non-decreasing (the MGF norm),
    duplicate bins are consecutive, so one vector compare suffices.
    Otherwise a (spectrum, bin, position) lexsort marks last occurrences."""
    p = bins.size
    if p == 0:
        return np.zeros(0, dtype=bool)
    same_spec = spec_of_peak[1:] == spec_of_peak[:-1]
    if not (same_spec & (mz[1:] < mz[:-1])).any():
        consecutive_dup = same_spec & (bins[1:] == bins[:-1]) & (bins[1:] >= 0)
        keep = np.ones(p, dtype=bool)
        keep[:-1] &= ~consecutive_dup
        return keep
    order = np.lexsort((np.arange(p), bins, spec_of_peak))
    sb = bins[order]
    ss = spec_of_peak[order]
    last = np.ones(p, dtype=bool)
    last[:-1] = (sb[1:] != sb[:-1]) | (ss[1:] != ss[:-1])
    keep = np.zeros(p, dtype=bool)
    keep[order] = last
    return keep


def _bin_quantize_dedup(table: SpectraTable, config):
    """f64 quantization, range filter and duplicate-(member, bin) drop.
    Returns (bins64, kept_src, kept_counts, kept_offsets, kept_totals)."""
    mz = table.mz
    n_bins = config.n_bins
    bins64, in_range = quantize.bin_mean_bins(mz, config)
    bins64 = np.where(in_range, np.clip(bins64, 0, n_bins - 1), -1)
    spec_of_peak = np.repeat(
        np.arange(table.n_spectra, dtype=np.int64), table.peak_counts
    )
    keep = _dedup_keep_mask(spec_of_peak, bins64, mz) & in_range

    kept_counts = np.bincount(
        spec_of_peak[keep], minlength=table.n_spectra
    ).astype(np.int64)
    kept_offsets = np.zeros(table.n_spectra + 1, dtype=np.int64)
    np.cumsum(kept_counts, out=kept_offsets[1:])
    kept_src = np.flatnonzero(keep)  # kept-peak -> original peak

    kept_totals = np.bincount(
        table.cluster_code, weights=kept_counts, minlength=table.n_clusters
    ).astype(np.int64)
    return bins64, kept_src, kept_counts, kept_offsets, kept_totals


@dataclasses.dataclass
class FlatBinBatch:
    """One chunk of the flat layout: kept peaks sorted by (cluster, bin).

    ``gbin`` composites (local_row, bin) into one int32 so the kernel
    needs no separate row channel: ``local_row * (n_bins + 1) + bin``,
    with ``SENTINEL`` for padding.  Rows are chunk-local, and a chunk
    holds few enough rows that the composite fits int32."""

    mz: np.ndarray  # (N,) f32, sorted by (cluster, bin)
    intensity: np.ndarray  # (N,) f32, same order
    gbin: np.ndarray  # (N,) i32 composite
    n_members: np.ndarray  # (rows,) i32
    n_distinct_total: int  # number of (row, bin) runs in this chunk
    run_starts: np.ndarray  # (R,) i64 run-start positions within the chunk
    cluster_ids: list[str]
    source_indices: list[int]


def flat_batch_from_arrays(fields: dict) -> FlatBinBatch:
    """Build a ``FlatBinBatch`` from the numpy fields of a flat batch
    packed elsewhere (``dataclasses.asdict`` of the JAX package's
    ``FlatBinBatch``): the state the two packages hand their kernels.
    The reduced-precision fields (``precision``, ``codes``, ``scale``)
    must be absent or at their f32 defaults."""
    extra = set(fields) - {f.name for f in dataclasses.fields(FlatBinBatch)}
    unknown = extra - {"precision", "codes", "scale"}
    if unknown:
        raise ValueError(f"unknown flat batch fields {sorted(unknown)}")
    if fields.get("precision", "f32") != "f32":
        raise ValueError(
            f"flat batch precision {fields['precision']!r} is not "
            f"supported: only the f32 layout is ported"
        )
    return FlatBinBatch(
        mz=np.ascontiguousarray(fields["mz"], dtype=np.float32),
        intensity=np.ascontiguousarray(fields["intensity"], dtype=np.float32),
        gbin=np.ascontiguousarray(fields["gbin"], dtype=np.int32),
        n_members=np.ascontiguousarray(fields["n_members"], dtype=np.int32),
        n_distinct_total=int(fields["n_distinct_total"]),
        run_starts=np.ascontiguousarray(fields["run_starts"], dtype=np.int64),
        cluster_ids=list(fields["cluster_ids"]),
        source_indices=[int(i) for i in fields["source_indices"]],
    )


def pack_flat_bin_mean(
    clusters_or_table,
    bin_config,
    max_elements: int = 16 * 1024 * 1024,
) -> list[FlatBinBatch]:
    """Quantize (f64), dedup, and lay out all kept peaks flat, sorted by
    (cluster, bin).  Chunked so each batch holds <= ``max_elements`` peaks
    (a single larger cluster gets a chunk of its own) and the (row, bin)
    composite stays inside int32."""
    table = _as_table(clusters_or_table)
    idx = table.cluster_order()
    n_bins = bin_config.n_bins

    bins64, kept_src, kept_counts, kept_offsets, kept_totals = (
        _bin_quantize_dedup(table, bin_config)
    )

    c = table.n_clusters
    row_peak_offsets = np.zeros(c + 1, dtype=np.int64)
    np.cumsum(kept_totals, out=row_peak_offsets[1:])

    if np.array_equal(idx.order, np.arange(idx.order.size)):
        # spectra already cluster-contiguous (the common CLI case)
        orig = kept_src
    else:
        cnt_kept = kept_counts[idx.order]
        src2 = np.repeat(
            kept_offsets[idx.order], cnt_kept
        ) + _grouped_arange(cnt_kept)
        orig = kept_src[src2]  # original peak ids, grouped by cluster
    final = orig[seg_argsort(bins64[orig], row_peak_offsets)]
    s_mz = table.mz[final].astype(np.float32)
    s_int = table.intensity[final].astype(np.float32)
    s_bin = bins64[final]
    s_row = np.repeat(np.arange(c, dtype=np.int64), kept_totals)

    # run starts over the sorted (row, bin) axis
    first = np.ones(s_bin.size, dtype=bool)
    if s_bin.size:
        first[1:] = (s_bin[1:] != s_bin[:-1]) | (s_row[1:] != s_row[:-1])

    # chunk rows greedily under the element and composite-key budgets
    max_rows = (2**31 - 2) // (n_bins + 1)
    batches: list[FlatBinBatch] = []
    lo = 0
    while lo < c:
        hi = min(lo + max_rows, c)
        while (
            hi > lo + 1
            and row_peak_offsets[hi] - row_peak_offsets[lo] > max_elements
        ):
            hi = lo + int(
                np.searchsorted(
                    row_peak_offsets[lo + 1 : hi + 1],
                    row_peak_offsets[lo] + max_elements,
                    side="right",
                )
            )
            hi = max(hi, lo + 1)
        p0, p1 = int(row_peak_offsets[lo]), int(row_peak_offsets[hi])
        gbin = (
            (s_row[p0:p1] - lo) * np.int64(n_bins + 1) + s_bin[p0:p1]
        ).astype(np.int32)
        # chunk boundaries are row boundaries, so first[p0] is a run start
        run_starts = np.flatnonzero(first[p0:p1])
        batches.append(
            FlatBinBatch(
                mz=s_mz[p0:p1],
                intensity=s_int[p0:p1],
                gbin=gbin,
                n_members=idx.n_members[lo:hi].astype(np.int32),
                n_distinct_total=int(run_starts.size),
                run_starts=run_starts,
                cluster_ids=[table.cluster_names[i] for i in range(lo, hi)],
                source_indices=list(range(lo, hi)),
            )
        )
        lo = hi
    return batches
