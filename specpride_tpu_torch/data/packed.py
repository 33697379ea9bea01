"""Packing of clusters for the card: flat for the binned-mean and
gap-average kernels, bucketized (B, K) for the medoid.

Binned mean: every kept peak of every cluster lies along ONE axis, sorted
by (cluster, bin): the host quantizes m/z on the float64 grid, drops
duplicate (member, bin) peaks (the reference's buffered ``+=``
semantics, ref src/binning.py:197-199) and sorts, so the card only runs
the segmented reduction.

Gap average: every peak lies along one axis, sorted by (cluster, m/z)
(singletons in input order), with the groups decided on the host in
float64 and marked by 1-byte group-start flags.

Bucketized: clusters of like total peak count share a (B, K) batch, each
row its cluster's peaks concatenated in member order with a member-id
channel (``pack_bucketize``, the medoid's); for the binned mean each row
holds its cluster's kept peaks sorted by bin (``pack_bucketize_bin_mean``),
for the gap average its peaks in group order with segment ids
(``pack_bucketize_gap``).  A (B, K) batch splits along its cluster axis
over several cards; a flat peak axis would split clusters.

All passes are vectorized numpy over a ``SpectraTable``.  With a reduced
``precision`` the packers also encode the channels the card receives
(``ops.quantize``).  Each packer runs under a ``pack:*`` tracing span.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from specpride_tpu_torch.config import BatchConfig
from specpride_tpu_torch.data.table import ClusterIndex, SpectraTable
from specpride_tpu_torch.observability import tracing
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


def f64_sort_keys(x: np.ndarray) -> np.ndarray:
    """int64 keys that order as ``np.sort`` orders the float64 ``x``:
    the bit patterns with the magnitude bits of negatives flipped, after
    -0.0 is made 0.0 (the two compare equal) and every NaN the one
    positive NaN (sorted last, equal to each other)."""
    x = np.where(np.isnan(x), np.nan, np.asarray(x, dtype=np.float64) + 0.0)
    bits = x.view(np.int64)
    return bits ^ ((bits >> 63) & np.int64(0x7FFF_FFFF_FFFF_FFFF))


def _cluster_peak_order(table: SpectraTable, idx) -> np.ndarray:
    """Peak ids grouped by cluster code, each cluster's in file order."""
    if np.array_equal(idx.order, np.arange(idx.order.size)):
        return np.arange(int(table.peak_offsets[-1]), dtype=np.int64)
    cnt = table.peak_counts[idx.order]
    return np.repeat(table.peak_offsets[idx.order], cnt) + _grouped_arange(cnt)


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
    # reduced precision: the intensity channel the card receives instead
    # of f32, as bf16 bit patterns (int16) or int8 codes against a
    # per-cluster ``scale`` that the host applies to the fetched means.
    # f32 batches leave all three at their defaults.
    precision: str = "f32"
    codes: np.ndarray | None = None  # (N,) int16 (bf16 bits) | int8
    scale: np.ndarray | None = None  # (rows,) f32, int8 only


def _reduced_fields(precision: str, codes, scale) -> dict:
    """``precision``, ``codes`` and ``scale`` of a batch packed elsewhere,
    checked and in the port's encoding: bf16 codes of any 2-byte dtype
    (the JAX package's ``ml_dtypes.bfloat16``) as int16 bit patterns."""
    if precision not in quantize.PRECISIONS:
        raise ValueError(f"flat batch precision {precision!r} is not one of "
                         f"{quantize.PRECISIONS}")
    if precision == "f32":
        if codes is not None or scale is not None:
            raise ValueError("an f32 flat batch carries no codes or scale")
        return dict(precision="f32", codes=None, scale=None)
    if codes is None:
        raise ValueError(f"a {precision} flat batch needs its codes")
    codes = np.ascontiguousarray(codes)
    if precision == "bf16":
        if codes.dtype.itemsize != 2:
            raise ValueError(f"bf16 codes must be 2-byte, got {codes.dtype}")
        return dict(precision="bf16", codes=codes.view(np.int16), scale=None)
    if codes.dtype != np.int8 or scale is None:
        raise ValueError("int8 precision needs int8 codes and a scale")
    return dict(precision="int8", codes=codes,
                scale=np.ascontiguousarray(scale, dtype=np.float32))


def flat_batch_from_arrays(fields: dict) -> FlatBinBatch:
    """Build a ``FlatBinBatch`` from the numpy fields of a flat batch
    packed elsewhere (``dataclasses.asdict`` of the JAX package's
    ``FlatBinBatch``): the state the two packages hand their kernels.
    Reduced-precision codes arrive in the JAX package's dtypes and are
    converted (``_reduced_fields``)."""
    unknown = set(fields) - {f.name for f in dataclasses.fields(FlatBinBatch)}
    if unknown:
        raise ValueError(f"unknown flat batch fields {sorted(unknown)}")
    return FlatBinBatch(
        mz=np.ascontiguousarray(fields["mz"], dtype=np.float32),
        intensity=np.ascontiguousarray(fields["intensity"], dtype=np.float32),
        gbin=np.ascontiguousarray(fields["gbin"], dtype=np.int32),
        n_members=np.ascontiguousarray(fields["n_members"], dtype=np.int32),
        n_distinct_total=int(fields["n_distinct_total"]),
        run_starts=np.ascontiguousarray(fields["run_starts"], dtype=np.int64),
        cluster_ids=list(fields["cluster_ids"]),
        source_indices=[int(i) for i in fields["source_indices"]],
        **_reduced_fields(fields.get("precision", "f32"),
                          fields.get("codes"), fields.get("scale")),
    )


def _row_chunks(row_peak_offsets: np.ndarray, max_elements: int,
                max_rows: int):
    """Row ranges [lo, hi) of the chunks, taken greedily: at most
    ``max_rows`` rows and ``max_elements`` peaks each, a single larger row
    in a chunk of its own."""
    c = row_peak_offsets.size - 1
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
        yield lo, hi
        lo = hi


@tracing.traced("pack:flat_bin_mean")
def pack_flat_bin_mean(
    clusters_or_table,
    bin_config,
    max_elements: int = 16 * 1024 * 1024,
    precision: str = "f32",
) -> list[FlatBinBatch]:
    """Quantize (f64), dedup, and lay out all kept peaks flat, sorted by
    (cluster, bin).  Chunked so each batch holds <= ``max_elements`` peaks
    (a single larger cluster gets a chunk of its own) and the (row, bin)
    composite stays inside int32.  A reduced ``precision`` also encodes
    each chunk's intensities (``quantize.encode_intensity_flat``); f32
    leaves the batches exactly as they were."""
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
    for lo, hi in _row_chunks(row_peak_offsets, max_elements, max_rows):
        p0, p1 = int(row_peak_offsets[lo]), int(row_peak_offsets[hi])
        gbin = (
            (s_row[p0:p1] - lo) * np.int64(n_bins + 1) + s_bin[p0:p1]
        ).astype(np.int32)
        # chunk boundaries are row boundaries, so first[p0] is a run start
        run_starts = np.flatnonzero(first[p0:p1])
        codes = scale = None
        if precision != "f32":
            codes, scale = quantize.encode_intensity_flat(
                s_int[p0:p1], row_peak_offsets[lo : hi + 1] - p0, precision
            )
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
                precision=precision,
                codes=codes,
                scale=scale,
            )
        )
    return batches


# ---------------------------------------------------------------------------
# Gap-average packing: f64 sort and gap groups, all vectorized
# ---------------------------------------------------------------------------


@tracing.traced("pack:gap_segments")
def gap_global_segments(table: SpectraTable, idx, config) -> dict:
    """Sort and gap-segment every cluster in one vectorized global pass,
    in float64 (ref src/average_spectrum_clustering.py:55-90).

    A segmented sort (``seg_argsort`` per cluster, on ``f64_sort_keys``)
    orders each cluster's peaks by m/z (singleton clusters by input
    position instead, ref :88-90 passthrough), ties in file order, as one
    global lexsort over (cluster, key) would; gap flags, the reference's
    final-gap merge (``tail_mode="reference"``, ref :79-87) and
    per-cluster segment ids come from flat cumsum/bincount passes."""
    p_total = int(table.peak_offsets[-1])
    spec_of_peak = np.repeat(
        np.arange(table.n_spectra, dtype=np.int64), table.peak_counts
    )
    cluster_of_peak = table.cluster_code[spec_of_peak]
    nm_of_peak = idx.n_members[cluster_of_peak]

    # sort key: m/z for multi-member clusters, input position for singletons
    # (positions are small integers, exact in f64)
    key = np.where(
        nm_of_peak == 1, np.arange(p_total, dtype=np.float64), table.mz
    )
    src = _cluster_peak_order(table, idx)
    offsets = np.zeros(table.n_clusters + 1, dtype=np.int64)
    np.cumsum(idx.total_peaks, out=offsets[1:])
    order = src[seg_argsort(f64_sort_keys(key[src]), offsets)]
    s_cluster = cluster_of_peak[order]
    s_mz = table.mz[order]

    same_cluster = np.zeros(p_total, dtype=bool)
    if p_total > 1:
        same_cluster[1:] = s_cluster[1:] == s_cluster[:-1]
    gap = np.zeros(p_total, dtype=bool)  # gap[i]: boundary BEFORE peak i
    if p_total > 1:
        diff_ok = (s_mz[1:] - s_mz[:-1]) >= config.mz_accuracy
        gap[1:] = same_cluster[1:] & diff_ok
        # singletons: every peak its own group regardless of spacing
        gap[1:] |= same_cluster[1:] & (idx.n_members[s_cluster[1:]] == 1)

    if config.tail_mode == "reference":
        # drop each multi-member cluster's final gap when it has >= 2 gaps
        # (ref :79-87 iterates ind_list[1:-1])
        gpos = np.flatnonzero(gap)
        if gpos.size:
            gcluster = s_cluster[gpos]
            counts = np.bincount(gcluster, minlength=table.n_clusters)
            is_last = np.ones(gpos.size, dtype=bool)
            is_last[:-1] = gcluster[1:] != gcluster[:-1]
            drop = (
                is_last
                & (counts[gcluster] >= 2)
                & (idx.n_members[gcluster] > 1)
            )
            gap[gpos[drop]] = False

    # segment ids, reset at cluster starts
    gseg = np.cumsum(gap)
    cluster_first_peak = np.zeros(p_total, dtype=bool)
    if p_total:
        cluster_first_peak[0] = True
        cluster_first_peak[1:] = ~same_cluster[1:]
    first_pos = np.zeros(table.n_clusters, dtype=np.int64)
    fidx = np.flatnonzero(cluster_first_peak)
    first_pos[s_cluster[fidx]] = fidx
    seg = (gseg - gseg[first_pos[s_cluster]]).astype(np.int32)

    n_groups = np.zeros(table.n_clusters, dtype=np.int64)
    if p_total:
        last_peak = np.ones(p_total, dtype=bool)
        last_peak[:-1] = ~same_cluster[1:]
        lidx = np.flatnonzero(last_peak)
        n_groups[s_cluster[lidx]] = seg[lidx] + 1

    return dict(
        order=order, s_cluster=s_cluster, s_mz=s_mz, gap=gap, seg=seg,
        n_groups=n_groups, first_pos=first_pos,
        cluster_first_peak=cluster_first_peak,
    )


@dataclasses.dataclass
class FlatGapBatch:
    """One chunk of the flat gap-average layout: every peak of its
    clusters sorted by (cluster, m/z), singletons in input order.

    A group begins where ``group_start`` is 1: at each cluster's first
    peak and at each host-f64 gap.  ``group_mz`` holds each group's mean
    m/z, taken here in float64 as the JAX package's default host path
    takes it (ascending m/z, one addition after another, as ``np.bincount``
    and ``native/gap_average.cpp`` add), so the card ships and averages
    only the intensities.  At f32 ``single_groups`` / ``single_int`` are
    the groups of singleton clusters (one peak each) and their float64
    intensities, which pass through unrounded (ref
    src/average_spectrum_clustering.py:88-90); None at a reduced
    precision, whose intensities are the reduced ones throughout.
    ``quorum`` is the per-row integer threshold ``ceil(min_fraction *
    n_members)`` (f64), exact for integer group sizes.  Rows are
    chunk-local; ``row_offsets`` are their peak extents."""

    intensity: np.ndarray  # (N,) f32, or int16 bf16 bits | int8 codes
    group_start: np.ndarray  # (N,) uint8
    group_mz: np.ndarray  # (groups,) f64
    n_members: np.ndarray  # (rows,) i32
    quorum: np.ndarray  # (rows,) i32
    n_groups: np.ndarray  # (rows,) i64
    row_offsets: np.ndarray  # (rows + 1,) i64
    cluster_ids: list[str]
    source_indices: list[int]
    precision: str = "f32"
    scale: np.ndarray | None = None  # (rows,) f32, int8 only
    single_groups: np.ndarray | None = None  # (k,) i64 chunk group ids
    single_int: np.ndarray | None = None  # (k,) f64


def pack_flat_gap(
    clusters_or_table,
    config,
    max_elements: int = 16 * 1024 * 1024,
    precision: str = "f32",
) -> list[FlatGapBatch]:
    """Lay the peaks of ``gap_global_segments`` flat and chunk them at
    cluster boundaries, each chunk at most ``max_elements`` peaks (a single
    larger cluster gets a chunk of its own), with each group's float64
    mean m/z.  A reduced ``precision`` encodes each chunk's intensities per
    row (``encode_intensity_flat``)."""
    table = _as_table(clusters_or_table)
    idx = table.cluster_order()
    g = gap_global_segments(table, idx, config)
    s_int64 = table.intensity[g["order"]]
    s_int = s_int64.astype(np.float32)
    heads = g["cluster_first_peak"] | g["gap"]
    group_start = heads.astype(np.uint8)
    gid = np.cumsum(heads) - 1
    n_total = int(g["n_groups"].sum())
    sizes = np.bincount(gid, minlength=n_total)
    group_mz = np.bincount(gid, weights=g["s_mz"], minlength=n_total
                           ) / np.maximum(sizes, 1)
    single = idx.n_members[g["s_cluster"]] == 1
    quorum = np.ceil(
        config.min_fraction * idx.n_members.astype(np.float64)
    ).astype(np.int32)

    c = table.n_clusters
    row_peak_offsets = np.zeros(c + 1, dtype=np.int64)
    np.cumsum(idx.total_peaks, out=row_peak_offsets[1:])
    row_group_offsets = np.zeros(c + 1, dtype=np.int64)
    np.cumsum(g["n_groups"], out=row_group_offsets[1:])
    batches: list[FlatGapBatch] = []
    for lo, hi in _row_chunks(row_peak_offsets, max_elements, c):
        p0, p1 = int(row_peak_offsets[lo]), int(row_peak_offsets[hi])
        g0, g1 = int(row_group_offsets[lo]), int(row_group_offsets[hi])
        offsets = row_peak_offsets[lo : hi + 1] - p0
        inten, scale = quantize.encode_intensity_flat(
            s_int[p0:p1], offsets, precision
        )
        single_groups = single_int = None
        if precision == "f32":
            (pos,) = np.nonzero(single[p0:p1])
            single_groups = gid[p0 + pos] - g0
            single_int = s_int64[p0 + pos]
        batches.append(
            FlatGapBatch(
                intensity=inten,
                group_start=group_start[p0:p1],
                group_mz=group_mz[g0:g1],
                n_members=idx.n_members[lo:hi].astype(np.int32),
                quorum=quorum[lo:hi],
                n_groups=g["n_groups"][lo:hi],
                row_offsets=offsets,
                cluster_ids=[table.cluster_names[i] for i in range(lo, hi)],
                source_indices=list(range(lo, hi)),
                precision=precision,
                scale=scale,
                single_groups=single_groups,
                single_int=single_int,
            )
        )
    return batches


# ---------------------------------------------------------------------------
# Bucketized packing: (B, K) batches of like-sized clusters (medoid)
# ---------------------------------------------------------------------------


def _bucket_keys(values: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Bucket size per value: the least bucket holding it, past the last
    bucket the next power of two."""
    values = np.maximum(values, 1)
    b = np.asarray(buckets, dtype=np.int64)
    idx = np.searchsorted(b, values, side="left")
    inside = idx < len(b)
    keys = np.where(inside, b[np.minimum(idx, len(b) - 1)], 0)
    if not inside.all():
        over = values[~inside]
        keys[~inside] = 1 << (
            np.ceil(np.log2(np.maximum(over, 2))).astype(np.int64)
        )
    return keys


@dataclasses.dataclass
class PackedBatch:
    """B clusters, each with up to K packed peaks (its members' peaks
    concatenated in member order) and up to M members."""

    mz: np.ndarray  # (B, K) float32
    mz64: np.ndarray  # (B, K) float64, host only: exact m/z for binning
    intensity: np.ndarray  # (B, K) float32
    member_id: np.ndarray  # (B, K) int32, -1 = padding
    n_peaks_total: np.ndarray  # (B,) int32 valid peaks per cluster
    n_members: np.ndarray  # (B,) int32
    member_mask: np.ndarray  # (B, M) bool
    precursor_mz: np.ndarray  # (B, M) float32
    precursor_charge: np.ndarray  # (B, M) int32
    rt: np.ndarray  # (B, M) float32
    n_peaks: np.ndarray  # (B, M) int32 raw per-member peak counts
    member_spec: np.ndarray  # (B, M) int64 table spectrum id, -1 = padding
    cluster_ids: list[str]
    source_indices: list[int]

    @property
    def n_clusters(self) -> int:
        return self.mz.shape[0]

    @property
    def k(self) -> int:
        return self.mz.shape[1]

    @property
    def m(self) -> int:
        return self.member_mask.shape[1]


def packed_batch_from_arrays(fields: dict) -> PackedBatch:
    """Build a ``PackedBatch`` from the numpy fields of a bucketized batch
    packed elsewhere (``dataclasses.asdict`` of the JAX package's
    ``PackedBatch``), in the port's dtypes."""
    names = [f.name for f in dataclasses.fields(PackedBatch)]
    unknown = set(fields) - set(names)
    if unknown:
        raise ValueError(f"unknown packed batch fields {sorted(unknown)}")
    dtypes = dict(
        mz=np.float32, mz64=np.float64, intensity=np.float32,
        member_id=np.int32, n_peaks_total=np.int32, n_members=np.int32,
        member_mask=bool, precursor_mz=np.float32,
        precursor_charge=np.int32, rt=np.float32, n_peaks=np.int32,
        member_spec=np.int64,
    )
    return PackedBatch(
        **{k: np.ascontiguousarray(fields[k], dtype=dt)
           for k, dt in dtypes.items()},
        cluster_ids=list(fields["cluster_ids"]),
        source_indices=[int(i) for i in fields["source_indices"]],
    )


@dataclasses.dataclass
class _BucketPlan:
    """One (K[, M]) bucket group of clusters, chunked by clusters_per_batch."""

    codes: np.ndarray  # cluster codes in this chunk, appearance order
    k: int
    m: int  # 0 when the member axis is unbucketed


def _plan_buckets(
    idx: ClusterIndex,
    eligible: np.ndarray,  # (C,) bool
    totals: np.ndarray,  # (C,) value that picks the K bucket
    config: BatchConfig,
    bucket_members: bool,
) -> list[_BucketPlan]:
    """Clusters grouped by (K, M) bucket, in ascending K then M, each
    group cut into batches of at most ``clusters_per_batch``."""
    codes = np.flatnonzero(eligible)
    if codes.size == 0:
        return []
    kkeys = _bucket_keys(totals[codes], config.total_peak_buckets)
    if bucket_members:
        mkeys = _bucket_keys(idx.n_members[codes], config.member_buckets)
    else:
        mkeys = np.zeros(codes.size, dtype=np.int64)
    plans: list[_BucketPlan] = []
    for kkey in np.unique(kkeys):
        for mkey in np.unique(mkeys[kkeys == kkey]):
            sel = codes[(kkeys == kkey) & (mkeys == mkey)]
            for start in range(0, sel.size, config.clusters_per_batch):
                chunk = sel[start : start + config.clusters_per_batch]
                plans.append(_BucketPlan(chunk, int(kkey), int(mkey)))
    return plans


def _peak_layout(table: SpectraTable, idx: ClusterIndex, plan: _BucketPlan):
    """Flat source/destination indices for scattering a plan's peaks into a
    (B, K) buffer in cluster-member-peak order.

    Returns (spec_ids, row_of_spec, member_idx, counts, src, dest):
    ``src`` indexes ``table.mz``, ``dest`` the flat (B*K,) buffer."""
    codes = plan.codes
    nm = idx.n_members[codes]
    # positions of each chosen cluster's spectra within idx.order
    first = np.zeros(len(idx.n_members), dtype=np.int64)
    np.cumsum(idx.n_members[:-1], out=first[1:])
    starts = first[codes]
    row_of_spec = np.repeat(np.arange(codes.size, dtype=np.int64), nm)
    member_idx = _grouped_arange(nm)
    spec_ids = idx.order[np.repeat(starts, nm) + member_idx]
    counts = table.peak_counts[spec_ids]
    # within-row start offset of each spectrum's peaks
    cs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    row_spec_start = np.concatenate([[0], np.cumsum(nm)])[:-1]
    base = np.repeat(cs[row_spec_start], nm)
    within = cs - base
    src = np.repeat(table.peak_offsets[spec_ids], counts) + _grouped_arange(
        counts
    )
    dest = (
        np.repeat(row_of_spec, counts) * plan.k
        + np.repeat(within, counts)
        + _grouped_arange(counts)
    )
    return spec_ids, row_of_spec, member_idx, counts, src, dest


@tracing.traced("pack:bucketize")
def pack_bucketize(
    clusters_or_table,
    config: BatchConfig = BatchConfig(),
    bucket_members: bool = False,
) -> list[PackedBatch]:
    """Group clusters into PackedBatches of one K bucket each, recording
    cluster codes in ``source_indices``.  Each row holds its cluster's
    peaks from column 0 on, padding after them.

    With ``bucket_members=False`` the member axis M is the largest cluster
    of the batch rounded up to a power of two; ``bucket_members=True``
    buckets M by ``config.member_buckets`` (the medoid's run × member
    occupancy shape)."""
    table = _as_table(clusters_or_table)
    idx = table.cluster_order()
    eligible = idx.n_members > 0
    plans = _plan_buckets(idx, eligible, idx.total_peaks, config,
                          bucket_members)

    batches: list[PackedBatch] = []
    for plan in plans:
        codes = plan.codes
        b, k = codes.size, plan.k
        spec_ids, row_of_spec, member_idx, counts, src, dest = _peak_layout(
            table, idx, plan
        )
        if plan.m:
            m = plan.m
        else:
            mx = int(idx.n_members[codes].max(initial=1))
            m = 1 << (max(mx, 1) - 1).bit_length()

        mz64 = np.zeros(b * k, dtype=np.float64)
        mz64[dest] = table.mz[src]
        inten = np.zeros(b * k, dtype=np.float32)
        inten[dest] = table.intensity[src]
        member_id = np.full(b * k, -1, dtype=np.int32)
        member_id[dest] = np.repeat(member_idx, counts)

        member_mask = np.zeros((b, m), dtype=bool)
        member_mask[row_of_spec, member_idx] = True
        precursor_mz = np.zeros((b, m), dtype=np.float32)
        precursor_mz[row_of_spec, member_idx] = table.precursor_mz[spec_ids]
        precursor_charge = np.zeros((b, m), dtype=np.int32)
        precursor_charge[row_of_spec, member_idx] = table.precursor_charge[
            spec_ids
        ]
        rt = np.zeros((b, m), dtype=np.float32)
        rt[row_of_spec, member_idx] = table.rt[spec_ids]
        n_peaks = np.zeros((b, m), dtype=np.int32)
        n_peaks[row_of_spec, member_idx] = counts
        member_spec = np.full((b, m), -1, dtype=np.int64)
        member_spec[row_of_spec, member_idx] = spec_ids

        batches.append(
            PackedBatch(
                mz=mz64.astype(np.float32).reshape(b, k),
                mz64=mz64.reshape(b, k),
                intensity=inten.reshape(b, k),
                member_id=member_id.reshape(b, k),
                n_peaks_total=idx.total_peaks[codes].astype(np.int32),
                n_members=idx.n_members[codes].astype(np.int32),
                member_mask=member_mask,
                precursor_mz=precursor_mz,
                precursor_charge=precursor_charge,
                rt=rt,
                n_peaks=n_peaks,
                member_spec=member_spec,
                cluster_ids=[table.cluster_names[c] for c in codes],
                source_indices=[int(c) for c in codes],
            )
        )
    return batches


@dataclasses.dataclass
class BinPackedBatch:
    """A (B, K) batch for the bucketized binned mean: bins quantized in
    float64 and duplicate (member, bin) peaks dropped on the host, each row
    sorted by bin with the padding (bin ``n_bins``) last, so the card needs
    no member channel and sorts nothing."""

    mz: np.ndarray  # (B, K) f32
    intensity: np.ndarray  # (B, K) f32
    bins: np.ndarray  # (B, K) i32, n_bins in padding slots
    n_valid: np.ndarray  # (B,) i32 kept peaks per row
    n_members: np.ndarray  # (B,) i32
    cluster_ids: list[str]
    source_indices: list[int]


@tracing.traced("pack:bucketize_bin_mean")
def pack_bucketize_bin_mean(
    clusters_or_table,
    bin_config,
    config: BatchConfig = BatchConfig(),
) -> list[BinPackedBatch]:
    """Quantize (float64), dedup and bucket clusters for the bucketized
    binned mean; K buckets are chosen on the kept peak counts.  Each row's
    kept peaks are sorted by bin with the host library's stable segmented
    sort, the padding (sentinel ``n_bins``) after them."""
    table = _as_table(clusters_or_table)
    idx = table.cluster_order()
    bins64, kept_src, _, kept_offsets, kept_totals = _bin_quantize_dedup(
        table, bin_config)
    plans = _plan_buckets(idx, idx.n_members > 0, kept_totals, config, False)
    # the kept peaks as a table of their own drive the same layout helper
    kept_table = dataclasses.replace(table, peak_offsets=kept_offsets)
    kept_idx = dataclasses.replace(idx, total_peaks=kept_totals)
    n_bins = bin_config.n_bins

    batches: list[BinPackedBatch] = []
    for plan in plans:
        codes = plan.codes
        b, k = codes.size, plan.k
        _, _, _, _, src_kept, dest = _peak_layout(kept_table, kept_idx, plan)
        src = kept_src[src_kept]
        n_valid = kept_totals[codes]
        # dest lists each row's kept peaks from column 0 in row order, so a
        # segmented sort of them by bin is the rows' stable sort (the
        # padding, all n_bins, is already last)
        offsets = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(n_valid, out=offsets[1:])
        perm = src[seg_argsort(bins64[src], offsets)]
        mzf = np.zeros(b * k, dtype=np.float32)
        mzf[dest] = table.mz[perm]
        inten = np.zeros(b * k, dtype=np.float32)
        inten[dest] = table.intensity[perm]
        pbins = np.full(b * k, n_bins, dtype=np.int32)
        pbins[dest] = bins64[perm]
        batches.append(
            BinPackedBatch(
                mz=mzf.reshape(b, k),
                intensity=inten.reshape(b, k),
                bins=pbins.reshape(b, k),
                n_valid=n_valid.astype(np.int32),
                n_members=idx.n_members[codes].astype(np.int32),
                cluster_ids=[table.cluster_names[c] for c in codes],
                source_indices=[int(c) for c in codes],
            )
        )
    return batches


@dataclasses.dataclass
class GapPackedBatch:
    """A (B, K) batch for the bucketized gap average: each row its
    cluster's peaks sorted and split into groups in float64 on the host
    (``gap_global_segments``), with non-decreasing segment ids; the card
    takes the group means.  ``n_groups`` is each row's exact group count,
    so the output is sized exactly."""

    mz: np.ndarray  # (B, K) f32, ascending (singletons: input order)
    intensity: np.ndarray  # (B, K) f32, same order
    seg: np.ndarray  # (B, K) i32 segment ids, non-decreasing; padding 0
    n_valid: np.ndarray  # (B,) i32
    quorum: np.ndarray  # (B,) i32 host-f64 ceil(min_fraction * n_members)
    n_members: np.ndarray  # (B,) i32
    n_groups: np.ndarray  # (B,) i64
    cluster_ids: list[str]
    source_indices: list[int]


@tracing.traced("pack:bucketize_gap")
def pack_bucketize_gap(
    clusters_or_table,
    config,
    batch_config: BatchConfig = BatchConfig(),
) -> list[GapPackedBatch]:
    """Bucketize the float64 gap segmentation (``gap_global_segments``) by
    total peak count."""
    table = _as_table(clusters_or_table)
    idx = table.cluster_order()
    g = gap_global_segments(table, idx, config)
    s_mz, seg, n_groups, first_pos = (
        g["s_mz"], g["seg"], g["n_groups"], g["first_pos"])
    s_intensity = table.intensity[g["order"]]
    quorum_all = np.ceil(
        config.min_fraction * idx.n_members.astype(np.float64)
    ).astype(np.int32)
    plans = _plan_buckets(idx, idx.n_members > 0, idx.total_peaks,
                          batch_config, False)

    batches: list[GapPackedBatch] = []
    for plan in plans:
        codes = plan.codes
        b, k = codes.size, plan.k
        totals = idx.total_peaks[codes]
        src = np.repeat(first_pos[codes], totals) + _grouped_arange(totals)
        dest = np.repeat(
            np.arange(b, dtype=np.int64) * k, totals
        ) + _grouped_arange(totals)
        mzf = np.zeros(b * k, dtype=np.float32)
        mzf[dest] = s_mz[src]
        inten = np.zeros(b * k, dtype=np.float32)
        inten[dest] = s_intensity[src]
        pseg = np.zeros(b * k, dtype=np.int32)
        pseg[dest] = seg[src]
        batches.append(
            GapPackedBatch(
                mz=mzf.reshape(b, k),
                intensity=inten.reshape(b, k),
                seg=pseg.reshape(b, k),
                n_valid=totals.astype(np.int32),
                quorum=quorum_all[codes],
                n_members=idx.n_members[codes].astype(np.int32),
                n_groups=n_groups[codes],
                cluster_ids=[table.cluster_names[c] for c in codes],
                source_indices=[int(c) for c in codes],
            )
        )
    return batches


def merge_cluster_sources(parts) -> tuple[list, list[tuple[int, int]]]:
    """Concatenate the cluster lists of several sources into one pack
    input, with each source's ``(start, stop)`` span of the merged list
    (and of any result aligned with it), so the bucket plan fills buckets
    across sources and results are sliced back per source."""
    merged: list = []
    spans: list[tuple[int, int]] = []
    for part in parts:
        start = len(merged)
        merged.extend(part)
        spans.append((start, len(merged)))
    return merged, spans
