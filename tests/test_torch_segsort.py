"""The port's host library (``ops/csrc/segsort.cpp``, built by
``ops/_build.load_host``) against its plain numpy versions: identical
permutations and search results, stable ties included; the sorts moved
onto it (the QC rep sort, the gap pack's per-cluster m/z sort) give the
arrays the old global lexsorts gave; a failed build raises."""

import sys
import threading

import numpy as np
import pytest

from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import CosineConfig, GapAverageConfig
from specpride_tpu_torch.data import packed
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.data.table import SpectraTable
from specpride_tpu_torch.ops import _build, segsort

I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)


def _offsets(rng, n, n_segs, empty_share=0.3):
    """``n_segs`` segments over ``n`` keys, about ``empty_share`` empty."""
    cuts = np.sort(rng.integers(0, n + 1, n_segs - 1))
    cuts[rng.random(cuts.size) < empty_share] = cuts[0] if cuts.size else 0
    return np.concatenate([[0], np.sort(cuts), [n]]).astype(np.int64)


def _check_sort(keys, offsets):
    got = segsort.seg_argsort(keys, offsets)
    want = segsort.seg_argsort_plain(keys, offsets)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("key_range", [2, 50, 1 << 40])
@pytest.mark.parametrize("n,n_segs", [(1, 1), (997, 40), (20_000, 300),
                                      (50_000, 1)])
def test_seg_argsort_matches_plain(n, n_segs, key_range):
    rng = np.random.default_rng(n + n_segs + key_range % 97)
    keys = rng.integers(-key_range, key_range, n)
    got = _check_sort(keys, _offsets(rng, n, n_segs))
    # stable: equal keys keep input order inside each segment
    assert np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("offsets", [[0], [0, 0], [0, 0, 0, 0]])
def test_seg_argsort_no_keys(offsets):
    got = _check_sort(np.zeros(0, np.int64), np.array(offsets))
    assert got.size == 0


def test_seg_argsort_extreme_keys_and_empty_segments():
    keys = np.array([I64.max, I64.min, 0, I64.max, -1, I64.min, 1, I64.max,
                     I64.min, 0], dtype=np.int64)
    for offsets in ([0, 10], [0, 0, 3, 3, 7, 10, 10], [0, 1, 2, 10]):
        _check_sort(keys, np.array(offsets))


def test_seg_argsort_all_ties_keeps_input_order():
    keys = np.full(10_000, 7, dtype=np.int64)
    got = _check_sort(keys, np.array([0, 4_000, 4_000, 10_000]))
    np.testing.assert_array_equal(got, np.arange(10_000))


@pytest.mark.parametrize("offsets", [[1, 5], [0, 4], [0, 3, 2, 5], []])
def test_seg_argsort_rejects_bad_offsets(offsets):
    with pytest.raises(ValueError, match="offsets"):
        segsort.seg_argsort(np.arange(5), np.array(offsets, dtype=np.int64))


@pytest.mark.parametrize("n_keys,n_queries", [(0, 0), (0, 10), (10, 0),
                                              (1, 1), (5_000, 200_003)])
def test_searchsorted_matches_plain(n_keys, n_queries):
    rng = np.random.default_rng(n_keys * 7 + n_queries)
    keys = np.sort(rng.integers(-50, 50, n_keys)).astype(np.int32)
    queries = rng.integers(-60, 60, n_queries).astype(np.int32)
    got = segsort.searchsorted_right_i32(keys, queries)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, segsort.searchsorted_right_i32_plain(keys, queries))


def test_searchsorted_extremes():
    keys = np.array([I32.min, I32.min, -1, 0, 0, 5, I32.max - 1, I32.max],
                    dtype=np.int32)
    queries = np.array([I32.min, I32.max, 0, -1, 6, I32.max - 1, 4],
                       dtype=np.int32)
    np.testing.assert_array_equal(
        segsort.searchsorted_right_i32(keys, queries),
        np.searchsorted(keys, queries, side="right"))


def test_threads_sort_side_by_side():
    """Eight threads (more than the pack lanes) sorting at once, with a
    short switch interval: every result the plain version's."""
    rng = np.random.default_rng(3)
    jobs = []
    for i in range(16):
        n = int(rng.integers(1_000, 30_000))
        keys = rng.integers(0, 30, n)
        offsets = _offsets(rng, n, int(rng.integers(1, 200)))
        jobs.append((keys, offsets, segsort.seg_argsort_plain(keys, offsets)))
    bad = []

    def work(k):
        for keys, offsets, want in jobs[k::8]:
            if not np.array_equal(segsort.seg_argsort(keys, offsets), want):
                bad.append(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source the compiler refuses: the build raises with its output,
    and the sort raises too; no numpy route is taken."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_host_lib", None)
    with pytest.raises(RuntimeError, match="host library build failed"
                       "(.|\n)*broken.cpp"):
        _build.load_host()
    with pytest.raises(RuntimeError, match="host library build failed"):
        segsort.seg_argsort(np.arange(3), np.array([0, 3]))


def _spectrum(mz, intensity, title):
    return Spectrum(mz=np.asarray(mz, np.float64),
                    intensity=np.asarray(intensity, np.float64),
                    precursor_mz=500.0, precursor_charge=2, title=title)


def test_rep_sort_is_the_old_lexsort():
    """``_prep_cosine_reps`` sorts each row's rep peaks by bin with
    ``seg_argsort`` over the row extents: the arrays the global lexsort
    over (row, bin) gave, for reps with unsorted m/z, equal bins and an
    empty rep."""
    rng = np.random.default_rng(11)
    clusters, reps = [], []
    for i, n in enumerate([40, 0, 25, 60, 1]):
        mz = rng.uniform(150.0, 170.0, n)
        mz[: n // 3] = 160.0  # ties in one bin
        reps.append(_spectrum(mz, rng.uniform(1, 1e3, n), f"c{i}"))
        clusters.append(Cluster(f"c{i}", [_spectrum(
            np.sort(rng.uniform(150.0, 170.0, 30)), rng.uniform(1, 1e3, 30),
            f"c{i};mzspec:PXD1:r:scan:{i}")]))
    backend = TorchBackend(device="cpu")
    cfg = CosineConfig()
    prep = backend._prep_cosine_reps(
        reps, backend._prep_cosine_members(clusters, cfg), cfg)
    counts = np.array([r.n_peaks for r in reps])
    row = np.repeat(np.arange(len(reps)), counts)
    mz = np.concatenate([r.mz for r in reps])
    inten = np.concatenate([r.intensity for r in reps]).astype(np.float32)
    rbin = np.maximum(np.floor((mz + cfg.mz_space / 2.0)
                               / cfg.mz_space).astype(np.int64), 0)
    perm = np.lexsort((rbin, row))
    np.testing.assert_array_equal(prep["rbin"], rbin[perm])
    np.testing.assert_array_equal(prep["rep_row"], row[perm])
    np.testing.assert_array_equal(prep["rep_in"], inten[perm])


def test_f64_sort_keys_order_as_np_sort():
    x = np.array([3.5, -0.0, 0.0, np.nan, -np.inf, np.inf, -2.0, -1.0,
                  1e-310, -1e-310, 2.0, 0.0, -0.0, np.nan, 5e307, -5e307])
    keys = packed.f64_sort_keys(x)
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"),
                                  np.argsort(x, kind="stable"))


def _gap_table(rng, cluster_codes, n_peaks):
    """Spectra in the given cluster-code order (interleaved clusters
    included); m/z with exact ties, 0.0 and duplicates across members."""
    clusters = {}
    for s_i, code in enumerate(cluster_codes):
        mz = np.round(rng.uniform(0.0, 3.0, n_peaks), 1)
        mz[:2] = 0.0
        spec = _spectrum(mz, rng.uniform(1, 100, n_peaks),
                         f"cl-{code};mzspec:PXD1:r:scan:{s_i}")
        clusters.setdefault(code, []).append(spec)
    spectra = []
    for s_i, code in enumerate(cluster_codes):
        spectra.append(clusters[code][sum(c == code
                                          for c in cluster_codes[:s_i])])
    return SpectraTable.from_spectra(spectra)


@pytest.mark.parametrize("codes", [
    [0, 0, 0, 1, 2, 2, 3],  # cluster-contiguous, singletons 1 and 3
    [0, 1, 0, 2, 1, 0, 3],  # interleaved
])
def test_gap_sort_is_the_old_lexsort(codes):
    """The gap pack's per-cluster sort on ``f64_sort_keys``: the order of
    the global lexsort over (cluster, m/z or input position), with equal
    m/z, 0.0 and singleton clusters."""
    table = _gap_table(np.random.default_rng(len(set(codes))), codes, 12)
    idx = table.cluster_order()
    g = packed.gap_global_segments(table, idx, GapAverageConfig())
    spec = np.repeat(np.arange(table.n_spectra), table.peak_counts)
    cluster = table.cluster_code[spec]
    key = np.where(idx.n_members[cluster] == 1,
                   np.arange(cluster.size, dtype=np.float64), table.mz)
    np.testing.assert_array_equal(g["order"],
                                  np.lexsort((key, cluster)))
