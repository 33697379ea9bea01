"""The port's medoid (``select --method medoid``) against the JAX package
fed the same inputs.

Packing: ``pack_bucketize`` equal field for field, ``medoid_bins_packed``
and ``narrow_i32_to_i16`` equal array for array.  Counts:
``shared_bins_packed`` on the JAX dispatch's sorted arguments, integer
equal to the JAX function (whose OR-scan uses ceil(m / 32) lanes, hence
the member counts around 32 and above 128).  Picks: ``medoid_indices``
identical to the JAX bucketized path with the host float64 finalize, to
the JAX default route and to the numpy oracle, index for index."""

import dataclasses

import numpy as np
import pytest
import torch
from conftest import make_cluster

from specpride_tpu.backends import numpy_backend as jnb
from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import BatchConfig as JaxBatchConfig
from specpride_tpu.config import MedoidConfig as JaxMedoidConfig
from specpride_tpu.data import packed as jpacked
from specpride_tpu.data import table as jtable
from specpride_tpu.ops import quantize as jquantize
from specpride_tpu.ops import similarity as jsim
from specpride_tpu_torch.backends import numpy_backend
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BatchConfig, MedoidConfig
from specpride_tpu_torch.data import packed, table
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.ops import quantize, similarity

PACKED_FIELDS = [f.name for f in dataclasses.fields(packed.PackedBatch)]


def _port(clusters):
    return [
        Cluster(c.cluster_id, [_port_spec(s) for s in c.members])
        for c in clusters
    ]


def _port_spec(s):
    return Spectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                    s.rt, s.title)


def _random_clusters(rng, n=12):
    """The JAX package's medoid parity input (tests/test_tpu_parity.py)."""
    return [
        make_cluster(rng, f"cluster-{i}", n_members=int(rng.integers(1, 9)),
                     n_peaks=int(rng.integers(5, 120)),
                     jitter=float(rng.uniform(0.001, 0.02)),
                     base_scan=1000 * i)
        for i in range(n)
    ]


def _ragged_clusters(seed):
    """Clusters over three K buckets (2048, 8192, 32768) and three M
    buckets (32, 128 and 256, past the last)."""
    rng = np.random.default_rng(seed)
    shapes = [(3, 40), (1, 12), (40, 30), (7, 400), (130, 20), (2, 9000),
              (5, 60), (33, 70)]
    return [
        make_cluster(rng, f"k{i}", n_members=nm, n_peaks=npk,
                     base_scan=1000 * i)
        for i, (nm, npk) in enumerate(shapes)
    ]


def _assert_same_packed(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in PACKED_FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name


# --- packing -------------------------------------------------------------

@pytest.mark.parametrize("bucket_members", [True, False])
@pytest.mark.parametrize("per_batch", [1024, 3])
def test_pack_bucketize_matches_jax(bucket_members, per_batch):
    jclusters = _ragged_clusters(1)
    want = jpacked.pack_bucketize(
        jclusters, JaxBatchConfig(clusters_per_batch=per_batch),
        bucket_members=bucket_members,
    )
    got = packed.pack_bucketize(
        _port(jclusters), BatchConfig(clusters_per_batch=per_batch),
        bucket_members=bucket_members,
    )
    assert {b.k for b in want} == {2048, 8192, 32768}
    if bucket_members:
        assert {b.m for b in want} == {32, 128, 256}
    _assert_same_packed(got, want)


def test_pack_bucketize_interleaved_spectra_matches_jax():
    """Spectra of several clusters interleaved in file order: both packers
    regroup them by cluster through the table's order."""
    jclusters = _ragged_clusters(2)[:5]
    jspec = [s for c in jclusters for s in c.members]
    order = np.random.default_rng(3).permutation(len(jspec))
    jspec = [jspec[i] for i in order]
    want = jpacked.pack_bucketize(
        jtable.SpectraTable.from_spectra(jspec), bucket_members=True)
    got = packed.pack_bucketize(
        table.SpectraTable.from_spectra([_port_spec(s) for s in jspec]),
        bucket_members=True)
    _assert_same_packed(got, want)


def test_packed_batch_from_arrays_round_trips():
    want = jpacked.pack_bucketize(_ragged_clusters(4), bucket_members=True)
    got = [packed.packed_batch_from_arrays(dataclasses.asdict(b))
           for b in want]
    _assert_same_packed(got, want)
    with pytest.raises(ValueError, match="unknown"):
        packed.packed_batch_from_arrays(
            dict(dataclasses.asdict(want[0]), extra=1))


@pytest.mark.parametrize("bin_size", [0.1, 0.02, 1.0])
def test_medoid_bins_packed_matches_jax(bin_size):
    for jbatch in jpacked.pack_bucketize(_ragged_clusters(5),
                                         bucket_members=True):
        batch = packed.packed_batch_from_arrays(dataclasses.asdict(jbatch))
        want = jquantize.medoid_bins_packed(
            jbatch, JaxMedoidConfig(bin_size=bin_size))
        got = quantize.medoid_bins_packed(batch, MedoidConfig(bin_size))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_valid", [0, 20_000, 2**15 - 2, 2**15 - 1,
                                       2**20])
@pytest.mark.parametrize("sentinel", [None, 7])
def test_narrow_i32_to_i16_matches_jax(max_valid, sentinel):
    rng = np.random.default_rng(max_valid % 97)
    arr = rng.integers(0, max_valid + 1, size=(4, 50)).astype(np.int32)
    arr[:, 40:] = 2**30
    want = jquantize.narrow_i32_to_i16(arr, max_valid, sentinel)
    got = quantize.narrow_i32_to_i16(arr, max_valid, sentinel)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)


# --- counts --------------------------------------------------------------

def _sorted_args(rng, b, k, m, n_bins):
    """(B, K) global bins and member ids sorted per row by (bin, member)
    as the JAX dispatch sorts them, with a ragged padding tail (bin
    sentinel 2^30, member m), and each row's run count."""
    bins = rng.integers(1000, 1000 + n_bins, size=(b, k)).astype(np.int64)
    mm = rng.integers(0, m, size=(b, k)).astype(np.int64)
    for row in range(b):
        pad = int(rng.integers(0, k // 3 + 1))
        if pad:
            bins[row, k - pad:] = 2**30
            mm[row, k - pad:] = m
    order = np.argsort(bins * (m + 1) + mm, axis=1, kind="stable")
    sbins = np.take_along_axis(bins, order, axis=1).astype(np.int32)
    smm = np.take_along_axis(mm, order, axis=1).astype(np.int32)
    runs = 1 + np.count_nonzero(sbins[:, 1:] != sbins[:, :-1], axis=1)
    return sbins, smm, int(runs.max())


@pytest.mark.parametrize("m", [1, 2, 31, 32, 33, 130])
@pytest.mark.parametrize("narrow", [False, True])
def test_shared_bins_packed_matches_jax(m, narrow):
    rng = np.random.default_rng(m)
    sbins, smm, runs = _sorted_args(rng, b=3, k=256, m=m, n_bins=90)
    want = np.asarray(jsim.shared_bins_packed(sbins, smm, m=m, lcap=256))
    if narrow:
        sbins = quantize.narrow_i32_to_i16(sbins, int(sbins[sbins < 2**30]
                                                      .max()))
        smm = smm.astype(np.int16)
    got = similarity.shared_bins_packed(
        torch.from_numpy(sbins), torch.from_numpy(smm), m=m, runs=runs)
    assert got.dtype == torch.int32 and got.shape == (3, m, m)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # a larger run axis changes nothing; a smaller one is refused
    more = similarity.shared_bins_packed(
        torch.from_numpy(sbins), torch.from_numpy(smm), m=m, runs=runs + 5)
    assert torch.equal(more, got)
    with pytest.raises(ValueError, match="runs"):
        similarity.shared_bins_packed(torch.from_numpy(sbins),
                                      torch.from_numpy(smm), m=m,
                                      runs=runs - 1)


def test_medoid_sort_matches_jax_dispatch():
    """The backend's per-row sort of the real peaks only gives the JAX
    dispatch's full-row sort, padding included."""
    for jbatch in jpacked.pack_bucketize(_ragged_clusters(6),
                                         bucket_members=True):
        batch = packed.packed_batch_from_arrays(dataclasses.asdict(jbatch))
        bins = jquantize.medoid_bins_packed(jbatch, JaxMedoidConfig())
        m = jbatch.m
        mm = np.where(jbatch.member_id >= 0, jbatch.member_id, m)
        order = np.argsort(bins.astype(np.int64) * (m + 1) + mm, axis=1,
                           kind="stable")
        sbins, smm, runs, enc = TorchBackend(device="cpu")._medoid_sorted(
            batch, MedoidConfig())
        assert enc == "i32"
        np.testing.assert_array_equal(
            sbins, np.take_along_axis(bins, order, axis=1))
        np.testing.assert_array_equal(
            smm, np.take_along_axis(mm, order, axis=1).astype(np.int32))
        assert runs.tolist() == [
            len(np.unique(r)) for r in sbins
        ]


def test_medoid_finalize_matches_jax():
    rng = np.random.default_rng(8)
    b, m = 6, 32
    n_members = rng.integers(1, m + 1, size=b)
    member_mask = np.arange(m) < n_members[:, None]
    n_peaks = np.where(member_mask, rng.integers(0, 60, size=(b, m)), 0)
    shared = rng.integers(0, 60, size=(b, m, m))
    shared = np.minimum(shared, shared.transpose(0, 2, 1))
    shared[:, 3, :] = shared[:, 5, :]  # tied rows: lowest index wins
    shared[:, :, 3] = shared[:, :, 5]
    n_peaks[:, 3] = n_peaks[:, 5]
    want = jsim.medoid_finalize(shared, n_peaks, member_mask, n_members)
    got = similarity.medoid_finalize(shared, n_peaks, member_mask,
                                     n_members)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --- picks ---------------------------------------------------------------

def _edge_cluster():
    """One-decimal m/z values on exact 0.1 Da grid edges."""
    members = []
    for k, base in enumerate(([100.1, 250.7, 999.9],
                              [100.1, 250.7, 999.89],
                              [100.14, 250.72, 999.9])):
        members.append(Spectrum(
            mz=np.array(base), intensity=np.array([5.0, 7.0, 9.0]),
            precursor_mz=500.0, precursor_charge=2,
            title=f"c1;mzspec:PXD1:r:scan:{k}",
        ))
    return [Cluster("c1", members)]


def _identical_cluster(rng):
    s = make_cluster(rng, n_members=1).members[0]
    return [Cluster("c1", [
        Spectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                 title=f"c1;scan{i}")
        for i in range(4)
    ])]


def _case(name, rng):
    if name == "random":
        return _port(_random_clusters(rng))
    if name == "edges":
        return _edge_cluster()
    if name == "identical":
        return _identical_cluster(rng)
    if name == "singletons":
        return _port([make_cluster(rng, f"s{i}", n_members=1)
                      for i in range(3)])
    if name == "mixed":
        return _port([
            make_cluster(rng, f"cluster-{i}", n_members=m, n_peaks=20)
            for i, m in enumerate([1, 7, 2, 7, 15, 1, 3, 40])
        ])
    if name == "peakless_members":
        # members 1 and 3 of a five-member cluster have no peak, beside a
        # cluster whose first member has none
        clusters = _port([
            make_cluster(rng, f"cluster-{i}", n_members=m, n_peaks=30)
            for i, m in enumerate([5, 3])
        ])
        for c, empty in zip(clusters, ((1, 3), (0,))):
            for k in empty:
                s = c.members[k]
                s.mz, s.intensity = s.mz[:0], s.intensity[:0]
        return clusters
    if name == "all_peakless":
        # a cluster none of whose members has a peak, between two others
        clusters = _port([
            make_cluster(rng, f"cluster-{i}", n_members=m, n_peaks=25)
            for i, m in enumerate([3, 4, 2])
        ])
        for s in clusters[1].members:
            s.mz, s.intensity = s.mz[:0], s.intensity[:0]
        return clusters
    raise ValueError(name)


def _as_jax(clusters):
    from specpride_tpu.data.peaks import Cluster as JCluster
    from specpride_tpu.data.peaks import Spectrum as JSpectrum

    return [JCluster(c.cluster_id, [
        JSpectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                  s.rt, s.title) for s in c.members
    ]) for c in clusters]


CASES = ["random", "edges", "identical", "singletons", "mixed",
         "peakless_members", "all_peakless"]


@pytest.mark.parametrize("case", CASES)
def test_medoid_indices_match_jax_and_oracle(case, rng):
    clusters = _case(case, rng)
    jclusters = _as_jax(clusters)
    got = TorchBackend(device="cpu").medoid_indices(clusters)
    oracle = [jnb.medoid_index(c.members) for c in jclusters]
    assert got == oracle
    assert got == [numpy_backend.medoid_index(c.members) for c in clusters]
    assert got == TpuBackend(layout="bucketized",
                             medoid_device_select=False).medoid_indices(
                                 jclusters)
    assert got == TpuBackend().medoid_indices(jclusters)
    if case == "identical":
        assert got == [0]
    if case == "singletons":
        assert got == [0, 0, 0]


@pytest.mark.parametrize("case", ["peakless_members", "all_peakless"])
def test_medoid_peakless_reps_match_jax_and_oracle(case, rng):
    """Clusters with peakless members and an all-peakless cluster: the
    representatives (``run_medoid``) are the same members, with the same
    peak counts, on the port's CPU path, the JAX bucketized path, the JAX
    default route and the numpy oracle."""
    clusters = _case(case, rng)
    jclusters = _as_jax(clusters)
    got = TorchBackend(device="cpu").run_medoid(clusters)
    refs = [
        jnb.run_medoid(jclusters),
        TpuBackend(layout="bucketized",
                   medoid_device_select=False).run_medoid(jclusters),
        TpuBackend().run_medoid(jclusters),
    ]
    titles = [r.title for r in got]
    counts = [r.n_peaks for r in got]
    if case == "all_peakless":
        assert counts[1] == 0
    for ref in refs:
        assert [r.title for r in ref] == titles
        assert [r.n_peaks for r in ref] == counts


@pytest.mark.parametrize("case", ["peakless_members", "all_peakless"])
def test_peakless_consensus_and_cosines_match_jax(case, rng):
    """The same peakless cases through the consensus methods and the QC
    cosine: bin-mean and gap-average peak counts equal to the JAX flat
    path's, the default route's and the oracle's, and the medoid
    representatives' mean cosines (``average_cosines``) within the
    cosine tolerance of the JAX device path and the oracle."""
    clusters = _case(case, rng)
    jclusters = _as_jax(clusters)
    port = TorchBackend(device="cpu")
    for method in ("run_bin_mean", "run_gap_average"):
        counts = [r.n_peaks for r in getattr(port, method)(clusters)]
        for ref in (TpuBackend(layout="flat"), TpuBackend(), jnb):
            assert [r.n_peaks for r in getattr(ref, method)(
                jclusters)] == counts, (method, ref)
    reps = port.run_medoid(clusters)
    jreps = _as_jax([Cluster(r.cluster_id, [r]) for r in reps])
    got = port.average_cosines(reps, clusters)
    oracle = [jnb.average_cosine(r.members[0], c.members)
              for r, c in zip(jreps, jclusters)]
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, TpuBackend().average_cosines([r.members[0] for r in jreps],
                                          jclusters),
        rtol=1e-5, atol=1e-6)
    if case == "all_peakless":
        assert got[1] == 0.0


@pytest.mark.parametrize("grid", [64 * 1024 * 1024, 3000, 1])
def test_medoid_chunking_keeps_picks(grid, rng):
    """Small ``max_grid_elements`` cut each batch into several chunks (one
    row each at the smallest): the picks do not move, and every chunk is
    counted."""
    clusters = _case("random", rng)
    backend = TorchBackend(device="cpu", max_grid_elements=grid)
    got = backend.medoid_indices(clusters)
    assert got == [numpy_backend.medoid_index(c.members) for c in clusters]
    if grid == 1:
        assert backend.chunks == len(clusters)
    assert backend.medoid_encodings == {"i32": backend.chunks, "i16": 0}
    assert backend.h2d_bytes["h2d"] > 0 and backend.d2h_bytes["d2h"] > 0


def test_run_medoid_returns_members(rng):
    clusters = _case("random", rng)
    reps = TorchBackend(device="cpu").run_medoid(clusters)
    oracle = numpy_backend.run_medoid(clusters)
    assert len(reps) == len(oracle) == len(clusters)
    assert all(a is b for a, b in zip(reps, oracle))


# --- guards and precision ------------------------------------------------

def test_refuses_empty_cluster(rng):
    clusters = _case("random", rng) + [Cluster("empty", [])]
    with pytest.raises(ValueError, match="empty cluster"):
        TorchBackend(device="cpu").medoid_indices(clusters)


def test_refuses_member_of_2_16_peaks(rng):
    big = np.sort(rng.uniform(100.0, 2000.0, size=1 << 16))
    clusters = [Cluster("big", [
        Spectrum(big, np.ones_like(big), 500.0, 2, title="big;a"),
        Spectrum(big[:10], np.ones(10), 500.0, 2, title="big;b"),
    ])]
    with pytest.raises(ValueError, match=r"2\*\*16 peaks"):
        TorchBackend(device="cpu").medoid_indices(clusters)
    with pytest.raises(ValueError, match=r"2\*\*16 peaks"):
        TpuBackend(layout="bucketized").medoid_indices(_as_jax(clusters))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_reduced_precision_ships_int16_same_picks(precision, rng):
    clusters = _case("mixed", rng) + _case("random", rng)
    f32 = TorchBackend(device="cpu")
    red = TorchBackend(device="cpu", precision=precision)
    assert red.medoid_indices(clusters) == f32.medoid_indices(clusters)
    assert red.medoid_encodings == {"i32": 0, "i16": red.chunks}
    assert red.chunks == f32.chunks
    assert red.h2d_bytes["h2d"] * 2 == f32.h2d_bytes["h2d"]
    assert red.d2h_bytes == f32.d2h_bytes
    jclusters = _as_jax(clusters)
    assert red.medoid_indices(clusters) == TpuBackend(
        layout="bucketized", medoid_device_select=False,
        precision=precision).medoid_indices(jclusters)


def test_grid_too_large_for_int16_falls_back_to_int32(rng):
    """At 0.01 Da the global grid passes 2^15 - 1 (m/z above 327.67): the
    reduced run ships int32, records it, and picks as f32 does."""
    clusters = _case("random", rng)
    cfg = MedoidConfig(bin_size=0.01)
    red = TorchBackend(device="cpu", precision="bf16")
    f32 = TorchBackend(device="cpu")
    assert red.medoid_indices(clusters, cfg) == f32.medoid_indices(
        clusters, cfg)
    assert red.medoid_encodings == {"i32": red.chunks, "i16": 0}
    assert red.h2d_bytes == f32.h2d_bytes
