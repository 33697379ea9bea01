"""The port's bucketized (B, K) layout against the JAX package's, fed the
same inputs on the CPU.

Packs (``pack_bucketize_bin_mean``, ``pack_bucketize_gap``,
``merge_cluster_sources``) and the 2-D run helpers must give arrays equal
to the JAX package's.  The ops (``bin_mean_deduped_compact``,
``gap_average_compact2d``, ``cosine_packed``) against their JAX
counterparts on the same packed arguments, and ``TorchBackend(layout=
"bucketized")`` against ``TpuBackend(layout="bucketized")`` (with
``force_device`` for the gap average, as the JAX package's own tests run
it): peak counts and quorum decisions equal; m/z within rtol 1e-5 / atol
1e-3 and intensity within rtol 1e-4 / atol 1e-3 (``ROADMAP.md``, from
``tests/test_pallas.py``); cosines within rtol 1e-5 / atol 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_cluster

from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import BatchConfig as JaxBatchConfig
from specpride_tpu.config import BinMeanConfig as JaxBinMeanConfig
from specpride_tpu.config import CosineConfig as JaxCosineConfig
from specpride_tpu.config import GapAverageConfig as JaxGapConfig
from specpride_tpu.data import packed as jpacked
from specpride_tpu.ops import binning as jbinning
from specpride_tpu.ops import gap_average as jgap
from specpride_tpu.ops import segments as jsg
from specpride_tpu.ops import similarity as jsim
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import (
    BatchConfig,
    BinMeanConfig,
    CosineConfig,
    GapAverageConfig,
)
from specpride_tpu_torch.data import packed
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.ops import binning, gap_average, kernels, quantize
from specpride_tpu_torch.ops import segments as sg
from specpride_tpu_torch.ops import similarity

MZ_TOL = dict(rtol=1e-5, atol=1e-3)
INT_TOL = dict(rtol=1e-4, atol=1e-3)
COS_TOL = dict(rtol=1e-5, atol=1e-6)
# small buckets, so a few dozen clusters fill several batches of each K
SMALL = dict(total_peak_buckets=(256, 1024, 4096), clusters_per_batch=7)


def _jax_clusters(seed, n=24):
    rng = np.random.default_rng(seed)
    return [
        make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 9)),
                     n_peaks=int(rng.integers(5, 150)), base_scan=100 * i)
        for i in range(n)
    ]


def _port(clusters):
    return [
        Cluster(c.cluster_id, [
            Spectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                     s.rt, s.title)
            for s in c.members
        ])
        for c in clusters
    ]


def _same_fields(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


def _assert_spectra(got, want, exact_mz=False):
    assert [s.title for s in got] == [s.title for s in want]
    for g, w in zip(got, want):
        assert g.n_peaks == w.n_peaks, g.title
        if exact_mz:
            np.testing.assert_array_equal(g.mz, w.mz)
        np.testing.assert_allclose(g.mz, w.mz, **MZ_TOL)
        np.testing.assert_allclose(g.intensity, w.intensity, **INT_TOL)
        assert g.precursor_mz == w.precursor_mz
        assert g.precursor_charge == w.precursor_charge


# -- packs ----------------------------------------------------------------


@pytest.mark.parametrize("unsorted", [False, True])
def test_pack_bucketize_bin_mean_equals_jax(unsorted):
    clusters = _jax_clusters(3)
    if unsorted:  # the dedup's lexsort path: spectra out of m/z order
        for c in clusters[::3]:
            for s in c.members:
                s.mz = s.mz[::-1].copy()
                s.intensity = s.intensity[::-1].copy()
    got = packed.pack_bucketize_bin_mean(
        _port(clusters), BinMeanConfig(), BatchConfig(**SMALL))
    want = jpacked.pack_bucketize_bin_mean(
        clusters, JaxBinMeanConfig(), JaxBatchConfig(**SMALL))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        _same_fields(g, w, [f.name for f in dataclasses.fields(w)])


@pytest.mark.parametrize("tail_mode", ["reference", "split"])
def test_pack_bucketize_gap_equals_jax(tail_mode):
    clusters = _jax_clusters(5)
    got = packed.pack_bucketize_gap(
        _port(clusters), GapAverageConfig(tail_mode=tail_mode),
        BatchConfig(**SMALL))
    want = jpacked.pack_bucketize_gap(
        clusters, JaxGapConfig(tail_mode=tail_mode), JaxBatchConfig(**SMALL))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        _same_fields(g, w, [f.name for f in dataclasses.fields(w)])


def test_merge_cluster_sources_equals_jax():
    parts = [_jax_clusters(s, n) for s, n in ((1, 3), (2, 0), (3, 5))]
    got_merged, got_spans = packed.merge_cluster_sources(
        [_port(p) for p in parts])
    want_merged, want_spans = jpacked.merge_cluster_sources(parts)
    assert got_spans == want_spans == [(0, 3), (3, 3), (3, 8)]
    assert ([c.cluster_id for c in got_merged]
            == [c.cluster_id for c in want_merged])


def test_run_starts2d_and_ends2d_equal_jax():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.integers(0, 6, (9, 40)), axis=1).astype(np.int32)
    keys[3] = 7  # one row a single run
    starts = sg.run_starts2d(torch.from_numpy(keys))
    want = jsg.run_starts2d(jnp.asarray(keys))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sg.run_ends2d(starts).numpy(),
                                  np.asarray(jsg.run_ends2d(want)))
    b = np.sort(rng.integers(0, 3, (9, 40)), axis=1)
    got2 = sg.run_starts2d2(torch.from_numpy(keys), torch.from_numpy(b))
    comp = keys.astype(np.int64) * 10 + b
    np.testing.assert_array_equal(
        got2.numpy(), np.asarray(jsg.run_starts2d(jnp.asarray(comp))))


def test_seg_scan2d_is_row_local_like_jax():
    rng = np.random.default_rng(1)
    keys = np.sort(rng.integers(0, 5, (6, 33)), axis=1).astype(np.int32)
    vals = [rng.uniform(-1, 1, (6, 33)).astype(np.float32) for _ in range(3)]
    starts = sg.run_starts2d(torch.from_numpy(keys))
    got = sg.seg_scan2d(starts, tuple(torch.from_numpy(v) for v in vals))
    want = jsg.seg_scan(jsg.run_starts2d(jnp.asarray(keys)),
                        tuple(jnp.asarray(v) for v in vals), 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# -- ops ------------------------------------------------------------------


@pytest.mark.parametrize("apply_quorum", [True, False])
def test_bin_mean_deduped_compact_matches_jax(apply_quorum):
    clusters = _jax_clusters(7)
    jcfg = JaxBinMeanConfig(apply_peak_quorum=apply_quorum)
    for batch in jpacked.pack_bucketize_bin_mean(
            clusters, jcfg, JaxBatchConfig(**SMALL)):
        dist = int(jnp.sum(jnp.asarray(
            jpacked_distinct(batch.bins, jcfg.n_bins))))
        want = np.asarray(jbinning.bin_mean_deduped_compact(
            batch.mz, batch.intensity, batch.bins, batch.n_members,
            config=jcfg, total_cap=dist))
        got = binning.bin_mean_deduped_compact(
            torch.from_numpy(batch.mz), torch.from_numpy(batch.intensity),
            torch.from_numpy(batch.bins), torch.from_numpy(batch.n_members),
            n_bins=jcfg.n_bins, quorum_fraction=jcfg.quorum_fraction,
            apply_quorum=apply_quorum, total_cap=dist).numpy()
        b = batch.mz.shape[0]
        np.testing.assert_array_equal(got[2 * dist:], want[2 * dist:])
        np.testing.assert_allclose(got[:dist], want[:dist], **MZ_TOL)
        np.testing.assert_allclose(got[dist:2 * dist], want[dist:2 * dist],
                                   **INT_TOL)
        assert got.size == 2 * dist + b


def jpacked_distinct(bins, n_bins):
    heads = np.ones(bins.shape, dtype=bool)
    heads[:, 1:] = bins[:, 1:] != bins[:, :-1]
    return (heads & (bins < n_bins)).sum(axis=1)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_gap_average_compact2d_matches_jax(precision):
    clusters = _jax_clusters(9)
    jcfg = JaxGapConfig()
    for batch in jpacked.pack_bucketize_gap(clusters, jcfg,
                                            JaxBatchConfig(**SMALL)):
        cap = int(batch.n_groups.sum())
        inten, scale = quantize.encode_intensity_rows(batch.intensity,
                                                      precision)
        want = np.asarray(jgap.gap_average_compact(
            batch.mz, inten, batch.seg, batch.n_valid, batch.quorum,
            batch.n_members, config=jcfg, total_cap=cap))
        got = gap_average.gap_average_compact2d(
            torch.from_numpy(batch.mz), quantize.codes_tensor(inten),
            torch.from_numpy(batch.seg), torch.from_numpy(batch.n_valid),
            torch.from_numpy(batch.quorum),
            torch.from_numpy(batch.n_members), dyn_range=jcfg.dyn_range,
            total_cap=cap).numpy()
        np.testing.assert_array_equal(got[2 * cap:], want[2 * cap:])
        np.testing.assert_allclose(got[:cap], want[:cap], **MZ_TOL)
        np.testing.assert_allclose(got[cap:2 * cap], want[cap:2 * cap],
                                   **INT_TOL)


@pytest.mark.parametrize("norm", ["none", "sqrt"])
def test_cosine_packed_matches_jax(norm):
    clusters = _jax_clusters(11)
    reps = TpuBackend(layout="bucketized").run_bin_mean(clusters)
    port_clusters = _port(clusters)
    port_reps = _port([Cluster(r.title, [r]) for r in reps])
    port_reps = [c.members[0] for c in port_reps]
    backend = TorchBackend(device="cpu", layout="bucketized")
    config = CosineConfig(normalization=norm)
    for batch in packed.pack_bucketize(port_clusters, BatchConfig(**SMALL)):
        arrays, _ = backend._cosine_rows(port_reps, port_clusters, batch,
                                         config)
        want_mean, want_cos = jsim.cosine_packed(
            *[jnp.asarray(a) for a in arrays], batch.n_members, m=batch.m)
        got = similarity.cosine_packed(
            *[torch.from_numpy(a) for a in arrays], m=batch.m).numpy()
        np.testing.assert_allclose(got, np.asarray(want_cos), **COS_TOL)
        mean = got.astype(np.float64).sum(1) / np.maximum(batch.n_members, 1)
        np.testing.assert_allclose(mean, np.asarray(want_mean), **COS_TOL)


# -- the backend ------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_run_bin_mean_bucketized_matches_jax(precision):
    clusters = _jax_clusters(13, n=40)
    want = TpuBackend(layout="bucketized", precision=precision,
                      batch_config=JaxBatchConfig(**SMALL)).run_bin_mean(
        clusters)
    backend = TorchBackend(device="cpu", layout="bucketized",
                           precision=precision,
                           batch_config=BatchConfig(**SMALL))
    got = backend.run_bin_mean(_port(clusters))
    _assert_spectra(got, want)
    assert backend.chunks >= 2
    assert (backend.bucket_elements["padded"]
            > backend.bucket_elements["real"] > 0)


@pytest.mark.parametrize("norm", ["none", "log"])
def test_run_bin_mean_with_cosines_bucketized_matches_jax(norm):
    clusters = _jax_clusters(17, n=30)
    want_reps, _ = TpuBackend(
        layout="bucketized").run_bin_mean_with_cosines(
            clusters, JaxBinMeanConfig(), JaxCosineConfig(normalization=norm))
    backend = TorchBackend(device="cpu", layout="bucketized")
    got_reps, got_cos = backend.run_bin_mean_with_cosines(
        _port(clusters), BinMeanConfig(), CosineConfig(normalization=norm))
    _assert_spectra(got_reps, want_reps)
    # the JAX cosines of the port's own representatives: m/z means a float32
    # ulp apart can fall on either side of a cosine bin edge
    from specpride_tpu.data.peaks import Spectrum as JaxSpectrum

    jreps = [JaxSpectrum(r.mz, r.intensity, r.precursor_mz,
                         r.precursor_charge, r.rt, r.title)
             for r in got_reps]
    want_cos = TpuBackend(layout="bucketized").average_cosines(
        jreps, clusters, JaxCosineConfig(normalization=norm))
    np.testing.assert_allclose(got_cos, want_cos, **COS_TOL)
    assert backend.cos_chunks >= 1
    # the same QC as the flat layout's cosine of the same representatives
    flat = TorchBackend(device="cpu").average_cosines(
        got_reps, _port(clusters), CosineConfig(normalization=norm))
    np.testing.assert_allclose(got_cos, flat, **COS_TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_run_gap_average_bucketized_matches_jax(precision):
    clusters = _jax_clusters(19, n=30)
    want = TpuBackend(layout="bucketized", force_device=True,
                      precision=precision).run_gap_average(clusters)
    got = TorchBackend(device="cpu", layout="bucketized",
                       precision=precision).run_gap_average(_port(clusters))
    _assert_spectra(got, want)


def _quorum_cluster(n_members, shared):
    """``n_members`` spectra sharing bins at 300 and 700 m/z; a bin at
    500 m/z in the first ``shared`` members only."""
    members = []
    for i in range(n_members):
        mz = [300.0, 500.0, 700.0] if i < shared else [300.0, 700.0]
        members.append(Spectrum(
            np.array(mz), np.full(len(mz), 10.0 + i), 450.0, 2, 10.0,
            f"q;mzspec:PXD000001:run1:scan:{i + 1}"))
    return Cluster("q", members)


def test_f32_device_quorum_is_kept_where_it_differs_from_f64():
    """At fraction 0.7 and 90 members the float64 host quorum is
    ``int(62.999...) + 1 = 63`` and the float32 device quorum
    ``floor(63.0) + 1 = 64`` (the CLI's ``--quorum-fraction`` takes any
    float, and fractions 0.35, 0.65 and 0.7 have such member counts below
    2,000).  A bin in 63 of the 90 members: the flat layout keeps it, the
    bucketized one drops it, in both packages."""
    n, frac = 90, 0.7
    q = binning.device_quorum(torch.tensor([n], dtype=torch.int32), frac)
    assert float(q[0]) == 64.0 and int(n * frac) + 1 == 63
    jq = jnp.floor(jnp.asarray([n], jnp.int32).astype(jnp.float32) * frac)
    assert float(q[0]) == float(jq[0]) + 1.0

    cluster = _quorum_cluster(n, 63)
    config = BinMeanConfig(quorum_fraction=frac)
    jconfig = JaxBinMeanConfig(quorum_fraction=frac)
    (bucket,) = TorchBackend(device="cpu", layout="bucketized").run_bin_mean(
        [cluster], config)
    (flat,) = TorchBackend(device="cpu").run_bin_mean([cluster], config)
    (jbucket,) = TpuBackend(layout="bucketized").run_bin_mean([cluster],
                                                              jconfig)
    (jflat,) = TpuBackend(layout="flat").run_bin_mean([cluster], jconfig)
    assert bucket.n_peaks == jbucket.n_peaks == 2
    assert flat.n_peaks == jflat.n_peaks == 3
    np.testing.assert_allclose(bucket.mz, jbucket.mz, **MZ_TOL)
    # one member fewer than the f32 quorum: dropped; at it: kept
    (at,) = TorchBackend(device="cpu", layout="bucketized").run_bin_mean(
        [_quorum_cluster(n, 64)], config)
    assert at.n_peaks == 3


def test_run_shared_equals_solo_runs():
    parts = [_port(_jax_clusters(s, n)) for s, n in ((21, 6), (22, 4))]
    backend = TorchBackend(device="cpu", layout="bucketized")
    shared = backend.run_shared("bin-mean", parts, BinMeanConfig(),
                                CosineConfig())
    for part, (reps, cosines) in zip(parts, shared):
        solo_reps, solo_cos = TorchBackend(
            device="cpu", layout="bucketized").run_bin_mean_with_cosines(
                part)
        assert len(reps) == len(part)
        for a, b in zip(reps, solo_reps):
            assert a.title == b.title
            np.testing.assert_array_equal(a.mz, b.mz)
            np.testing.assert_array_equal(a.intensity, b.intensity)
        np.testing.assert_array_equal(cosines, solo_cos)
    with pytest.raises(ValueError, match="not batchable"):
        backend.run_shared("best", parts, None)


def test_bucketized_runs_no_pack_stage_and_rejects_bad_layout():
    backend = TorchBackend(device="cpu", layout="bucketized")
    assert not backend.supports_prepare("bin-mean")
    assert not backend.supports_prepare("gap-average")
    assert backend.supports_prepare("medoid")
    assert TorchBackend(device="cpu", layout="flat").supports_prepare(
        "bin-mean")
    with pytest.raises(ValueError, match="layout"):
        TorchBackend(device="cpu", layout="sideways")


def test_bucketized_launches_the_kernels_only_on_the_card():
    """On the CPU the wrappers take their plain versions: nothing is
    launched; the (B, K) consensus reaches ``seg_mean_heads`` (one call
    per dispatch) and the cosine ``seg_scan`` (four per dispatch)."""
    calls = {"seg_mean_heads": 0, "seg_scan": 0}
    heads, scan = kernels.seg_mean_heads, kernels.seg_scan

    def counting_heads(*a):
        calls["seg_mean_heads"] += 1
        return heads(*a)

    def counting_scan(*a):
        calls["seg_scan"] += 1
        return scan(*a)

    before = dict(kernels.launches)
    kernels.seg_mean_heads, kernels.seg_scan = counting_heads, counting_scan
    try:
        backend = TorchBackend(device="cpu", layout="bucketized")
        backend.run_bin_mean_with_cosines(_port(_jax_clusters(23, n=10)))
    finally:
        kernels.seg_mean_heads, kernels.seg_scan = heads, scan
    assert kernels.launches == before
    assert calls["seg_mean_heads"] == backend.chunks >= 1
    assert calls["seg_scan"] == 4 * backend.cos_chunks
