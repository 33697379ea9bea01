"""The port's flat packer against the JAX package's: on the same clusters
every field of every chunk must be equal, exactly."""

import dataclasses

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import BinMeanConfig as JaxBinMeanConfig
from specpride_tpu.data import packed as jpacked
from specpride_tpu.data import table as jtable
from specpride_tpu.data.peaks import Spectrum as JaxSpectrum
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BinMeanConfig
from specpride_tpu_torch.data import packed, table
from specpride_tpu_torch.data.peaks import Cluster, Spectrum

FIELDS = [f.name for f in dataclasses.fields(packed.FlatBinBatch)]


def _jax_clusters(seed, n=10):
    rng = np.random.default_rng(seed)
    return [
        make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 8)),
                     n_peaks=int(rng.integers(10, 90)), base_scan=100 * i)
        for i in range(n)
    ]


def _port_clusters(clusters):
    return [
        Cluster(c.cluster_id, [
            Spectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                     s.rt, s.title)
            for s in c.members
        ])
        for c in clusters
    ]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name


@pytest.mark.parametrize(
    "layout",
    ["one_chunk", "multi_chunk", "ppm", "unsorted_mz", "interleaved"],
)
def test_pack_flat_bin_mean_matches_jax(layout):
    jclusters = _jax_clusters(3)
    kwargs = {}
    cfg = {}
    if layout == "multi_chunk":
        kwargs["max_elements"] = 300
    if layout == "ppm":
        cfg = dict(tolerance_mode="ppm", ppm=15.0)
    if layout == "unsorted_mz":  # the dedup lexsort fallback
        s = jclusters[2].members[0]
        perm = np.random.default_rng(0).permutation(s.n_peaks)
        s.mz, s.intensity = s.mz[perm], s.intensity[perm]
        dup = jclusters[4].members[1]  # plus duplicate (member, bin) peaks
        dup.mz[3:6] = dup.mz[2]
    jcfg, pcfg = JaxBinMeanConfig(**cfg), BinMeanConfig(**cfg)
    if layout == "interleaved":
        # spectra in file order with clusters interleaved: the packer
        # regroups them by cluster
        order = np.random.default_rng(1).permutation(
            sum(c.n_members for c in jclusters)
        )
        jspec = [s for c in jclusters for s in c.members]
        jspec = [jspec[i] for i in order]
        pspec = [Spectrum(s.mz, s.intensity, s.precursor_mz,
                          s.precursor_charge, s.rt, s.title) for s in jspec]
        want_in = jtable.SpectraTable.from_spectra(jspec)
        got_in = table.SpectraTable.from_spectra(pspec)
    else:
        want_in, got_in = jclusters, _port_clusters(jclusters)
    want = jpacked.pack_flat_bin_mean(want_in, jcfg, **kwargs)
    got = packed.pack_flat_bin_mean(got_in, pcfg, **kwargs)
    if layout == "multi_chunk":
        assert len(want) >= 3
    _assert_same_batches(got, want)


def test_flat_batch_from_arrays_round_trips():
    jclusters = _jax_clusters(4)
    want = jpacked.pack_flat_bin_mean(
        jclusters, JaxBinMeanConfig(), max_elements=400
    )
    got = [packed.flat_batch_from_arrays(dataclasses.asdict(b))
           for b in want]
    _assert_same_batches(got, want)
    again = [packed.flat_batch_from_arrays(dataclasses.asdict(b))
             for b in got]
    _assert_same_batches(again, want)


def test_flat_batch_from_arrays_refuses_reduced_precision():
    """Reduced-precision batches are taken (tests/test_torch_precision.py)
    but refused where their fields cannot be the JAX packer's: an unknown
    precision, codes missing, codes of the wrong width, an int8 batch
    without its scale, codes on an f32 batch."""
    jclusters = _jax_clusters(5, n=3)
    (bf16,) = jpacked.pack_flat_bin_mean(jclusters, JaxBinMeanConfig(),
                                         precision="bf16")
    (int8,) = jpacked.pack_flat_bin_mean(jclusters, JaxBinMeanConfig(),
                                         precision="int8")
    bad = [
        dict(dataclasses.asdict(bf16), precision="fp8"),
        dict(dataclasses.asdict(bf16), codes=None),
        dict(dataclasses.asdict(bf16), codes=int8.codes),
        dict(dataclasses.asdict(int8), scale=None),
        dict(dataclasses.asdict(int8), precision="f32"),
    ]
    for fields in bad:
        with pytest.raises(ValueError, match="precision|codes|scale"):
            packed.flat_batch_from_arrays(fields)


def test_jax_packed_chunk_through_port_dispatch():
    """One JAX-packed chunk through the port's dispatch: the same kept
    runs and m/z means as the JAX flat dispatch, intensity within rtol
    1e-5."""
    jclusters = _jax_clusters(6)
    (jbatch,) = jpacked.pack_flat_bin_mean(jclusters, JaxBinMeanConfig())
    batch = packed.flat_batch_from_arrays(dataclasses.asdict(jbatch))
    backend = TorchBackend(device="cpu")
    got, aux = backend._flat_chunk_dispatch(
        batch, backend._flat_chunk_host_args(batch, BinMeanConfig())
    )
    want, jaux = TpuBackend(layout="flat")._flat_chunk_dispatch(
        jbatch, JaxBinMeanConfig()
    )
    want = np.asarray(want)
    n = int(jaux["row_out_offsets"][-1])
    assert got.shape == (n,)
    np.testing.assert_array_equal(aux["keep"], jaux["keep"])
    np.testing.assert_array_equal(aux["kept_mz"], jaux["kept_mz"])
    np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=0)
    assert not want[n:].any()
