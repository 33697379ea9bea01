"""Reduced precision on the port's binned-mean path (``--precision``),
against the JAX package fed the same inputs.

The encoders are the same numpy arithmetic, so their codes and scales
must be bit-identical to the JAX package's (bf16 compared as 16-bit
patterns: the port casts through ``torch.bfloat16``, the JAX package
through ``ml_dtypes``).  ``bin_mean_flat_q`` against the JAX
``_bin_mean_flat_q`` on the arguments its flat dispatch builds: kept
means within rtol 1e-5 (float32 sums in another order), the kept count
equal.  ``run_bin_mean`` at bf16/int8 against the JAX flat run at the same
precision: the same peaks, identical m/z (host means), intensity within
rtol 1e-5.  f32 output is pinned to the bytes the port wrote before
reduced precision existed."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch
from conftest import make_cluster

from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import BinMeanConfig as JaxBinMeanConfig
from specpride_tpu.data import packed as jpacked
from specpride_tpu.ops import binning as jbinning
from specpride_tpu.ops import quantize as jquantize
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BinMeanConfig
from specpride_tpu_torch.data import packed
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.io.mgf import write_mgf
from specpride_tpu_torch.ops import binning, kernels, quantize

REDUCED = ["bf16", "int8"]


def _bits(a):
    """bf16 codes of either package as int16 bit patterns."""
    return np.asarray(a).view(np.int16)


def _jax_clusters(seed, n=12):
    rng = np.random.default_rng(seed)
    return [
        make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 8)),
                     n_peaks=int(rng.integers(10, 120)), base_scan=100 * i)
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


def _values(kind, rng):
    if kind == "random":
        return rng.uniform(10.0, 1e4, 700).astype(np.float32)
    if kind == "exact":  # bf16-representable values
        return np.float32([0.0, 1.0, -2.5, 512.0, 1536.0, 3.140625,
                           2.0**100])
    if kind == "ties":  # halfway between bf16 neighbours: round to even
        base = rng.uniform(1.0, 2.0, 300).astype(np.float32)
        bits = (base.view(np.uint32) & 0xFFFF0000) | 0x8000
        return bits.view(np.float32)
    if kind == "wide":
        return (rng.standard_normal(500) * 10.0 ** rng.integers(-30, 30, 500)
                ).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "exact", "ties", "wide"])
def test_bf16_encoders_match_jax_bit_for_bit(kind):
    x = _values(kind, np.random.default_rng(len(kind)))
    np.testing.assert_array_equal(quantize.bf16_bits(x),
                                  _bits(x.astype(jquantize._bf16())))
    assert quantize.bf16_exact(x) == jquantize.bf16_exact(x)
    for precision in ("f32", *REDUCED):
        got, tok = quantize.encode_mz(x, precision)
        want, jtok = jquantize.encode_mz(x, precision)
        assert tok == jtok
        if tok == "bf16":
            np.testing.assert_array_equal(got, _bits(want))
            np.testing.assert_array_equal(quantize.bf16_values(got), x)
        else:
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("precision", ["f32", *REDUCED])
@pytest.mark.parametrize("rows", ["ragged", "empty_rows", "no_peaks"])
def test_encode_intensity_flat_matches_jax(rows, precision):
    rng = np.random.default_rng(3)
    counts = {"ragged": [5, 1, 40, 17, 3],
              "empty_rows": [0, 6, 0, 0, 9, 0],
              "no_peaks": [0, 0]}[rows]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    x = rng.uniform(10.0, 1e4, offsets[-1]).astype(np.float32)
    got, scale = quantize.encode_intensity_flat(x, offsets, precision)
    want, jscale = jquantize.encode_intensity_flat(x, offsets, precision)
    if precision == "bf16":
        np.testing.assert_array_equal(got, _bits(want))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if jscale is None:
        assert scale is None
    else:
        assert scale.dtype == jscale.dtype == np.float32
        np.testing.assert_array_equal(scale, jscale)


@pytest.mark.parametrize("method", ["bin-mean", "gap-average", "medoid",
                                    "best"])
@pytest.mark.parametrize("precision", ["f32", *REDUCED])
def test_precision_tolerance_matches_jax(method, precision):
    assert quantize.precision_tolerance(method, precision) == (
        jquantize.precision_tolerance(method, precision)
    )
    assert quantize.PRECISION_MIN_COSINE == jquantize.PRECISION_MIN_COSINE
    assert quantize.PRECISIONS == jquantize.PRECISIONS


@pytest.mark.parametrize("max_elements", [16 * 1024 * 1024, 300])
@pytest.mark.parametrize("precision", REDUCED)
def test_pack_flat_bin_mean_codes_match_jax(precision, max_elements):
    jclusters = _jax_clusters(8)
    want = jpacked.pack_flat_bin_mean(jclusters, JaxBinMeanConfig(),
                                      max_elements=max_elements,
                                      precision=precision)
    got = packed.pack_flat_bin_mean(_port(jclusters), BinMeanConfig(),
                                    max_elements=max_elements,
                                    precision=precision)
    assert len(got) == len(want) >= (3 if max_elements == 300 else 1)
    for g, w in zip(got, want):
        assert g.precision == w.precision == precision
        np.testing.assert_array_equal(g.intensity, w.intensity)
        np.testing.assert_array_equal(g.gbin, w.gbin)
        if precision == "bf16":
            assert g.codes.dtype == np.int16 and g.scale is None
            np.testing.assert_array_equal(g.codes, _bits(w.codes))
        else:
            assert g.codes.dtype == w.codes.dtype == np.int8
            np.testing.assert_array_equal(g.codes, w.codes)
            np.testing.assert_array_equal(g.scale, w.scale)
        # and the JAX batch converts to the same port batch
        again = packed.flat_batch_from_arrays(dataclasses.asdict(w))
        np.testing.assert_array_equal(again.codes, g.codes)
        assert again.precision == precision


def _jax_flat_args(precision, seed=9):
    """One JAX-packed reduced chunk and the numpy arguments its flat
    dispatch hands ``_bin_mean_flat_q`` (padded tail run included)."""
    (batch,) = jpacked.pack_flat_bin_mean(
        _jax_clusters(seed), JaxBinMeanConfig(), precision=precision
    )
    backend = TpuBackend(layout="flat", precision=precision)
    args, aux, meta = backend._flat_chunk_host_args(batch, JaxBinMeanConfig())
    assert meta["precision"] == precision
    return batch, args, aux, meta


@pytest.mark.parametrize("impl", ["scan", "pallas_interpret"])
@pytest.mark.parametrize("precision", REDUCED)
def test_bin_mean_flat_q_matches_jax(precision, impl):
    _, (codes, run_start, keep_runs), aux, meta = _jax_flat_args(precision)
    want = np.asarray(jbinning.bin_mean_flat_q(
        codes, run_start, keep_runs, total_cap=meta["cap"],
        rcap=meta["rcap"], lcap=meta["lcap"], impl=impl,
    ))
    if precision == "bf16":
        codes = _bits(codes)
    before = dict(kernels.launches)
    got = binning.bin_mean_flat_q(
        quantize.codes_tensor(codes), torch.from_numpy(run_start),
        torch.from_numpy(keep_runs), total_cap=meta["cap"],
        rcap=meta["rcap"],
    ).numpy()
    assert kernels.launches == before  # CPU: the plain version
    n_kept = int(aux["row_out_offsets"][-1])
    assert n_kept == int(aux["keep"].sum()) > 0
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert not got[n_kept:].any() and not want[n_kept:].any()


@pytest.mark.parametrize("precision", REDUCED)
def test_jax_reduced_chunk_through_port_dispatch(precision):
    """A JAX-packed reduced chunk, converted by ``flat_batch_from_arrays``,
    through the port's dispatch: the JAX flat dispatch's kept runs and
    m/z, intensity means of the codes within rtol 1e-5."""
    jbatch, _, _, _ = _jax_flat_args(precision, seed=10)
    batch = packed.flat_batch_from_arrays(dataclasses.asdict(jbatch))
    backend = TorchBackend(device="cpu")
    got, aux = backend._flat_chunk_dispatch(
        batch, backend._flat_chunk_host_args(batch, BinMeanConfig())
    )
    want, jaux = TpuBackend(layout="flat", precision=precision)\
        ._flat_chunk_dispatch(jbatch, JaxBinMeanConfig())
    n = int(jaux["row_out_offsets"][-1])
    np.testing.assert_array_equal(aux["keep"], jaux["keep"])
    np.testing.assert_array_equal(aux["kept_mz"], jaux["kept_mz"])
    np.testing.assert_allclose(got, np.asarray(want)[:n], rtol=1e-5, atol=0)


@pytest.mark.parametrize("max_grid", [64 * 1024 * 1024, 2048])
@pytest.mark.parametrize("precision", REDUCED)
def test_run_bin_mean_reduced_matches_jax_flat(precision, max_grid):
    jclusters = _jax_clusters(11, n=16)
    backend = TorchBackend(device="cpu", max_grid_elements=max_grid,
                           precision=precision)
    got = backend.run_bin_mean(_port(jclusters))
    want = TpuBackend(layout="flat", precision=precision,
                      max_grid_elements=max_grid).run_bin_mean(jclusters)
    assert backend.chunks >= (3 if max_grid == 2048 else 1)
    assert len(got) == len(want) == len(jclusters)
    for g, w in zip(got, want):
        assert g.title == w.title and g.n_peaks == w.n_peaks
        np.testing.assert_array_equal(g.mz, w.mz)
        np.testing.assert_allclose(g.intensity, w.intensity, rtol=1e-5)
        assert g.precursor_mz == w.precursor_mz
        assert g.precursor_charge == w.precursor_charge


def test_h2d_bytes_per_peak_fall_with_precision():
    """f32 sends 8 B per peak (intensity and key) plus a keep byte per
    run; bf16 3 B and int8 2 B per peak plus the same keep bytes."""
    clusters = _port(_jax_clusters(12, n=10))
    sent, peaks, runs = {}, None, None
    for precision in ("f32", *REDUCED):
        backend = TorchBackend(device="cpu", precision=precision)
        backend.run_bin_mean(clusters)
        sent[precision] = backend.h2d_bytes["h2d"]
        assert backend.h2d_bytes["qc_h2d"] == 0
    for b in packed.pack_flat_bin_mean(clusters, BinMeanConfig()):
        peaks = (peaks or 0) + b.gbin.size
        runs = (runs or 0) + b.n_distinct_total
    assert sent["f32"] == 8 * peaks + runs
    assert sent["bf16"] == 3 * peaks + runs
    assert sent["int8"] == 2 * peaks + runs


def _pin_workload(seed=17, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        skel = np.sort(rng.uniform(120, 1800, int(rng.integers(20, 120))))
        members = [
            Spectrum(np.sort(skel + rng.normal(0, 0.004, skel.size)),
                     rng.uniform(10, 1e4, skel.size), 500.0 + i, 2,
                     float(m), f"c{i};mzspec:PXD1:r:scan:{100 * i + m}")
            for m in range(int(rng.integers(1, 9)))
        ]
        out.append(Cluster(f"c{i}", members))
    return out


# sha256 of the MGF that the port wrote for ``_pin_workload`` before it had
# reduced precision (the same bytes whether one chunk or many)
F32_PIN = "c86bd1f58febf6664fa23f42400f629667589bce8fd9829e100c59cc1f42f3f8"


@pytest.mark.parametrize("max_grid", [64 * 1024 * 1024, 4096])
def test_f32_output_bytes_unchanged(max_grid, tmp_path):
    clusters = _pin_workload()
    for backend in (TorchBackend(device="cpu", max_grid_elements=max_grid),
                    TorchBackend(device="cpu", max_grid_elements=max_grid,
                                 precision="f32")):
        path = tmp_path / "out.mgf"
        write_mgf(backend.run_bin_mean(clusters), path)
        assert hashlib.sha256(path.read_bytes()).hexdigest() == F32_PIN


def test_backend_rejects_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        TorchBackend(device="cpu", precision="fp8")
