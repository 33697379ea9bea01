"""The port's bin_mean_flat_intensity against the JAX package's, fed the
same numpy arguments: the padded ones ``TpuBackend`` ships for a flat
chunk (sentinel tail included).  Kept means must match within rtol 1e-5
(float32 sums in another order), with the same number of kept entries."""

import numpy as np
import pytest
import torch
from conftest import make_cluster

from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import BinMeanConfig
from specpride_tpu.data.packed import pack_flat_bin_mean
from specpride_tpu.ops import binning as jbinning
from specpride_tpu_torch.ops import binning, kernels


def _chunk_args(seed, config):
    rng = np.random.default_rng(seed)
    clusters = [
        make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 9)),
                     n_peaks=int(rng.integers(20, 120)))
        for i in range(12)
    ]
    (batch,) = pack_flat_bin_mean(clusters, config)
    args, aux, meta = TpuBackend(layout="flat")._flat_chunk_host_args(
        batch, config
    )
    return args, aux, meta


@pytest.mark.parametrize("grid", ["da", "ppm"])
@pytest.mark.parametrize("impl", ["scan", "pallas_interpret"])
def test_flat_intensity_matches_jax(impl, grid):
    config = BinMeanConfig(tolerance_mode=grid)
    args, aux, meta = _chunk_args(5 if grid == "da" else 6, config)
    intensity, gbin, keep_runs = args
    assert gbin[-1] == 2**31 - 1  # the shipped args carry a sentinel tail

    want = np.asarray(jbinning.bin_mean_flat_intensity(
        intensity, gbin, keep_runs, total_cap=meta["cap"],
        rcap=meta["rcap"], lcap=meta["lcap"], impl=impl,
    ))
    before = kernels.launches["seg_mean"]
    got = binning.bin_mean_flat_intensity(
        torch.from_numpy(intensity), torch.from_numpy(gbin),
        torch.from_numpy(keep_runs), total_cap=meta["cap"],
        rcap=meta["rcap"],
    ).numpy()
    assert kernels.launches["seg_mean"] == before
    n_kept = int(aux["keep"].sum())
    assert got.shape == want.shape == (meta["cap"],)
    assert np.count_nonzero(got) == np.count_nonzero(want) == n_kept
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_flat_intensity_truncates_at_total_cap():
    """More kept runs than ``total_cap``: the first ``total_cap`` kept
    means, in run order (as ``jnp.nonzero(size=total_cap)`` gives)."""
    config = BinMeanConfig(apply_peak_quorum=False)
    args, aux, meta = _chunk_args(7, config)
    intensity, gbin, keep_runs = args
    cap = int(aux["keep"].sum()) // 2
    want = np.asarray(jbinning.bin_mean_flat_intensity(
        intensity, gbin, keep_runs, total_cap=cap, rcap=meta["rcap"],
        lcap=meta["lcap"], impl="scan",
    ))
    got = binning.bin_mean_flat_intensity(
        torch.from_numpy(intensity), torch.from_numpy(gbin),
        torch.from_numpy(keep_runs), total_cap=cap, rcap=meta["rcap"],
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
