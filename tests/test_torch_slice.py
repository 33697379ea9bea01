"""The slice end to end on the CPU: ``TorchBackend.run_bin_mean`` against
the JAX package's flat device path and against the numpy oracle.

Against JAX: the same peaks, bit-identical m/z (both compute it on the
host with the same numpy code) and intensity within rtol 1e-5 (float32
sums in another order).  Against the oracle: the tolerances of the JAX
package's own flat-vs-oracle test (tests/test_pallas.py:157-162)."""

import dataclasses

import numpy as np
import pytest
import torch
from conftest import make_cluster

from specpride_tpu.backends import numpy_backend as nb
from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import BinMeanConfig as JaxBinMeanConfig
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BinMeanConfig
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.ops import kernels


def _clusters(seed, n=14):
    rng = np.random.default_rng(seed)
    return [
        make_cluster(rng, f"cluster-{i}", n_members=int(rng.integers(1, 9)),
                     n_peaks=int(rng.integers(20, 150)),
                     charge=int(rng.integers(2, 4)))
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


CONFIGS = {
    "da": {},
    "ppm": dict(tolerance_mode="ppm", ppm=20.0),
    "no_quorum": dict(apply_peak_quorum=False),
}


@pytest.mark.parametrize("max_grid", [64 * 1024 * 1024, 4096])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_run_bin_mean_matches_jax_and_oracle(cfg, max_grid):
    clusters = _clusters(21 + len(cfg))
    jcfg = JaxBinMeanConfig(**CONFIGS[cfg])
    config = BinMeanConfig(**dataclasses.asdict(jcfg))
    backend = TorchBackend(device="cpu", max_grid_elements=max_grid)
    before = kernels.launches["seg_mean"]

    got = backend.run_bin_mean(_port(clusters), config)
    want = TpuBackend(layout="flat", max_grid_elements=max_grid).run_bin_mean(
        clusters, jcfg
    )
    oracle = nb.run_bin_mean(clusters, jcfg)

    assert kernels.launches["seg_mean"] == before
    assert backend.chunks >= (3 if max_grid == 4096 else 1)
    assert set(backend.phase_seconds) == {
        "pack", "h2d", "kernel", "d2h", "finalize",
        "qc_pack", "qc_h2d", "qc_kernel", "qc_d2h",
    }
    assert backend.cos_chunks == 0
    assert len(got) == len(want) == len(oracle) == len(clusters)
    for g, w, o in zip(got, want, oracle):
        assert g.title == w.title == o.title
        assert g.n_peaks == w.n_peaks == o.n_peaks
        np.testing.assert_array_equal(g.mz, w.mz)
        np.testing.assert_allclose(g.intensity, w.intensity, rtol=1e-5)
        assert g.precursor_mz == w.precursor_mz
        assert g.precursor_charge == w.precursor_charge
        np.testing.assert_allclose(g.mz, o.mz, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(
            g.intensity, o.intensity, rtol=1e-4, atol=1e-3
        )


def test_run_bin_mean_cluster_without_kept_peaks():
    """A cluster whose peaks all fall outside the grid gives an empty
    spectrum in its slot, as the oracle does."""
    clusters = _clusters(3, n=4)
    for s in clusters[1].members:
        s.mz = s.mz + 5000.0
    config = BinMeanConfig()
    got = TorchBackend(device="cpu", max_grid_elements=2048).run_bin_mean(
        _port(clusters), config
    )
    oracle = nb.run_bin_mean(clusters)
    assert [s.n_peaks for s in got] == [s.n_peaks for s in oracle]
    assert got[1].n_peaks == 0


@pytest.mark.parametrize("bad", ["empty", "mixed_charge"])
def test_run_bin_mean_rejects_bad_clusters(bad):
    clusters = _port(_clusters(4, n=3))
    if bad == "empty":
        clusters[1] = Cluster("nothing", [])
    else:
        clusters[2].members[0].precursor_charge += 1
    with pytest.raises(ValueError):
        TorchBackend(device="cpu").run_bin_mean(clusters)


def test_backend_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBackend()
