"""The port's QC cosine on the CPU against the JAX package's flat cosine
(``TpuBackend(layout="flat")``) and the numpy oracle.

``cosine_flat`` is fed the twelve arrays that the JAX package's
``_dispatch_cosine_flat`` builds, chunk by chunk.  Against JAX the
tolerance is rtol 1e-5 / atol 1e-6 (float32 sums in another order: the
port's float64 within-run prefixes against XLA's float32 scans); against
the oracle rtol 5e-5 / atol 1e-5, and atol 5e-5 where member intensity
scales differ by orders of magnitude, as the JAX package's own parity
tests hold its device path (tests/test_tpu_parity.py:453-566)."""

import dataclasses

import numpy as np
import pytest
import torch
from conftest import make_cluster

from specpride_tpu.backends import numpy_backend as nb
from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import CosineConfig as JaxCosineConfig
from specpride_tpu.data.peaks import Cluster as JaxCluster
from specpride_tpu.data.peaks import Spectrum as JaxSpectrum
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import CosineConfig
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.ops import kernels, similarity

JAX_TOL = dict(rtol=1e-5, atol=1e-6)
ORACLE_TOL = dict(rtol=5e-5, atol=1e-5)


def _clusters(seed, n=12):
    rng = np.random.default_rng(seed)
    return [
        make_cluster(
            rng, f"cluster-{i}", n_members=int(rng.integers(1, 9)),
            n_peaks=int(rng.integers(5, 120)),
            jitter=float(rng.uniform(0.001, 0.02)), base_scan=1000 * i,
        )
        for i in range(n)
    ]


def _spectrum(s):
    return Spectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                    s.rt, s.title)


def _port(clusters):
    return [Cluster(c.cluster_id, [_spectrum(s) for s in c.members])
            for c in clusters]


def _capture_cosine_flat(backend):
    """Make ``backend`` record the arguments and result of every
    ``cosine_flat`` it dispatches, as numpy."""
    calls = []

    def kfn(plain, donated):
        def run(*args, **kw):
            host = [np.array(a) for a in args]
            out = plain(*args, **kw)
            calls.append((host, kw, np.asarray(out)))
            return out
        return run

    backend._kfn = kfn
    return calls


@pytest.mark.parametrize("max_grid", [64 * 1024 * 1024, 4096])
def test_cosine_flat_matches_jax_on_its_arrays(max_grid):
    clusters = _clusters(31)
    reps = nb.run_bin_mean(clusters)
    backend = TpuBackend(layout="flat", max_grid_elements=max_grid)
    calls = _capture_cosine_flat(backend)
    backend.average_cosines(reps, clusters)
    assert len(calls) >= (3 if max_grid == 4096 else 1)
    before = kernels.launches["seg_scan"]
    for arrays, kw, want in calls:
        assert len(arrays) == 12
        got = similarity.cosine_flat(
            *(torch.from_numpy(a) for a in arrays), shift=kw["shift"]
        ).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **JAX_TOL)
    assert kernels.launches["seg_scan"] == before  # CPU: no launch


def _mixed_scale_clusters(rng, ratio):
    base = np.sort(rng.uniform(150.0, 1500.0, 50))
    clusters = []
    for i in range(6):
        members = []
        for m in range(4):
            scale = ratio if m % 2 == 0 else 1.0
            members.append(JaxSpectrum(
                mz=np.sort(base + rng.normal(0, 0.001, base.size)),
                intensity=rng.uniform(0.5, 1.0, base.size) * scale,
                precursor_mz=500.0, precursor_charge=2, rt=float(m),
                title=f"c{i};mzspec:PXD1:r:scan:{i * 10 + m}",
            ))
        clusters.append(JaxCluster(f"c{i}", members))
    return clusters, nb.run_bin_mean(clusters)


def _behaviour(case, rng):
    """(reps, clusters, cosine config fields, max_grid_elements, oracle
    tolerance) for one pinned reference behaviour."""
    big = 64 * 1024 * 1024
    if case == "self_similarity":
        s = make_cluster(rng, "c1", n_members=1).members[0]
        return [s], [JaxCluster("c1", [s])], {}, big, ORACLE_TOL
    if case == "unsorted_member":
        # the grid stops at the pair's LAST peak m/z, not the max
        rep = JaxSpectrum(mz=[200.0, 300.0], intensity=[10.0, 20.0],
                          precursor_mz=400.0, precursor_charge=2, title="c1")
        member = JaxSpectrum(
            mz=[200.0, 900.0, 950.0, 300.0], intensity=[10.0, 300.0, 1.0, 20.0],
            precursor_mz=400.0, precursor_charge=2, title="c1;u1",
        )
        return [rep], [JaxCluster("c1", [member])], {}, big, ORACLE_TOL
    if case == "empty_rep_and_member":
        full = make_cluster(rng, "c-full", n_members=3, n_peaks=20)
        empty_rep = JaxSpectrum(mz=[], intensity=[], precursor_mz=500.0,
                                precursor_charge=2, title="c-full")
        mixed = JaxCluster("c-mixed", [
            JaxSpectrum(mz=[], intensity=[], precursor_mz=500.0,
                        precursor_charge=2, title="c-mixed;u0"),
            full.members[0],
        ])
        reps = [empty_rep, nb.run_bin_mean([mixed])[0],
                nb.run_bin_mean([full])[0]]
        return reps, [full, mixed, full], {}, big, ORACLE_TOL
    if case.startswith("mixed_scale_"):
        clusters, reps = _mixed_scale_clusters(rng, float(case[12:]))
        return reps, clusters, {}, big, dict(rtol=5e-5, atol=5e-5)
    clusters = _clusters(int(rng.integers(1000)), n=14)
    reps = nb.run_bin_mean(clusters)
    if case == "multi_chunk":
        return reps, clusters, {}, 4096, ORACLE_TOL
    if case in ("sqrt", "log"):
        return reps, clusters, {"normalization": case}, big, ORACLE_TOL
    raise ValueError(case)


BEHAVIOURS = [
    "self_similarity", "unsorted_member", "empty_rep_and_member",
    "mixed_scale_100", "mixed_scale_1000", "mixed_scale_1000000",
    "multi_chunk", "sqrt", "log",
]


@pytest.mark.parametrize("case", BEHAVIOURS)
def test_average_cosines_pins_reference_behaviour(case):
    rng = np.random.default_rng(BEHAVIOURS.index(case) + 7)
    reps, clusters, fields, max_grid, oracle_tol = _behaviour(case, rng)
    jcfg = JaxCosineConfig(**fields)
    backend = TorchBackend(device="cpu", max_grid_elements=max_grid)

    got = backend.average_cosines(
        [_spectrum(r) for r in reps], _port(clusters),
        CosineConfig(**dataclasses.asdict(jcfg)),
    )
    want = TpuBackend(
        layout="flat", max_grid_elements=max_grid
    ).average_cosines(reps, clusters, jcfg)
    oracle = np.array([
        nb.average_cosine(r, c.members, jcfg) for r, c in zip(reps, clusters)
    ])

    assert got.dtype == np.float64 and got.shape == (len(clusters),)
    np.testing.assert_allclose(got, want, **JAX_TOL)
    np.testing.assert_allclose(got, oracle, **oracle_tol)
    if case == "self_similarity":
        np.testing.assert_allclose(got, [1.0], rtol=1e-5)
    if case == "empty_rep_and_member":
        assert got[0] == 0.0
        assert 0.0 < got[1] < 1.0  # the empty member weighs the mean
    if case == "multi_chunk":
        assert backend.cos_chunks >= 3


@pytest.mark.parametrize("max_grid", [64 * 1024 * 1024, 4096])
def test_run_bin_mean_with_cosines_matches_jax_and_oracle(max_grid):
    clusters = _clusters(41, n=10)
    backend = TorchBackend(device="cpu", max_grid_elements=max_grid)
    before = dict(kernels.launches)

    reps, cos = backend.run_bin_mean_with_cosines(_port(clusters))
    want_reps, want_cos = TpuBackend(
        layout="flat", max_grid_elements=max_grid
    ).run_bin_mean_with_cosines(clusters)
    # the oracle scores the port's own representatives
    oracle = np.array([
        nb.average_cosine(JaxSpectrum(r.mz, r.intensity), c.members)
        for r, c in zip(reps, clusters)
    ])

    assert kernels.launches == before  # CPU: no launch
    assert set(backend.phase_seconds) == {
        "pack", "h2d", "kernel", "d2h", "finalize",
        "qc_pack", "qc_h2d", "qc_kernel", "qc_d2h",
    }
    assert backend.cos_chunks >= (3 if max_grid == 4096 else 1)
    assert [s.title for s in reps] == [s.title for s in want_reps]
    for g, w in zip(reps, want_reps):
        np.testing.assert_array_equal(g.mz, w.mz)
        np.testing.assert_allclose(g.intensity, w.intensity, rtol=1e-5)
    np.testing.assert_allclose(cos, want_cos, **JAX_TOL)
    np.testing.assert_allclose(cos, oracle, **ORACLE_TOL)
    # composition: the same as the consensus, then the cosine of its reps
    np.testing.assert_array_equal(
        cos, TorchBackend(device="cpu", max_grid_elements=max_grid)
        .average_cosines(reps, _port(clusters)),
    )


def test_average_cosines_rejects_misaligned_and_empty():
    clusters = _port(_clusters(5, n=3))
    reps = TorchBackend(device="cpu").run_bin_mean(clusters)
    with pytest.raises(ValueError, match="align"):
        TorchBackend(device="cpu").average_cosines(reps[:2], clusters)
    clusters[1] = Cluster("nothing", [])
    with pytest.raises(ValueError, match="empty"):
        TorchBackend(device="cpu").average_cosines(reps, clusters)
