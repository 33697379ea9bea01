"""Gap-average consensus in the port, against the JAX package and the
numpy oracle fed the same clusters.

``gap_global_segments`` is the same numpy code as the JAX package's and
must be equal exactly.  ``gap_average_groups`` runs on the port's flat
chunk of the clusters of each JAX (B, K) batch; its kept groups, joined to
the pack's float64 group m/z, must give the JAX kernel's compacted output
in the same row-major order.  Tolerances of the method runs are those of
the JAX package's own device-vs-oracle test (tests/test_pallas.py:
174-220): equal peak counts, m/z rtol 1e-5, intensity rtol 1e-4 / atol
1e-3 (group intensity sums in float32 on the card, in float64 in the
oracle).

The flat layout's group m/z are float64 host means, as the JAX package's
default host path takes them: on a seeded workload shaped like its
benchmark the port's default gap average gives the JAX package's m/z
exactly, and QC cosines within rtol 1e-5 / atol 1e-6."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from specpride_tpu.backends import numpy_backend as nb
from specpride_tpu.backends.tpu_backend import TpuBackend
from specpride_tpu.config import GapAverageConfig as JaxGapConfig
from specpride_tpu.data import packed as jpacked
from specpride_tpu.data.peaks import Cluster as JaxCluster
from specpride_tpu.data.peaks import Spectrum as JaxSpectrum
from specpride_tpu.ops import gap_average as jgap
from specpride_tpu_torch.backends import numpy_backend as pnb
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import GapAverageConfig
from specpride_tpu_torch.data import packed
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.ops import gap_average, kernels, quantize

TOL_MZ = dict(rtol=1e-5)
TOL_INT = dict(rtol=1e-4, atol=1e-3)


def _clusters(seed, n=14, bf16_mz=False):
    """Jittered skeletons (groups of about n_members peaks), with a few
    skeleton peaks closer than ``mz_accuracy`` (merged groups), mixed
    charges, singletons, and a member with no peaks.  ``bf16_mz`` puts
    every m/z on bf16-representable values 2 Da apart."""
    rng = np.random.default_rng(seed)
    clusters = []
    for i in range(n):
        m = int(rng.integers(1, 7)) if i else 1
        k = int(rng.integers(15, 60))
        if bf16_mz:
            skel = np.sort(rng.choice(np.arange(128, 256) * 2.0, k,
                                      replace=False))
        else:
            skel = np.sort(rng.uniform(150, 1600, k))
            skel[k // 2] = skel[k // 2 - 1] + 0.004  # within mz_accuracy
        members = []
        for j in range(m):
            if bf16_mz:
                mz = skel[rng.uniform(0, 1, k) < 0.9]
            else:
                mz = np.sort(skel + rng.normal(0, 0.002, k))
            if i == 3 and j == 1:
                mz = mz[:0]
            members.append(JaxSpectrum(
                mz=mz, intensity=rng.uniform(1, 1e4, mz.size),
                precursor_mz=float(rng.uniform(400, 900)),
                precursor_charge=int(rng.integers(2, 4)),
                rt=float(rng.uniform(10, 5000)),
                title=f"g{i};mzspec:PXD1:r:scan:{100 * i + j}",
            ))
        clusters.append(JaxCluster(f"g{i}", members))
    return clusters


def _port(clusters):
    return [
        Cluster(c.cluster_id, [
            Spectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                     s.rt, s.title)
            for s in c.members
        ])
        for c in clusters
    ]


def _assert_spectra(got, want, exact_precursor=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.title == w.title
        assert g.n_peaks == w.n_peaks, g.title
        np.testing.assert_allclose(g.mz, w.mz, **TOL_MZ, err_msg=g.title)
        np.testing.assert_allclose(g.intensity, w.intensity, **TOL_INT,
                                   err_msg=g.title)
        assert g.precursor_charge == w.precursor_charge
        assert g.precursor_mz == w.precursor_mz and g.rt == w.rt


@pytest.mark.parametrize("tail_mode", ["reference", "split"])
def test_gap_global_segments_equal_jax(tail_mode):
    from specpride_tpu.data import table as jtable
    from specpride_tpu_torch.data import table

    clusters = _clusters(1, n=20)
    jt = jtable.SpectraTable.from_clusters(clusters)
    pt = table.SpectraTable.from_clusters(_port(clusters))
    want = jpacked.gap_global_segments(jt, jt.cluster_order(),
                                       JaxGapConfig(tail_mode=tail_mode))
    got = packed.gap_global_segments(pt, pt.cluster_order(),
                                     GapAverageConfig(tail_mode=tail_mode))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_pack_flat_gap_matches_bucketized_pack(precision):
    """The flat chunk holds, row for row, the valid peaks of the JAX
    (B, K) rows, the same quorum, group counts and (int8) row scales;
    group starts are where the JAX segment id changes."""
    clusters = _clusters(2)
    cfg = GapAverageConfig()
    (chunk,) = packed.pack_flat_gap(_port(clusters), cfg, precision=precision)
    assert chunk.precision == precision
    # the group m/z: float64 means over the JAX segmentation, each group's
    # m/z added in ascending order (np.bincount), as native/gap_average.cpp
    from specpride_tpu.data import table as jtable

    jt = jtable.SpectraTable.from_clusters(clusters)
    jg = jpacked.gap_global_segments(jt, jt.cluster_order(), JaxGapConfig())
    gid = np.cumsum(jg["cluster_first_peak"] | jg["gap"]) - 1
    want_mz = np.bincount(gid, weights=jg["s_mz"]) / np.bincount(gid)
    assert chunk.group_mz.dtype == np.float64
    np.testing.assert_array_equal(chunk.group_mz, want_mz)
    assert chunk.intensity.size == chunk.group_start.size
    if precision == "f32":
        # singletons' groups are their peaks, in input order
        single = [c.members[0] for c in clusters if c.n_members == 1]
        assert single and np.array_equal(
            chunk.single_int, np.concatenate([m.intensity for m in single]))
        np.testing.assert_array_equal(
            chunk.group_mz[chunk.single_groups],
            np.concatenate([m.mz for m in single]))
    else:
        assert chunk.single_groups is None and chunk.single_int is None
    jbatches = jpacked.pack_bucketize_gap(clusters, JaxGapConfig())
    seen = 0
    for jb in jbatches:
        _, scale = quantize.encode_intensity_flat(
            jb.intensity.reshape(-1),
            np.arange(jb.mz.shape[0] + 1) * jb.mz.shape[1], precision,
        )
        for r, ci in enumerate(jb.source_indices):
            p0, p1 = chunk.row_offsets[ci], chunk.row_offsets[ci + 1]
            nv = int(jb.n_valid[r])
            assert p1 - p0 == nv
            heads = np.ones(nv, bool)
            heads[1:] = jb.seg[r, 1:nv] != jb.seg[r, : nv - 1]
            np.testing.assert_array_equal(chunk.group_start[p0:p1] != 0,
                                          heads)
            assert chunk.quorum[ci] == jb.quorum[r]
            assert chunk.n_groups[ci] == jb.n_groups[r]
            assert chunk.n_members[ci] == jb.n_members[r]
            if precision == "int8":
                assert chunk.scale[ci] == scale[r]
            seen += 1
    assert seen == len(clusters)


@pytest.mark.parametrize("impl", ["scan", "pallas_interpret"])
@pytest.mark.parametrize("tail_mode", ["reference", "split"])
def test_gap_average_compact_matches_jax(tail_mode, impl):
    clusters = _clusters(3)
    jcfg = JaxGapConfig(tail_mode=tail_mode)
    cfg = GapAverageConfig(tail_mode=tail_mode)
    port = _port(clusters)
    for jb in jpacked.pack_bucketize_gap(clusters, jcfg):
        b = len(jb.source_indices)
        cap = int(jb.n_groups.sum())
        want = np.asarray(jgap.gap_average_compact(
            jb.mz, jb.intensity, jb.seg, jb.n_valid, jb.quorum,
            jb.n_members, config=jcfg, total_cap=cap, impl=impl,
        ))
        (chunk,) = packed.pack_flat_gap([port[i] for i in jb.source_indices],
                                        cfg)
        assert int(chunk.n_groups.sum()) == cap
        before = dict(kernels.launches)
        got = gap_average.gap_average_groups(
            *(torch.from_numpy(a) for a in (
                chunk.intensity, chunk.group_start, chunk.quorum,
                chunk.n_members, chunk.n_groups)),
            dyn_range=cfg.dyn_range, total_cap=cap,
        ).numpy()
        assert kernels.launches == before  # CPU: the plain version
        assert got.shape == (2 * cap,) and want.shape == (2 * cap + b,)
        keep = got[cap:] != 0
        assert set(np.unique(got[cap:])) <= {0.0, 1.0}
        grow = np.repeat(np.arange(b), chunk.n_groups)
        np.testing.assert_array_equal(np.bincount(grow[keep], minlength=b),
                                      want[2 * cap:])
        k = int(want[2 * cap:].sum())
        assert k == keep.sum() > 0
        np.testing.assert_allclose(chunk.group_mz[keep], want[:k], **TOL_MZ)
        np.testing.assert_allclose(got[:cap][keep], want[cap : cap + k],
                                   **TOL_INT)


ESTIMATORS = [(p, r) for p in ("naive_average", "neutral_average",
                               "lower_median")
              for r in ("median", "mass_lower_median")]


@pytest.mark.parametrize("pepmass,rt", ESTIMATORS)
def test_run_gap_average_matches_jax_and_oracle(pepmass, rt):
    clusters = _clusters(4)
    if pepmass == "naive_average":  # needs one charge per cluster
        for c in clusters:
            for s in c.members:
                s.precursor_charge = 2
    jcfg = JaxGapConfig(pepmass=pepmass, rt=rt)
    cfg = GapAverageConfig(**dataclasses.asdict(jcfg))
    backend = TorchBackend(device="cpu")
    got = backend.run_gap_average(_port(clusters), cfg)
    want = TpuBackend(layout="bucketized", force_device=True)\
        .run_gap_average(clusters, jcfg)
    oracle = nb.run_gap_average(clusters, jcfg)
    assert backend.chunks == 1
    assert any(c.n_members == 1 for c in clusters)
    _assert_spectra(got, want)
    _assert_spectra(got, oracle)


@pytest.mark.parametrize("tail_mode", ["reference", "split"])
@pytest.mark.parametrize("max_grid", [64 * 1024 * 1024, 1024])
def test_run_gap_average_chunks_and_tail_modes(max_grid, tail_mode):
    clusters = _clusters(5, n=18)
    jcfg = JaxGapConfig(tail_mode=tail_mode, min_fraction=0.4,
                        dyn_range=50.0)
    cfg = GapAverageConfig(**dataclasses.asdict(jcfg))
    backend = TorchBackend(device="cpu", max_grid_elements=max_grid)
    got = backend.run_gap_average(_port(clusters), cfg)
    assert backend.chunks >= (3 if max_grid == 1024 else 1)
    assert set(backend.phase_seconds) >= {"pack", "h2d", "kernel", "d2h",
                                          "finalize"}
    _assert_spectra(got, nb.run_gap_average(clusters, jcfg))


def test_run_gap_average_cluster_without_peaks():
    clusters = _clusters(6, n=5)
    for s in clusters[2].members:
        s.mz, s.intensity = s.mz[:0], s.intensity[:0]
    got = TorchBackend(device="cpu").run_gap_average(_port(clusters))
    _assert_spectra(got, nb.run_gap_average(clusters))
    assert got[2].n_peaks == 0


def test_run_gap_average_rejects_empty_cluster():
    clusters = _port(_clusters(7, n=3))
    clusters[1] = Cluster("nothing", [])
    with pytest.raises(ValueError):
        TorchBackend(device="cpu").run_gap_average(clusters)


@pytest.mark.parametrize("bf16_mz", [False, True])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_run_gap_average_reduced_matches_jax(precision, bf16_mz):
    """Against the JAX bucketized run at the same precision (its m/z
    bf16 only where exact, which ``bf16_mz`` makes so, else float32
    means; the port's are the host's float64 means either way) with int8
    codes against the same row scales.  The flat layout ships no m/z:
    each peak crosses as its encoded intensity and a 1-byte group flag."""
    clusters = _clusters(8, bf16_mz=bf16_mz)
    backend = TorchBackend(device="cpu", precision=precision)
    got = backend.run_gap_average(_port(clusters))
    want = TpuBackend(layout="bucketized", force_device=True,
                      precision=precision).run_gap_average(clusters)
    (chunk,) = packed.pack_flat_gap(_port(clusters), GapAverageConfig(),
                                    precision=precision)
    _assert_spectra(got, want)
    f32 = TorchBackend(device="cpu")
    f32.run_gap_average(_port(clusters))
    per_peak = {"bf16": 2, "int8": 1}[precision]
    n = chunk.group_start.size
    assert chunk.intensity.itemsize == per_peak
    assert backend.h2d_bytes["h2d"] < f32.h2d_bytes["h2d"]
    assert backend.h2d_bytes["h2d"] - f32.h2d_bytes["h2d"] == n * (
        per_peak - 4)


@pytest.mark.parametrize("method", ["naive_average", "neutral_average",
                                    "lower_median"])
def test_estimators_match_jax(method):
    rng = np.random.default_rng(9)
    members = [JaxSpectrum(np.zeros(0), np.zeros(0),
                           float(rng.uniform(300, 900)), 2,
                           float(rng.uniform(0, 100)), f"x;{k}")
               for k in range(5)]
    port = _port([JaxCluster("x", members)])[0].members
    assert pnb.PEPMASS_ESTIMATORS[method](port) == \
        nb.PEPMASS_ESTIMATORS[method](members)
    for rt in ("median", "mass_lower_median"):
        assert pnb.RT_ESTIMATORS[rt](port) == nb.RT_ESTIMATORS[rt](members)
    assert pnb.PROTON_MASS == nb.PROTON_MASS


@pytest.mark.parametrize("norm", ["none", "sqrt", "log"])
def test_binned_cosine_matches_oracle(norm):
    from specpride_tpu.config import CosineConfig as JaxCosineConfig
    from specpride_tpu_torch.config import CosineConfig

    clusters = _clusters(10, n=4)
    a, b = clusters[1].members[0], clusters[2].members[0]
    pa, pb = _port([JaxCluster("p", [a, b])])[0].members
    for x, y, px, py in ((a, b, pa, pb), (a, a, pa, pa)):
        assert pnb.binned_cosine(px, py, CosineConfig(normalization=norm)) \
            == nb.binned_cosine(x, y, JaxCosineConfig(normalization=norm))


# -- the flat gap average's m/z against the JAX CLI (float64 host means) ----


def _workload(n_clusters, seed):
    """``bench.py::make_workload``, rebuilt: PXD004732-shaped clusters
    (1-20 members, 100-400 peaks, 0.003 Da jitter), JAX data classes."""
    rng = np.random.default_rng(seed)
    clusters = []
    for i in range(n_clusters):
        n_members = min(20, 1 + int(rng.gamma(2.0, 2.5)))
        n_peaks = int(rng.integers(100, 400))
        skeleton = np.sort(rng.uniform(120.0, 1900.0, size=n_peaks))
        charge = int(rng.integers(2, 4))
        members = []
        for k in range(n_members):
            mz = np.sort(skeleton + rng.normal(0.0, 0.003, size=n_peaks))
            members.append(JaxSpectrum(
                mz=mz, intensity=rng.uniform(10.0, 1e4, size=n_peaks),
                precursor_mz=float(rng.uniform(300.0, 900.0)),
                precursor_charge=charge, rt=float(i),
                title=f"cluster-{i};mzspec:PXD1:r:scan:{i * 100 + k}",
            ))
        clusters.append(JaxCluster(f"cluster-{i}", members))
    return clusters


def _peak_lines(path):
    with open(path) as fh:
        return [line.split() for line in fh if line[:1].isdigit()]


@pytest.fixture(scope="module")
def c1_runs(tmp_path_factory):
    """``consensus --method gap-average --qc-report`` with the defaults on
    ``make_workload(240, seed=11)`` written as an MGF: the JAX CLI (its
    default host path) and the port's CLI on the CPU."""
    import subprocess
    import sys

    from specpride_tpu.io.mgf import write_mgf as jwrite_mgf
    from specpride_tpu_torch import cli

    d = tmp_path_factory.mktemp("c1")
    clusters = _workload(240, seed=11)
    src = str(d / "in.mgf")
    jwrite_mgf([s for c in clusters for s in c.members], src)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "specpride_tpu", "consensus", src,
         str(d / "jax.mgf"), "--method", "gap-average", "--qc-report",
         str(d / "jax.qc.json")],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert cli.main(["consensus", src, str(d / "port.mgf"), "--device",
                     "cpu", "--method", "gap-average", "--qc-report",
                     str(d / "port.qc.json")]) == 0
    return d, clusters


def test_c1_default_gap_average_gives_the_jax_cli_mz_bytes(c1_runs):
    d, clusters = c1_runs
    got, want = _peak_lines(d / "port.mgf"), _peak_lines(d / "jax.mgf")
    assert len(got) == len(want) > 50_000
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([float(g[1]) for g in got],
                               [float(w[1]) for w in want], **TOL_INT)


def test_c1_qc_cosines_match_the_jax_cli(c1_runs):
    import json

    d, _ = c1_runs
    rows = [json.loads((d / f"{who}.qc.json").read_text())["clusters"]
            for who in ("port", "jax")]
    assert [r["cluster_id"] for r in rows[0]] == \
        [r["cluster_id"] for r in rows[1]]
    np.testing.assert_allclose([r["avg_cosine"] for r in rows[0]],
                               [r["avg_cosine"] for r in rows[1]],
                               rtol=1e-5, atol=1e-6)


def test_c1_singletons_equal_their_member(c1_runs):
    """A singleton's peaks pass through with their float64 m/z and
    intensity (then the dynamic-range floor), as the reference's
    (src/average_spectrum_clustering.py:88-90); its QC cosine is 1."""
    import json

    from specpride_tpu_torch.io.mgf import read_mgf

    d, clusters = c1_runs
    reps = {s.cluster_id: s for s in read_mgf(str(d / "port.mgf"))}
    qc = {r["cluster_id"]: r["avg_cosine"] for r in json.loads(
        (d / "port.qc.json").read_text())["clusters"]}
    singles = [c for c in clusters if c.n_members == 1]
    assert len(singles) == 14  # of 240 clusters, cluster-52 among them
    for c in singles:
        want = nb.gap_average_consensus(c.members)
        got = reps[c.cluster_id]
        np.testing.assert_array_equal(got.mz, want.mz)
        np.testing.assert_array_equal(got.intensity, want.intensity)
        assert got.mz.size == c.members[0].mz.size
        assert qc[c.cluster_id] == pytest.approx(1.0, abs=1e-12)


# (precision, layout) -> the JAX CLI's gate decision on this input and
# the port's: the port's reduced flat gap average keeps the host's float64
# m/z means, so it clears the gate against the f32 path (min cosine
# 0.999998 bf16, 0.999992 int8), while the JAX CLI's reduced run moves to
# its bucketized device path, whose float32 m/z means move peaks across
# cosine bin edges (0.969, refused); on the bucketized layout both hold
# float32 card means against the flat float64 path and both refuse
GATE_CASES = [("bf16", "auto", True), ("bf16", "flat", True),
              ("bf16", "bucketized", False), ("int8", "flat", True)]


@pytest.mark.parametrize("precision,layout,port_accepts", GATE_CASES)
def test_c1_precision_gate_decisions_against_the_jax_cli(
        precision, layout, port_accepts):
    from specpride_tpu import cli as jcli
    from specpride_tpu.observability.journal import NullJournal as JNull
    from specpride_tpu_torch import cli
    from specpride_tpu_torch.config import CosineConfig

    clusters = _workload(240, seed=11)
    args = jcli.build_parser().parse_args(
        ["consensus", "in.mgf", "out.mgf", "--method", "gap-average",
         "--precision", precision, "--layout", layout])
    with pytest.raises(SystemExit, match="precision gate FAILED"):
        jcli._precision_gate(
            args, TpuBackend(precision=precision, layout=layout), clusters,
            "gap-average", jcli.RunStats(), JNull())
    backend = TorchBackend(device="cpu", precision=precision, layout=layout)
    gate = lambda: cli.precision_gate(  # noqa: E731
        backend, "gap-average", _port(clusters), GapAverageConfig(),
        CosineConfig())
    if port_accepts:
        result = gate()
        assert result["ok"] and result["min_cosine"] > 0.99999
    else:
        with pytest.raises(SystemExit, match="precision gate failed"):
            gate()
