#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``specpride_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

1. prints the card and its power limit, builds the CUDA kernels from
   ``specpride_tpu_torch/ops/csrc`` with nvcc (sm_90a);
2. kernel phase: ``seg_mean`` against ``seg_mean_plain`` on the card
   (nv = 1 and 2, N = 16,777,216 and a ragged N, runs of 1-20, one run
   across many tiles, masked slots, a -1 tail), and times the kernel, the
   plain version and ``torch.segment_reduce`` with CUDA events;
3. slice phase: ``TorchBackend(device="cuda").run_bin_mean`` on 20,000
   synthetic clusters (seed 42, about 27M peaks, two or more chunks),
   counting kernel launches, against the same run on the CPU;
4. CLI phase: ``python -m specpride_tpu_torch consensus`` on a
   2,000-cluster MGF, against a CPU run;
5. prints a ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failed phase exits non-zero.  It exits non-zero, printing no result,
where CUDA is unavailable or the package is not beside it.  Full
measurements also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TOL = dict(rtol=1e-5, atol=0.0)  # f32 tile sums vs f64 plain prefixes
KERNEL_N = 16 * 1024 * 1024  # the main path's chunk cap
RAGGED_N = 10_000_019
SLICE_CLUSTERS = 20_000
CLI_CLUSTERS = 2_000


def make_workload(n_clusters: int, seed: int = 42):
    """Synthetic clustered MS/MS workload shaped like the PXD004732
    benchmark set (the repo's bench.py generator): cluster sizes skewed
    small (most 2-8 members, tail to 20), 100-400 peaks per spectrum,
    0.003 Da m/z jitter within a cluster."""
    from specpride_tpu_torch.data.peaks import Cluster, Spectrum

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
            members.append(
                Spectrum(
                    mz=mz,
                    intensity=rng.uniform(10.0, 1e4, size=n_peaks),
                    precursor_mz=float(rng.uniform(300.0, 900.0)),
                    precursor_charge=charge,
                    rt=float(i),
                    title=f"cluster-{i};mzspec:PXD1:r:scan:{i * 100 + k}",
                )
            )
        clusters.append(Cluster(f"cluster-{i}", members))
    return clusters


def kernel_inputs(n: int, nv: int, seed: int):
    """Keys in runs of 1-20 (the path's shape), one run of 5,000
    elements (several tiles), 3% masked slots and a -1 padding tail."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 21, size=n // 5 + 1)
    lens[len(lens) // 3] = 5000
    keys = np.repeat(np.arange(lens.size, dtype=np.int64), lens)[:n]
    keys[n - 50_000:] = -1
    w = (rng.uniform(0, 1, n) > 0.03).astype(np.float32)
    w[keys < 0] = 0.0
    values = [rng.uniform(10.0, 1e4, n).astype(np.float32)
              for _ in range(nv)]
    return keys.astype(np.int32), w, values


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(got, want, what: str) -> float:
    """Counts equal, means within TOL; returns the means' max abs error."""
    import torch

    if not torch.equal(got[0], want[0]):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"{what}: {bad} counts differ")
    err = 0.0
    for c, (g, e) in enumerate(zip(got[1:], want[1:])):
        bad = ~torch.isclose(g, e, **TOL)
        if bad.any():
            i = int(torch.nonzero(bad)[0])
            raise AssertionError(
                f"{what}: {int(bad.sum())} of channel {c}'s means outside "
                f"{TOL}; first at {i}: {float(g[i])!r} vs {float(e[i])!r} "
                f"(count {float(got[0][i])})"
            )
        err = max(err, float((g - e).abs().max()))
    return err


def kernel_phase(kernels) -> dict:
    import torch

    dev = torch.device("cuda")
    res = {"cases": []}
    for n in (KERNEL_N, RAGGED_N):
        for nv in (1, 2):
            keys, w, values = kernel_inputs(n, nv, seed=n % 97 + nv)
            args = [torch.from_numpy(a).to(dev) for a in (keys, w, *values)]
            got = kernels.seg_mean(*args)
            torch.cuda.synchronize()
            want = kernels.seg_mean_plain(*args)
            case = {"n": n, "nv": nv,
                    "max_abs_err": compare(got, want, f"n={n} nv={nv}")}
            if n == KERNEL_N:
                head = torch.ones(n, dtype=torch.bool, device=dev)
                head[1:] = args[0][1:] != args[0][:-1]
                bounds = torch.nonzero(head).squeeze(1)
                lengths = torch.diff(bounds, append=torch.tensor(
                    [n], device=dev))
                stacked = torch.stack(
                    [args[1]] + [v * args[1] for v in args[2:]], dim=1
                )
                case["ms"] = time_ms(lambda: kernels.seg_mean(*args))
                case["plain_ms"] = time_ms(
                    lambda: kernels.seg_mean_plain(*args)
                )
                # the yardstick yields only each run's totals: the run-end
                # subset of the kernel's output that the path consumes
                case["library_ms"] = time_ms(lambda: torch.segment_reduce(
                    stacked, "sum", lengths=lengths, axis=0, unsafe=True
                ))
                case["library"] = "torch.segment_reduce, run totals only"
                case["bound_ms"] = n * (12 + 8 * nv) / HBM_BYTES_PER_S * 1e3
            res["cases"].append(case)
            print(f"kernel seg_mean {json.dumps(case)}", flush=True)
    return res


def check_same(got, want, what: str) -> None:
    """GPU vs CPU run: same spectra, identical m/z, intensity in TOL."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} spectra")
    for g, e in zip(got, want):
        if g.title != e.title or g.n_peaks != e.n_peaks:
            raise AssertionError(f"{what}: {g.title} differs in shape")
        if not np.array_equal(g.mz, e.mz):
            raise AssertionError(f"{what}: {g.title} m/z differs")
        if not np.isfinite(g.intensity).all():
            raise AssertionError(f"{what}: {g.title} non-finite intensity")
        np.testing.assert_allclose(g.intensity, e.intensity, **TOL,
                                   err_msg=what)


def slice_phase(kernels) -> dict:
    import torch

    from specpride_tpu_torch.backends.torch_backend import TorchBackend

    t0 = time.perf_counter()
    clusters = make_workload(SLICE_CLUSTERS, seed=42)
    n_peaks = sum(c.total_peaks for c in clusters)
    gen_s = time.perf_counter() - t0
    TorchBackend(device="cuda").run_bin_mean(clusters[:200])  # warm-up

    backend = TorchBackend(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.launches["seg_mean"] = 0
    t0 = time.perf_counter()
    reps = backend.run_bin_mean(clusters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches["seg_mean"]
    if backend.chunks < 2 or launches != backend.chunks:
        raise AssertionError(
            f"slice ran {backend.chunks} chunks, {launches} launches"
        )
    ref = TorchBackend(device="cpu").run_bin_mean(clusters)
    check_same(reps, ref, "slice")
    res = {
        "clusters": len(clusters), "peaks": n_peaks,
        "spectra": sum(c.n_members for c in clusters),
        "chunks": backend.chunks, "launches": launches,
        "wall_s": wall, "clusters_per_s": len(clusters) / wall,
        "phase_s": backend.phase_seconds,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "workload_gen_s": gen_s,
    }
    print(f"slice {json.dumps(res)}", flush=True)
    return res


def cli_phase() -> dict:
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.data.peaks import group_into_clusters
    from specpride_tpu_torch.io.mgf import read_mgf, write_mgf

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    src, dst = os.path.join(work, "in.mgf"), os.path.join(work, "out.mgf")
    clusters = make_workload(CLI_CLUSTERS, seed=42)
    write_mgf([s for c in clusters for s in c.members], src)
    if os.path.exists(dst):
        os.remove(dst)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "specpride_tpu_torch", "consensus", src, dst],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI exited {proc.returncode}:\n{proc.stderr}")
    ref = TorchBackend(device="cpu").run_bin_mean(
        group_into_clusters(read_mgf(src))
    )
    check_same(read_mgf(dst), ref, "cli")
    res = {"clusters": len(clusters), "wall_s": wall}
    print(f"cli {json.dumps(res)}", flush=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "specpride_tpu_torch")):
        print("chip_smoke: the specpride_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from specpride_tpu_torch.ops import _build, kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"device {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info or {}
    print(f"build {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info.get('seconds', 0.0):.2f} s)", flush=True)
    print(info.get("log", "").strip(), flush=True)

    kres = kernel_phase(kernels)
    sres = slice_phase(kernels)
    cres = cli_phase()

    main_case = kres["cases"][0]
    entry = {
        "name": "seg_mean",
        "route": "cuda",
        "source": "specpride_tpu_torch/ops/csrc/seg_mean.cu",
        "replaces": "specpride_tpu/ops/pallas_kernels.py:187",
        "launches": sres["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in kres["cases"]),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
    }
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "kernel": kres, "slice": sres, "cli": cres,
                   "build": info.get("seconds")}, fh, indent=1)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
