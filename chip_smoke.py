#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``specpride_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

1. prints the card and its power limit, builds the CUDA kernels from
   ``specpride_tpu_torch/ops/csrc`` with nvcc (sm_90a, one nvcc per
   source, side by side); the host library (the sort, the MGF parser and
   formatter) builds with g++ at its first use;
2. kernel phase: ``seg_mean`` against ``seg_mean_plain`` on the card
   (nv = 1 and 2, N = 16,777,216 and a ragged N, runs of 1-20, one run
   across many tiles, masked slots, a -1 tail), and times the kernel, the
   plain version and ``torch.segment_reduce`` with CUDA events; then
   ``seg_scan`` against ``seg_scan_plain`` (head flags with nc = 1 and 2,
   sorted keys with nc = 3, at the same N), timed beside ``torch.cumsum``
   as a same-bytes reference.  Each timed case is profiled and must show
   one CUDA kernel per call, and beside its bound it is given the time of
   a plain device copy of the same traffic (``copy_ms``);
   then ``seg_mean_heads`` against ``seg_mean_heads_plain`` (head flags;
   one f32 (the flat gap average's intensities), bf16 or int8 channel,
   f32/f32 and f32/int8 channel pairs at 16M, a ragged N, and pointers
   one element off alignment), timed the same way;
   stress phase: 200 calls of both kernels back to back on one stream, N
   cycling through the path's shape, 16M, a ragged N, 1, one tile and one
   tile + 1, each against its plain version; extremes: 16M elements as
   one run and as 16M runs; streams: both kernels on two streams at once,
   each with its own workspace;
3. slice phase: ``TorchBackend(device="cuda").run_bin_mean_with_cosines``
   (consensus and QC cosine) on 20,000 synthetic clusters (seed 42, about
   27M peaks, two or more consensus and cosine chunks), counting kernel
   launches, against the same run on the CPU (of every
   ``REF_STRIDE``-th cluster, as every 20k CPU reference, so every chunk
   is held); precision phase: the same
   consensus at ``precision="bf16"`` and ``"int8"``, each
   representative's cosine to the f32 one held to the precision
   tolerance, H2D bytes per peak beside f32's; gap phase:
   ``run_gap_average`` on the same clusters at f32 and int8 against CPU
   runs, the m/z (the host's float64 group means) identical and the
   singletons equal to their member; medoid phase: ``run_medoid`` on the same clusters at f32 and
   bf16 (int16 channels), the picks identical to each other, to a CPU run
   and to the numpy oracle on subsets, no hand-written kernel launched,
   the shared-bin counts' device time beside their bound; select phase:
   ``run_medoid`` then ``average_cosines`` (five ``seg_scan`` launches per
   cosine chunk) against a CPU run, and ``run_best_spectrum`` on seeded
   scores with 5 % of clusters scoreless; every run with the launch counts
   zeroed just before it; then ``seg_scan`` against its plain version and
   timed at the path's largest scans;
4. CLI phase: ``python -m specpride_tpu_torch consensus`` with
   ``--qc-report`` (a child process: the CLI's wall), then in this
   process (``cli.main``) with ``--method gap-average --qc-report`` and
   with ``--precision int8`` on a 2,000-cluster MGF, each against a CPU
   run;
   ``select --method medoid --qc-report``, ``select --method best --msms
   --qc-report`` and ``select --precision bf16`` on the golden clustered
   MGF, each against the port's ``--device cpu`` run;
   host sort phase: the packs' segmented sorts and searches on
   slice-20k's first 5,000 clusters (consensus pack, QC member prep, QC
   rep sort, cosine chunk search, medoid per-row sort, gap pack, and the
   consensus pack's dedup lexsort), native (``ops/csrc/segsort.cpp``)
   against plain numpy, identical, each beside its stage's wall, with the
   host's core count;
   executor phase: slice-20k with QC through the CLI's
   chunked executor (``cli._checkpointed_run``, 512 clusters a chunk) at
   ``--prefetch 0``, the defaults, ``--h2d-buffer 2`` and ``--pack-workers
   0``, the bytes of output, manifest and QC report identical, one
   ``seg_mean`` and five ``seg_scan`` launches per chunk; medoid, gap f32
   and bin-mean int8 through it at the defaults; files phase: the same
   clusters as a clustered MGF written by the native writer (its first
   500 clusters also by the numpy writer, the same bytes) and parsed
   back by the native parser (the head also by the Python parser), the
   spectra written bit for bit; ``consensus --qc-report`` on the file as
   a subprocess, its output and report the executor's bytes; ``evaluate``
   (five ``seg_scan`` launches per cosine chunk, no ``seg_mean``) against
   the slice's cosines and, on the head, a ``--device cpu`` run;
   ``consensus --single`` and ``convert`` against the CPU; kill phase:
   the CLI on the 2,000-cluster MGF killed (SIGKILL) after its first
   committed chunk and resumed, its output and QC report the bytes of an
   uninterrupted run;
5. robustness: stream phase (inside the files phase): ``consensus
   --qc-report --checkpoint`` on the 1.0 GB file at the default
   ``--stream-clusters auto`` (it streams) and ``off``, the executor's
   bytes each, with each run's wall, phases and peak RSS, and
   the host library's byte index timed and held to the Python scan;
   quarantine phase: CLI-2k with a truncated and an unparseable block
   under ``--on-error skip``, eager and streamed (the same output and
   quarantine file), and under ``abort`` (a non-zero exit, no file);
   chaos phase: ``select --method medoid --qc-report`` and the main path
   with a fault at every site (I/O, an OOM split, a hang the watchdog
   breaks), the clean run's bytes, and the main path's OOM split held to
   the clean run at the tolerances; real OOM phase: a genuine
   ``torch.OutOfMemoryError`` under a capped allocator splits an int8
   consensus chunk to the clean bytes, and the kernels match their plain
   versions afterwards;
6. the bucketized layout and the cluster split: bucketized-20k phase:
   slice-20k through ``TorchBackend(layout="bucketized")``, bin-mean with
   QC, gap-average f32 and bin-mean int8, one ``seg_mean_heads`` launch
   per consensus dispatch and four ``seg_scan`` per cosine dispatch, each
   against the port's CPU run of the same layout, the bin-mean's peak
   counts against the flat run's, with the padded and real peak slots
   and the H2D bytes; mesh phase: the same bin-mean with QC over a
   ``DeviceMesh`` of every visible card and of the one card twice (two
   streams), the bucketized bytes exactly; ranks phase: CLI-2k as two
   ``--coordinator`` ranks on the card joined by ``merge-parts``, against
   the single-process ``--mesh`` run: the medoid and int8 bytes, the f32
   bin-mean and its QC report at the tolerances with the changed bits
   counted; elastic phase (``elastic_phase``): files-20k as two
   ``--elastic`` ranks joined by ``merge-parts --elastic``, exec-20k's
   bytes and launches, each rank's wall and peak RSS; then on CLI-2k a
   forced steal, a killed rank taken over, an object-store run on a
   ``cas-server`` process with the result cache's shared tier cold and
   warm (no launch, a rank's live ``/metrics`` scraped), and ``fleet
   --ranks 2``, each merged to the single-process bytes, and a custom
   ``--elastic-range`` off the ``--checkpoint-every`` grid, its changed
   peaks and largest relative errors beside the tolerances;
7. telemetry phase, on CLI-2k: ``consensus --qc-report --journal
   --metrics-out --trace-dir`` on the card, the journal read back with no
   schema violation, its ``dispatch`` and ``chunk_done`` events counted
   against the ``seg_mean`` and ``seg_scan`` launches, the textfile's
   ``specpride_*`` families with a device-memory gauge above 0, the
   ``torch.profiler`` trace's CUDA kernels naming both hand-written
   kernels, and ``stats`` over the journal; ``consensus --method
   gap-average --qc-report`` against ``--device cpu`` (m/z identical,
   singletons equal to their member, one ``seg_mean_heads`` launch per
   chunk); ``evaluate --layout bucketized`` against the CPU; ``plot``
   (skipped, with a line saying so, where matplotlib does not import);
8. tracing phase, on CLI-2k in process: ``consensus --qc-report`` with
   and without ``--journal --chrome-trace`` (the same launches and
   bytes), the journal read back with no violation, one trace id on
   every event, a ``kernel:*`` span per ``dispatch`` event and per
   launch, top-level spans covering at least 95 % of the phase seconds;
   ``trace`` and the ``--chrome-trace`` file holding every span; ``stats
   --top-spans 10`` and ``stats --trace ID`` timed; then the tracer's
   cost on exec-20k (untraced, traced, untraced, traced, the same bytes);
   result-cache phase: ``--result-cache`` on CLI-2k for bin-mean and
   gap-average consensus and medoid select with QC, cold (the launches
   and bytes of a run without it) and warm (every cluster a hit, no
   launch, no ``dispatch`` event, the same bytes), the digest, read,
   write and scan costs on one thread, then the executor on slice-20k's
   first 2,000 clusters without the cache, cold and warm; serve phase: a daemon process (``serve --journal
   --metrics-port 0 --metrics-out``), its spawn-to-ping wall and
   ``boot_s``; CLI-2k's bin-mean with QC, gap-average and medoid with QC
   as ``submit`` children (no torch imported) beside the one-shot CLI on
   the same argv (a cold child for bin-mean, in this process for the
   others), the same bytes, the job journals clean and
   the bin-mean job's 4 + 4 ``dispatch`` events; ``profile --seconds 2``
   during a CLI-2k job (both kernels in the trace); files-20k twice (the
   MGF written anew; exec-20k's bytes, the repeat an ingest-cache hit),
   the daemon's peak RSS; SIGTERM (exit 0 within 60 s, the journal
   ending in ``serve_drain`` and ``run_end``, the drain exposition valid
   and counting every job); then daemons in this process: CLI-2k's
   halves on two lanes of the card (two streams) and as one batched pair
   (``--batch-window 50``), each time the halves' solo bytes, with the
   launches of each step against the solo runs'; flightrec phase: two
   daemon processes with and without ``--flightrec on`` taking CLI-2k jobs
   in turns under a 1 ms SLO (the golden bytes, one bundled
   ``slo_breach`` incident, ``incidents list|show|export``,
   ``incident-replay``, both drains exiting 0, the submit walls and the
   bundle's dump seconds and bytes), elastic ranks with ``--flightrec
   on`` and an injected retry (``retry_exhaust``, the coordinator's
   counters in the bundle), ``off`` and no flag (the same launches and
   bytes), and ``fleet --flightrec observe`` (no torch in the
   supervisor, its journal replayed clean); autotune phase: a daemon
   process with ``--autotune on`` under a burst of five CLI-2k jobs (an
   acted ``batch_window_ms`` decision, the golden bytes, the
   ``specpride_autotune_*`` series, ``autotune.json`` in the
   ``slo_breach`` bundle, ``autotune-replay`` exit 0, the drain exit 0),
   two ``--elastic`` ranks with ``--autotune on`` and a forced steal (the
   single run's bytes, every cede within the split hint and one cut
   down to it) and ``fleet --autotune observe`` (no torch in the
   supervisor); warmup phase: a shape manifest from a CLI-2k run,
   ``warmup`` in a fresh child (each
   entry's status and seconds), a ``--warmup manifest`` daemon and a
   ``--warmup off`` one taking three jobs each in turns (``warmed_kernels``,
   the first and repeat ``submit`` walls, the warm's own launches, every
   job the cold job's launches and the golden bytes), and ``--warmup
   manifest`` without a manifest refused with the JAX message;
   process-start phase: a child interpreter's start,
   ``import torch``, the package's import, CUDA init, the two libraries'
   hash check and load, each timed, beside a 3-cluster CLI run's wall;
   lint phase: ``python -m specpride_tpu_torch lint <this tree> --json
   -`` in a child, which must exit 0 with no new finding and without
   importing torch; its wall and checker count are printed;
9. prints a ``{"kernels": [...]}`` line (launches: the executor's runs at
   the defaults, the files phase's consensus runs and evaluate, the chaos
   and real OOM runs, the bucketized, mesh and rank runs, the elastic
   ranks whose summaries are read, the telemetry, tracing and
   result-cache phases' runs, the in-process serving daemons' runs, the
   flight-recorder, autotune and warmup phases' daemons and ranks) and,
   last, the ``{"ok": true, "device": {...}}`` line.

Every comparison of a kernel with its plain version prints its largest
relative error beside the tolerance.

Any failed phase exits non-zero.  It exits non-zero, printing no result,
where CUDA is unavailable or the package is not beside it.  Full
measurements, each phase's wall among them (``phase_s``), also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TOL = dict(rtol=1e-5, atol=0.0)  # f32 tile sums vs f64 plain prefixes
# cosines: f32 sums in another order on the card than on the CPU
COS_TOL = dict(rtol=1e-5, atol=1e-6)
KERNEL_N = 16 * 1024 * 1024  # the main path's chunk cap
RAGGED_N = 10_000_019
SLICE_CLUSTERS = 20_000
CLI_CLUSTERS = 2_000
PATH_N = 2_841_563  # slice-20k's largest cosine chunk, member side
# the CPU references of the 20k card runs: every 4th cluster, 5,000 of
# them spread over every chunk and bucket of the card run (a cluster's
# result depends on no other's, on the CPU in any chunking)
REF_STRIDE = 4
STRESS_CALLS = 200
STREAM_ROUNDS = 10


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


PROFILE_TRIES = 10
SPIN_CYCLES = 2_000_000  # ~1 ms of the card's clock: outlasts any enqueue


def time_ms(fn, reps: int = 25, warm: int = 3, lead_in: bool = True) -> float:
    """Median of ``reps`` CUDA-event timings of one call after ``warm``
    calls.  With ``lead_in`` (the kernels' ``ms``) a ~1 ms spin kernel
    runs first, so the host has enqueued the whole call before the start
    event fires: the number is the card's time for the call, unless ``fn``
    itself waits for the card.  Without it (``call_ms``) the card is idle
    at the start event and the number also holds the host's time to reach
    the first launch: the latency one call shows its caller."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if lead_in:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


PROFILE_CALLS = 20
PROFILE_PAD_S = 0.05  # idle host time at each end of a first profiled try


def profile_try(fn, calls: int, pad_s: float):
    """One try of ``device_split``: a session of ``calls`` calls that is
    dropped, then a session of the same calls between two idle stretches
    of ``pad_s``; the second session's key averages."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(pad_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return prof.key_averages()


def device_split(fn, calls: int = PROFILE_CALLS):
    """Where one call of ``fn`` spends its time: the device time of each
    CUDA kernel it launches, in µs per call (``torch.profiler`` over
    ``calls`` calls, from the last try; None where the profiler saw no
    device time), the host's time to enqueue one call, in µs (host clock,
    no synchronize inside the loop), the kernel names seen in any try, the
    CUDA kernels each try saw and the host's kernel launch calls
    (``cudaLaunchKernel``) each try saw."""
    import re

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    # The profiler has returned none or only some of a session's device
    # records on the H100, while it saw every host launch call: a cold
    # first session, a record that arrived late, in the next session (6,
    # then 23, of 20 kernels), and the first records of a scheduled
    # profile's active step, 3-18 of 20 in a short process and 5 of 20 in
    # each of ten tries late in a full smoke, whether or not the step
    # idled 50 ms at its ends (kept kernel records have borne times up to
    # 1.7 ms before their launch calls).  So a try
    # (``profile_try``) has no warm-up step: a dropped session of the
    # same calls comes first and takes what is late, the calls sit
    # between idle stretches that double from PROFILE_PAD_S with each
    # try, and a try that saw fewer kernels than calls is taken again; a
    # count over the calls ends the tries (``one_kernel`` fails it).
    names, counts, launched = set(), [], []
    for attempt in range(PROFILE_TRIES):
        split = {}
        kernels = launches = 0
        pad_s = min(PROFILE_PAD_S * 2 ** attempt, 1.0)
        for ev in profile_try(fn, calls, pad_s):
            if re.match(r"cu(da)?LaunchKernel", ev.key):
                launches += ev.count
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(ev, "device_time_total", 0.0) / calls
            m = re.search(r"(seg_\w+)", ev.key)
            name = m.group(1) if m else ev.key[:60]
            split[name] = split.get(name, 0.0) + us
            kernels += ev.count
        names |= set(split)
        counts.append(kernels)
        launched.append(launches)
        if kernels >= calls:
            break
    return (split or None), host_us, names, counts, launched


def one_kernel(case: dict, fn, what: str) -> None:
    """Profile ``fn`` into ``case`` (``device_us``, ``host_us_per_call``,
    ``kernels_per_call``, ``profiled_kernels`` and
    ``profiled_launch_calls`` of each try) and fail unless
    every try saw one kernel name and no more kernels than calls, and the
    last saw exactly one per call."""
    split, host_us, names, counts, launched = device_split(fn)
    case["device_us"], case["host_us_per_call"] = split, host_us
    case["kernels_per_call"] = counts[-1] / PROFILE_CALLS
    case["profiled_kernels"] = counts
    case["profiled_launch_calls"] = launched
    if (len(names) != 1 or max(counts) > PROFILE_CALLS
            or counts[-1] != PROFILE_CALLS):
        raise AssertionError(f"{what}: kernels {sorted(names)}, {counts} "
                             f"in tries of {PROFILE_CALLS} calls")


def copy_ms(moved: int) -> float:
    """The card's time to copy ``moved / 2`` bytes on the device: the same
    traffic (each byte read once and written once) as a kernel that must
    move ``moved`` bytes, at the rate a plain copy reaches."""
    import torch

    src = torch.ones(moved // 2, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src))


def max_rel_err(got, want) -> float:
    """Largest |got - want| / |want| over the elements where want != 0
    (there, an rtol check with atol 0 needs got == want exactly)."""
    import torch

    nz = want != 0
    if not bool(nz.any()):
        return 0.0
    return float(((got - want).abs()[nz] / want.abs()[nz]).max())


def compare(got, want, what: str, exact_first: bool,
            quiet: bool = False) -> tuple[float, float]:
    """Channels within TOL (the first, seg_mean's count, exactly equal when
    ``exact_first``); returns the max abs and max relative error of the
    channels held to TOL, printing the latter beside the tolerance unless
    ``quiet``."""
    import torch

    if exact_first and not torch.equal(got[0], want[0]):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"{what}: {bad} counts differ")
    err = rel = 0.0
    start = 1 if exact_first else 0
    for c, (g, e) in enumerate(zip(got[start:], want[start:])):
        bad = ~torch.isclose(g, e, **TOL)
        if bad.any():
            i = int(torch.nonzero(bad)[0])
            raise AssertionError(
                f"{what}: {int(bad.sum())} of channel {c}'s values outside "
                f"{TOL}; first at {i}: {float(g[i])!r} vs {float(e[i])!r}"
            )
        err = max(err, float((g - e).abs().max()))
        rel = max(rel, max_rel_err(g, e))
    if not quiet:
        print(f"compare {what}: max_rel_err {rel!r} (rtol {TOL['rtol']}, "
              f"atol {TOL['atol']})", flush=True)
    return err, rel


def seg_mean_phase(kernels) -> dict:
    import torch

    dev = torch.device(DEV)
    res = {"cases": []}
    for n in (KERNEL_N, RAGGED_N):
        for nv in (1, 2):
            keys, w, values = kernel_inputs(n, nv, seed=n % 97 + nv)
            args = [torch.from_numpy(a).to(dev) for a in (keys, w, *values)]
            got = kernels.seg_mean(*args)
            torch.cuda.synchronize()
            want = kernels.seg_mean_plain(*args)
            err, rel = compare(got, want, f"seg_mean n={n} nv={nv}", True)
            case = {"n": n, "nv": nv, "max_abs_err": err,
                    "max_rel_err": rel}
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
                case["call_ms"] = time_ms(lambda: kernels.seg_mean(*args),
                                          lead_in=False)
                case["plain_ms"] = time_ms(
                    lambda: kernels.seg_mean_plain(*args)
                )
                # the yardstick yields only each run's totals: the run-end
                # subset of the kernel's output that the path consumes
                case["library_ms"] = time_ms(lambda: torch.segment_reduce(
                    stacked, "sum", lengths=lengths, axis=0, unsafe=True
                ))
                case["library"] = "torch.segment_reduce, run totals only"
                one_kernel(case, lambda: kernels.seg_mean(*args),
                           f"seg_mean n={n} nv={nv}")
                moved = n * (12 + 8 * nv)
                case["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
                case["copy_ms"] = copy_ms(moved)
            res["cases"].append(case)
            print(f"kernel seg_mean {json.dumps(case)}", flush=True)
    return res


SCAN_CASES = (("flags", 1), ("flags", 2), ("keys", 3))


def scan_case(kernels, n: int, kind: str, nc: int, timed: bool) -> dict:
    """``seg_scan`` on ``kernel_inputs``' runs, given as head flags or as
    the sorted keys themselves, against ``seg_scan_plain``; with ``timed``
    also the kernel, the plain version and ``torch.cumsum`` over the same
    channels, which moves the same value bytes but computes another
    function (no single PyTorch call computes a segmented scan)."""
    import torch

    keys, _, values = kernel_inputs(n, nc, seed=n % 89 + nc)
    runs = keys
    if kind == "flags":
        runs = np.ones(n, dtype=bool)
        runs[1:] = keys[1:] != keys[:-1]
    args = [torch.from_numpy(a).to(DEV) for a in (runs, *values)]
    got = kernels.seg_scan(*args)
    torch.cuda.synchronize()
    want = kernels.seg_scan_plain(*args)
    err, rel = compare(got, want, f"seg_scan {kind} n={n} nc={nc}", False)
    case = {"n": n, "runs": kind, "nc": nc, "max_abs_err": err,
            "max_rel_err": rel}
    if timed:
        case["ms"] = time_ms(lambda: kernels.seg_scan(*args))
        case["call_ms"] = time_ms(lambda: kernels.seg_scan(*args),
                                  lead_in=False)
        case["plain_ms"] = time_ms(lambda: kernels.seg_scan_plain(*args))
        case["cumsum_ms"] = time_ms(
            lambda: [torch.cumsum(v, 0) for v in args[1:]]
        )
        case["cumsum"] = "torch.cumsum per channel: same bytes, not a yardstick"
        one_kernel(case, lambda: kernels.seg_scan(*args),
                   f"seg_scan {kind} n={n} nc={nc}")
        head_bytes = 4 if kind == "keys" else 1
        moved = n * (head_bytes + 8 * nc)
        case["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
        case["copy_ms"] = copy_ms(moved)
    print(f"kernel seg_scan {json.dumps(case)}", flush=True)
    return case


def seg_scan_phase(kernels) -> dict:
    return {"cases": [
        scan_case(kernels, n, kind, nc, timed=n == KERNEL_N)
        for n in (KERNEL_N, RAGGED_N) for kind, nc in SCAN_CASES
    ]}


def path_scan_phase(kernels, shapes: list) -> dict:
    """``seg_scan`` at the slice's largest one- and two-channel scans (the
    member side of its largest cosine chunk)."""
    cases = []
    for nc in (1, 2):
        n = max(m for m, c in shapes if c == nc)
        cases.append(scan_case(kernels, n, "flags", nc, timed=True))
    return {"cases": cases}


# seg_mean_heads at the paths' shapes: the flat gap average's f32
# intensities and the binned mean's bf16 or int8 codes (nv = 1), the
# bucketized gap average's m/z and intensity (nv = 2), a ragged N, and
# every pointer one element off its 16-byte alignment (the scalar path)
HEAD_CASES = (
    ("f32 nv=1", KERNEL_N, ("float32",), 0),
    ("bf16 nv=1", KERNEL_N, ("bfloat16",), 0),
    ("int8 nv=1", KERNEL_N, ("int8",), 0),
    ("f32/f32 nv=2", KERNEL_N, ("float32", "float32"), 0),
    ("f32/int8 nv=2", KERNEL_N, ("float32", "int8"), 0),
    ("bf16/bf16 nv=2 ragged", RAGGED_N, ("bfloat16", "bfloat16"), 0),
    ("f32/int8 nv=2 offset", KERNEL_N, ("float32", "int8"), 1),
)
HEAD_MAIN = "f32 nv=1"  # the flat gap average at f32: the kernels line's


def head_inputs(n: int, dtypes, seed: int):
    """Head flags in runs of 1-20 with one run of 5,000 (``kernel_inputs``'
    runs), and one channel per dtype: m/z-like f32 or bf16, or int8 codes
    of 0-127, made on the host from ``seed``."""
    import torch

    keys, _, _ = kernel_inputs(n, 0, seed)
    rng = np.random.default_rng(seed + 1)
    head = np.ones(n, np.uint8)
    head[1:] = keys[1:] != keys[:-1]
    values = []
    for dt in dtypes:
        if dt == "int8":
            values.append(torch.from_numpy(
                rng.integers(0, 128, n).astype(np.int8)))
        else:
            v = torch.from_numpy(rng.uniform(120.0, 1900.0, n)
                                 .astype(np.float32))
            values.append(v.to(getattr(torch, dt)))
    return [torch.from_numpy(head), *values]


def seg_mean_heads_phase(kernels) -> dict:
    """``seg_mean_heads`` against ``seg_mean_heads_plain`` for each of
    ``HEAD_CASES``, each timed beside its plain version, its bound and a
    device copy of its traffic, and profiled for one kernel per call; the
    f32 case also beside ``torch.segment_reduce`` of its run totals."""
    import torch

    res = {"cases": []}
    for what, n, dtypes, offset in HEAD_CASES:
        host = head_inputs(n + offset, dtypes, seed=n % 83 + len(what))
        args = [t.to(DEV)[offset:] for t in host]
        got = kernels.seg_mean_heads(*args)
        torch.cuda.synchronize()
        want = kernels.seg_mean_heads_plain(*args)
        err, rel = compare(got, want, f"seg_mean_heads {what} n={n}", True)
        case = {"case": what, "n": n, "dtypes": dtypes, "offset": offset,
                "aligned": all(t.data_ptr() % 16 == 0 for t in args),
                "max_abs_err": err, "max_rel_err": rel}
        if case["aligned"] == bool(offset):
            raise AssertionError(f"seg_mean_heads {what}: pointers "
                                 f"{'' if offset else 'not '}aligned")
        case["ms"] = time_ms(lambda: kernels.seg_mean_heads(*args))
        case["call_ms"] = time_ms(lambda: kernels.seg_mean_heads(*args),
                                  lead_in=False)
        case["plain_ms"] = time_ms(
            lambda: kernels.seg_mean_heads_plain(*args))
        if what == HEAD_MAIN:
            bounds = torch.nonzero(args[0]).squeeze(1)
            lengths = torch.diff(bounds, append=torch.tensor([n],
                                                             device=DEV))
            stacked = torch.stack(
                [torch.ones(n, device=DEV)] + [v.float() for v in args[1:]],
                dim=1)
            case["library_ms"] = time_ms(lambda: torch.segment_reduce(
                stacked, "sum", lengths=lengths, axis=0, unsafe=True))
            case["library"] = "torch.segment_reduce, run totals only"
        one_kernel(case, lambda: kernels.seg_mean_heads(*args),
                   f"seg_mean_heads {what}")
        moved = n * (1 + sum(t.element_size() for t in args[1:])
                     + 4 * len(args))
        case["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
        case["copy_ms"] = copy_ms(moved)
        res["cases"].append(case)
        print(f"kernel seg_mean_heads {json.dumps(case)}", flush=True)
    return res


def device_inputs(op: str, n: int, nch: int, gen):
    """Inputs made on the card from ``gen``: keys in runs of 1-20 (sorted,
    int32), then head flags from them for ``flags``, 3 % masked weights for
    ``mean``, and ``nch`` channels uniform in [10, 1e4)."""
    import torch

    lens = torch.randint(1, 21, (n // 5 + 1,), device=DEV, generator=gen)
    keys = torch.repeat_interleave(
        torch.arange(lens.numel(), device=DEV, dtype=torch.int32), lens
    )[:n].contiguous()
    values = [torch.rand(n, device=DEV, generator=gen) * (1e4 - 10) + 10
              for _ in range(nch)]
    if op == "mean":
        w = (torch.rand(n, device=DEV, generator=gen) > 0.03).float()
        return [keys, w, *values]
    if op == "flags":
        head = torch.ones(n, dtype=torch.bool, device=DEV)
        head[1:] = keys[1:] != keys[:-1]
        return [head, *values]
    return [keys, *values]


STRESS_OPS = (("flags", 1), ("keys", 3), ("mean", 1), ("flags", 2),
              ("mean", 2), ("keys", 1))


def stress_phase(kernels, lib) -> dict:
    """200 ``seg_scan`` and ``seg_mean`` calls back to back on one stream,
    no synchronize between them, N cycling through the path's shape, 16M,
    a ragged N, 1, one tile and one tile + 1, channel counts varying, on a
    workspace registry emptied first (so it is grown, then reused); then
    every result against its plain version."""
    import torch

    sizes = (PATH_N, KERNEL_N, RAGGED_N, 1, lib.tile, lib.tile + 1)
    gen = torch.Generator(device=DEV).manual_seed(7)
    inputs, want = {}, {}
    plan = [(sizes[i % len(sizes)], STRESS_OPS[(i // len(sizes))
                                                % len(STRESS_OPS)])
            for i in range(STRESS_CALLS)]
    for n, (op, nch) in plan:
        if (n, op, nch) not in inputs:
            args = device_inputs(op, n, nch, gen)
            inputs[n, op, nch] = args
            want[n, op, nch] = (kernels.seg_mean_plain(*args) if op == "mean"
                                else kernels.seg_scan_plain(*args))
    torch.cuda.synchronize()
    kernels.workspaces.clear()
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    got = [(kernels.seg_mean if op == "mean" else kernels.seg_scan)(
        *inputs[n, op, nch]) for n, (op, nch) in plan]
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = sum(kernels.launches[k] - before[k] for k in before)
    if launched != STRESS_CALLS:
        raise AssertionError(f"stress: {launched} launches for "
                             f"{STRESS_CALLS} calls")
    err = rel = 0.0
    for (n, (op, nch)), out in zip(plan, got):
        e, r = compare(out, want[n, op, nch], f"stress {op} n={n} nc={nch}",
                       op == "mean", quiet=True)
        err, rel = max(err, e), max(rel, r)
    (ws,) = kernels.workspaces.values()
    res = {"calls": STRESS_CALLS, "sizes": sizes, "ops": STRESS_OPS,
           "max_abs_err": err, "max_rel_err": rel, "enqueue_s": enqueue_s,
           "wall_s": wall_s, "workspace_tiles": ws.tiles,
           "workspace_base": ws.base}
    print(f"compare stress ({STRESS_CALLS} calls): max_rel_err {rel!r} "
          f"(rtol {TOL['rtol']}, atol {TOL['atol']})", flush=True)
    print(f"stress {json.dumps(res)}", flush=True)
    return res


def extremes_phase(kernels) -> dict:
    """16M elements as one run (the longest look-back chain: no tile but
    the first holds a head) and as 16M runs of one.  The one-run values
    are 0 or 1, so every f32 prefix up to 2^24 is exact and the comparison
    sees the look-back's composition, not f32 rounding of a 16M-term sum."""
    import torch

    n = KERNEL_N
    gen = torch.Generator(device=DEV).manual_seed(11)
    bits = [(torch.rand(n, device=DEV, generator=gen) < 0.5).float()
            for _ in range(3)]
    values = [torch.rand(n, device=DEV, generator=gen) * (1e4 - 10) + 10
              for _ in range(3)]
    one_key = torch.zeros(n, dtype=torch.int32, device=DEV)
    no_head = torch.zeros(n, dtype=torch.bool, device=DEV)
    all_keys = torch.arange(n, dtype=torch.int32, device=DEV)
    all_heads = torch.ones(n, dtype=torch.bool, device=DEV)
    cases = {
        "one run flags nc=1": ("scan", [no_head, bits[0]]),
        "one run keys nc=3": ("scan", [one_key, *bits]),
        "one run mean nv=2": ("mean", [one_key, bits[0], bits[1], bits[2]]),
        "all heads flags nc=2": ("scan", [all_heads, *values[:2]]),
        "all heads keys nc=3": ("scan", [all_keys, *values]),
        "all heads mean nv=1": ("mean", [all_keys, bits[0], values[0]]),
    }
    res = {}
    for what, (op, args) in cases.items():
        fn, plain = ((kernels.seg_mean, kernels.seg_mean_plain) if op == "mean"
                     else (kernels.seg_scan, kernels.seg_scan_plain))
        got = fn(*args)
        torch.cuda.synchronize()
        err, rel = compare(got, plain(*args), what, op == "mean")
        res[what] = {"max_abs_err": err, "max_rel_err": rel}
        if what.startswith("one run"):
            res[what]["ms"] = time_ms(lambda: fn(*args))
    print(f"extremes {json.dumps(res)}", flush=True)
    return res


def streams_phase(kernels, lib) -> dict:
    """``seg_scan`` and ``seg_mean`` on two streams at once, their calls
    interleaved with no synchronize: each stream must get its own
    workspace, whose ticket base counts exactly that stream's tiles."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(13)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    jobs = (("flags", PATH_N, 1), ("mean", KERNEL_N, 1))
    inputs = [device_inputs(op, n, nch, gen) for op, n, nch in jobs]
    want = [kernels.seg_mean_plain(*a) if op == "mean"
            else kernels.seg_scan_plain(*a)
            for (op, _, _), a in zip(jobs, inputs)]
    dev = torch.device(DEV).index or 0
    for stream in streams:
        kernels.workspaces.pop((dev, stream.cuda_stream), None)
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(STREAM_ROUNDS):
        for k, ((op, _, _), stream) in enumerate(zip(jobs, streams)):
            with torch.cuda.stream(stream):
                fn = kernels.seg_mean if op == "mean" else kernels.seg_scan
                got[k].append(fn(*inputs[k]))
    torch.cuda.synchronize()
    err = rel = 0.0
    for k, (op, n, nch) in enumerate(jobs):
        for out in got[k]:
            e, r = compare(out, want[k], f"streams {op} n={n}",
                           op == "mean", quiet=True)
            err, rel = max(err, e), max(rel, r)
    ws = [kernels.workspaces[dev, s.cuda_stream] for s in streams]
    if ws[0].buf.data_ptr() == ws[1].buf.data_ptr():
        raise AssertionError("streams: both streams share one workspace")
    for w, (_, n, _) in zip(ws, jobs):
        tiles = -(-n // lib.tile)
        if w.base != STREAM_ROUNDS * tiles:
            raise AssertionError(
                f"streams: base {w.base} after {STREAM_ROUNDS} calls of "
                f"{tiles} tiles")
    res = {"rounds": STREAM_ROUNDS, "max_abs_err": err, "max_rel_err": rel,
           "workspace_ptrs": [w.buf.data_ptr() for w in ws],
           "workspace_bases": [w.base for w in ws]}
    print(f"compare streams ({2 * STREAM_ROUNDS} calls): max_rel_err "
          f"{rel!r} (rtol {TOL['rtol']}, atol {TOL['atol']})", flush=True)
    print(f"streams {json.dumps(res)}", flush=True)
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


def check_cosines(got, want, what: str) -> dict:
    """Card vs CPU cosines: finite, of one shape, within COS_TOL."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: cosines not finite or misshapen")
    np.testing.assert_allclose(got, want, **COS_TOL, err_msg=what)
    nz = want != 0
    rel = float((np.abs(got - want)[nz] / np.abs(want[nz])).max(initial=0))
    err = {"max_abs_err": float(np.abs(got - want).max(initial=0)),
           "max_rel_err": rel}
    print(f"compare {what} cosines: max_abs_err {err['max_abs_err']!r} "
          f"max_rel_err {rel!r} (rtol {COS_TOL['rtol']}, atol "
          f"{COS_TOL['atol']})", flush=True)
    return err


def host_split(backend, clusters, reps) -> dict:
    """Host seconds of the pack stages on the slice's data, one call each
    after the main run (host clock, one sample): the consensus pack
    (``pack_flat_bin_mean``, its table included; the per-chunk host run
    pass is the rest of the ``pack`` phase), and the QC cosine's member
    prep, rep prep and per-chunk arrays (together the ``qc_pack`` phase)."""
    from specpride_tpu_torch.config import BinMeanConfig, CosineConfig
    from specpride_tpu_torch.data.packed import pack_flat_bin_mean

    cfg = CosineConfig()
    split = {}
    t0 = time.perf_counter()
    pack_flat_bin_mean(clusters, BinMeanConfig(),
                       max_elements=backend.max_grid_elements // 4)
    split["consensus_pack_flat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mprep = backend._prep_cosine_members(clusters, cfg)
    split["qc_members"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = backend._prep_cosine_reps(reps, mprep, cfg)
    split["qc_reps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo, hi in backend._cosine_chunks(prep):
        backend._cosine_chunk_arrays(prep, lo, hi)
    split["qc_chunk_arrays"] = time.perf_counter() - t0
    print(f"host split {json.dumps(split)}", flush=True)
    return split


def zero_launches(kernels) -> None:
    for name in kernels.launches:
        kernels.launches[name] = 0


def check_launches(launches: dict, kernel: str, want: int, what: str):
    """``want`` launches of ``kernel`` (at least 2: the run took several
    chunks) and none of any other kernel."""
    others = {k: v for k, v in launches.items() if k != kernel and v}
    if want < 2 or launches[kernel] != want or others:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{want} of {kernel} and no other")


def slice_phase(kernels, clusters, gen_s: float) -> dict:
    """The main path, consensus and QC, with every launch count zeroed just
    before it; the shapes of its seg_scan calls are recorded on the way."""
    import torch

    from specpride_tpu_torch.backends.torch_backend import TorchBackend

    n_peaks = sum(c.total_peaks for c in clusters)
    TorchBackend(device=DEV).run_bin_mean_with_cosines(clusters[:200])

    backend = TorchBackend(device=DEV)
    shapes = []
    scan = kernels.seg_scan

    def recording_scan(runs, *values):
        shapes.append((runs.numel(), len(values)))
        return scan(runs, *values)

    torch.cuda.reset_peak_memory_stats()
    kernels.seg_scan = recording_scan
    zero_launches(kernels)
    t0 = time.perf_counter()
    try:
        reps, cosines = backend.run_bin_mean_with_cosines(clusters)
        torch.cuda.synchronize()
    finally:
        kernels.seg_scan = scan
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if launches["seg_mean_heads"]:
        raise AssertionError(f"slice: launches {launches}")
    if backend.chunks < 2 or launches["seg_mean"] != backend.chunks:
        raise AssertionError(
            f"slice ran {backend.chunks} consensus chunks, "
            f"{launches['seg_mean']} seg_mean launches"
        )
    if backend.cos_chunks < 2 or launches["seg_scan"] != 5 * backend.cos_chunks:
        raise AssertionError(
            f"slice ran {backend.cos_chunks} cosine chunks, "
            f"{launches['seg_scan']} seg_scan launches"
        )
    ref_reps, ref_cos = TorchBackend(device="cpu").run_bin_mean_with_cosines(
        clusters[::REF_STRIDE]
    )
    check_same(reps[::REF_STRIDE], ref_reps, "slice")
    cos_err = check_cosines(cosines[::REF_STRIDE], ref_cos, "slice")
    split = host_split(backend, clusters, reps)
    res = {
        "clusters": len(clusters), "peaks": n_peaks,
        "spectra": sum(c.n_members for c in clusters),
        "chunks": backend.chunks, "cos_chunks": backend.cos_chunks,
        "launches": launches,
        "wall_s": wall, "clusters_per_s": len(clusters) / wall,
        "phase_s": backend.phase_seconds,
        "mean_cosine": float(np.mean(cosines)),
        "cosine_err": cos_err,
        "host_split_s": split,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "workload_gen_s": gen_s,
        "h2d_bytes": backend.h2d_bytes,
        "h2d_bytes_per_peak": backend.h2d_bytes["h2d"] / n_peaks,
    }
    print(f"slice {json.dumps(res)}", flush=True)
    res["scan_shapes"] = shapes
    res["reps"] = reps
    res["cosines"] = cosines
    return res


def rep_cosines(reps, ref_reps, what: str) -> np.ndarray:
    """Binned cosine of each representative to the reference one, on the
    card by the port's own QC cosine (``average_cosines`` with the
    reference as the only member).  A pair empty on both sides is skipped;
    empty on one side fails."""
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.data.peaks import Cluster

    pairs = [(r, e) for r, e in zip(reps, ref_reps) if r.n_peaks or e.n_peaks]
    if any(not (r.n_peaks and e.n_peaks) for r, e in pairs):
        raise AssertionError(f"{what}: a representative is empty on one "
                             "side only")
    return TorchBackend(device=DEV).average_cosines(
        [r for r, _ in pairs], [Cluster(e.title, [e]) for _, e in pairs])


def precision_phase(kernels, clusters, f32_reps, f32_h2d: int) -> dict:
    """slice-20k's consensus at bf16 and at int8, no QC, launch counts
    zeroed just before each run: one ``seg_mean_heads`` launch per chunk;
    every representative's binned cosine to the card's f32 one at or
    above ``precision_tolerance``; H2D bytes per input peak beside f32's."""
    import torch

    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.ops.quantize import precision_tolerance

    n_peaks = sum(c.total_peaks for c in clusters)
    res = {"f32_h2d_bytes_per_peak": f32_h2d / n_peaks}
    for precision in ("bf16", "int8"):
        backend = TorchBackend(device=DEV, precision=precision)
        zero_launches(kernels)
        t0 = time.perf_counter()
        reps = backend.run_bin_mean(clusters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        check_launches(launches, "seg_mean_heads", backend.chunks,
                       f"precision {precision}")
        cos = rep_cosines(reps, f32_reps, f"precision {precision}")
        tol = precision_tolerance("bin-mean", precision)
        per_peak = backend.h2d_bytes["h2d"] / n_peaks
        run = {"chunks": backend.chunks, "launches": launches,
               "wall_s": wall, "clusters_per_s": len(clusters) / wall,
               "phase_s": backend.phase_seconds,
               "h2d_bytes": backend.h2d_bytes["h2d"],
               "h2d_bytes_per_peak": per_peak,
               "compared": int(cos.size), "min_cosine": float(cos.min()),
               "mean_cosine": float(cos.mean()), "tolerance": tol}
        print(f"precision {precision} {json.dumps(run)}", flush=True)
        if not run["min_cosine"] >= tol:
            raise AssertionError(f"precision {precision}: min cosine "
                                 f"{run['min_cosine']!r} below {tol}")
        if not per_peak < res["f32_h2d_bytes_per_peak"]:
            raise AssertionError(f"precision {precision}: {per_peak} H2D "
                                 "bytes per peak, not below f32's")
        res[precision] = run
    return res


GAP_TOL = (dict(rtol=1e-5, atol=0.0), dict(rtol=1e-4, atol=1e-3))


def check_gap_same(got, want, what: str, exact_mz: bool = True) -> None:
    """Card vs CPU gap average: the same spectra and precursors, equal peak
    counts, identical m/z (the flat layout's group m/z are the host's
    float64 means on both; with ``exact_mz`` False, the bucketized
    layout's float32 card means, rtol 1e-5), intensity rtol 1e-4 / atol
    1e-3 (group intensity means in float32 on the card, from float64
    prefixes on the CPU)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} spectra")
    for g, e in zip(got, want):
        if (g.title, g.n_peaks, g.precursor_mz, g.precursor_charge,
                g.rt) != (e.title, e.n_peaks, e.precursor_mz,
                          e.precursor_charge, e.rt):
            raise AssertionError(f"{what}: {g.title} differs in structure")
        if not np.isfinite(g.intensity).all():
            raise AssertionError(f"{what}: {g.title} non-finite intensity")
        if exact_mz and not np.array_equal(g.mz, e.mz):
            raise AssertionError(f"{what}: {g.title} m/z differs")
        np.testing.assert_allclose(g.mz, e.mz, **GAP_TOL[0], err_msg=what)
        np.testing.assert_allclose(g.intensity, e.intensity, **GAP_TOL[1],
                                   err_msg=what)


def check_singletons(reps, clusters, what: str, dyn_range: float = 1000.0
                     ) -> int:
    """Each singleton's representative is its member's peaks, float64
    m/z and intensity unchanged, less those under the dynamic-range floor
    (ref src/average_spectrum_clustering.py:88-98).  Returns the count."""
    n = 0
    for rep, c in zip(reps, clusters):
        if c.n_members != 1:
            continue
        m = c.members[0]
        keep = (m.intensity >= m.intensity.max() / dyn_range
                if m.n_peaks else np.zeros(0, bool))
        if not (np.array_equal(rep.mz, m.mz[keep])
                and np.array_equal(rep.intensity, m.intensity[keep])):
            raise AssertionError(f"{what}: singleton {c.cluster_id} is not "
                                 "its member")
        n += 1
    if not n:
        raise AssertionError(f"{what}: no singleton to check")
    return n


def gap_phase(kernels, clusters) -> dict:
    """``run_gap_average`` on slice-20k at f32 and at int8, launch counts
    zeroed just before each card run: one ``seg_mean_heads`` launch per
    chunk; the card's spectra against a CPU run of the port."""
    import torch

    from specpride_tpu_torch.backends.torch_backend import TorchBackend

    n_peaks = sum(c.total_peaks for c in clusters)
    res = {}
    for precision in ("f32", "int8"):
        backend = TorchBackend(device=DEV, precision=precision)
        zero_launches(kernels)
        t0 = time.perf_counter()
        reps = backend.run_gap_average(clusters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        check_launches(launches, "seg_mean_heads", backend.chunks,
                       f"gap {precision}")
        ref = TorchBackend(device="cpu", precision=precision)\
            .run_gap_average(clusters[::REF_STRIDE])
        check_gap_same(reps[::REF_STRIDE], ref, f"gap {precision}")
        run = {}
        if precision == "f32":
            run["singletons"] = check_singletons(reps, clusters,
                                                 f"gap {precision}")
        run.update({"chunks": backend.chunks, "launches": launches,
               "wall_s": wall, "clusters_per_s": len(clusters) / wall,
               "phase_s": backend.phase_seconds,
               "h2d_bytes_per_peak": backend.h2d_bytes["h2d"] / n_peaks,
               "peaks_out": sum(s.n_peaks for s in reps)})
        print(f"compare gap {precision} vs cpu: peak counts equal, m/z "
              f"identical, intensity {GAP_TOL[1]}"
              + (f", {run['singletons']} singletons their member"
                 if "singletons" in run else ""), flush=True)
        print(f"gap {precision} {json.dumps(run)}", flush=True)
        res[precision] = run
    return res


TF32_FLOPS_PER_S = 495e12  # H100 SXM data sheet, dense


def medoid_bound(b: int, k: int, runs: int, m: int, width: int) -> dict:
    """The least time of one ``shared_bins_packed`` call on the card: the
    larger of its bytes (bins and member ids read once, the (b, runs, m)
    f32 occupancy written and read once, the (b, m, m) int32 counts
    written once) over the memory rate and its gram's 2·b·runs·m² TF32
    operations over the tensor-core rate."""
    moved = 2 * b * k * width + 2 * b * runs * m * 4 + b * m * m * 4
    flops = 2 * b * runs * m * m
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / TF32_FLOPS_PER_S * 1e3
    return {"bytes": moved, "flops": flops, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def picks_of(reps, clusters) -> list[int]:
    """Each representative's member index in its cluster (by identity)."""
    return [next(i for i, s in enumerate(c.members) if s is r)
            for r, c in zip(reps, clusters)]


def medoid_phase(kernels, clusters) -> dict:
    """``run_medoid`` on slice-20k at f32 and at bf16 (int16 bins and
    member ids), launch counts zeroed just before each card run: no
    hand-written kernel launches; the picks identical between the two, to
    a CPU run of the port on the first 2,000 clusters and to the numpy
    oracle on the first 200.  The ``kernel`` phase (the shared-bin counts,
    torch ops) beside the sum of its chunks' bounds; the largest chunk's
    call and its gram alone timed."""
    import torch

    from specpride_tpu_torch.backends import numpy_backend
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.ops import similarity

    n_peaks = sum(c.total_peaks for c in clusters)
    TorchBackend(device=DEV).run_medoid(clusters[:200])
    shared = similarity.shared_bins_packed
    chunks = []

    def recording(bins, member_id, m, runs):
        chunks.append(((*bins.shape, runs, m, bins.element_size()),
                       (bins, member_id)))
        return shared(bins, member_id, m=m, runs=runs)

    res, picks = {}, {}
    for precision in ("f32", "bf16"):
        backend = TorchBackend(device=DEV, precision=precision)
        chunks.clear()
        torch.cuda.reset_peak_memory_stats()
        similarity.shared_bins_packed = recording
        zero_launches(kernels)
        t0 = time.perf_counter()
        try:
            reps = backend.run_medoid(clusters)
            torch.cuda.synchronize()
        finally:
            similarity.shared_bins_packed = shared
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        if any(launches.values()):
            raise AssertionError(f"medoid {precision}: launches {launches}")
        picks[precision] = picks_of(reps, clusters)
        bounds = [medoid_bound(*shape) for shape, _ in chunks]
        bound_ms = sum(b["bound_ms"] for b in bounds)
        run = {"chunks": backend.chunks, "encodings": backend.medoid_encodings,
               "launches": launches, "wall_s": wall,
               "clusters_per_s": len(clusters) / wall,
               "phase_s": backend.phase_seconds,
               "h2d_bytes": backend.h2d_bytes["h2d"],
               "h2d_bytes_per_peak": backend.h2d_bytes["h2d"] / n_peaks,
               "d2h_bytes": backend.d2h_bytes["d2h"],
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "kernel_ms": backend.phase_seconds["kernel"] * 1e3,
               "bound_ms": bound_ms,
               "bound_by": sorted({b["bound_by"] for b in bounds}),
               "flops": sum(b["flops"] for b in bounds),
               "bytes": sum(b["bytes"] for b in bounds),
               "chunk_shapes": sorted({shape for shape, _ in chunks})}
        want = {"f32": "i32", "bf16": "i16"}[precision]
        if backend.chunks < 2 or run["encodings"][want] != backend.chunks:
            raise AssertionError(f"medoid {precision}: {backend.chunks} "
                                 f"chunks, encodings {run['encodings']}")
        if precision == "bf16":
            big = max(chunks, key=lambda c: c[0][0] * c[0][2] * c[0][3])
            (b, k, runs, m, _), args = big
            occ = torch.rand(b, runs, m, device=DEV).round()
            with similarity._tf32_matmul():
                run["gram_ms"] = time_ms(
                    lambda: torch.bmm(occ.transpose(1, 2), occ))
            run["largest_chunk"] = big[0]
            run["largest_call_ms"] = time_ms(
                lambda: shared(*args, m=m, runs=runs), lead_in=False)
            run["largest_bound"] = medoid_bound(*big[0])
        print(f"medoid {precision} {json.dumps(run)}", flush=True)
        res[precision] = run
    chunks.clear()
    if picks["bf16"] != picks["f32"]:
        raise AssertionError("medoid: bf16 picks differ from f32's")
    cpu = picks_of(TorchBackend(device="cpu").run_medoid(
        clusters[:CLI_CLUSTERS]), clusters[:CLI_CLUSTERS])
    if cpu != picks["f32"][:CLI_CLUSTERS]:
        raise AssertionError("medoid: picks differ from the CPU run")
    oracle = [numpy_backend.medoid_index(c.members) for c in clusters[:200]]
    if oracle != picks["f32"][:200]:
        raise AssertionError("medoid: picks differ from the numpy oracle")
    print(f"compare medoid: picks identical f32 = bf16 ({len(clusters)}), "
          f"= cpu ({CLI_CLUSTERS}), = oracle (200)", flush=True)
    res["host_split_s"] = medoid_host_split(clusters)
    res["picks"] = picks["f32"]
    return res


def medoid_host_split(clusters) -> dict:
    """Host seconds of the medoid's ``pack`` phase on the slice's data, one
    call each (host clock, one sample): ``pack_bucketize`` (its table
    included), the f64 binning, and the per-row sort with the run counts
    (``_medoid_sorted``, the binning included)."""
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.config import BatchConfig, MedoidConfig
    from specpride_tpu_torch.data.packed import pack_bucketize
    from specpride_tpu_torch.ops.quantize import medoid_bins_packed

    backend = TorchBackend(device=DEV)
    split = {}
    t0 = time.perf_counter()
    batches = pack_bucketize(clusters, BatchConfig(), bucket_members=True)
    split["pack_bucketize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for batch in batches:
        medoid_bins_packed(batch, MedoidConfig())
    split["bins"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for batch in batches:
        backend._medoid_sorted(batch, MedoidConfig())
    split["bins_sort_runs"] = time.perf_counter() - t0
    print(f"medoid host split {json.dumps(split)}", flush=True)
    return split


def select_phase(kernels, clusters, medoid_picks) -> dict:
    """``select --method medoid --qc-report`` on slice-20k: ``run_medoid``
    then ``average_cosines`` on the card, launch counts zeroed just before:
    five ``seg_scan`` launches per cosine chunk and no other kernel; the
    picks the medoid phase's, the cosines a CPU run's on the first 2,000
    clusters.  Then ``run_best_spectrum`` with seeded scores over the
    workload's own USIs, about 5 % of clusters left without one: their
    clusters dropped, every pick its cluster's top score."""
    import torch

    from specpride_tpu_torch.backends import numpy_backend
    from specpride_tpu_torch.backends.torch_backend import TorchBackend

    backend = TorchBackend(device=DEV)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    t0 = time.perf_counter()
    reps = backend.run_medoid(clusters)
    t1 = time.perf_counter()
    cosines = backend.average_cosines(reps, clusters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check_launches(launches, "seg_scan", 5 * backend.cos_chunks, "select")
    if picks_of(reps, clusters) != medoid_picks:
        raise AssertionError("select: medoid picks differ from the medoid "
                             "phase's")
    head = clusters[:CLI_CLUSTERS]
    ref = TorchBackend(device="cpu").average_cosines(reps[:CLI_CLUSTERS],
                                                      head)
    cos_err = check_cosines(cosines[:CLI_CLUSTERS], ref, "select")
    if not np.isfinite(cosines).all():
        raise AssertionError("select: non-finite cosines")

    rng = np.random.default_rng(5)
    scoreless = rng.random(len(clusters)) < 0.05
    scores = {s.usi: float(rng.uniform(0.0, 200.0))
              for c, skip in zip(clusters, scoreless) if not skip
              for s in c.members}
    t2 = time.perf_counter()
    best = backend.run_best_spectrum(clusters, scores)
    best_s = time.perf_counter() - t2
    kept = [c for c, skip in zip(clusters, scoreless) if not skip]
    oracle = numpy_backend.run_best_spectrum(clusters, scores)
    if (len(best) != len(oracle) or any(a is not b for a, b in
                                        zip(best, oracle))
            or [r.cluster_id for r in best] != [c.cluster_id for c in kept]):
        raise AssertionError("best: picks or dropped clusters differ")
    if any(scores[r.usi] != max(scores[s.usi] for s in c.members)
           for r, c in zip(best, kept)):
        raise AssertionError("best: a pick is not its cluster's top score")
    res = {"chunks": backend.chunks, "cos_chunks": backend.cos_chunks,
           "launches": launches, "wall_s": wall, "medoid_s": t1 - t0,
           "clusters_per_s": len(clusters) / wall,
           "phase_s": backend.phase_seconds,
           "h2d_bytes": backend.h2d_bytes, "d2h_bytes": backend.d2h_bytes,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "mean_cosine": float(np.mean(cosines)), "cosine_err": cos_err,
           "best_s": best_s, "best_clusters_per_s": len(clusters) / best_s,
           "best_kept": len(best), "best_dropped": int(scoreless.sum())}
    print(f"compare best: {len(best)} picks = oracle, {res['best_dropped']} "
          "scoreless clusters dropped", flush=True)
    print(f"select {json.dumps(res)}", flush=True)
    return res


SORT_SITES = ("consensus pack", "qc member prep", "qc rep sort",
              "qc chunk search", "medoid per-row sort", "gap pack")


def dedup_site(calls, stage_s: float) -> dict:
    """The consensus pack's dedup (``packed._dedup_keep_mask``), still
    numpy: its (spectrum, bin, position) ``np.lexsort`` runs only when a
    spectrum's m/z is out of order, else one vector compare decides.  For
    each recorded call: whether the lexsort ran, the lexsort timed on the
    call's arrays regardless, and ``seg_argsort`` over the spectra (what
    moving it would run), held to the same permutation.  Shares are of
    the consensus pack's wall, with the lexsort added where it did not
    run."""
    from specpride_tpu_torch.ops import segsort

    site = {"calls": len(calls), "elements": 0, "lexsort_runs": 0,
            "stage_s": stage_s, "dedup_s": 0.0, "plain_s": 0.0,
            "native_s": 0.0}
    for spec, bins, mz, dedup_s in calls:
        p = bins.size
        site["elements"] += p
        site["dedup_s"] += dedup_s
        site["lexsort_runs"] += bool(
            ((spec[1:] == spec[:-1]) & (mz[1:] < mz[:-1])).any())
        t0 = time.perf_counter()
        want = np.lexsort((np.arange(p), bins, spec))
        site["plain_s"] += time.perf_counter() - t0
        offsets = np.r_[0, np.flatnonzero(spec[1:] != spec[:-1]) + 1, p]
        t0 = time.perf_counter()
        got = segsort.seg_argsort(bins, offsets)
        site["native_s"] += time.perf_counter() - t0
        if not np.array_equal(got, want):
            raise AssertionError("sort split dedup lexsort: native and plain "
                                 "permutations differ")
    ran = site["lexsort_runs"] > 0
    base = stage_s if ran else stage_s + site["plain_s"]
    site.update({
        "share_plain": site["plain_s"] / base,
        "share_native": site["native_s"] / (base - site["plain_s"]
                                            + site["native_s"]),
        "share_this_input": site["plain_s"] / stage_s if ran else 0.0,
        "speedup": (site["plain_s"] / site["native_s"]
                    if site["native_s"] else None),
        "identical": True,
    })
    return site


SORT_CLUSTERS = 5_000  # slice-20k's head: the split's shares, in a quarter


def sort_split_phase(clusters, reps) -> dict:
    """The host sorts on the head of slice-20k's real arrays
    (``SORT_CLUSTERS``), native (the port's
    threaded ``ops/csrc/segsort.cpp``) against plain (numpy), host clock,
    one sample each: every ``seg_argsort`` / ``searchsorted_right_i32``
    call of six stages is recorded while the stage runs (native), then
    replayed native and plain and the results held identical.  Each
    stage's wall beside its sorts gives the sort's share of it, and the
    share it would have with the plain sort.  A seventh site, the
    consensus pack's dedup lexsort, is ``dedup_site``'s."""
    from specpride_tpu_torch.backends import torch_backend
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.config import (
        BatchConfig,
        BinMeanConfig,
        CosineConfig,
        GapAverageConfig,
        MedoidConfig,
    )
    from specpride_tpu_torch.data import packed
    from specpride_tpu_torch.ops import segsort

    backend = TorchBackend(device=DEV)
    cfg = CosineConfig()
    cap = backend.max_grid_elements // 4
    calls = []

    def recording(real, plain):
        def rec(*args):
            calls.append((real, plain, args))
            return real(*args)
        return rec

    sort = recording(segsort.seg_argsort, segsort.seg_argsort_plain)
    search = recording(segsort.searchsorted_right_i32,
                       segsort.searchsorted_right_i32_plain)
    dedup_calls = []
    real_dedup = packed._dedup_keep_mask

    def dedup(spec, bins, mz):
        t0 = time.perf_counter()
        keep = real_dedup(spec, bins, mz)
        dedup_calls.append((spec, bins, mz, time.perf_counter() - t0))
        return keep

    saved = (packed.seg_argsort, torch_backend.seg_argsort,
             torch_backend.searchsorted_right_i32, real_dedup)
    state = {}

    def member_prep():
        state["mprep"] = backend._prep_cosine_members(clusters, cfg)

    def rep_sort():
        state["prep"] = backend._prep_cosine_reps(reps, state["mprep"], cfg)

    def chunk_search():
        for lo, hi in backend._cosine_chunks(state["prep"]):
            backend._cosine_chunk_arrays(state["prep"], lo, hi)

    def medoid_sort():
        for batch in state["buckets"]:
            backend._medoid_sorted(batch, MedoidConfig())

    stages = (
        lambda: packed.pack_flat_bin_mean(clusters, BinMeanConfig(),
                                          max_elements=cap),
        member_prep, rep_sort, chunk_search, medoid_sort,
        lambda: packed.pack_flat_gap(clusters, GapAverageConfig(),
                                     max_elements=cap),
    )
    state["buckets"] = packed.pack_bucketize(clusters, BatchConfig(),
                                             bucket_members=True)
    res = {"cores": len(os.sched_getaffinity(0)),
           "cpu_count": os.cpu_count(), "sites": {}}
    packed.seg_argsort = torch_backend.seg_argsort = sort
    torch_backend.searchsorted_right_i32 = search
    packed._dedup_keep_mask = dedup
    try:
        for site, stage in zip(SORT_SITES, stages):
            calls.clear()
            t0 = time.perf_counter()
            stage()
            stage_s = time.perf_counter() - t0
            native_s = plain_s = 0.0
            n = 0
            for real, plain, args in calls:
                t0 = time.perf_counter()
                got = real(*args)
                native_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                want = plain(*args)
                plain_s += time.perf_counter() - t0
                if not np.array_equal(got, want):
                    raise AssertionError(f"sort split {site}: native and "
                                         "plain results differ")
                n += args[0].size if real is segsort.seg_argsort \
                    else args[1].size
            res["sites"][site] = {
                "calls": len(calls), "elements": n, "stage_s": stage_s,
                "native_s": native_s, "plain_s": plain_s,
                "speedup": plain_s / native_s if native_s else None,
                "share_native": native_s / stage_s,
                "share_plain": plain_s / (stage_s - native_s + plain_s),
                "identical": True,
            }
    finally:
        packed.seg_argsort, torch_backend.seg_argsort, \
            torch_backend.searchsorted_right_i32, \
            packed._dedup_keep_mask = saved
    res["sites"]["dedup lexsort"] = dedup_site(
        dedup_calls, res["sites"]["consensus pack"]["stage_s"])
    print(f"compare host sorts native vs plain: identical at "
          f"{len(SORT_SITES) + 1} sites ({res['cores']} cores)", flush=True)
    print(f"host sort split {json.dumps(res)}", flush=True)
    return res


EXEC_EVERY = 512  # --checkpoint-every, the JAX CLI's default
EXEC_SETTINGS = (
    ("prefetch 0", ("--prefetch", "0")),
    ("defaults", ()),
    ("h2d-buffer 2", ("--h2d-buffer", "2")),
    ("pack-workers 0", ("--pack-workers", "0")),
)


def executor_run(kernels, clusters, name: str, command: str, flags=(),
                 qc: bool = True) -> dict:
    """One in-process run of the CLI's chunked executor on ``clusters``
    with ``--checkpoint`` and ``--checkpoint-every EXEC_EVERY``, as
    ``cli._run_pipeline_command`` runs it less the parse (the input is in
    memory: parsing the MGF is not what is measured): the span tracer
    (with ``--journal`` / ``--chrome-trace``), the result cache's run
    context (``--result-cache``), the journal, ``cli._checkpointed_run``
    (the launch counts zeroed just before it, the wall around it), the
    QC report and ``cli._finish_run`` (``finish_s``: the Chrome trace
    written).  Returns its numbers and the bytes it wrote."""
    import torch

    from specpride_tpu_torch import cli
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.cache import result_cache

    work = os.path.join(ROOT, "build", "chip_smoke", "executor")
    os.makedirs(work, exist_ok=True)
    paths = {k: os.path.join(work, f"{name}.{k}") for k in
             ("mgf", "ck.json", "qc.json")}
    for path in paths.values():
        if os.path.exists(path):
            os.remove(path)
    argv = [command, "in.mgf", paths["mgf"], "--checkpoint",
            paths["ck.json"], "--checkpoint-every", str(EXEC_EVERY), *flags]
    if qc:
        argv += ["--qc-report", paths["qc.json"]]
    args = cli.build_parser().parse_args(argv)
    backend = TorchBackend(device=DEV, precision=args.precision)
    stats = cli.RunStats()
    rows = [] if qc else None
    cli._install_tracer_early(args)
    journal = cli.NullJournal()
    try:
        args._result_cache = result_cache.runtime_for(args, command,
                                                      backend)
        journal = cli._open_run_journal(args, backend, len(clusters))
        zero_launches(kernels)
        t0 = time.perf_counter()
        resumed, failed, qc_failed = cli._checkpointed_run(
            backend, args.method, clusters, args, stats, qc=rows,
            journal=journal)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        if qc:
            cli._write_qc_report(args, backend, clusters, rows, resumed,
                                 failed, qc_failed)
        t0 = time.perf_counter()
        cli._finish_run(args, backend, stats, journal)
        finish_s = time.perf_counter() - t0
    finally:
        cli._restore_tracer(args)
        journal.close()
    if failed or qc_failed:
        raise AssertionError(f"executor {name}: failed {failed} {qc_failed}")
    got = {}
    for key, path in paths.items():
        if key != "qc.json" or qc:
            with open(path, "rb") as fh:
                got[key] = fh.read()
    ph = backend.phase_seconds
    pipe = stats.pipeline or {}
    run = {"wall_s": wall, "clusters_per_s": len(clusters) / wall,
           "device_idle_s": pipe.get("device_idle_s"),
           "overlap_efficiency": pipe.get("overlap_efficiency"),
           "launches": launches, "chunks": backend.chunks,
           "cos_chunks": backend.cos_chunks, "pipeline": stats.pipeline,
           "phase_s": ph, "cli_phases_s": dict(stats.phases),
           "counters": dict(stats.counters), "finish_s": finish_s,
           "h2d_bytes": backend.h2d_bytes,
           "output_bytes": len(got["mgf"]),
           "robustness": stats.robustness}
    if not stats.pipeline:
        # the card's share of the wall, from the CUDA events around each
        # kernel: only a serial run's, since with other lanes running the
        # dispatch thread can lose the interpreter between an event and
        # its kernel's launch, which inflates the events' times
        run["card_busy_share"] = (ph["kernel"] + ph["qc_kernel"]) / wall
    return run, got


def executor_phase(kernels, clusters, slice_cos, medoid_picks) -> dict:
    """slice-20k (bin-mean with QC) through the chunked executor at four
    settings: the output, manifest and QC-report bytes identical across
    them; per run one ``seg_mean`` launch per chunk and five ``seg_scan``
    launches per cosine chunk, one cosine chunk per executor chunk; the
    QC cosines within COS_TOL of the one-shot slice phase's.  Then
    medoid-20k, gap-20k (f32) and bin-mean int8 at the defaults: the
    medoid's output the bytes of the medoid phase's picks, the gap and
    int8 outputs identical to their own ``--prefetch 0`` runs."""
    from specpride_tpu_torch.io.mgf import write_mgf

    n_chunks = -(-len(clusters) // EXEC_EVERY)
    res = {"every": EXEC_EVERY, "chunks": n_chunks}
    first = None
    for what, flags in EXEC_SETTINGS:
        run, got = executor_run(kernels, clusters, what.replace(" ", "_"),
                                "consensus", flags)
        want = {"seg_mean": n_chunks, "seg_mean_heads": 0,
                "seg_scan": 5 * n_chunks}
        if (run["launches"] != want or run["chunks"] != n_chunks
                or run["cos_chunks"] != n_chunks):
            raise AssertionError(f"executor {what}: launches "
                                 f"{run['launches']}, chunks {run['chunks']}"
                                 f"/{run['cos_chunks']}, expected {want}")
        if first is None:
            first = got
            rows = json.loads(got["qc.json"])["clusters"]
            run["cosine_err"] = check_cosines(
                [r["avg_cosine"] for r in rows], slice_cos,
                "executor vs one-shot slice")
        elif got != first:
            bad = [k for k in got if got[k] != first[k]]
            raise AssertionError(f"executor {what}: {bad} differ from the "
                                 f"{EXEC_SETTINGS[0][0]} run's")
        print(f"executor {what} {json.dumps(run)}", flush=True)
        res[what] = run
    print(f"compare executor: output, manifest and QC report identical over "
          f"{len(EXEC_SETTINGS)} settings ({len(first['mgf'])} output "
          "bytes)", flush=True)

    run, got = executor_run(kernels, clusters, "medoid", "select")
    if any(run["launches"][k] for k in ("seg_mean", "seg_mean_heads")):
        raise AssertionError(f"executor medoid: launches {run['launches']}")
    path = os.path.join(ROOT, "build", "chip_smoke", "executor",
                        "medoid_phase_picks.mgf")
    write_mgf([c.members[p] for c, p in zip(clusters, medoid_picks)], path)
    with open(path, "rb") as fh:
        if fh.read() != got["mgf"]:
            raise AssertionError("executor medoid: picks differ from the "
                                 "medoid phase's")
    print(f"executor medoid {json.dumps(run)}", flush=True)
    res["medoid"] = run
    for what, command, flags in (
        ("gap f32", "consensus", ("--method", "gap-average")),
        ("bin-mean int8", "consensus", ("--precision", "int8")),
    ):
        run, got = executor_run(kernels, clusters, what.replace(" ", "_"),
                                command, flags, qc=False)
        ls = run["launches"]
        if (ls["seg_mean_heads"] != run["chunks"] or ls["seg_mean"]
                or ls["seg_scan"] or run["chunks"] < n_chunks):
            raise AssertionError(f"executor {what}: launches "
                                 f"{run['launches']}, chunks {run['chunks']}")
        _, serial = executor_run(kernels, clusters,
                                 what.replace(" ", "_") + "_serial",
                                 command, flags + ("--prefetch", "0"),
                                 qc=False)
        if serial != got:
            raise AssertionError(f"executor {what}: defaults and "
                                 "--prefetch 0 differ")
        print(f"executor {what} {json.dumps(run)}", flush=True)
        res[what] = run
    print("compare executor: medoid = medoid phase picks; gap f32 and "
          "bin-mean int8 = their --prefetch 0 runs", flush=True)
    res["bytes"] = first
    return res


def cli_phase() -> dict:
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.data.peaks import group_into_clusters
    from specpride_tpu_torch.io.mgf import read_mgf, write_mgf

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    src, dst = os.path.join(work, "in.mgf"), os.path.join(work, "out.mgf")
    qc = os.path.join(work, "qc.json")
    clusters = make_workload(CLI_CLUSTERS, seed=42)
    write_mgf([s for c in clusters for s in c.members], src)
    parsed = group_into_clusters(read_mgf(src))

    def cli(*flags, command="consensus", source=src, child=False) -> float:
        """The run's wall: a child process for the main path's (the CLI
        wall), the others in this process (``run_main``: the same code
        without a process start each)."""
        for path in (dst, qc):
            if os.path.exists(path):
                os.remove(path)
        if child:
            return run_cli(command, source, dst, *flags)[0]
        return cli_ok(f"cli {command} {flags}", command, source, dst,
                      *flags)["wall_s"]

    def qc_cosines(what: str, ref_cos) -> dict:
        with open(qc) as fh:
            report = json.load(fh)
        rows = report["clusters"]
        if [r["cluster_id"] for r in rows] != [c.cluster_id for c in parsed]:
            raise AssertionError(f"{what}: QC report rows differ from the "
                                 "clusters")
        if report["summary"]["n_clusters"] != len(parsed):
            raise AssertionError(f"{what}: QC report summary miscounts "
                                 "clusters")
        return check_cosines([r["avg_cosine"] for r in rows], ref_cos, what)

    res = {"clusters": len(clusters)}
    res["wall_s"] = cli("--qc-report", qc, child=True)
    cpu = TorchBackend(device="cpu")
    ref_reps, ref_cos = cpu.run_bin_mean_with_cosines(parsed)
    check_same(read_mgf(dst), ref_reps, "cli")
    res["cosine_err"] = qc_cosines("cli", ref_cos)

    res["gap_wall_s"] = cli("--method", "gap-average", "--qc-report", qc)
    got = read_mgf(dst)
    cpu_gap = cpu.run_gap_average(parsed)
    check_gap_same(got, cpu_gap, "cli gap-average")
    # the group m/z are the host's float64 means on both, so the CPU's
    # cosines of its own representatives are the reference
    res["gap_cosine_err"] = qc_cosines(
        "cli gap-average", cpu.average_cosines(cpu_gap, parsed))

    res["int8_wall_s"] = cli("--precision", "int8")
    ref_reps = TorchBackend(device="cpu", precision="int8").run_bin_mean(
        parsed)
    check_same(read_mgf(dst), ref_reps, "cli --precision int8")

    golden = os.path.join(ROOT, "tests", "data", "golden_clustered.mgf")
    msms = os.path.join(ROOT, "tests", "data", "golden_msms.txt")
    for what, flags in (
        ("select medoid --qc-report", ("--qc-report", qc)),
        ("select best --qc-report", ("--method", "best", "--msms", msms,
                                     "--qc-report", qc)),
        ("select medoid --precision bf16", ("--precision", "bf16")),
    ):
        res[f"{what} wall_s"] = cli(*flags, command="select", source=golden)
        res[what] = same_as_cpu_select(golden, dst, qc, flags, work, what)
    print(f"cli {json.dumps(res)}", flush=True)
    return res


FILES_CHECK_CLUSTERS = 500  # the head of files-20k held to plain / CPU


def same_spectra(got, want, what: str) -> None:
    """Parsed spectra equal to written ones: titles, headers and the
    float64 bit patterns of every peak."""
    def key(s):
        return (s.title, s.precursor_mz, s.precursor_charge, s.rt, s.extra,
                s.mz.tobytes(), s.intensity.tobytes())

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} spectra")
    for g, w in zip(got, want):
        if key(g) != key(w):
            raise AssertionError(f"{what}: {w.title} differs")


def run_cli(*argv) -> tuple[float, dict | None]:
    """``python -m specpride_tpu_torch ARGV`` in a subprocess: its wall
    and the run summary it prints last on stderr (None when there is
    none)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "specpride_tpu_torch", *argv], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI {argv} exited {proc.returncode}:\n"
                             f"{proc.stderr}")
    lines = proc.stderr.strip().splitlines()
    return wall, (json.loads(lines[-1]) if lines else None)


# The launcher: a small Python process started before this script imports
# torch.  It runs each CLI command it is sent and reaps it with os.wait4.
# A child's ru_maxrss counts the resident set of the process it was forked
# from (Linux keeps the pre-exec high-water mark), so a child of this
# script, which holds gigabytes by then, would report this script's size;
# a child of the launcher starts from the launcher's few MiB.
LAUNCHER = r"""
import json, os, subprocess, sys, tempfile, time
for line in sys.stdin:
    job = json.loads(line)
    argvs = job.get("argvs") or [job["argv"]]
    errs = [tempfile.TemporaryFile() for _ in argvs]
    t0 = time.perf_counter()
    pids = [subprocess.Popen(argv, cwd=job["cwd"], env=job["env"],
                             stdout=subprocess.DEVNULL, stderr=err).pid
            for argv, err in zip(argvs, errs)]
    if job.get("announce"):  # a long-lived child: its pid first
        print(json.dumps({"pid": pids[0]}), flush=True)
    results = [None] * len(pids)
    for _ in pids:  # each reaped as it exits: its own wall
        pid, status, usage = os.wait4(-1, 0)
        results[pids.index(pid)] = {
            "rc": os.waitstatus_to_exitcode(status),
            "wall_s": time.perf_counter() - t0,
            "maxrss_kib": usage.ru_maxrss}
    for res, err in zip(results, errs):
        err.seek(0)
        res["stderr"] = err.read().decode(errors="replace")
        err.close()
    print(json.dumps({"group": results} if "argvs" in job else results[0]),
          flush=True)
"""
_launcher: subprocess.Popen | None = None


def start_launcher() -> None:
    global _launcher
    _launcher = subprocess.Popen([sys.executable, "-c", LAUNCHER],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                 text=True)


def stop_launcher() -> None:
    global _launcher
    if _launcher is not None:
        _launcher.stdin.close()
        try:
            _launcher.wait(timeout=30)
        except subprocess.TimeoutExpired:
            _launcher.kill()
            _launcher.wait()
        _launcher = None


def start_launched(*argv) -> int:
    """``python -m specpride_tpu_torch ARGV`` started by the launcher, which
    reaps it later (``launched_result``): its pid."""
    _launcher.stdin.write(json.dumps({
        "argv": [sys.executable, "-m", "specpride_tpu_torch", *argv],
        "cwd": ROOT, "env": dict(os.environ, PYTHONPATH=ROOT),
        "announce": True,
    }) + "\n")
    _launcher.stdin.flush()
    return json.loads(_launcher.stdout.readline())["pid"]


def launched_result() -> dict:
    """The exit of the child ``start_launched`` started: its exit code,
    wall, peak resident set (KiB) and stderr."""
    line = _launcher.stdout.readline()
    if not line:
        raise AssertionError("the launcher died")
    return json.loads(line)


def run_cli_rss(*argv, env=None, expect_ok: bool = True):
    """``python -m specpride_tpu_torch ARGV`` run by the launcher: its wall,
    exit code, the run summary it prints last on stderr (None when there
    is none), its peak resident set (``ru_maxrss`` from ``os.wait4``, KiB)
    and its stderr."""
    _launcher.stdin.write(json.dumps({
        "argv": [sys.executable, "-m", "specpride_tpu_torch", *argv],
        "cwd": ROOT, "env": dict(env or os.environ, PYTHONPATH=ROOT),
    }) + "\n")
    _launcher.stdin.flush()
    line = _launcher.stdout.readline()
    if not line:
        raise AssertionError("the launcher died")
    res = json.loads(line)
    if expect_ok and res["rc"] != 0:
        raise AssertionError(f"CLI {argv} exited {res['rc']}:\n"
                             f"{res['stderr']}")
    res["summary"] = None
    lines = res["stderr"].strip().splitlines()
    if lines and lines[-1].startswith("{"):
        res["summary"] = json.loads(lines[-1])
    return res


# `auto` streams files-20k in windows of 512, the value of an explicit
# `--stream-clusters 512`, which is therefore not run again
STREAM_MODES = (("auto", ()), ("off", ("--stream-clusters", "off")))


def stream_phase(src: str, head: str, work: str, exec_bytes: dict,
                 n_chunks: int) -> dict:
    """stream (files-20k): ``consensus --qc-report --checkpoint`` on the
    1.0 GB file as a subprocess at the default ``--stream-clusters auto``
    (over 256 MB: it streams, in windows of 512) and ``off``: output, QC
    report and manifest identical across the two and the executor phase's
    bytes,
    ``n_chunks`` ``seg_mean`` and five times as many ``seg_scan``
    launches each; each run's wall, phases and peak resident set; the
    host library's byte index of the whole file timed, and on the
    500-cluster head held to the Python scan."""
    from specpride_tpu_torch.io import mgf, native

    res = {}
    # the resident set of a run on a 3-cluster file: the process, torch
    # and the CUDA context, which every run below carries too
    golden = os.path.join(ROOT, "tests", "data", "golden_clustered.mgf")
    base = run_cli_rss("consensus", golden, os.path.join(work, "base.mgf"),
                       "--qc-report", os.path.join(work, "base.qc.json"))
    res["baseline"] = {"wall_s": base["wall_s"],
                       "maxrss_kib": base["maxrss_kib"]}
    t0 = time.perf_counter()
    records, spans = native.index_mgf(src)
    res["index_s"] = time.perf_counter() - t0
    res["index_records"] = len(records)
    if spans:
        raise AssertionError(f"stream: the index found truncated {spans}")
    del records
    t0 = time.perf_counter()
    head_native = native.index_mgf(head)
    res["head_index_native_s"] = time.perf_counter() - t0
    view = mgf.StreamedClusters(head, window=512)
    t0 = time.perf_counter()
    head_plain = (view._scan_plain(), view.malformed_spans)
    res["head_index_plain_s"] = time.perf_counter() - t0
    if head_native != head_plain:
        raise AssertionError("stream: native index differs from the Python "
                             "scan on the head")
    res["head_index_records"] = len(head_native[0])
    print(f"compare stream index: native = Python scan on the head "
          f"({res['head_index_records']} records)", flush=True)
    for mode, flags in STREAM_MODES:
        paths = {k: os.path.join(work, f"stream_{mode}.{k}")
                 for k in ("mgf", "ck.json", "qc.json")}
        run = run_cli_rss(
            "consensus", src, paths["mgf"], "--qc-report", paths["qc.json"],
            "--checkpoint", paths["ck.json"], "--checkpoint-every",
            str(EXEC_EVERY), *flags)
        for key, path in paths.items():
            with open(path, "rb") as fh:
                if fh.read() != exec_bytes[key]:
                    raise AssertionError(f"stream {mode}: {key} differs "
                                         "from the executor phase's")
            os.remove(path)
        summary = run["summary"]
        launches = summary["backend"]["launches"]
        if launches != {"seg_mean": n_chunks, "seg_mean_heads": 0,
                        "seg_scan": 5 * n_chunks}:
            raise AssertionError(f"stream {mode}: launches {launches}")
        res[mode] = {"wall_s": run["wall_s"],
                     "maxrss_kib": run["maxrss_kib"],
                     "phases_s": summary["phases_s"],
                     "pipeline": summary.get("pipeline"),
                     "launches": launches}
        print(f"stream {mode} {json.dumps(res[mode])}", flush=True)
    if not res["auto"]["maxrss_kib"] < res["off"]["maxrss_kib"]:
        raise AssertionError("stream: the streamed run's peak RSS is not "
                             "below the eager run's")
    print(f"compare stream: output, QC report and manifest identical at "
          f"--stream-clusters auto and off (= the executor phase's); peak "
          f"RSS {res['auto']['maxrss_kib']} / {res['off']['maxrss_kib']} KiB "
          f"(a 3-cluster run: {res['baseline']['maxrss_kib']})", flush=True)
    return res


def files_phase(kernels, clusters, slice_cos, cos_chunks: int,
                exec_bytes: dict) -> dict:
    """files-20k, the file-to-file path on slice-20k's clusters, in a
    temporary directory: the clustered MGF written by the native writer
    (its first FILES_CHECK_CLUSTERS clusters also by the numpy writer: the
    same bytes) and parsed back by the native parser (the head also by
    the Python parser: the spectra written, bit for bit); ``consensus
    --qc-report`` on the file as a user runs it, streamed and eager
    (``stream_phase``), its output, report and manifest the executor
    phase's bytes; ``evaluate`` in process, launch counts
    zeroed just before (five ``seg_scan`` launches per cosine chunk, no
    ``seg_mean``), its cosines the slice phase's, its head against a
    ``--device cpu`` run; then ``consensus --single`` (bin-mean without
    the quorum, and gap-average) on the head's charge-2 spectra and
    ``convert`` of a small mzML, each against the CPU."""
    import tempfile

    import torch

    from specpride_tpu_torch import cli
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.io import mgf

    head_clusters = clusters[:FILES_CHECK_CLUSTERS]
    spectra = [s for c in clusters for s in c.members]
    head = [s for c in head_clusters for s in c.members]
    res = {"clusters": len(clusters), "spectra": len(spectra),
           "peaks": sum(s.n_peaks for s in spectra),
           "head_clusters": len(head_clusters)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files") as work:
        def path(name):
            return os.path.join(work, name)

        # 1. the writers: numpy and native bytes identical on the head
        t0 = time.perf_counter()
        with open(path("head_plain.mgf"), "w", encoding="utf-8") as fh:
            for s in head:
                fh.write(mgf.format_spectrum_plain(s))
        res["head_write_plain_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgf.write_mgf(head, path("head.mgf"))
        res["head_write_native_s"] = time.perf_counter() - t0
        with open(path("head_plain.mgf"), "rb") as a, \
                open(path("head.mgf"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError("files: native and numpy writers differ")
        t0 = time.perf_counter()
        mgf.write_mgf(spectra, path("in.mgf"))
        res["write_s"] = time.perf_counter() - t0
        res["bytes"] = {n: os.path.getsize(path(n))
                        for n in ("in.mgf", "head.mgf")}
        print(f"compare files writer: native = numpy bytes over "
              f"{len(head)} spectra ({res['bytes']['head.mgf']} bytes)",
              flush=True)

        # 2. the parsers: native on the whole file, Python on the head
        t0 = time.perf_counter()
        parsed = mgf.read_mgf(path("in.mgf"))
        res["parse_s"] = time.perf_counter() - t0
        same_spectra(parsed, spectra, "files native parse")
        del parsed
        t0 = time.perf_counter()
        head_native = mgf.read_mgf(path("head.mgf"))
        res["head_parse_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(path("head.mgf"), encoding="utf-8") as fh:
            head_plain = list(mgf.parse_mgf_stream(fh))
        res["head_parse_plain_s"] = time.perf_counter() - t0
        same_spectra(head_native, head, "files native parse (head)")
        same_spectra(head_plain, head, "files plain parse (head)")
        del head_native, head_plain
        print(f"compare files parsers: native (all {len(spectra)}) and "
              f"plain (head) = the spectra written", flush=True)

        # 3. consensus from the file, as a user runs it: streamed at the
        # default, eager and in windows of 512
        n_chunks = -(-len(clusters) // EXEC_EVERY)
        res["stream"] = stream_phase(path("in.mgf"), path("head.mgf"), work,
                                     exec_bytes, n_chunks)
        # the user's run: the default
        res["consensus_wall_s"] = res["stream"]["auto"]["wall_s"]
        res["consensus_launches"] = {
            k: sum(res["stream"][m]["launches"][k] for m, _ in STREAM_MODES)
            for k in kernels.launches}
        # the executor's output, for evaluate below
        with open(path("out.mgf"), "wb") as fh:
            fh.write(exec_bytes["mgf"])

        # 4. evaluate on the card, in process
        args = cli.build_parser().parse_args(
            ["evaluate", path("out.mgf"), path("in.mgf"), "--report",
             path("eval.json")])
        backend = TorchBackend(device=DEV)
        zero_launches(kernels)
        t0 = time.perf_counter()
        summary = cli.run_evaluate(args, backend)
        torch.cuda.synchronize()
        res["evaluate_wall_s"] = time.perf_counter() - t0
        launches = dict(kernels.launches)
        if (backend.cos_chunks != cos_chunks
                or launches != {"seg_mean": 0, "seg_mean_heads": 0,
                                "seg_scan": 5 * cos_chunks}):
            raise AssertionError(f"files evaluate: {backend.cos_chunks} "
                                 f"cosine chunks, launches {launches}")
        res["evaluate_launches"] = launches
        res["evaluate_phase_s"] = backend.phase_seconds
        res["evaluate_summary"] = summary
        with open(path("eval.json")) as fh:
            rows = json.load(fh)["clusters"]
        res["evaluate_cosine_err"] = check_cosines(
            [r["avg_cosine"] for r in rows], slice_cos,
            "files evaluate vs slice QC")
        reps = mgf.read_mgf(path("out.mgf"))
        mgf.write_mgf(reps[:FILES_CHECK_CLUSTERS], path("head_out.mgf"))
        del reps
        cpu_args = cli.build_parser().parse_args(
            ["evaluate", path("head_out.mgf"), path("head.mgf"), "--report",
             path("eval_cpu.json"), "--device", "cpu"])
        cli.run_evaluate(cpu_args, TorchBackend(device="cpu"))
        with open(path("eval_cpu.json")) as fh:
            cpu_rows = json.load(fh)["clusters"]
        exact = ("cluster_id", "n_members", "n_peaks", "by_fraction")
        if ([[r[k] for k in exact] for r in rows[:FILES_CHECK_CLUSTERS]]
                != [[r[k] for k in exact] for r in cpu_rows]):
            raise AssertionError("files evaluate: head differs from the CPU")
        res["evaluate_head_cosine_err"] = check_cosines(
            [r["avg_cosine"] for r in rows[:FILES_CHECK_CLUSTERS]],
            [r["avg_cosine"] for r in cpu_rows], "files evaluate head vs cpu")
        print(f"files evaluate {json.dumps(summary)}", flush=True)

        # 5. --single on the head's charge-2 clusters (a consensus refuses
        # members of mixed charge), and convert
        z2 = [s for s in head if s.precursor_charge == 2]
        mgf.write_mgf(z2, path("head_z2.mgf"))
        res["single_spectra"] = len(z2)
        res["single_peaks"] = sum(s.n_peaks for s in z2)
        for method, check, flags in (
                ("bin-mean", check_same, ("--no-quorum",)),
                ("gap-average", check_gap_same, ())):
            single = path("single.mgf")
            argv = ["consensus", path("head_z2.mgf"), single, "--single",
                    "--method", method, *flags]
            wall = cli_ok(f"files --single {method}", *argv)["wall_s"]
            got = mgf.read_mgf(single)
            if cli.main([*argv, "--device", "cpu"]) != 0:
                raise AssertionError(f"files --single {method} on the CPU")
            check(got, mgf.read_mgf(single), f"files --single {method}")
            res[f"single {method}"] = {"wall_s": wall,
                                       "peaks_out": got[0].n_peaks}
        res["convert"] = convert_check(head_clusters[:60], work)
        print("compare files --single (bin-mean, gap-average) and convert "
              "(mzML to MGF) vs cpu: same", flush=True)
    print(f"files {json.dumps(res)}", flush=True)
    return res


def convert_check(clusters, work: str) -> dict:
    """``convert`` of an mzML of ``clusters``' spectra with a MaRaCluster
    TSV and an msms.txt naming peptides for two spectra of three: the MGF
    the numpy writer makes of the expected spectra; then consensus with
    QC and ``evaluate`` (b/y fractions from the peptides) on it, the card
    against the CPU."""
    from specpride_tpu_torch import cli
    from specpride_tpu_torch.data.peaks import Spectrum, build_title
    from specpride_tpu_torch.io import mgf
    from specpride_tpu_torch.io.mzml import write_mzml

    peptides = ("PEPTIDEK", "VLHPLEGAVVIIFK", "SAMPLER")
    scans, tsv, msms, want = [], [], ["\t".join(
        ["Raw file", "Scan number", "c2", "c3", "c4", "c5", "c6",
         "Modified sequence", "Score"])], []
    scan = 1000
    for i, c in enumerate(clusters):
        for s in c.members:
            scan += 1
            scans.append((scan, s, {}))
            tsv.append(f"run9.raw\t{scan}\t0.9")
            if scan % 3:
                pep = peptides[i % 3]
                msms.append("\t".join(["run9", str(scan), *"xxxxx",
                                       f"_{pep}_", "50"]))
                want.append(Spectrum(
                    s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                    s.rt, build_title(f"cluster-{i + 1}", "PXD004732",
                                      "run9", scan, pep,
                                      s.precursor_charge)))
        tsv.append("")
    src = os.path.join(work, "run9.mzML")
    write_mzml(scans, src)
    paths = {k: os.path.join(work, k) for k in
             ("c.tsv", "msms.txt", "conv.mgf", "conv_out.mgf",
              "conv_qc.json", "conv_eval.json", "conv_eval_cpu.json")}
    with open(paths["c.tsv"], "w") as fh:
        fh.write("\n".join(tsv))
    with open(paths["msms.txt"], "w") as fh:
        fh.write("\n".join(msms) + "\n")
    wall = cli_ok("files convert", "convert", src, paths["conv.mgf"],
                  "--msms", paths["msms.txt"], "--clusters",
                  paths["c.tsv"])["wall_s"]
    with open(paths["conv.mgf"]) as fh:
        if fh.read() != "".join(mgf.format_spectrum_plain(s) for s in want):
            raise AssertionError("files convert: output differs")
    cli_ok("files convert consensus", "consensus", paths["conv.mgf"],
           paths["conv_out.mgf"], "--qc-report", paths["conv_qc.json"])
    rows = {}
    for device, report in (("cuda", "conv_eval.json"),
                           ("cpu", "conv_eval_cpu.json")):
        args = ["evaluate", paths["conv_out.mgf"], paths["conv.mgf"],
                "--report", paths[report], "--device", device]
        if cli.main(args) != 0:
            raise AssertionError(f"files convert: evaluate on {device}")
        with open(paths[report]) as fh:
            rows[device] = json.load(fh)["clusters"]
    exact = ("cluster_id", "n_members", "n_peaks", "by_fraction")
    if ([[r[k] for k in exact] for r in rows["cuda"]]
            != [[r[k] for k in exact] for r in rows["cpu"]]
            or any(r["by_fraction"] is None for r in rows["cuda"])):
        raise AssertionError("files convert: evaluate differs from the CPU")
    err = check_cosines([r["avg_cosine"] for r in rows["cuda"]],
                        [r["avg_cosine"] for r in rows["cpu"]],
                        "files convert evaluate vs cpu")
    return {"spectra_in": len(scans), "spectra_out": len(want),
            "wall_s": wall, "clusters": len(rows["cuda"]),
            "cosine_err": err}


KILL_EVERY = 128


def kill_resume_phase(src: str) -> dict:
    """A real kill and resume of the CLI on CLI-2k's file, ``--checkpoint
    --checkpoint-every KILL_EVERY --qc-report`` at the defaults: the run
    is sent SIGKILL once its manifest lists a chunk and it has not ended,
    then resumed with the same flags; the output and QC report must be
    the bytes of an uninterrupted run, and the resume's summary must show
    the skipped clusters."""
    import signal

    work = os.path.join(ROOT, "build", "chip_smoke", "kill")
    os.makedirs(work, exist_ok=True)

    def paths(name):
        p = {k: os.path.join(work, f"{name}.{k}")
             for k in ("mgf", "ck.json", "qc.json")}
        for path in p.values():
            if os.path.exists(path):
                os.remove(path)
        return p

    def argv(p):
        return [sys.executable, "-m", "specpride_tpu_torch", "consensus",
                src, p["mgf"], "--checkpoint", p["ck.json"],
                "--checkpoint-every", str(KILL_EVERY), "--qc-report",
                p["qc.json"]]

    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(p) -> dict:
        proc = subprocess.run(argv(p), cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"kill phase CLI exited {proc.returncode}:"
                                 f"\n{proc.stderr}")
        return json.loads(proc.stderr.strip().splitlines()[-1])

    full = paths("full")
    # the uninterrupted reference in this process: the same code without
    # a process start
    ref = cli_ok("kill phase reference", *argv(full)[3:])
    full_summary, full_s = ref["summary"], ref["wall_s"]
    killed = paths("killed")
    proc = subprocess.Popen(argv(killed), cwd=ROOT, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    done_at_kill = 0
    try:
        deadline = time.perf_counter() + 600
        while time.perf_counter() < deadline and proc.poll() is None:
            try:
                with open(killed["ck.json"]) as fh:
                    done_at_kill = len(json.load(fh)["done"])
            except (OSError, ValueError, KeyError):
                done_at_kill = 0
            if done_at_kill >= KILL_EVERY:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.005)
    finally:
        if proc.poll() is None and done_at_kill < KILL_EVERY:
            proc.kill()
        proc.wait()
    if proc.returncode != -signal.SIGKILL or done_at_kill < KILL_EVERY:
        raise AssertionError(f"kill phase: the run ended with "
                             f"{proc.returncode} before it could be killed "
                             f"after a chunk ({done_at_kill} done)")
    with open(killed["mgf"], "rb") as fh:
        bytes_at_kill = len(fh.read())
    resumed = run(killed)
    same = {}
    for key in ("mgf", "qc.json"):
        with open(full[key], "rb") as a, open(killed[key], "rb") as b:
            same[key] = a.read() == b.read()
    skipped = resumed["counters"].get("clusters_skipped_done", 0)
    res = {"every": KILL_EVERY, "done_at_kill": done_at_kill,
           "output_bytes_at_kill": bytes_at_kill, "resume_skipped": skipped,
           "identical": same, "full_wall_s": full_s,
           "full_pipeline": full_summary.get("pipeline"),
           "resume_pipeline": resumed.get("pipeline")}
    if not all(same.values()) or skipped < done_at_kill:
        raise AssertionError(f"kill phase: {res}")
    print(f"compare kill and resume: output and QC report identical to an "
          f"uninterrupted run; killed after {done_at_kill} clusters, resume "
          f"skipped {skipped}", flush=True)
    print(f"kill {json.dumps(res)}", flush=True)
    return res


def dirty_copy(src: str, dst: str) -> None:
    """``src`` with a truncated block (no END IONS) after its 100th record
    and, after its 1,000th, an unparseable record (a peak intensity that
    is no number) of that record's cluster: the cluster keeps its other
    members, so the eager and the streamed run chunk the same clusters (a
    cluster whose only record is damaged stays in a streamed run's index,
    empty, and is skipped; the eager run never sees it)."""
    with open(src, encoding="utf-8") as fh:
        blocks = fh.read().split("\n\n")
    cid = blocks[999].split("TITLE=", 1)[1].split(";", 1)[0]
    blocks.insert(1000, f"BEGIN IONS\nTITLE={cid};mzspec:PXD1:r:scan:999999"
                        "\nPEPMASS=500.0\nCHARGE=2+\n123.4 banana\n"
                        "END IONS")
    blocks.insert(100, "BEGIN IONS\nTITLE=cluster-trunc;mzspec:PXD1:r:scan:"
                       "8\nPEPMASS=500.0\n123.4 10.0")
    with open(dst, "w", encoding="utf-8") as fh:
        fh.write("\n\n".join(blocks))


def run_main(*argv) -> dict:
    """``cli.main(ARGV)`` in this process, as a caller of the package
    runs it, the launch counts zeroed just before (its summary's
    ``launches`` are then this run's): its exit code (1 for an exception,
    SystemExit's code), wall, stderr and the run summary it prints last
    there (None when there is none)."""
    import contextlib
    import io
    import logging

    from specpride_tpu_torch import cli
    from specpride_tpu_torch.ops import kernels

    err = io.StringIO()
    handler = logging.StreamHandler(err)
    log = logging.getLogger("specpride_tpu_torch")
    log.addHandler(handler)
    zero_launches(kernels)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(list(argv))
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    except Exception as e:  # noqa: BLE001 - the run's failure, reported
        rc = 1
        err.write(f"{type(e).__name__}: {e}\n")
    finally:
        log.removeHandler(handler)
    wall = time.perf_counter() - t0
    text = err.getvalue()
    lines = [ln for ln in text.strip().splitlines() if ln.startswith("{")]
    return {"rc": rc, "wall_s": wall, "stderr": text,
            "summary": json.loads(lines[-1]) if lines else None}


def quarantine_phase(src: str) -> dict:
    """quarantine (CLI-2k with one truncated and one unparseable block,
    ``dirty_copy``): ``consensus --on-error skip`` in process, eager and
    streamed in windows of 256: the same output and quarantine file
    bytes, 2 quarantined, every cluster written; under ``--on-error
    abort`` the run fails and leaves no quarantine file."""
    from specpride_tpu_torch.io import mgf

    work = os.path.join(ROOT, "build", "chip_smoke", "quarantine")
    os.makedirs(work, exist_ok=True)
    dirty = os.path.join(work, "dirty.mgf")
    dirty_copy(src, dirty)
    res, got = {}, {}
    for mode in ("off", "256"):
        out = os.path.join(work, f"q_{mode}.mgf")
        run = run_main("consensus", dirty, out, "--on-error", "skip",
                       "--stream-clusters", mode, "--qc-report",
                       out + ".qc.json")
        if run["rc"] != 0:
            raise AssertionError(f"quarantine {mode}: {run['stderr']}")
        rb = run["summary"].get("robustness") or {}
        if rb.get("quarantined") != 2:
            raise AssertionError(f"quarantine {mode}: summary {rb}")
        with open(out, "rb") as a, open(out + ".quarantine.mgf", "rb") as b:
            got[mode] = (a.read(), b.read())
        res[mode] = {"wall_s": run["wall_s"], "robustness": rb,
                     "skipped": run["summary"].get("skipped_cluster_ids"),
                     "quarantine_bytes": len(got[mode][1])}
    if got["off"] != got["256"]:
        bad = [what for what, a, b in zip(("output", "quarantine file"),
                                          got["off"], got["256"]) if a != b]
        raise AssertionError(f"quarantine: the eager and streamed runs' "
                             f"{bad} differ")
    text = got["off"][1].decode()
    if "cluster-trunc" not in text or "banana" not in text:
        raise AssertionError("quarantine: a damaged block is missing")
    n_out = len(mgf.read_mgf(os.path.join(work, "q_off.mgf")))
    if n_out != CLI_CLUSTERS:
        raise AssertionError(f"quarantine: {n_out} of {CLI_CLUSTERS} "
                             "clusters written")
    out = os.path.join(work, "abort.mgf")
    if os.path.exists(out + ".quarantine.mgf"):
        os.remove(out + ".quarantine.mgf")
    run = run_main("consensus", dirty, out)
    if run["rc"] == 0 or os.path.exists(out + ".quarantine.mgf"):
        raise AssertionError(f"quarantine abort: exit {run['rc']}")
    res["abort"] = {"rc": run["rc"],
                    "error": run["stderr"].strip().splitlines()[-1]}
    print(f"compare quarantine: eager = streamed output and quarantine file "
          f"({len(got['off'][1])} bytes, 2 blocks); abort fails "
          f"({res['abort']['error']}) with no quarantine file", flush=True)
    print(f"quarantine {json.dumps(res)}", flush=True)
    return res


CHAOS_FLAGS = ("--prefetch", "4", "--pack-workers", "3", "--retries", "3",
               "--retry-backoff", "0.01", "--watchdog-timeout", "0.3")
CHAOS_FAULTS = ("parse:io:1,pack:io:1:1,prepare:io:1:1,dispatch:oom:1:1,"
                "d2h:io:1:1,qc:io:1:1,write:io:1:1,checkpoint_write:io:1:1,"
                "dispatch:hang:1:2")
CHAOS_EVERY = 128
CHAOS_RUNS = (
    # (name, command and flags, the fault plan, sites that must fire)
    ("select medoid", ("select", "--method", "medoid"), CHAOS_FAULTS,
     ("parse", "pack", "prepare", "dispatch", "d2h", "qc", "write",
      "checkpoint_write")),
    # the main path, every site but the split (the fused QC has no
    # separate pass, so its `qc` site is never visited, as in the JAX
    # package)
    ("consensus bin-mean", ("consensus",),
     CHAOS_FAULTS.replace("dispatch:oom:1:1", "dispatch:io:1:1"),
     ("parse", "pack", "prepare", "dispatch", "d2h", "write",
      "checkpoint_write")),
)


def chaos_phase(src: str) -> dict:
    """chaos (CLI-2k, ``cli.main`` in process): ``select --method medoid
    --qc-report`` with CHAOS_FLAGS and the fault plan CHAOS_FAULTS (an I/O
    fault at every site, an OOM at the second dispatch, a hang at the
    third), and the main path (``consensus --qc-report``) with the same
    plan but an I/O fault for the OOM: output, manifest and QC report the
    bytes of a clean run with the same flags; every site fired and was
    recovered; the medoid run split a chunk and its watchdog broke the
    hang; no reroute.  Then the main path with only the OOM: the split
    chunk's halves run on the card at new flat layouts, and the output and
    QC report are held to the clean run's at TOL and COS_TOL, their byte
    differences counted."""
    from specpride_tpu_torch.io import mgf

    work = os.path.join(ROOT, "build", "chip_smoke", "chaos")
    os.makedirs(work, exist_ok=True)

    def run(name, argv, *flags):
        paths = {k: os.path.join(work, f"{name}.{k}")
                 for k in ("mgf", "ck.json", "qc.json")}
        for path in paths.values():
            if os.path.exists(path):
                os.remove(path)
        r = run_main(argv[0], src, paths["mgf"], *argv[1:],
                     "--qc-report", paths["qc.json"], "--checkpoint",
                     paths["ck.json"], "--checkpoint-every",
                     str(CHAOS_EVERY), *CHAOS_FLAGS, *flags)
        if r["rc"] != 0:
            raise AssertionError(f"chaos {name}: {r['stderr']}")
        got = {}
        for key, path in paths.items():
            with open(path, "rb") as fh:
                got[key] = fh.read()
        return r["summary"], got, r["wall_s"]

    res = {"launches": dict.fromkeys(("seg_mean", "seg_mean_heads",
                                      "seg_scan"), 0)}
    cleans = {}
    for name, argv, plan, sites in CHAOS_RUNS:
        tag = name.replace(" ", "_")
        _, clean, clean_s = cleans[name] = run(tag + "_clean", argv)
        summary, got, wall = run(tag, argv, "--inject-faults", plan)
        if got != clean:
            bad = [k for k in got if got[k] != clean[k]]
            raise AssertionError(f"chaos {name}: {bad} differ from the "
                                 "clean run's")
        rb = summary.get("robustness") or {}
        fired = (rb.get("faults") or {}).get("fired_by_site", {})
        if (sorted(fired) != sorted(sites) or "degrade_reroutes" in rb
                or rb.get("retries", 0) < len(sites)):
            raise AssertionError(f"chaos {name}: robustness {rb}")
        if name.startswith("select") and (
                rb.get("degrade_splits", 0) < 1
                or rb.get("watchdog_stalls", 0) < 1):
            raise AssertionError(f"chaos {name}: robustness {rb}")
        for k, v in summary["backend"]["launches"].items():
            res["launches"][k] += v
        res[name] = {"wall_s": wall, "clean_wall_s": clean_s,
                     "robustness": rb,
                     "launches": summary["backend"]["launches"]}
        print(f"compare chaos {name}: output, manifest and QC report = the "
              f"clean run's; fired {sorted(fired)}", flush=True)
        print(f"chaos {name} {json.dumps(res[name])}", flush=True)

    # the main path's split: held at the tolerances, byte changes counted
    argv = ("consensus",)
    _, clean, _ = cleans["consensus bin-mean"]
    summary, got, wall = run("split", argv, "--inject-faults",
                             "dispatch:oom:1:1")
    rb = summary.get("robustness") or {}
    if rb.get("degrade_splits", 0) < 1:
        raise AssertionError(f"chaos split: robustness {rb}")
    reps = {k: mgf.read_mgf(os.path.join(work, f"{k}.mgf"))
            for k in ("split", "consensus_bin-mean_clean")}
    reps["split_clean"] = reps.pop("consensus_bin-mean_clean")
    check_same(reps["split"], reps["split_clean"], "chaos split vs clean")
    rows = {k: json.loads(v["qc.json"])["clusters"]
            for k, v in (("split", got), ("split_clean", clean))}
    err = check_cosines([r["avg_cosine"] for r in rows["split"]],
                        [r["avg_cosine"] for r in rows["split_clean"]],
                        "chaos split vs clean")
    res["bin-mean split"] = {
        "wall_s": wall, "robustness": rb, "cosine_err": err,
        "same_bytes": {k: got[k] == clean[k] for k in got},
        "spectra_differing": sum(
            a.intensity.tobytes() != b.intensity.tobytes()
            for a, b in zip(reps["split"], reps["split_clean"])),
        "cosines_differing": sum(
            a["avg_cosine"] != b["avg_cosine"]
            for a, b in zip(rows["split"], rows["split_clean"])),
    }
    for k, v in summary["backend"]["launches"].items():
        res["launches"][k] += v
    print(f"chaos bin-mean split {json.dumps(res['bin-mean split'])}",
          flush=True)
    return res


OOM_CLUSTERS = 8_000  # one chunk of them: --checkpoint-every 8000


def real_oom_phase(kernels) -> dict:
    """real OOM: ``consensus --precision int8`` through the in-process
    executor, one chunk of OOM_CLUSTERS clusters (about 11M peaks, one
    flat batch), first clean; then the allocator capped
    (``torch.cuda.set_per_process_memory_fraction``) halfway between the
    chunk's device peak and its halves', so the whole chunk raises
    ``torch.OutOfMemoryError`` on the dispatch lane: the run splits,
    writes the clean run's bytes and counts ``degrade_splits`` >= 1.  The
    int8 consensus because its card sums are of integer codes, exact in
    float32 in any order, so a split leaves the bytes as they were (f32
    sums round by layout: the chaos phase's split); the medoid's device
    peak does not fall with the chunk (it works in bucket batches capped
    by ``max_grid_elements``).  The peaks and the cap are printed.  Then,
    on the same process's workspaces, ``seg_mean`` and ``seg_scan``
    against their plain versions (a launch after the OOM reads no stale
    tickets)."""
    import torch

    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.config import BinMeanConfig

    clusters = make_workload(OOM_CLUSTERS, seed=7)
    flags = ("--precision", "int8", "--checkpoint-every", str(OOM_CLUSTERS))
    res = {"clusters": len(clusters),
           "peaks": sum(c.total_peaks for c in clusters)}

    def peak(fn) -> int:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    backend = TorchBackend(device=DEV, precision="int8")
    mid = (len(clusters) + 1) // 2
    res["peak_whole_b"] = peak(lambda: backend.run_bin_mean(
        clusters, BinMeanConfig()))
    res["peak_half_b"] = max(
        peak(lambda: backend.run_bin_mean(clusters[:mid], BinMeanConfig())),
        peak(lambda: backend.run_bin_mean(clusters[mid:], BinMeanConfig())))
    if res["peak_whole_b"] < 1.5 * res["peak_half_b"]:
        raise AssertionError(f"real OOM: no cap splits the chunk: {res}")
    clean, clean_bytes = executor_run(kernels, clusters, "oom_clean",
                                      "consensus", flags, qc=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    # over what the process holds now (the workspaces, the allocator's
    # own), halfway between the halves' peak and the whole chunk's
    cap = torch.cuda.memory_reserved() + (
        res["peak_half_b"] + res["peak_whole_b"]) // 2
    res["cap_b"] = cap
    res["total_b"] = total
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        run, got = executor_run(kernels, clusters, "oom", "consensus",
                                flags + ("--retry-backoff", "0.01"),
                                qc=False)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    if got != clean_bytes:
        raise AssertionError("real OOM: bytes differ from the clean run's")
    rb = run.get("robustness") or {}
    if rb.get("degrade_splits", 0) < 1 or "degrade_reroutes" in rb:
        raise AssertionError(f"real OOM: robustness {rb}")
    res["robustness"] = rb
    res["launches"] = run["launches"]
    res["wall_s"], res["clean_wall_s"] = run["wall_s"], clean["wall_s"]
    # the kernels after the OOM, on this process's workspaces
    errs = []
    for n, nv in ((KERNEL_N, 1), (PATH_N, 2)):
        keys, w, values = kernel_inputs(n, nv, seed=nv)
        args = [torch.from_numpy(a).to(DEV) for a in (keys, w, *values)]
        errs.append(compare(kernels.seg_mean(*args),
                            kernels.seg_mean_plain(*args),
                            f"after OOM seg_mean n={n} nv={nv}", True))
        heads = torch.ones(n, dtype=torch.bool, device=DEV)
        heads[1:] = args[0][1:] != args[0][:-1]
        errs.append(compare(kernels.seg_scan(heads, *args[2:]),
                            kernels.seg_scan_plain(heads, *args[2:]),
                            f"after OOM seg_scan n={n} nc={nv}", False))
    res["after_oom_max_abs_err"] = [e for e, _ in errs]
    print(f"compare real OOM: split run = clean bytes; kernels match their "
          f"plain versions after it", flush=True)
    print(f"real_oom {json.dumps(res)}", flush=True)
    return res



def same_as_cpu_select(golden, dst, qc, flags, work, what) -> dict:
    """The card's ``select`` output against the port's ``--device cpu``
    run with the same flags: the same bytes; a QC report with the same
    rows and counts, cosines within COS_TOL."""
    from specpride_tpu_torch import cli

    ref_dst = os.path.join(work, "ref.mgf")
    ref_qc = os.path.join(work, "ref.qc.json")
    ref_flags = [ref_qc if f == qc else f for f in flags]
    if cli.main(["select", golden, ref_dst, *ref_flags, "--device",
                 "cpu"]) != 0:
        raise AssertionError(f"CLI {what} on the CPU failed")
    with open(dst, "rb") as a, open(ref_dst, "rb") as b:
        if a.read() != b.read():
            raise AssertionError(f"CLI {what}: output differs from the CPU's")
    if qc not in flags:
        return {"same_bytes": True}
    with open(qc) as a, open(ref_qc) as b:
        got, want = json.load(a), json.load(b)
    keep = ("n_clusters", "n_input_clusters", "n_method_failed",
            "n_qc_failed")
    if ([(r["cluster_id"], r["n_members"]) for r in got["clusters"]]
            != [(r["cluster_id"], r["n_members"]) for r in want["clusters"]]
            or [got["summary"][k] for k in keep]
            != [want["summary"][k] for k in keep]):
        raise AssertionError(f"CLI {what}: QC report differs from the CPU's")
    err = check_cosines([r["avg_cosine"] for r in got["clusters"]],
                        [r["avg_cosine"] for r in want["clusters"]],
                        f"cli {what}")
    return {"same_bytes": True, "cosine_err": err}


BUCKET_TOL = dict(rtol=1e-5, atol=0.0)  # f32 means vs f64 plain prefixes


def changed_bits(got, want) -> int:
    """Values whose float64 bit patterns differ, over two runs' spectra
    (m/z and intensity) of equal shapes."""
    return sum(int((g.mz != w.mz).sum() + (g.intensity != w.intensity).sum())
               for g, w in zip(got, want))


def check_bucket_same(got, want, what: str) -> dict:
    """Bucketized card run vs the port's CPU run of the same layout: the
    same titles, precursors and peak counts (so the same float32 quorum
    decisions), m/z and intensity within BUCKET_TOL (the card's float32
    means against the CPU's float64 prefixes)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} spectra")
    err = 0.0
    for g, e in zip(got, want):
        if (g.title, g.n_peaks, g.precursor_mz, g.precursor_charge) != (
                e.title, e.n_peaks, e.precursor_mz, e.precursor_charge):
            raise AssertionError(f"{what}: {g.title} differs in structure")
        if not (np.isfinite(g.mz).all() and np.isfinite(g.intensity).all()):
            raise AssertionError(f"{what}: {g.title} non-finite values")
        np.testing.assert_allclose(g.mz, e.mz, **BUCKET_TOL, err_msg=what)
        np.testing.assert_allclose(g.intensity, e.intensity, **BUCKET_TOL,
                                   err_msg=what)
        for a, b in ((g.mz, e.mz), (g.intensity, e.intensity)):
            nz = b != 0
            if nz.any():
                err = max(err, float((np.abs(a - b)[nz] / np.abs(b[nz]))
                                     .max()))
    print(f"compare {what} vs cpu: peak counts equal, max_rel_err {err!r} "
          f"(rtol {BUCKET_TOL['rtol']})", flush=True)
    return {"max_rel_err": err, "changed_bits": changed_bits(got, want)}


def bucket_launches(kernels, backend, what: str, qc: bool) -> dict:
    """One ``seg_mean_heads`` launch per consensus dispatch, four
    ``seg_scan`` per cosine dispatch with QC, no ``seg_mean``."""
    launches = dict(kernels.launches)
    want = {"seg_mean": 0, "seg_mean_heads": backend.chunks,
            "seg_scan": 4 * backend.cos_chunks if qc else 0}
    if launches != want or backend.chunks < 2 or (qc and
                                                  backend.cos_chunks < 2):
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    return launches


def bucketized_phase(kernels, clusters, flat_reps) -> dict:
    """bucketized-20k: slice-20k through ``layout="bucketized"`` on the
    card, the launch counts zeroed just before each run: bin-mean with QC,
    gap-average f32 and bin-mean int8, each against the port's CPU run of
    the same layout; the bin-mean's peak counts against the flat run's
    where the float32 and float64 quorums agree (all clusters at the
    default fraction 0.25); padded and real peak slots, H2D bytes."""
    import torch

    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.config import BinMeanConfig

    n_peaks = sum(c.total_peaks for c in clusters)
    res = {}
    runs = (("bin-mean QC", "f32"), ("gap f32", "f32"),
            ("bin-mean int8", "int8"))
    for what, precision in runs:
        backend = TorchBackend(device=DEV, layout="bucketized",
                               precision=precision)
        zero_launches(kernels)
        t0 = time.perf_counter()
        cosines = None
        if what == "bin-mean QC":
            reps, cosines = backend.run_bin_mean_with_cosines(clusters)
        elif what == "gap f32":
            reps = backend.run_gap_average(clusters)
        else:
            reps = backend.run_bin_mean(clusters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bucket_launches(kernels, backend, f"bucketized {what}",
                                   cosines is not None)
        cpu = TorchBackend(device="cpu", layout="bucketized",
                           precision=precision)
        run = {"wall_s": wall, "clusters_per_s": len(clusters) / wall,
               "chunks": backend.chunks, "cos_chunks": backend.cos_chunks,
               "launches": launches, "phase_s": backend.phase_seconds,
               "real_elements": backend.bucket_elements["real"],
               "padded_elements": backend.bucket_elements["padded"],
               "h2d_bytes": backend.h2d_bytes,
               "h2d_bytes_per_peak": backend.h2d_bytes["h2d"] / n_peaks}
        # a row's sums do not depend on the other rows of its batch
        held, ref = reps[::REF_STRIDE], clusters[::REF_STRIDE]
        if what == "gap f32":
            check_gap_same(held, cpu.run_gap_average(ref),
                           "bucketized gap f32", exact_mz=False)
        elif cosines is not None:
            run["vs_cpu"] = check_bucket_same(held, cpu.run_bin_mean(ref),
                                              "bucketized bin-mean QC")
            # the CPU's cosines of the card's own representatives: m/z
            # means from the card's float32 sums sit an ulp from the CPU's,
            # enough to move a peak across a QC bin edge
            run["cosine_err"] = check_cosines(
                cosines[::REF_STRIDE], cpu.average_cosines(held, ref),
                "bucketized bin-mean QC")
            # the flat layout's host quorum int(n * 0.25) + 1 against the
            # float32 device quorum: equal for every member count here
            frac = BinMeanConfig().quorum_fraction
            agree = [
                int(np.floor(np.float32(c.n_members) * np.float32(frac)))
                == int(c.n_members * frac) for c in clusters]
            same = [i for i, ok in enumerate(agree) if ok]
            if any(reps[i].n_peaks != flat_reps[i].n_peaks for i in same):
                raise AssertionError("bucketized bin-mean: peak counts "
                                     "differ from the flat layout's")
            run["flat_compared"] = len(same)
            res["reps"], res["cosines"] = reps, cosines
        else:
            run["vs_cpu"] = check_bucket_same(
                held, cpu.run_bin_mean(ref), "bucketized bin-mean int8")
        print(f"bucketized {what} {json.dumps(run)}", flush=True)
        res[what] = run
    return res


def mesh_phase(kernels, clusters, reps, cosines) -> dict:
    """mesh: slice-20k's bin-mean with QC through a ``DeviceMesh``: every
    visible card (``--mesh``'s, one here) and the one card twice (two
    streams, the rows split in two), the launch counts zeroed just before
    each run; both must give the bucketized run's bytes."""
    import torch

    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.parallel.mesh import DeviceMesh

    res = {}
    for what, mesh in (("local", DeviceMesh.local("cuda")),
                       ("two streams", DeviceMesh(["cuda:0", "cuda:0"]))):
        backend = TorchBackend(device=DEV, mesh=mesh)
        zero_launches(kernels)
        t0 = time.perf_counter()
        got, got_cos = backend.run_bin_mean_with_cosines(clusters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bucket_launches(kernels, backend, f"mesh {what}", True)
        bits = changed_bits(got, reps)
        cos_bits = int((np.asarray(got_cos) != np.asarray(cosines)).sum())
        if [g.title for g in got] != [r.title for r in reps] or any(
                g.n_peaks != r.n_peaks for g, r in zip(got, reps)) \
                or bits or cos_bits:
            raise AssertionError(f"mesh {what}: {bits} spectrum values and "
                                 f"{cos_bits} cosines differ from the "
                                 "bucketized run")
        run = {"devices": [str(d) for d in mesh.devices], "wall_s": wall,
               "chunks": backend.chunks, "cos_chunks": backend.cos_chunks,
               "launches": launches, "same_bytes": True}
        print(f"mesh {what} {json.dumps(run)}", flush=True)
        res[what] = run
    return res


RANK_CONFIGS = (
    ("bin-mean f32 QC", "consensus", ("--qc-report", "{qc}")),
    ("medoid", "select", ("--method", "medoid")),
    ("bin-mean int8", "consensus", ("--precision", "int8")),
)


def ranks_phase(src: str) -> dict:
    """ranks: CLI-2k as two ``--coordinator`` ranks on the one card (two
    processes, a port the OS picked), joined by ``merge-parts``, against
    the single-process ``--mesh`` run in process: the medoid and int8
    outputs byte for byte; the f32 bin-mean and its QC report held at the
    tolerances with the changed bits counted."""
    import socket

    from specpride_tpu_torch.io.mgf import read_mgf

    work = os.path.join(ROOT, "build", "chip_smoke", "ranks")
    os.makedirs(work, exist_ok=True)
    res = {"launches": {"seg_mean": 0, "seg_mean_heads": 0, "seg_scan": 0}}
    for what, command, flags in RANK_CONFIGS:
        for f in os.listdir(work):
            os.remove(os.path.join(work, f))
        single, out = (os.path.join(work, n) for n in ("single.mgf",
                                                        "out.mgf"))
        sqc, qc = (os.path.join(work, n) for n in ("single.json", "qc.json"))
        one = run_main(command, src, single, "--mesh",
                       *(f.format(qc=sqc) for f in flags))
        if one["rc"] != 0:
            raise AssertionError(f"ranks {what}: the single run failed:\n"
                                 f"{one['stderr'][-2000:]}")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "specpride_tpu_torch", command, src, out,
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(i), *(f.format(qc=qc) for f in flags)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        ) for i in range(2)]
        try:
            errs = [p.communicate(timeout=600)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for p, err in zip(procs, errs):
            if p.returncode != 0:
                raise AssertionError(f"ranks {what}: a rank exited "
                                     f"{p.returncode}:\n{err[-2000:]}")
            summary = json.loads(err.strip().splitlines()[-1])
            for k, v in summary["backend"]["launches"].items():
                res["launches"][k] += v
        merge = run_main("merge-parts", out, "--num-processes", "2",
                         *(("--qc-report", qc) if "{qc}" in flags else ()))
        if merge["rc"] != 0:
            raise AssertionError(f"ranks {what}: merge-parts failed:\n"
                                 f"{merge['stderr'][-2000:]}")
        with open(out, "rb") as a, open(single, "rb") as b:
            same = a.read() == b.read()
        run = {"ranks_wall_s": wall, "single_wall_s": one["wall_s"],
               "same_bytes": same}
        if what == "bin-mean f32 QC":
            got, want = read_mgf(out), read_mgf(single)
            run["vs_single"] = check_bucket_same(got, want,
                                                 "ranks bin-mean f32")
            with open(qc) as a, open(sqc) as b:
                gq, wq = json.load(a), json.load(b)
            gc = [r["avg_cosine"] for r in gq["clusters"]]
            wc = [r["avg_cosine"] for r in wq["clusters"]]
            run["cosine_err"] = check_cosines(gc, wc, "ranks bin-mean f32")
            run["cosine_changed"] = int(sum(a != b for a, b in zip(gc, wc)))
            with open(qc, "rb") as a, open(sqc, "rb") as b:
                run["qc_same_bytes"] = a.read() == b.read()
        elif not same:
            raise AssertionError(f"ranks {what}: merged parts differ from "
                                 "the single-process bytes")
        print(f"ranks {what} {json.dumps(run)}", flush=True)
        res[what] = run
    return res


ELASTIC_EVERY = 128  # CLI-2k's elastic runs: 16 chunks of a 2,000 range
ELASTIC_SLOW_S = "1.5"  # the steal's donor: a stall per dispatch
ELASTIC_KILL_AT = "15"  # write visit: ranges 1-7 whole, range 0's 1st chunk


ELASTIC_OFFGRID = 200  # a range off the 128 grid: chunks of 128 and 72
# the ROADMAP tolerances of a consensus whose f32 sums round differently
OFF_GRID_TOL = {"mz": dict(rtol=1e-5, atol=1e-3),
                "intensity": dict(rtol=1e-4, atol=1e-3),
                "avg_cosine": dict(rtol=1e-5, atol=1e-6)}


def off_grid_compare(got_mgf: str, want_mgf: str, got_qc: str,
                     want_qc: str) -> dict:
    """An off-grid range's merged output and QC report against the single
    run's: the same spectra and peak counts, the peaks whose m/z or
    intensity bits moved counted, the largest relative errors beside
    ``OFF_GRID_TOL``; fails outside a tolerance."""
    from specpride_tpu_torch.io import mgf

    def rel(a, b) -> float:
        nz = b != 0
        return float((np.abs(a - b)[nz] / np.abs(b[nz])).max()) \
            if nz.any() else 0.0

    got, want = mgf.read_mgf(got_mgf), mgf.read_mgf(want_mgf)
    if [g.title for g in got] != [w.title for w in want] or [
            len(g.mz) for g in got] != [len(w.mz) for w in want]:
        raise AssertionError("off-grid: the spectra or their peak counts "
                             "differ from the single run's")
    res: dict = {"spectra": len(got), "peaks": int(sum(len(g.mz)
                                                       for g in got))}
    cols = {"mz": ([g.mz for g in got], [w.mz for w in want]),
            "intensity": ([g.intensity for g in got],
                          [w.intensity for w in want])}
    moved = np.zeros(res["peaks"], dtype=bool)
    for key, (a, b) in cols.items():
        a, b = np.concatenate(a), np.concatenate(b)
        moved |= a != b
        res[f"{key}_max_rel_err"] = rel(a, b)
        res[f"{key}_ok"] = bool(np.allclose(a, b, **OFF_GRID_TOL[key]))
    res["changed_peaks"] = int(moved.sum())
    with open(got_qc) as fh, open(want_qc) as gh:
        a = np.array([r["avg_cosine"] for r in json.load(fh)["clusters"]])
        b = np.array([r["avg_cosine"] for r in json.load(gh)["clusters"]])
    res["avg_cosine_changed"] = int((a != b).sum())
    res["avg_cosine_max_rel_err"] = rel(a, b)
    res["avg_cosine_ok"] = bool(np.allclose(a, b, **OFF_GRID_TOL[
        "avg_cosine"]))
    res["tolerances"] = OFF_GRID_TOL
    if not all(res[f"{k}_ok"] for k in OFF_GRID_TOL):
        raise AssertionError(f"off-grid: outside the tolerances {res}")
    return res


def launch_group(*argvs) -> list:
    """``python -m specpride_tpu_torch ARGV`` for each argv, started
    together by the launcher and reaped as each exits: per child its exit
    code, wall from the common start, peak resident set (KiB), stderr and
    the run summary it prints last there."""
    _launcher.stdin.write(json.dumps({
        "argvs": [[sys.executable, "-m", "specpride_tpu_torch", *argv]
                  for argv in argvs],
        "cwd": ROOT, "env": dict(os.environ, PYTHONPATH=ROOT),
    }) + "\n")
    _launcher.stdin.flush()
    line = _launcher.stdout.readline()
    if not line:
        raise AssertionError("the launcher died")
    out = json.loads(line)["group"]
    for argv, res in zip(argvs, out):
        if res["rc"] != 0:
            raise AssertionError(f"rank {argv[:2]} exited {res['rc']}:\n"
                                 f"{res['stderr'][-3000:]}")
        lines = res["stderr"].strip().splitlines()
        res["summary"] = json.loads(lines[-1])
    return out


def rank_events(journal: str, ranks, what: str) -> list:
    """The events of every rank's ``.part<rank>`` journal, schema-clean."""
    from specpride_tpu_torch.observability.journal import read_events

    events = []
    for r in ranks:
        ev, bad = read_events(f"{journal}.part{r:05d}")
        if bad:
            raise AssertionError(f"{what}: rank {r} journal {bad[:3]}")
        events += ev
    return events


def add_launches(total: dict, *summaries) -> None:
    for summary in summaries:
        for k, v in summary["backend"]["launches"].items():
            total[k] += v


def elastic_phase(src: str, clusters, exec_bytes: dict, single: dict
                  ) -> dict:
    """elastic: the port's elastic runs as CLI processes on the card.

    (a) elastic-20k: files-20k (the MGF written anew) as ``consensus
    --qc-report --checkpoint-every 512 --elastic DIR``, two ranks started
    together, joined by ``merge-parts --elastic`` in process: the output
    and QC report exec-20k's bytes (the stream phase's single run with
    these flags and a checkpoint), the ranks' launches summing to 40
    ``seg_mean`` and 200 ``seg_scan``; each rank's wall, ranges and peak
    RSS beside the single run's wall, and ``run_end.elastic``'s counters.
    Then CLI-2k at ``--checkpoint-every 128``, each run against the
    single-process run with a checkpoint at those chunks (in process):
    (b) steal: one 2,048-cluster range; the donor stalls
    ``ELASTIC_SLOW_S`` at every dispatch (``rank_slow``) and the thief
    starts once the donor's ``lease_claim`` is journaled: a
    ``lease_split`` paired with ``chunk_reassign via=lease_split``,
    ``audit_elastic`` clean; (c) kill: rank 1 alone, killed by
    ``rank_kill`` after range 0's first committed chunk, then rank 0 (in
    process) takes it over: a ``resume`` with ``n_done`` 128,
    ``lease_expire`` paired with ``chunk_reassign``,
    ``audit_fault_recovery`` clean; (d) object store: a ``cas-server``
    process, two ranks with ``--elastic URL --result-cache DIR
    --result-store URL`` cold, then (the store's run records cleared, a
    fresh local tier) warm: no launch, every cluster a shared hit, and
    rank 0's ``/metrics`` scraped during the run (its first claim held
    3 s by a ``cas`` ``rank_slow``) valid with
    ``specpride_rank_heartbeat_age_seconds``; (e) ``fleet --ranks 2``: two
    ``rank_spawn`` events.  Every merge gives the single-process bytes."""
    import shutil
    import socket
    import tempfile
    import urllib.request

    from specpride_tpu_torch.io import mgf
    from specpride_tpu_torch.observability.exporter import (
        validate_exposition,
    )
    from specpride_tpu_torch.parallel.elastic import audit_elastic
    from specpride_tpu_torch.parallel.store import HttpCasStore
    from specpride_tpu_torch.robustness.faults import audit_fault_recovery

    work = os.path.join(ROOT, "build", "chip_smoke", "elastic")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def path(name):
        return os.path.join(work, name)

    res = {"launches": {"seg_mean": 0, "seg_mean_heads": 0, "seg_scan": 0}}
    # the object-store server imports torch while the ranks below run
    cas = subprocess.Popen(
        [sys.executable, "-m", "specpride_tpu_torch", "cas-server",
         "--url-file", path("cas.url")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        # (a) elastic-20k
        big = path("files20k.mgf")
        mgf.write_mgf([s for c in clusters for s in c.members], big)
        out, qc, journal = path("e20k.mgf"), path("e20k.qc.json"), \
            path("e20k.jsonl")
        ranks = launch_group(*(
            ["consensus", big, out, "--method", "bin-mean", "--qc-report", qc,
             "--checkpoint-every", "512", "--elastic", path("coord20k"),
             "--process-id", str(i), "--journal", journal]
            for i in range(2)))
        launches = {"seg_mean": 0, "seg_mean_heads": 0, "seg_scan": 0}
        add_launches(launches, *(r["summary"] for r in ranks))
        if launches != {"seg_mean": 40, "seg_mean_heads": 0,
                        "seg_scan": 200}:
            raise AssertionError(f"elastic-20k: the ranks launched "
                                 f"{launches}")
        t0 = time.perf_counter()
        merge = run_main("merge-parts", out, "--elastic", path("coord20k"),
                         "--qc-report", qc)
        merge_s = time.perf_counter() - t0
        if merge["rc"] != 0:
            raise AssertionError(f"elastic-20k merge: {merge['stderr']}")
        if file_bytes(out, qc) != [exec_bytes["mgf"], exec_bytes["qc.json"]]:
            raise AssertionError("elastic-20k: the merged output or QC "
                                 "report differs from the single run's")
        ends = [e for e in rank_events(journal, (0, 1), "elastic-20k")
                if e["event"] == "run_end"]
        add_launches(res["launches"], *(r["summary"] for r in ranks))
        res["elastic-20k"] = {
            "single_wall_s": single["wall_s"],
            "single_maxrss_kib": single["maxrss_kib"],
            "ranks": [{"wall_s": r["wall_s"], "maxrss_kib": r["maxrss_kib"],
                       "phases_s": r["summary"]["phases_s"],
                       "launches": r["summary"]["backend"]["launches"],
                       "elastic": end["elastic"]}
                      for r, end in zip(ranks, sorted(
                          ends, key=lambda e: e["elastic"]["rank"]))],
            "merge_s": merge_s,
        }
        os.remove(big)
        runs = [r["elastic"]["ranges_run"]
                for r in res["elastic-20k"]["ranks"]]
        print(f"compare elastic-20k: two ranks + merge-parts --elastic = "
              f"exec-20k's output and QC report bytes, launches "
              f"{launches}; walls {[r['wall_s'] for r in ranks]} s against "
              f"the single run's {single['wall_s']} s, peak RSS "
              f"{[r['maxrss_kib'] for r in ranks]} KiB (single "
              f"{single['maxrss_kib']}), ranges {runs}, run_end.elastic "
              f"{[e['elastic'] for e in ends]}", flush=True)

        # the CLI-2k reference: one process, a checkpoint at these chunks
        ref = run_main("consensus", src, path("single.mgf"), "--qc-report",
                       path("single.qc.json"), "--checkpoint",
                       path("single.ck"), "--checkpoint-every",
                       str(ELASTIC_EVERY))
        if ref["rc"] != 0:
            raise AssertionError(f"elastic single: {ref['stderr']}")
        golden = file_bytes(path("single.mgf"), path("single.qc.json"))
        ref_launches = ref["summary"]["backend"]["launches"]
        add_launches(res["launches"], ref["summary"])

        def rank_argv(rank, name, coord, *extra):
            return ["consensus", src, path(f"{name}.mgf"), "--qc-report",
                    path(f"{name}.qc.json"), "--checkpoint-every",
                    str(ELASTIC_EVERY), "--elastic", coord, "--process-id",
                    str(rank), "--journal", path(f"{name}.jsonl"), *extra]

        def merged(name, coord, what):
            got = run_main("merge-parts", path(f"{name}.mgf"), "--elastic",
                           coord, "--qc-report", path(f"{name}.qc.json"))
            if got["rc"] != 0:
                raise AssertionError(f"{what} merge: {got['stderr']}")
            if file_bytes(path(f"{name}.mgf"),
                          path(f"{name}.qc.json")) != golden:
                raise AssertionError(f"{what}: the merged bytes differ from "
                                     "the single-process run's")

        def child(argv, env=None):
            err = tempfile.TemporaryFile("w+")
            proc = subprocess.Popen(
                [sys.executable, "-m", "specpride_tpu_torch", *argv],
                cwd=ROOT, env=dict(env or os.environ, PYTHONPATH=ROOT),
                stdout=subprocess.DEVNULL, stderr=err, text=True)
            proc.err = err
            return proc

        def finish(procs, what, rcs=(0,)):
            out = []
            for proc in procs:
                rc = proc.wait(timeout=600)
                proc.err.seek(0)
                text = proc.err.read()
                proc.err.close()
                if rc not in rcs:
                    raise AssertionError(f"{what}: a rank exited {rc}:\n"
                                         f"{text[-3000:]}")
                lines = text.strip().splitlines()
                out.append(json.loads(lines[-1]) if rc == 0 else None)
            return out

        # (b) steal
        t0 = time.perf_counter()
        coord = path("coord_steal")
        steal_flags = ("--elastic-range", "2048", "--elastic-ttl", "5")
        donor = child(rank_argv(0, "steal", coord, *steal_flags),
                      env=dict(os.environ, SPECPRIDE_FAULTS=(
                          "dispatch:rank_slow:1:0:9999"),
                          SPECPRIDE_SLOW_S=ELASTIC_SLOW_S))
        procs = [donor]
        try:
            deadline = time.perf_counter() + 300
            while True:
                try:
                    with open(path("steal.jsonl.part00000")) as fh:
                        if '"lease_claim"' in fh.read():
                            break
                except OSError:
                    pass
                if donor.poll() is not None or time.perf_counter() > deadline:
                    raise AssertionError("steal: the donor never claimed")
                time.sleep(0.05)
            claimed_s = time.perf_counter() - t0
            procs.append(child(rank_argv(1, "steal", coord, *steal_flags)))
            summaries = finish(procs, "steal")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        steal_wall = time.perf_counter() - t0
        merged("steal", coord, "steal")
        events = rank_events(path("steal.jsonl"), (0, 1), "steal")
        splits = [e for e in events if e["event"] == "lease_split"]
        moved = [e for e in events if e["event"] == "chunk_reassign"
                 and e.get("via") == "lease_split"]
        if not splits or sorted(e["new_range"] for e in splits) != sorted(
                e["range"] for e in moved) or audit_elastic(events):
            raise AssertionError(f"steal: splits {splits}, reassignments "
                                 f"{moved}, audit {audit_elastic(events)}")
        add_launches(res["launches"], *summaries)
        res["steal"] = {"wall_s": steal_wall, "donor_claimed_s": claimed_s,
                        "splits": [{k: e[k] for k in ("range", "new_range",
                                                      "split_at",
                                                      "n_clusters_split")}
                                   for e in splits],
                        "elastic": [s["elastic"] for s in summaries]}
        print(f"compare elastic steal (CLI-2k): {len(splits)} lease_split "
              f"paired with chunk_reassign via=lease_split, audit clean, "
              f"merged bytes = the single run's; splits "
              f"{res['steal']['splits']}, wall {steal_wall:.3f} s",
              flush=True)

        # (c) kill, then a survivor in process
        t0 = time.perf_counter()
        coord = path("coord_kill")
        kill_flags = ("--elastic-range", str(2 * ELASTIC_EVERY),
                      "--elastic-ttl", "2")
        (victim,) = [child(rank_argv(1, "kill", coord, *kill_flags),
                           env=dict(os.environ, SPECPRIDE_FAULTS=(
                               f"write:rank_kill:1:{ELASTIC_KILL_AT}")))]
        finish([victim], "kill victim", rcs=(-9, 137))
        victim_s = time.perf_counter() - t0
        done = sorted(os.listdir(os.path.join(coord, "done")))
        if done != [f"range_{k:05d}.json" for k in range(1, 8)]:
            raise AssertionError(f"kill: the victim committed {done}")
        survivor = run_main(*rank_argv(0, "kill", coord, *kill_flags))
        if survivor["rc"] != 0:
            raise AssertionError(f"kill survivor: {survivor['stderr']}")
        merged("kill", coord, "kill")
        victim_ev = rank_events(path("kill.jsonl"), (1,), "kill victim")
        survivor_ev = rank_events(path("kill.jsonl"), (0,), "kill survivor")
        resumes = [e["n_done"] for e in survivor_ev if e["event"] == "resume"]
        pair = [e["event"] for e in survivor_ev
                if e["event"] in ("lease_expire", "chunk_reassign")]
        merged_ev = victim_ev + survivor_ev
        if (resumes != [ELASTIC_EVERY]
                or pair != ["lease_expire", "chunk_reassign"]
                or audit_elastic(merged_ev)
                or audit_fault_recovery(merged_ev)):
            raise AssertionError(f"kill: resumes {resumes}, events {pair}, "
                                 f"audits {audit_elastic(merged_ev)} "
                                 f"{audit_fault_recovery(merged_ev)}")
        add_launches(res["launches"], survivor["summary"])
        res["kill"] = {"victim_wall_s": victim_s,
                       "survivor_wall_s": survivor["wall_s"],
                       "resume_n_done": resumes[0],
                       "elastic": survivor["summary"]["elastic"]}
        print(f"compare elastic kill (CLI-2k): the survivor resumed "
              f"{resumes[0]} clusters of range 0, lease_expire + "
              f"chunk_reassign, audits clean, merged bytes = the single "
              f"run's; victim {victim_s:.3f} s, survivor "
              f"{survivor['wall_s']:.3f} s", flush=True)

        # (c') a custom range off the chunk grid, in process: chunks of
        # 128 and 72 where the single run has 128s; the f32 sums round by
        # the new tiles, held at the tolerances with the changed peaks
        t0 = time.perf_counter()
        coord = path("coord_offgrid")
        offgrid = run_main(*rank_argv(0, "offgrid", coord, "--elastic-range",
                                      str(ELASTIC_OFFGRID)))
        if offgrid["rc"] != 0:
            raise AssertionError(f"off-grid: {offgrid['stderr'][-2000:]}")
        got = run_main("merge-parts", path("offgrid.mgf"), "--elastic",
                       coord, "--qc-report", path("offgrid.qc.json"))
        if got["rc"] != 0:
            raise AssertionError(f"off-grid merge: {got['stderr']}")
        add_launches(res["launches"], offgrid["summary"])
        res["off_grid"] = off_grid_compare(
            path("offgrid.mgf"), path("single.mgf"), path("offgrid.qc.json"),
            path("single.qc.json"))
        res["off_grid"]["wall_s"] = time.perf_counter() - t0
        print(f"compare elastic off-grid range (CLI-2k, --elastic-range "
              f"{ELASTIC_OFFGRID}, --checkpoint-every {ELASTIC_EVERY}): "
              f"{json.dumps(res['off_grid'])}", flush=True)

        # (d) the object store and the shared tier, cold then warm
        url = cas.stdout.readline().strip()
        if not url.startswith("http://"):
            raise AssertionError(f"cas-server printed {url!r}")
        t0 = time.perf_counter()
        cold = launch_group(*(rank_argv(
            i, "cold", url, "--elastic-local", path("local_cold"),
            "--result-cache", path("tier_a"), "--result-store", url)
            for i in range(2)))
        cold_wall = time.perf_counter() - t0
        merged("cold", url, "object store cold")
        cold_launches = {"seg_mean": 0, "seg_mean_heads": 0, "seg_scan": 0}
        add_launches(cold_launches, *(r["summary"] for r in cold))
        if cold_launches != ref_launches:
            raise AssertionError(f"object store cold: launches "
                                 f"{cold_launches}, single {ref_launches}")
        add_launches(res["launches"], *(r["summary"] for r in cold))
        # a new run on the same store: its run records go, the cache stays
        store = HttpCasStore(url)
        for key in store.list_keys(""):
            if not key.startswith("rc-"):
                store.delete(key)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        warm_flags = ("--elastic-local", path("local_warm"),
                      "--result-cache", path("tier_b"), "--result-store", url)
        procs = [child(rank_argv(0, "warm", url, *warm_flags,
                                 "--metrics-port", str(port)),
                       env=dict(os.environ,
                                SPECPRIDE_FAULTS="cas:rank_slow:1:0:1",
                                SPECPRIDE_SLOW_S="3")),
                 child(rank_argv(1, "warm", url, *warm_flags))]
        try:
            deadline = time.perf_counter() + 120
            while True:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/metrics",
                            timeout=5) as resp:
                        text = resp.read().decode()
                    break
                except OSError:
                    if (procs[0].poll() is not None
                            or time.perf_counter() > deadline):
                        raise AssertionError("warm: rank 0's /metrics never "
                                             "answered")
                    time.sleep(0.05)
            scraped_s = time.perf_counter() - t0
            summaries = finish(procs, "object store warm")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        warm_wall = time.perf_counter() - t0
        problems = validate_exposition(text)
        if problems or "specpride_rank_heartbeat_age_seconds" not in text:
            raise AssertionError(f"warm /metrics: {problems[:3]}")
        merged("warm", url, "object store warm")
        warm_launches = {"seg_mean": 0, "seg_mean_heads": 0, "seg_scan": 0}
        add_launches(warm_launches, *summaries)
        rc_events = [e for e in rank_events(path("warm.jsonl"), (0, 1),
                                            "warm")
                     if e["event"] == "result_cache"]
        shared_hits = sum(e["shared_hits"] for e in rc_events)
        if any(warm_launches.values()) or shared_hits != len(
                golden_ids(path("single.qc.json"))):
            raise AssertionError(f"warm: launches {warm_launches}, shared "
                                 f"hits {shared_hits}")
        res["object_store"] = {
            "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
            "warm_scraped_s": scraped_s, "shared_hits": shared_hits,
            "cold": [r["summary"]["elastic"] for r in cold],
            "warm": [s["elastic"] for s in summaries],
            "cold_maxrss_kib": [r["maxrss_kib"] for r in cold]}
        print(f"compare elastic object store (CLI-2k, cas-server): cold "
              f"launches = the single run's {ref_launches}, warm 0 launches "
              f"and {shared_hits} shared hits, both merges = the single "
              f"run's bytes; rank 0's /metrics valid with "
              f"specpride_rank_heartbeat_age_seconds {scraped_s:.3f} s into "
              f"the warm run; walls cold {cold_wall:.3f} s, warm "
              f"{warm_wall:.3f} s", flush=True)

        # (e) fleet
        t0 = time.perf_counter()
        fleet = subprocess.run(
            [sys.executable, "-m", "specpride_tpu_torch", "fleet", "--ranks",
             "2", "--timeout", "300", "--journal", path("fleet.jsonl"), "--",
             "consensus", src, path("fleet.mgf"), "--qc-report",
             path("fleet.qc.json"), "--checkpoint-every", str(ELASTIC_EVERY),
             "--elastic", path("coord_fleet"), "--elastic-ttl", "3"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=600)
        fleet_wall = time.perf_counter() - t0
        if fleet.returncode != 0:
            raise AssertionError(f"fleet exited {fleet.returncode}:\n"
                                 f"{fleet.stderr[-3000:]}")
        merged("fleet", path("coord_fleet"), "fleet")
        spawns = [e["reason"] for e in job_journal(path("fleet.jsonl"),
                                                   "fleet")
                  if e["event"] == "rank_spawn"]
        if spawns != ["boot", "boot"]:
            raise AssertionError(f"fleet: rank_spawn {spawns}")
        res["fleet"] = {"wall_s": fleet_wall,
                        "summary": json.loads(
                            fleet.stderr.strip().splitlines()[-1])}
        print(f"compare elastic fleet (CLI-2k): exit 0, two rank_spawn "
              f"(boot), merged bytes = the single run's; wall "
              f"{fleet_wall:.3f} s", flush=True)
    finally:
        cas.terminate()
        try:
            cas.wait(timeout=30)
        except subprocess.TimeoutExpired:
            cas.kill()
            cas.wait()
    print(f"elastic {json.dumps(res)}", flush=True)
    return res


def golden_ids(qc_path: str) -> list:
    with open(qc_path) as fh:
        return [r["cluster_id"] for r in json.load(fh)["clusters"]]


# the hand-written kernels' instantiations of seg_onepass (the name
# device_split matches) as the profiler's trace names them: the Load of
# seg_mean on int32 keys, the Store of seg_scan
TRACE_KERNELS = {"seg_mean": "MeanLoad", "seg_scan": "ScanStore"}
METRIC_FAMILIES = (
    "specpride_compiles_total", "specpride_dispatches_total",
    "specpride_rows_real_total", "specpride_rows_padded_total",
    "specpride_bytes_h2d_total", "specpride_bytes_d2h_total",
    "specpride_device_peak_bytes_in_use", "specpride_phase_seconds_total",
    "specpride_run_clusters_total", "specpride_padding_waste_frac",
    "specpride_bucket_occupancy_frac", "specpride_run_elapsed_seconds",
)


def read_textfile(path: str) -> dict:
    """A Prometheus textfile: family -> {sample line name and labels:
    value}."""
    out: dict = {}
    family = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("# TYPE"):
                family = line.split()[2]
                out[family] = {}
            elif line.strip() and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                out[family][key] = float(value)
    return out


def trace_kernels(path: str) -> dict:
    """The CUDA kernels of a ``torch.profiler`` Chrome trace: each of
    ``TRACE_KERNELS``' count, and the names ``device_split`` reads."""
    import re

    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    counts = {k: sum("seg_onepass" in n and tag in n for n in names)
              for k, tag in TRACE_KERNELS.items()}
    short = sorted({m.group(1) for n in names
                    for m in [re.search(r"(seg_\w+)", n)] if m})
    return {"kernel_events": len(names), "counts": counts, "names": short}


def telemetry_phase(kernels, src: str) -> dict:
    """CLI-2k through the CLI in process on the card, the launch counts
    zeroed just before each run: ``consensus --qc-report --journal
    --metrics-out --trace-dir`` (the journal, textfile and trace read back
    and held to the launches, ``stats`` over the journal, the output
    against a CPU run); ``consensus --method gap-average --qc-report``
    against ``--device cpu`` (m/z identical, singletons their member, one
    ``seg_mean_heads`` launch per journaled dispatch); ``evaluate --layout
    bucketized`` against ``--device cpu``; ``plot``."""
    import shutil

    from specpride_tpu_torch import cli
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.data.peaks import group_into_clusters
    from specpride_tpu_torch.io.mgf import read_mgf
    from specpride_tpu_torch.observability.journal import read_events
    from specpride_tpu_torch.observability.stats import trace_path

    work = os.path.join(ROOT, "build", "chip_smoke", "telemetry")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def path(name: str) -> str:
        return os.path.join(work, name)

    def run(*argv, what: str) -> tuple[float, dict]:
        zero_launches(kernels)
        t0 = time.perf_counter()
        if cli.main(list(argv)) != 0:
            raise AssertionError(f"telemetry {what}: CLI {argv} failed")
        return time.perf_counter() - t0, dict(kernels.launches)

    def journal(jpath: str, what: str) -> list:
        events, bad = read_events(jpath)
        if bad or events[0]["event"] != "run_start" \
                or events[-1]["event"] != "run_end":
            raise AssertionError(f"telemetry {what}: journal {bad[:3]}")
        return events

    def count(events, name: str, kernel: str | None = None) -> int:
        return sum(e["event"] == name and kernel in (None, e.get("kernel"))
                   for e in events)

    def qc_of(qc: str) -> list:
        with open(qc) as fh:
            return [r["avg_cosine"] for r in json.load(fh)["clusters"]]

    parsed = group_into_clusters(read_mgf(src))
    cpu = TorchBackend(device="cpu")
    res = {"clusters": len(parsed)}

    # 1. the run journal, the metrics textfile and the device trace; the
    # profiler has lost device events in a full smoke (device_split), so a
    # trace without both kernels is taken again, up to PROFILE_TRIES runs
    jpath, mpath, tdir = path("run.jsonl"), path("run.prom"), path("trace")
    for tries in range(1, PROFILE_TRIES + 1):
        for stale in (jpath, mpath):
            if os.path.exists(stale):
                os.remove(stale)
        shutil.rmtree(tdir, ignore_errors=True)
        wall, launches = run("consensus", src, path("out.mgf"),
                             "--qc-report", path("qc.json"), "--journal",
                             jpath, "--metrics-out", mpath, "--trace-dir",
                             tdir, what="journal")
        trace = trace_kernels(trace_path(tdir))
        if all(trace["counts"].values()):
            break
        print(f"telemetry trace try {tries}: kernels {trace}", flush=True)
    events = journal(jpath, "journal")
    chunks = count(events, "chunk_done")
    dispatch = {k: count(events, "dispatch", k)
                for k in ("bin_mean_flat_intensity", "cosine_flat")}
    want = {"seg_mean": dispatch["bin_mean_flat_intensity"],
            "seg_mean_heads": 0, "seg_scan": 5 * dispatch["cosine_flat"]}
    if chunks < 2 or launches != want or want["seg_mean"] != chunks:
        raise AssertionError(f"telemetry journal: launches {launches}, "
                             f"{chunks} chunks, dispatches {dispatch}")
    reps = read_mgf(path("out.mgf"))
    ref_reps, ref_cos = cpu.run_bin_mean_with_cosines(parsed)
    check_same(reps, ref_reps, "telemetry journal run")
    check_cosines(qc_of(path("qc.json")), ref_cos, "telemetry journal run")
    metrics = read_textfile(mpath)
    missing = [f for f in METRIC_FAMILIES if f not in metrics]
    peak = max(metrics.get("specpride_device_peak_bytes_in_use",
                           {}).values(), default=0.0)
    if missing or peak <= 0:
        raise AssertionError(f"telemetry metrics: missing {missing}, device "
                             f"peak {peak}")
    if not all(trace["counts"].values()) or trace["names"] != ["seg_onepass"]:
        raise AssertionError(f"telemetry trace: kernels {trace}")
    print(f"compare telemetry journal: {len(events)} events, 0 violations, "
          f"{chunks} chunk_done, dispatches {dispatch} = launches "
          f"{launches}", flush=True)
    t0 = time.perf_counter()
    if cli.main(["stats", jpath]) != 0:
        raise AssertionError("telemetry: stats over the journal failed")
    res["journal"] = {
        "wall_s": wall, "events": len(events), "chunk_done": chunks,
        "dispatch": dispatch, "launches": launches,
        "compile_events": count(events, "compile"),
        "device": events[-1]["device"], "metric_families": len(metrics),
        "device_peak_bytes": peak, "trace": trace, "trace_tries": tries,
        "trace_bytes": os.path.getsize(trace_path(tdir)),
        "stats_s": time.perf_counter() - t0,
    }

    # 2. the gap average: the host's float64 group m/z on the card
    gpath = path("gap.jsonl")
    wall, launches = run("consensus", src, path("gap.mgf"), "--method",
                         "gap-average", "--qc-report", path("gap.qc.json"),
                         "--journal", gpath, what="gap-average")
    events = journal(gpath, "gap-average")
    gap_dispatch = count(events, "dispatch", "gap_average_compact")
    cos = count(events, "dispatch", "cosine_flat")
    if (gap_dispatch < 2 or launches["seg_mean_heads"] != gap_dispatch
            or launches["seg_scan"] != 5 * cos or launches["seg_mean"]):
        raise AssertionError(f"telemetry gap-average: launches {launches}, "
                             f"dispatches {gap_dispatch} / {cos}")
    if cli.main(["consensus", src, path("gap.cpu.mgf"), "--method",
                 "gap-average", "--qc-report", path("gap.cpu.qc.json"),
                 "--device", "cpu"]) != 0:
        raise AssertionError("telemetry gap-average on the CPU failed")
    got = read_mgf(path("gap.mgf"))
    check_gap_same(got, read_mgf(path("gap.cpu.mgf")),
                   "telemetry gap-average")
    singles = check_singletons(got, parsed, "telemetry gap-average")
    cos_err = check_cosines(qc_of(path("gap.qc.json")),
                            qc_of(path("gap.cpu.qc.json")),
                            "telemetry gap-average")
    res["gap"] = {"wall_s": wall, "launches": launches,
                  "dispatches": gap_dispatch, "singletons": singles,
                  **cos_err}
    print(f"compare telemetry gap-average vs cpu: m/z identical, "
          f"{singles} singletons their member, {gap_dispatch} "
          "seg_mean_heads launches = dispatches", flush=True)

    # 3. evaluate on the bucketized layout
    wall, launches = run("evaluate", path("out.mgf"), src, "--layout",
                         "bucketized", "--report", path("ev.json"),
                         what="evaluate")
    if cli.main(["evaluate", path("out.mgf"), src, "--layout", "bucketized",
                 "--report", path("ev.cpu.json"), "--device", "cpu"]) != 0:
        raise AssertionError("telemetry evaluate on the CPU failed")
    with open(path("ev.json")) as fh, open(path("ev.cpu.json")) as gh:
        ev, ev_cpu = json.load(fh)["clusters"], json.load(gh)["clusters"]
    ev_err = check_cosines([r["avg_cosine"] for r in ev],
                           [r["avg_cosine"] for r in ev_cpu],
                           "telemetry evaluate --layout bucketized")
    if (launches["seg_scan"] < 4 or launches["seg_scan"] % 4
            or launches["seg_mean"] or launches["seg_mean_heads"]):
        raise AssertionError(f"telemetry evaluate: launches {launches}")
    res["evaluate"] = {"wall_s": wall, "launches": launches, **ev_err}

    # 4. plot: host work; skipped only where matplotlib is missing
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"plot: matplotlib does not import on this host ({e}); the "
              "plot check is skipped", flush=True)
        res["plot"] = None
    else:
        cid = parsed[0].cluster_id
        t0 = time.perf_counter()
        if cli.main(["plot", src, cid, path("mirror"), "--consensus",
                     path("out.mgf")]) != 0:
            raise AssertionError("telemetry plot failed")
        pngs = [path(f"mirror_{i}.png")
                for i in range(parsed[0].n_members)]
        if not all(os.path.getsize(p) > 1000 for p in pngs):
            raise AssertionError(f"telemetry plot: {pngs}")
        res["plot"] = {"wall_s": time.perf_counter() - t0,
                       "files": len(pngs)}
    print(f"telemetry {json.dumps(res)}", flush=True)
    return res


def cli_ok(what: str, *argv) -> dict:
    """``run_main(ARGV)``, which must exit 0: its result."""
    res = run_main(*argv)
    if res["rc"] != 0:
        raise AssertionError(f"{what}: CLI {argv} exited {res['rc']}:\n"
                             f"{res['stderr'][-2000:]}")
    return res


def file_bytes(*paths) -> list:
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(fh.read())
    return out


def span_events(events) -> list:
    return [e for e in events if e["event"] == "span"]


def check_trace_journal(events, launches: dict, what: str) -> dict:
    """A traced run's journal: one 32-hex trace id on every event, a
    ``kernel:*`` span per ``dispatch`` event (the main path's two: as
    many ``seg_mean`` launches as bin-mean spans, five ``seg_scan`` per
    cosine span), and top-level spans covering at least 95 % of the
    phase seconds.  Returns the counts."""
    import re

    ids = {e.get("trace_id") for e in events}
    if len(ids) != 1 or not re.fullmatch(r"[0-9a-f]{32}", str(min(ids))):
        raise AssertionError(f"{what}: trace ids {sorted(map(str, ids))[:3]}")
    spans = span_events(events)
    n = {}
    for kernel in ("bin_mean_flat_intensity", "cosine_flat"):
        n[kernel] = (sum(e["name"] == f"kernel:{kernel}" for e in spans),
                     sum(e["event"] == "dispatch" and e["kernel"] == kernel
                         for e in events))
    want = {"seg_mean": n["bin_mean_flat_intensity"][0], "seg_mean_heads": 0,
            "seg_scan": 5 * n["cosine_flat"][0]}
    if (any(a != b or a < 2 for a, b in n.values())
            or launches != want):
        raise AssertionError(f"{what}: kernel spans / dispatches {n}, "
                             f"launches {launches}")
    end = events[-1]
    phases = sum(end["phases_s"].values())
    top = sum(e["dur_s"] for e in spans if e["depth"] == 0)
    if top < 0.95 * phases:
        raise AssertionError(f"{what}: top-level spans {top} s cover under "
                             f"95 % of the phases' {phases} s")
    return {"spans": len(spans), "kernel_spans": {k: v[0] for k, v in
                                                  n.items()},
            "span_names": len({e["name"] for e in spans}),
            "top_level_s": top, "phase_s": phases,
            "coverage": top / phases if phases else None,
            "trace_id": min(ids)}


def tracing_phase(kernels, src: str, clusters) -> dict:
    """tracing: CLI-2k through ``cli.main`` in process, launch counts
    zeroed before each run: ``consensus --qc-report`` without and with
    ``--journal --chrome-trace`` (the same bytes; the journal read back
    with no violation and held to ``check_trace_journal``); ``trace J -o
    T`` and the ``--chrome-trace`` file load as JSON with every span;
    ``stats J --top-spans 10`` and ``stats J --trace ID`` timed.  Then the
    tracer's cost on exec-20k (``executor_run`` at the defaults): untraced,
    traced, untraced, traced, each pair the same bytes."""
    import shutil

    from specpride_tpu_torch.observability.journal import read_events

    work = os.path.join(ROOT, "build", "chip_smoke", "tracing")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def path(name: str) -> str:
        return os.path.join(work, name)

    plain = cli_ok("tracing plain", "consensus", src, path("plain.mgf"),
                   "--qc-report", path("plain.qc.json"))
    jpath, cpath = path("run.jsonl"), path("run.trace.json")
    traced = cli_ok("tracing traced", "consensus", src, path("out.mgf"),
                    "--qc-report", path("qc.json"), "--journal", jpath,
                    "--chrome-trace", cpath)
    launches = traced["summary"]["backend"]["launches"]
    if launches != plain["summary"]["backend"]["launches"]:
        raise AssertionError(f"tracing: launches {launches} against "
                             f"{plain['summary']['backend']['launches']}")
    if (file_bytes(path("out.mgf"), path("qc.json"))
            != file_bytes(path("plain.mgf"), path("plain.qc.json"))):
        raise AssertionError("tracing: the traced run's bytes differ")
    events, bad = read_events(jpath)
    if bad or events[0]["event"] != "run_start" \
            or events[-1]["event"] != "run_end":
        raise AssertionError(f"tracing: journal {bad[:3]}")
    res = {"plain_wall_s": plain["wall_s"], "wall_s": traced["wall_s"],
           "launches": launches, "events": len(events),
           **check_trace_journal(events, launches, "tracing CLI-2k")}
    n_spans = res["spans"]
    t0 = time.perf_counter()
    cli_ok("tracing trace", "trace", jpath, "-o", path("trace.json"))
    res["trace_s"] = time.perf_counter() - t0
    for what, p in (("trace", path("trace.json")), ("chrome", cpath)):
        with open(p) as fh:
            got = sum(e["ph"] == "X" for e in json.load(fh)["traceEvents"])
        if got != n_spans:
            raise AssertionError(f"tracing {what}: {got} spans, the journal "
                                 f"{n_spans}")
        res[f"{what}_bytes"] = os.path.getsize(p)
    t0 = time.perf_counter()
    cli_ok("tracing stats", "stats", jpath, "--top-spans", "10")
    res["stats_top_spans_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli_ok("tracing stats --trace", "stats", jpath, "--trace",
           res["trace_id"])
    res["stats_trace_s"] = time.perf_counter() - t0
    print(f"compare tracing CLI-2k: {len(events)} events, 0 violations, one "
          f"trace id, kernel spans {res['kernel_spans']} = dispatches = "
          f"launches {launches}, top-level spans {res['coverage']:.4f} of "
          f"the phase seconds, {n_spans} spans in trace and chrome files, "
          f"bytes = untraced; stats --top-spans {res['stats_top_spans_s']} "
          f"s, stats --trace {res['stats_trace_s']} s", flush=True)

    # the tracer's cost on exec-20k, alternating, same bytes each
    cost = []
    ref = None
    for i, traced_run in enumerate((False, True, False, True)):
        flags = (("--journal", path(f"exec{i}.jsonl"), "--chrome-trace",
                  path(f"exec{i}.trace.json")) if traced_run else ())
        run, got = executor_run(kernels, clusters, f"trace{i}", "consensus",
                                flags)
        ref = ref or got
        if got != ref:
            raise AssertionError(f"tracing exec-20k run {i}: bytes differ")
        if traced_run:
            ev, bad = read_events(path(f"exec{i}.jsonl"))
            if bad:
                raise AssertionError(f"tracing exec-20k: journal {bad[:3]}")
            run.update(check_trace_journal(ev, run["launches"],
                                           "tracing exec-20k"))
            run["trace_bytes"] = os.path.getsize(path(f"exec{i}.trace.json"))
        run["traced"] = traced_run
        cost.append(run)
    res["exec"] = cost
    res["exec_bytes"] = ref
    # every run of the phase is a main-path run
    res["all_launches"] = {
        k: 2 * launches[k] + sum(r["launches"][k] for r in cost)
        for k in launches}
    print("tracing exec-20k walls (untraced, traced, untraced, traced; "
          "+ the run's finish, the Chrome trace written): "
          + ", ".join(f"{r['wall_s']} + {r['finish_s']}" for r in cost),
          flush=True)
    return res


CACHE_RUNS = (
    ("bin-mean", ("consensus", "--qc-report")),
    ("gap-average", ("consensus", "--method", "gap-average", "--qc-report")),
    ("medoid", ("select", "--method", "medoid", "--qc-report")),
)


def result_cache_phase(kernels, src: str, clusters) -> dict:
    """result-cache: on CLI-2k through ``cli.main`` in process, for
    bin-mean and gap-average consensus and medoid select, each with QC: a
    run without the cache, a cold run with ``--result-cache D`` (the same
    launches, output and QC report bytes) and a warm rerun (every cluster
    a hit, no launch and no ``dispatch`` event, the same bytes), and the
    cache's host costs on one thread (``cache_split``).  Then the
    chunked executor (``executor_run``) on slice-20k's first 2,000
    clusters (exec-2k) without the cache, cold and warm: the walls, the
    warm's hits and no launch, all three the same bytes.  ``launches``:
    every run's (the warm runs launch none)."""
    import shutil

    from specpride_tpu_torch.observability.journal import read_events

    work = os.path.join(ROOT, "build", "chip_smoke", "result_cache")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def path(name: str) -> str:
        return os.path.join(work, name)

    res: dict = {}
    launched = {k: 0 for k in kernels.launches}
    for method, (command, *flags) in CACHE_RUNS:
        tier = path(f"{method}.tier")
        runs = {}
        for mode in ("off", "cold", "warm"):
            extra = ([] if mode == "off" else
                     ["--result-cache", tier, "--journal",
                      path(f"{method}.{mode}.jsonl")])
            qc = path(f"{method}.{mode}.qc.json")
            r = cli_ok(f"result-cache {method} {mode}", command, src,
                       path(f"{method}.{mode}.mgf"), *flags, qc, *extra)
            runs[mode] = {"wall_s": r["wall_s"],
                          "launches": r["summary"]["backend"]["launches"],
                          "bytes": file_bytes(path(f"{method}.{mode}.mgf"),
                                              qc)}
        for mode in ("cold", "warm"):
            if runs[mode]["bytes"] != runs["off"]["bytes"]:
                raise AssertionError(f"result-cache {method} {mode}: bytes "
                                     "differ from the run without it")
            events, bad = read_events(path(f"{method}.{mode}.jsonl"))
            rc = [e for e in events if e["event"] == "result_cache"]
            if bad or len(rc) != 1:
                raise AssertionError(f"result-cache {method} {mode}: "
                                     f"journal {bad[:3]}, {len(rc)} events")
            runs[mode]["result_cache"] = rc[0]
            runs[mode]["dispatch"] = sum(e["event"] == "dispatch"
                                         for e in events)
        cold, warm, off = runs["cold"], runs["warm"], runs["off"]
        n = len(group_ids(src))
        if (cold["launches"] != off["launches"]
                or not any(off["launches"].values())
                or cold["result_cache"]["misses"] != n
                or cold["result_cache"]["populated"] != n):
            raise AssertionError(f"result-cache {method} cold: {cold}")
        if (any(warm["launches"].values()) or warm["dispatch"]
                or warm["result_cache"]["hits"] != n):
            raise AssertionError(f"result-cache {method} warm: "
                                 f"launches {warm['launches']}, "
                                 f"{warm['dispatch']} dispatches, "
                                 f"{warm['result_cache']}")
        for k in launched:
            launched[k] += off["launches"][k] + cold["launches"][k]
        for r in runs.values():
            r.pop("bytes")
        res[method] = runs
        print(f"compare result-cache {method}: cold = off (launches "
              f"{cold['launches']}), warm {n} hits, 0 launches, 0 dispatch "
              f"events, bytes = off; walls off {off['wall_s']} s, cold "
              f"{cold['wall_s']} s, warm {warm['wall_s']} s", flush=True)
    res["launches"] = launched
    res["split"] = cache_split(src, path("bin-mean.tier"), path("split.tier"))

    tier = path("exec.tier")
    head = clusters[:CLI_CLUSTERS]
    run, exec_bytes = executor_run(kernels, head, "cache_off", "consensus")
    res["exec_off"] = run
    for k in launched:
        launched[k] += run["launches"][k]
    for mode in ("cold", "warm"):
        run, got = executor_run(kernels, head, f"cache_{mode}",
                                "consensus", ("--result-cache", tier))
        if got != exec_bytes:
            raise AssertionError(f"result-cache exec-2k {mode}: bytes "
                                 "differ from the run without it")
        hits = run["counters"].get("result_cache_hits", 0)
        if mode == "warm" and (hits != len(head)
                               or any(run["launches"].values())):
            raise AssertionError(f"result-cache exec-2k warm: {hits} hits, "
                                 f"launches {run['launches']}")
        if mode == "cold":
            for k in launched:
                launched[k] += run["launches"][k]
        res[f"exec_{mode}"] = run
    res["exec_tier_bytes"] = sum(
        os.path.getsize(os.path.join(tier, f)) for f in os.listdir(tier))
    print(f"result-cache exec-2k: off {res['exec_off']['wall_s']} s, cold "
          f"{res['exec_cold']['wall_s']} s, warm "
          f"{res['exec_warm']['wall_s']} s ({len(head)} hits), bytes = the "
          f"run without the cache; tier {res['exec_tier_bytes']} bytes",
          flush=True)
    return res


def cache_split(src: str, tier_dir: str, scratch_dir: str) -> dict:
    """The result cache's host costs on one thread, CLI-2k's clusters and
    the bin-mean run's tier: each cluster's content digest, each entry
    read back as a hit (``LocalTier.get``: the read, the seal check and
    the LRU touch), each written again into an empty tier
    (``LocalTier.put``), and one scan of that tier (``info``)."""
    from specpride_tpu_torch.cache.digest import cluster_digest
    from specpride_tpu_torch.cache.result_cache import LocalTier
    from specpride_tpu_torch.data.peaks import group_into_clusters
    from specpride_tpu_torch.io.mgf import read_mgf

    parsed = group_into_clusters(read_mgf(src))
    t0 = time.perf_counter()
    for c in parsed:
        cluster_digest(c)
    digest_s = time.perf_counter() - t0
    tier, scratch = LocalTier(tier_dir), LocalTier(scratch_dir)
    keys = [n[:-len(".json")] for n in os.listdir(tier_dir)
            if n.endswith(".json")]
    t0 = time.perf_counter()
    docs = [tier.get(k) for k in keys]
    get_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k, doc in zip(keys, docs):
        scratch.put(k, doc)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scratch.info()
    res = {"clusters": len(parsed), "entries": len(keys),
           "digest_ms": digest_s / len(parsed) * 1e3,
           "get_ms": get_s / len(keys) * 1e3,
           "put_ms": put_s / len(keys) * 1e3,
           "scan_s": time.perf_counter() - t0}
    print(f"result-cache split (one thread) {json.dumps(res)}", flush=True)
    return res


def group_ids(src: str) -> list:
    from specpride_tpu_torch.data.peaks import group_into_clusters
    from specpride_tpu_torch.io.mgf import read_mgf

    return [c.cluster_id for c in group_into_clusters(read_mgf(src))]


# The process-start split: a child interpreter marks each step with
# time.perf_counter (CLOCK_MONOTONIC, one clock for the whole host, so
# the parent's spawn time is on the same axis).  Measurement only.
PROC_START = r"""
import time
t_start = time.perf_counter()
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
t_torch = time.perf_counter()
import specpride_tpu_torch.cli
t_cli = time.perf_counter()
torch.cuda.init()
torch.empty(1, device="cuda")
torch.cuda.synchronize()
t_cuda = time.perf_counter()
from specpride_tpu_torch.ops import _build
_build.load()
t_lib = time.perf_counter()
_build.load_host()
t_host = time.perf_counter()
print(json.dumps({"t_start": t_start, "t_torch": t_torch, "t_cli": t_cli,
                  "t_cuda": t_cuda, "t_lib": t_lib, "t_host": t_host}))
"""
PROC_START_ROUNDS = 1


def process_start_phase(src: str) -> dict:
    """process start: ``PROC_START`` in a child interpreter: the
    interpreter's own start (the parent's spawn to the child's first
    mark), ``import torch``, ``import specpride_tpu_torch.cli``, CUDA
    init (``torch.cuda.init()`` and a first allocation), the kernel
    library's source-hash check and ``ctypes`` load (``_build.load``), the
    host library's (``_build.load_host``), and the exit; beside them the
    wall of a 3-cluster ``consensus --qc-report`` CLI run."""
    from specpride_tpu_torch.io.mgf import read_mgf, write_mgf

    work = os.path.join(ROOT, "build", "chip_smoke", "process_start")
    os.makedirs(work, exist_ok=True)
    rounds = []
    for _ in range(PROC_START_ROUNDS):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", PROC_START, ROOT],
                              capture_output=True, text=True, timeout=300)
        t_end = time.perf_counter()
        if proc.returncode != 0:
            raise AssertionError(f"process start: {proc.stderr[-2000:]}")
        m = json.loads(proc.stdout.strip().splitlines()[-1])
        rounds.append({
            "interpreter_s": m["t_start"] - t0,
            "import_torch_s": m["t_torch"] - m["t_start"],
            "import_cli_s": m["t_cli"] - m["t_torch"],
            "cuda_init_s": m["t_cuda"] - m["t_cli"],
            "kernel_lib_s": m["t_lib"] - m["t_cuda"],
            "host_lib_s": m["t_host"] - m["t_lib"],
            "exit_s": t_end - m["t_host"],
            "wall_s": t_end - t0,
        })
    small = os.path.join(work, "three.mgf")
    ids = set(group_ids(src)[:3])
    write_mgf([s for s in read_mgf(src) if s.cluster_id in ids], small)
    wall, summary = run_cli("consensus", small,
                            os.path.join(work, "three.out.mgf"),
                            "--qc-report", os.path.join(work, "three.qc"))
    res = {"rounds": rounds, "cli_3_clusters_wall_s": wall,
           "cli_3_clusters_elapsed_s": summary["elapsed_s"]}
    print(f"process start {json.dumps(res)}", flush=True)
    return res


# A child that runs ``python -m specpride_tpu_torch ARGV`` as the shell
# does, then prints its exit code and whether torch was imported.
TORCH_FREE = r"""
import runpy, sys
sys.argv = ["specpride_tpu_torch"] + sys.argv[1:]
rc = 0
try:
    runpy.run_module("specpride_tpu_torch", run_name="__main__")
except SystemExit as e:
    rc = e.code
print("CHILD", rc, "torch" in sys.modules, file=sys.stderr, flush=True)
"""
SERVE_CLI_RUNS = (
    ("bin-mean QC", ("consensus", "--qc-report")),
    ("gap-average", ("consensus", "--method", "gap-average")),
    ("medoid QC", ("select", "--method", "medoid", "--qc-report")),
)
SERVE_BATCH_WINDOW_MS = 50


def socket_path(work: str) -> str:
    """A unix socket path under the 108-byte limit: in ``work``, else in a
    fresh directory under the temporary root."""
    import tempfile

    path = os.path.join(work, "s.sock")
    if len(path) > 100:
        path = os.path.join(tempfile.mkdtemp(prefix="sp"), "s.sock")
    if len(path) > 100:
        raise AssertionError(f"serve: no socket path under 100 bytes "
                             f"({path})")
    return path


def run_child(*argv, timeout: float = 600) -> tuple[float, str]:
    """``TORCH_FREE`` with ARGV: its wall and stdout; fails unless it
    exited 0 without importing torch."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TORCH_FREE, *argv],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if "CHILD 0 False" not in proc.stderr:
        raise AssertionError(f"serve child {argv}: rc {proc.returncode}, "
                             f"{proc.stderr[-2000:]}\n{proc.stdout[-2000:]}")
    return wall, proc.stdout


def job_journal(path: str, what: str) -> list:
    from specpride_tpu_torch.observability.journal import read_events

    events, bad = read_events(path)
    if bad:
        raise AssertionError(f"{what}: journal violations {bad[:3]}")
    return events


def serve_daemon_phase(src: str, clusters, exec_bytes: dict, work: str
                       ) -> dict:
    """serve (a): a real daemon process (``serve --journal --metrics-port
    0 --metrics-out``).  CLI-2k's bin-mean with QC, gap-average and medoid
    with QC, each as a ``submit`` child (no torch in its modules) and as a
    one-shot CLI run on the same argv (a cold child for bin-mean, in this
    process for the others): the same output and QC report bytes, every
    job journal read back clean, the bin-mean job's 4 + 4 ``dispatch``
    events; ``profile --seconds 2`` during a further
    CLI-2k job: both kernels in the trace; then files-20k (20,000
    clusters, the MGF written anew) twice: exec-20k's bytes both times,
    the repeat an ingest-cache hit; SIGTERM: exit 0, the journal ending in
    ``serve_drain`` and ``run_end``, the drain textfile valid and counting
    every job."""
    import signal
    import threading

    from specpride_tpu_torch.io import mgf
    from specpride_tpu_torch.observability.exporter import (
        parse_exposition,
        validate_exposition,
    )
    from specpride_tpu_torch.serve import client as sc

    def path(name: str) -> str:
        return os.path.join(work, name)

    sock = socket_path(work)
    res: dict = {"socket": sock}
    t0 = time.perf_counter()
    # started by the launcher, which reports its peak resident set
    pid = start_launched(
        "serve", "--socket", sock, "--journal", path("serve.jsonl"),
        "--metrics-port", "0", "--metrics-out", path("serve.prom"))
    jobs = 0
    reaped = None
    try:
        if not sc.wait_for_socket(sock, timeout=180):
            raise AssertionError("serve: the daemon never answered a ping")
        res["spawn_to_ping_s"] = time.perf_counter() - t0
        (start,) = [e for e in job_journal(path("serve.jsonl"), "serve")
                    if e["event"] == "serve_start"]
        res["boot_s"] = start["boot_s"]
        res["placement"] = start["placement"]
        print(f"serve boot: ping {res['spawn_to_ping_s']:.3f} s after "
              f"spawn, serve_start.boot_s {res['boot_s']}, placement "
              f"{res['placement']}", flush=True)

        for what, (command, *flags) in SERVE_CLI_RUNS:
            tag = what.split()[0]

            def argv(who, command=command, flags=flags, tag=tag):
                out = [command, src, path(f"{who}_{tag}.mgf"), *flags]
                if "--qc-report" in out:
                    i = out.index("--qc-report")
                    out.insert(i + 1, path(f"{who}_{tag}.qc.json"))
                return out

            # the main path's reference is a cold one-shot CLI child (the
            # wall a served job saves); the others run in this process
            if tag == "bin-mean":
                cold, _ = run_cli(*argv("cold"))
            else:
                cold = cli_ok(f"serve {what} reference",
                              *argv("cold"))["wall_s"]
            wall, out = run_child(
                "submit", "--socket", sock, "--journal",
                path(f"client_{tag}.jsonl"), "--", *argv("served"),
                "--journal", path(f"job_{tag}.jsonl"))
            jobs += 1
            term = json.loads(out.strip().splitlines()[-1])
            if term.get("status") != "done":
                raise AssertionError(f"serve {what}: {term}")
            for ext in ("mgf", "qc.json") if "--qc-report" in flags \
                    else ("mgf",):
                if file_bytes(path(f"served_{tag}.{ext}")) != file_bytes(
                        path(f"cold_{tag}.{ext}")):
                    raise AssertionError(f"serve {what}: {ext} differs from "
                                         "the one-shot CLI's")
            events = job_journal(path(f"job_{tag}.jsonl"), f"serve {what}")
            job_journal(path(f"client_{tag}.jsonl"), f"serve {what} client")
            dispatch = {}
            for e in events:
                if e["event"] == "dispatch":
                    dispatch[e["kernel"]] = dispatch.get(e["kernel"], 0) + 1
            if tag == "bin-mean" and dispatch != {
                    "bin_mean_flat_intensity": 4, "cosine_flat": 4}:
                raise AssertionError(f"serve {what}: dispatch events "
                                     f"{dispatch}")
            ref = ("cold_cli_wall_s" if tag == "bin-mean"
                   else "in_process_wall_s")
            res[what] = {"submit_wall_s": wall, ref: cold,
                         "job_wall_s": term["wall_s"],
                         "dispatch_events": dispatch}
            print(f"serve {what}: submit child {wall:.3f} s (job "
                  f"{term['wall_s']} s) vs {ref} {cold:.3f} s, bytes "
                  f"identical, dispatch {dispatch}", flush=True)

        # profile --seconds 2 during a CLI-2k job: the capture first, the
        # job once its window is open (the daemon journals profile_start)
        prof = subprocess.Popen(
            [sys.executable, "-c", TORCH_FREE, "profile", "--socket", sock,
             "--seconds", "2", "--trace-dir", path("profile")], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        while not any(e["event"] == "profile_start" for e in
                      job_journal(path("serve.jsonl"), "serve")):
            if time.perf_counter() - t0 > 120:
                raise AssertionError("serve profile: no window opened")
            time.sleep(0.05)
        _, out = run_child("submit", "--socket", sock, "--", "consensus",
                           src, path("profiled.mgf"), "--qc-report",
                           path("profiled.qc.json"))
        jobs += 1
        prof_out, prof_err = prof.communicate(timeout=300)
        if "CHILD 0 False" not in prof_err:
            raise AssertionError(f"serve profile: {prof_err[-2000:]}")
        reply = json.loads(prof_out.strip().splitlines()[-1])
        kern = trace_kernels(reply["trace"])
        if not (kern["counts"]["seg_mean"] and kern["counts"]["seg_scan"]):
            raise AssertionError(f"serve profile: trace kernels {kern}")
        res["profile"] = {"wall_s": time.perf_counter() - t0,
                          "window_s": reply["seconds"],
                          "window_events": reply["window_events"],
                          "trace_kernels": kern}
        print(f"serve profile: {kern['counts']} kernels in a "
              f"{reply['seconds']} s window, journal window "
              f"{reply['window_events']}", flush=True)

        # files-20k at full size (the MGF written anew), twice
        big = path("files20k.mgf")
        mgf.write_mgf([s for c in clusters for s in c.members], big)
        res["files20k_bytes"] = os.path.getsize(big)
        for i in range(2):
            wall, out = run_child(
                "submit", "--socket", sock, "--", "consensus", big,
                path(f"big{i}.mgf"), "--method", "bin-mean", "--qc-report",
                path(f"big{i}.qc.json"), "--stream-clusters", "off",
                "--journal", path(f"big{i}.jsonl"))
            jobs += 1
            term = json.loads(out.strip().splitlines()[-1])
            for ext, key in (("mgf", "mgf"), ("qc.json", "qc.json")):
                if file_bytes(path(f"big{i}.{ext}"))[0] != exec_bytes[key]:
                    raise AssertionError(f"serve files-20k {i}: {ext} "
                                         "differs from exec-20k's")
            (end,) = [e for e in job_journal(path(f"big{i}.jsonl"),
                                             "serve files-20k")
                      if e["event"] == "run_end"]
            want = "ingest_cache_hits" if i else "ingest_cache_misses"
            if end["counters"].get(want) != 1:
                raise AssertionError(f"serve files-20k {i}: counters "
                                     f"{end['counters']}")
            res[f"files-20k {i}"] = {
                "submit_wall_s": wall, "job_wall_s": term["wall_s"],
                "phases_s": end["phases_s"], "counters": end["counters"]}
            print(f"serve files-20k {'repeat' if i else 'first'}: submit "
                  f"{wall:.3f} s, job {term['wall_s']} s, phases "
                  f"{end['phases_s']}", flush=True)
        os.remove(big)
        os.kill(pid, signal.SIGTERM)
        t0 = time.perf_counter()
        # a drain past 60 s is killed (and fails below)
        timer = threading.Timer(60.0, os.kill, (pid, signal.SIGKILL))
        timer.start()
        reaped = launched_result()
        timer.cancel()
        res["drain_s"] = time.perf_counter() - t0
    finally:
        if reaped is None:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            print(f"serve: the daemon's stderr:\n"
                  f"{launched_result()['stderr'][-3000:]}", flush=True)
    res["daemon_peak_rss_kib"] = reaped["maxrss_kib"]
    if reaped["rc"] != 0 or res["drain_s"] > 60:
        raise AssertionError(f"serve: the daemon exited {reaped['rc']} "
                             f"{res['drain_s']:.1f} s after SIGTERM:\n"
                             f"{reaped['stderr'][-2000:]}")
    events = job_journal(path("serve.jsonl"), "serve")
    if [e["event"] for e in events][-2:] != ["serve_drain", "run_end"]:
        raise AssertionError("serve: the journal does not end in "
                             "serve_drain, run_end")
    with open(path("serve.prom")) as fh:
        text = fh.read()
    problems = validate_exposition(text)
    samples, _ = parse_exposition(text)
    done = sum(v for (name, _), v in samples.items()
               if name == "specpride_serve_jobs_done_total")
    if problems or done != jobs:
        raise AssertionError(f"serve: exposition problems {problems[:3]}, "
                             f"{done} done jobs of {jobs}")
    res["jobs"] = jobs
    print(f"serve daemon {json.dumps(res)}", flush=True)
    return res


def serve_inprocess_phase(kernels, src: str, work: str) -> dict:
    """serve (b): ``ServeDaemon(...).run()`` in a thread of this process,
    so the launches can be read.  CLI-2k's two halves, bin-mean with QC:
    their solo one-shot runs; then on a two-lane daemon (two streams on
    the card) both jobs in flight at once, one on each lane; then on a
    daemon with ``--batch-window 50`` both jobs batched (one
    ``batch_dispatch`` event naming both).  The bytes are the solo runs'
    each time, and the launches of the two daemon steps no more than the
    solo runs' sum (the launch counts zeroed before each step)."""
    import threading

    import torch

    from specpride_tpu_torch import cli
    from specpride_tpu_torch.io import mgf
    from specpride_tpu_torch.serve import client as sc
    from specpride_tpu_torch.serve.daemon import ServeDaemon

    def path(name: str) -> str:
        return os.path.join(work, name)

    spectra = mgf.read_mgf(src)
    ids = group_ids(src)
    halves = []
    for k, keep in enumerate((set(ids[:len(ids) // 2]),
                              set(ids[len(ids) // 2:]))):
        halves.append(path(f"half{k}.mgf"))
        mgf.write_mgf([s for s in spectra if s.cluster_id in keep],
                      halves[-1])
    res: dict = {}
    zero_launches(kernels)
    t0 = time.perf_counter()
    for k, half in enumerate(halves):
        if cli.main(["consensus", half, path(f"solo{k}.mgf"), "--qc-report",
                     path(f"solo{k}.qc.json")]) != 0:
            raise AssertionError("serve: a solo run failed")
    torch.cuda.synchronize()
    res["solo"] = {"wall_s": time.perf_counter() - t0,
                   "launches": dict(kernels.launches)}

    def step(name: str, **kw) -> dict:
        d = ServeDaemon(socket_path(work), device=DEV,
                        journal_path=path(f"{name}.jsonl"), **kw)
        t = threading.Thread(target=d.run, daemon=True)
        t.start()
        terms: dict = {}
        try:
            if not sc.wait_for_socket(d.socket_path, timeout=120):
                raise AssertionError(f"serve {name}: no ping")

            def submit(k):
                terms[k] = sc.submit_wait(d.socket_path, [
                    "consensus", halves[k], path(f"{name}{k}.mgf"),
                    "--qc-report", path(f"{name}{k}.qc.json")],
                    client=f"client{k}", timeout=120)

            d._gate.clear()
            zero_launches(kernels)
            t0 = time.perf_counter()
            threads = [threading.Thread(target=submit, args=(k,))
                       for k in (0, 1)]
            for th in threads:
                th.start()
            deadline = time.time() + 60
            while (len(d._inflight_by) + len(d.queue) < 2
                   and time.time() < deadline):
                time.sleep(0.005)
            d._gate.set()
            for th in threads:
                th.join(timeout=300)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.launches)
        finally:
            d._gate.set()
            d.drain()
            t.join(timeout=120)
        for k in (0, 1):
            if terms.get(k, {}).get("status") != "done":
                raise AssertionError(f"serve {name}: {terms.get(k)}")
            for ext in ("mgf", "qc.json"):
                if file_bytes(path(f"{name}{k}.{ext}")) != file_bytes(
                        path(f"solo{k}.{ext}")):
                    raise AssertionError(f"serve {name}: half {k} {ext} "
                                         "differs from its solo run")
        for kernel in ("seg_mean", "seg_scan"):
            if not 0 < launches[kernel] <= res["solo"]["launches"][kernel]:
                raise AssertionError(f"serve {name}: launches {launches} "
                                     f"against solo {res['solo']}")
        return {"wall_s": wall, "launches": launches,
                "workers": sorted(terms[k]["worker"] for k in (0, 1)),
                "events": job_journal(path(f"{name}.jsonl"), name)}

    lanes = step("lanes", workers=2)
    if lanes["workers"] != [0, 1]:
        raise AssertionError(f"serve lanes: workers {lanes['workers']}")
    lanes.pop("events")
    res["two lanes"] = lanes
    batched = step("batched", workers=1,
                   batch_window=SERVE_BATCH_WINDOW_MS / 1000.0)
    events = batched.pop("events")
    batches = [e for e in events if e["event"] == "batch_dispatch"]
    if len(batches) != 1 or batches[0]["n_jobs"] != 2 or \
            batches[0]["status"] != "shared":
        raise AssertionError(f"serve batched: {batches}")
    res["batched"] = batched
    print(f"serve in process: solo {res['solo']}, two lanes "
          f"{res['two lanes']}, batched {res['batched']}", flush=True)
    return res


def serve_phase(kernels, src: str, clusters, exec_bytes: dict) -> dict:
    """serve: (a) a daemon process (``serve_daemon_phase``), (b) daemons in
    this process (``serve_inprocess_phase``)."""
    import shutil

    work = os.path.join(ROOT, "build", "chip_smoke", "serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    res = {"daemon": serve_daemon_phase(src, clusters, exec_bytes, work),
           "in_process": serve_inprocess_phase(kernels, src, work)}
    res["wall_s"] = time.perf_counter() - t0
    return res


FLIGHTREC_SLO = "bin-mean=0.001"  # 1 ms: every CLI-2k job breaks it
FLIGHTREC_FAULTS = ("--inject-faults", "dispatch:io:1:0:3", "--retries", "3",
                    "--retry-backoff", "0.01")  # one dispatch to attempt 3


def start_daemon(work: str, name: str, *flags) -> tuple:
    """``serve --journal --slo FLIGHTREC_SLO`` as a child of this script
    (the launcher reaps one child at a time; two daemons run here at
    once): the process, its socket and its journal's path."""
    import tempfile

    sock = socket_path(os.path.join(work, name))
    journal = os.path.join(work, f"{name}.jsonl")
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "specpride_tpu_torch", "serve", "--socket",
         sock, "--journal", journal, "--slo", FLIGHTREC_SLO, *flags],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.DEVNULL, stderr=err, text=True)
    proc.err = err
    return proc, sock, journal


def stop_daemon(proc, what: str) -> float:
    """SIGTERM, and the seconds to exit 0 (a drain past 60 s fails)."""
    import signal

    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed after 60 s"
    drain_s = time.perf_counter() - t0
    proc.err.seek(0)
    text = proc.err.read()
    proc.err.close()
    if rc != 0:
        raise AssertionError(f"{what}: the daemon exited {rc}:\n"
                             f"{text[-3000:]}")
    return drain_s


def flightrec_phase(src: str, golden: list) -> dict:
    """flightrec: the flight recorder on CLI-2k (``golden``: the output
    and QC report of CLI-2k's one-shot bin-mean with QC).

    (a) two daemon processes on the card, ``serve --journal --slo
    bin-mean=0.001 --metrics-port 0 --metrics-out`` with and without
    ``--flightrec on --incident-dir``, three bin-mean-with-QC ``submit``
    children each, in turns: every job the golden bytes and 4 + 4
    ``dispatch`` events; exactly one ``slo_breach`` incident, bundled,
    on the recorder's daemon and none on the other; ``incidents list``,
    ``show`` and ``export`` of the bundle, its ``metrics.prom`` counting
    ``slo_breach`` 1 and the six other detectors 0; SIGTERM: both exit 0
    within 60 s, the drain textfile counts the incident, and
    ``incident-replay`` reproduces 1/1; the submit walls of both daemons,
    the bundle's dump seconds and bytes.  (b) three elastic ranks
    (``--elastic`` on their own stores, ``--journal``) started together:
    ``--flightrec on --incident-dir`` with a fault plan that takes one
    dispatch to attempt 3 (``retry_exhaust``, its bundle's ``host.json``
    the coordinator's counters, the rank's journal replayed clean);
    ``--flightrec off`` and no flag, the same launches and no incident;
    each merged to the golden bytes.  (c) beside them, ``fleet --ranks 2
    --flightrec observe --journal``: the golden bytes, no torch in the
    supervisor, its journal replayed clean.  The child processes' own
    launch counts are summed into ``launches``; the fleet's ranks report
    none."""
    import shutil
    import threading

    from specpride_tpu_torch.observability.exporter import (
        parse_exposition,
        validate_exposition,
    )
    from specpride_tpu_torch.serve import client as sc

    work = os.path.join(ROOT, "build", "chip_smoke", "flightrec")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def path(name: str) -> str:
        return os.path.join(work, name)

    def incidents_of(journal: str, what: str) -> list:
        return [e for e in job_journal(journal, what)
                if e["event"] == "incident"]

    res: dict = {"launches": {"seg_mean": 0, "seg_mean_heads": 0,
                              "seg_scan": 0}}
    inc_dir = path("incidents")
    daemons = {
        "on": start_daemon(work, "on", "--flightrec", "on",
                           "--incident-dir", inc_dir, "--metrics-port",
                           "0", "--metrics-out", path("on.prom")),
        "off": start_daemon(work, "off", "--metrics-port", "0",
                            "--metrics-out", path("off.prom")),
    }
    try:
        for arm, (proc, sock, _) in daemons.items():
            if not sc.wait_for_socket(sock, timeout=180):
                raise AssertionError(f"flightrec {arm}: no ping")
        walls: dict = {"on": [], "off": []}
        summaries: dict = {}
        for i in range(3):
            for arm in ("off", "on") if i % 2 else ("on", "off"):
                _, sock, _ = daemons[arm]
                out = path(f"{arm}{i}.mgf")
                wall, text = run_child(
                    "submit", "--socket", sock, "--", "consensus", src, out,
                    "--qc-report", f"{out}.qc.json", "--journal",
                    path(f"{arm}{i}.job.jsonl"))
                term = json.loads(text.strip().splitlines()[-1])
                if term.get("status") != "done":
                    raise AssertionError(f"flightrec {arm} job {i}: {term}")
                if file_bytes(out, f"{out}.qc.json") != golden:
                    raise AssertionError(f"flightrec {arm} job {i}: bytes "
                                         "differ from the one-shot CLI's")
                dispatch: dict = {}
                for e in job_journal(path(f"{arm}{i}.job.jsonl"),
                                     f"flightrec {arm} job {i}"):
                    if e["event"] == "dispatch":
                        dispatch[e["kernel"]] = dispatch.get(e["kernel"],
                                                             0) + 1
                if dispatch != {"bin_mean_flat_intensity": 4,
                                "cosine_flat": 4}:
                    raise AssertionError(f"flightrec {arm} job {i}: "
                                         f"dispatch events {dispatch}")
                walls[arm].append(wall)
                # the daemon's launches since it started (it ran no other)
                summaries[arm] = term["stats"]
        status = sc.request(daemons["on"][1], {"op": "status"}, timeout=30)
        res["recorder"] = status.get("flightrec")
        for arm in ("on", "off"):
            add_launches(res["launches"], summaries[arm])
            if summaries[arm]["backend"]["launches"]["seg_mean"] != 12 or \
                    summaries[arm]["backend"]["launches"]["seg_scan"] != 60:
                raise AssertionError(f"flightrec {arm}: launches "
                                     f"{summaries[arm]['backend']}")
        # the bundle, read through the torch-free CLI while the daemon lives
        _, listing = run_child("incidents", "list", inc_dir)
        rows = listing.strip().splitlines()
        if len(rows) != 1 or rows[0].split()[1] != "slo_breach":
            raise AssertionError(f"flightrec: incidents list {rows}")
        iid = rows[0].split()[0]
        _, shown = run_child("incidents", "show", inc_dir, iid[:8])
        manifest = json.loads(shown)
        tarball = path("incident.tar.gz")
        run_child("incidents", "export", inc_dir, iid, "--output", tarball)
        bundle = manifest["dir"]
        with open(os.path.join(bundle, "metrics.prom")) as fh:
            prom, _ = parse_exposition(fh.read())
        counts = {k[1][0][1]: v for k, v in prom.items()
                  if k[0] == "specpride_incidents_total"}
        if len(counts) != 7 or counts.pop("slo_breach") != 1 or any(
                counts.values()):
            raise AssertionError(f"flightrec: the bundle's incident counts "
                                 f"{counts}")
        res["bundle"] = {
            "files": manifest["files"],
            "bytes": sum(os.path.getsize(os.path.join(bundle, f))
                         for f in os.listdir(bundle)),
            "tarball_bytes": os.path.getsize(tarball),
            "dump_s": res["recorder"]["dump_s"]}
        res["drain_s"] = {arm: stop_daemon(daemons[arm][0],
                                           f"flightrec {arm}")
                          for arm in ("on", "off")}
    finally:
        for proc, _, _ in daemons.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    (incident,) = incidents_of(daemons["on"][2], "flightrec on")
    if incident["detector"] != "slo_breach" or not incident["bundled"]:
        raise AssertionError(f"flightrec: the incident {incident}")
    if incidents_of(daemons["off"][2], "flightrec off"):
        raise AssertionError("flightrec: an incident without a recorder")
    for arm in ("on", "off"):
        with open(path(f"{arm}.prom")) as fh:
            text = fh.read()
        samples, _ = parse_exposition(text)
        n = samples.get(("specpride_incidents_total",
                         (("detector", "slo_breach"),)))
        if validate_exposition(text) or n != (1 if arm == "on" else 0):
            raise AssertionError(f"flightrec {arm}: drain textfile "
                                 f"slo_breach {n}")
    _, replay = run_child("incident-replay", daemons["on"][2])
    if "reproduced: 1/1" not in replay:
        raise AssertionError(f"flightrec: incident-replay {replay}")
    res["submit_wall_s"] = walls
    print(f"compare flightrec serve (CLI-2k): 3 + 3 jobs the one-shot bytes "
          f"with 4 + 4 dispatch events each, one slo_breach incident "
          f"bundled ({iid}), none without the recorder, the bundle's "
          f"metrics.prom slo_breach 1 and 6 detectors 0, both drains exit "
          f"0, incident-replay 1/1; submit walls on {walls['on']} s, off "
          f"{walls['off']} s; bundle {res['bundle']['bytes']} B dumped in "
          f"{res['bundle']['dump_s']} s", flush=True)

    # (c) starts first and runs beside (b): fleet, its supervisor
    # torch-free (TORCH_FREE)
    t_fleet = time.perf_counter()
    fleet = subprocess.Popen(
        [sys.executable, "-c", TORCH_FREE, "fleet", "--ranks", "2",
         "--timeout", "300", "--flightrec", "observe", "--journal",
         path("fleet.jsonl"), "--", "consensus", src, path("fleet.mgf"),
         "--qc-report", path("fleet.qc.json"), "--elastic",
         path("coord_fleet"), "--elastic-ttl", "3"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)

    fleet_out: dict = {}

    def reap() -> None:
        fleet_out["err"] = fleet.communicate(timeout=600)[1]
        fleet_out["wall_s"] = time.perf_counter() - t_fleet

    reaper = threading.Thread(target=reap, daemon=True)
    reaper.start()
    try:
        # (b) elastic ranks: the recorder's, off, and no flag, together
        def rank(name, *extra):
            return ["consensus", src, path(f"{name}.mgf"), "--qc-report",
                    path(f"{name}.qc.json"), "--elastic",
                    path(f"coord_{name}"), "--process-id", "0", "--journal",
                    path(f"{name}.jsonl"), *FLIGHTREC_FAULTS, *extra]

        ranks = launch_group(
            rank("rank_on", "--flightrec", "on", "--incident-dir",
                 path("rank_incidents")),
            rank("rank_off", "--flightrec", "off"), rank("rank_none"))
        res["elastic"] = {}
        for name, r in zip(("rank_on", "rank_off", "rank_none"), ranks):
            merged = run_main("merge-parts", path(f"{name}.mgf"),
                              "--elastic", path(f"coord_{name}"),
                              "--qc-report", path(f"{name}.qc.json"))
            if merged["rc"] != 0 or file_bytes(
                    path(f"{name}.mgf"), path(f"{name}.qc.json")) != golden:
                raise AssertionError(f"flightrec {name}: the merged bytes "
                                     f"differ from the one-shot CLI's "
                                     f"{merged['stderr'][-1000:]}")
            add_launches(res["launches"], r["summary"])
            res["elastic"][name] = {"wall_s": r["wall_s"],
                                    "launches": r["summary"]["backend"]
                                    ["launches"]}
        if len({json.dumps(v["launches"], sort_keys=True)
                for v in res["elastic"].values()}) != 1:
            raise AssertionError(f"flightrec elastic: launches "
                                 f"{res['elastic']}")
        journal = path("rank_on.jsonl.part00000")
        (incident,) = incidents_of(journal, "flightrec rank_on")
        if incident["detector"] != "retry_exhaust" or \
                not incident["bundled"]:
            raise AssertionError(f"flightrec rank_on: the incident "
                                 f"{incident}")
        for name in ("rank_off", "rank_none"):
            if incidents_of(path(f"{name}.jsonl.part00000"), name):
                raise AssertionError(f"flightrec {name}: an incident")
        with open(os.path.join(incident["bundle_dir"], "host.json")) as fh:
            host = json.load(fh)
        if not {"ranges_run", "ranges_committed",
                "reassignments"} <= set(host):
            raise AssertionError(f"flightrec rank_on: host.json {host}")
        _, replay = run_child("incident-replay", journal)
        if "reproduced: 1/1" not in replay:
            raise AssertionError(f"flightrec rank_on: incident-replay "
                                 f"{replay}")
        res["elastic"]["host"] = host
        print(f"compare flightrec elastic (CLI-2k): retry_exhaust bundled "
              f"with the coordinator's counters {host}, replayed 1/1; "
              f"--flightrec on, off and no flag: the one-shot bytes, the "
              f"same launches {res['elastic']['rank_none']['launches']}, "
              f"incidents 1, 0, 0; walls {[r['wall_s'] for r in ranks]} s",
              flush=True)

        reaper.join(timeout=600)
    finally:
        if fleet.poll() is None:
            fleet.kill()
            fleet.wait()
    wall = fleet_out.get("wall_s")
    if "CHILD 0 False" not in fleet_out.get("err", ""):
        raise AssertionError(f"flightrec fleet: "
                             f"{fleet_out.get('err', '')[-3000:]}")
    merged = run_main("merge-parts", path("fleet.mgf"), "--elastic",
                      path("coord_fleet"), "--qc-report",
                      path("fleet.qc.json"))
    if merged["rc"] != 0 or file_bytes(path("fleet.mgf"),
                                       path("fleet.qc.json")) != golden:
        raise AssertionError("flightrec fleet: the merged bytes differ")
    _, replay = run_child("incident-replay", path("fleet.jsonl"))
    if not replay.strip().endswith("ok"):
        raise AssertionError(f"flightrec fleet: incident-replay {replay}")
    res["fleet_wall_s"] = wall
    print(f"compare flightrec fleet (CLI-2k): --ranks 2 --flightrec "
          f"observe, the one-shot bytes, no torch in the supervisor, its "
          f"journal replayed clean; wall {wall:.3f} s (beside the three "
          f"ranks)", flush=True)
    print(f"flightrec {json.dumps(res)}", flush=True)
    return res


AUTOTUNE_BURST = 5  # submit children at once: the queue passes queue_hi (3)
# the steal pair: one range of 2,048 in chunks of 16.  The donor stalls
# AUTOTUNE_SLOW_S s in each of its first AUTOTUNE_STALLS dispatches (a
# rank slow for a while, longer than the thief takes to start), so its
# chunk walls put its elastic_range hint near 30 s / (1.5 s / 16) = 320,
# far under the half of its range that steal-half would cede when the
# thief comes: the hint caps the cede, and the donor runs its kept work
# fast once the stall is over
AUTOTUNE_EVERY = 16
AUTOTUNE_SLOW_S = "1.5"
AUTOTUNE_STALLS = 12


def popen_child(*argv, env=None, torch_free: bool = False):
    """``python -m specpride_tpu_torch ARGV`` (or ``TORCH_FREE``) started
    now, its stdout and stderr in temporary files; ``reap_child`` waits.
    A thread notes when it exits (``t_end``), so a child reaped after
    others keeps its own wall."""
    import tempfile
    import threading

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    head = ([sys.executable, "-c", TORCH_FREE] if torch_free
            else [sys.executable, "-m", "specpride_tpu_torch"])
    proc = subprocess.Popen([*head, *argv], cwd=ROOT,
                            env=dict(env or os.environ, PYTHONPATH=ROOT),
                            stdout=out, stderr=err, text=True)
    proc.out, proc.err, proc.t0 = out, err, time.perf_counter()
    proc.t_end = None

    def note_exit():
        proc.wait()
        proc.t_end = time.perf_counter()

    proc.waiter = threading.Thread(target=note_exit, daemon=True)
    proc.waiter.start()
    return proc


def reap_child(proc, what: str, timeout: float = 600) -> dict:
    """Wait for ``proc``: its wall, stdout and stderr; fails unless it
    exited 0."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = f"killed after {timeout} s"
    proc.waiter.join(timeout=5)
    wall = (proc.t_end or time.perf_counter()) - proc.t0
    texts = []
    for fh in (proc.out, proc.err):
        fh.seek(0)
        texts.append(fh.read())
        fh.close()
    if rc != 0:
        raise AssertionError(f"{what}: exited {rc}:\n{texts[1][-3000:]}\n"
                             f"{texts[0][-1000:]}")
    return {"wall_s": wall, "stdout": texts[0], "stderr": texts[1]}


def submit_terminal(child: dict, what: str) -> dict:
    term = json.loads(child["stdout"].strip().splitlines()[-1])
    if term.get("status") != "done":
        raise AssertionError(f"{what}: {term}")
    return term


def autotune_phase(src: str, golden: list) -> dict:
    """autotune: the closed-loop controller on CLI-2k (``golden``: the
    output and QC report of CLI-2k's one-shot bin-mean with QC).

    (a) a daemon process, ``serve --journal --autotune on
    --autotune-interval 0.2 --autotune-batch-window 0:20 --flightrec on
    --incident-dir --metrics-port 0`` (and the 1 ms SLO): a burst of
    ``AUTOTUNE_BURST`` bin-mean-with-QC ``submit`` children at once, so
    the queue passes the batch-window policy's ``queue_hi`` (3): every
    job the golden bytes, at least one acted ``batch_window_ms``
    decision, the ``specpride_autotune_*`` series on the live
    ``/metrics``, the ``slo_breach`` bundle carrying ``autotune.json``,
    ``autotune-replay`` exiting 0 on the journal and SIGTERM draining
    with exit 0.  (b) beside it, two ``--elastic`` ranks with
    ``--autotune on`` on one range of 2,048 in chunks of
    ``AUTOTUNE_EVERY`` with heartbeats every 0.5 s, the donor stalled
    ``AUTOTUNE_SLOW_S`` s in each of its first ``AUTOTUNE_STALLS``
    dispatches and the thief started once
    the donor's lease is journaled: a forced steal, the merged bytes
    those of the single run with the same chunks (the ``off`` bytes),
    every cede within the split hint its rank's controller had journaled
    (``ceded_within_hint``) and at least one cede cut down to it, both
    ranks' journals replayed clean.  (c) beside them, ``fleet
    --ranks 2 --spares 1 --autotune observe``: the golden bytes, no torch
    in the supervisor, its journal replayed clean.  ``launches``: the
    daemon's and the elastic ranks' own counts (the fleet's ranks report
    none)."""
    import shutil
    import urllib.request

    from specpride_tpu_torch.observability.exporter import (
        parse_exposition,
        validate_exposition,
    )
    from specpride_tpu_torch.serve import client as sc

    work = os.path.join(ROOT, "build", "chip_smoke", "autotune")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def path(name: str) -> str:
        return os.path.join(work, name)

    res: dict = {"launches": {"seg_mean": 0, "seg_mean_heads": 0,
                              "seg_scan": 0}}
    single = run_main("consensus", src, path("single.mgf"), "--qc-report",
                      path("single.qc.json"), "--checkpoint-every",
                      str(AUTOTUNE_EVERY), "--checkpoint",
                      path("single.ck"))
    if single["rc"] != 0:
        raise AssertionError(f"autotune single: {single['stderr'][-2000:]}")
    add_launches(res["launches"], single["summary"])
    off_bytes = file_bytes(path("single.mgf"), path("single.qc.json"))

    def rank(r: int, env=None):
        return popen_child(
            "consensus", src, path("el.mgf"), "--qc-report",
            path("el.qc.json"), "--elastic", path("coord_el"),
            "--process-id", str(r), "--elastic-range", "2048",
            "--checkpoint-every", str(AUTOTUNE_EVERY), "--journal",
            path("el.jsonl"), "--autotune", "on", "--elastic-heartbeat",
            "0.5", env=env)

    fleet = popen_child(
        "fleet", "--ranks", "2", "--spares", "1", "--timeout", "300",
        "--autotune", "observe", "--journal", path("fleet.jsonl"), "--",
        "consensus", src, path("fleet.mgf"), "--qc-report",
        path("fleet.qc.json"), "--elastic", path("coord_fleet"),
        torch_free=True)
    donor = rank(0, env=dict(
        os.environ, SPECPRIDE_SLOW_S=AUTOTUNE_SLOW_S,
        SPECPRIDE_FAULTS=f"dispatch:rank_slow:1:0:{AUTOTUNE_STALLS}"))
    proc, sock, journal = start_daemon(
        work, "daemon", "--autotune", "on", "--autotune-interval", "0.2",
        "--autotune-batch-window", "0:20", "--flightrec", "on",
        "--incident-dir", path("incidents"), "--metrics-port", "0")
    children = [fleet, donor]
    thief = None
    try:
        if not sc.wait_for_socket(sock, timeout=180):
            raise AssertionError("autotune: the daemon never answered")
        burst = [popen_child("submit", "--socket", sock, "--", "consensus",
                             src, path(f"job{i}.mgf"), "--qc-report",
                             path(f"job{i}.qc.json"), torch_free=True)
                 for i in range(AUTOTUNE_BURST)]
        children += burst
        deadline = time.perf_counter() + 300
        while thief is None:
            try:
                with open(path("el.jsonl.part00000")) as fh:
                    if '"lease_claim"' in fh.read():
                        thief = rank(1)
                        children.append(thief)
                        break
            except OSError:
                pass
            if donor.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError("autotune: the donor never claimed")
            time.sleep(0.05)
        stats, burst_walls = [], []
        for i, child in enumerate(burst):
            got = reap_child(child, f"autotune job {i}")
            burst_walls.append(got["wall_s"])
            if "CHILD 0 False" not in got["stderr"]:
                raise AssertionError(f"autotune job {i}: {got['stderr']}")
            stats.append(submit_terminal(got, f"autotune job {i}")["stats"])
            if file_bytes(path(f"job{i}.mgf"),
                          path(f"job{i}.qc.json")) != golden:
                raise AssertionError(f"autotune job {i}: bytes differ from "
                                     "the one-shot CLI's")
        status = sc.request(sock, {"op": "status"}, timeout=30)
        with urllib.request.urlopen(status["metrics_url"],
                                    timeout=30) as r:
            text = r.read().decode()
        samples, _ = parse_exposition(text)
        decisions = {k[1]: v for k, v in samples.items()
                     if k[0] == "specpride_autotune_decisions_total"}
        if validate_exposition(text) or not decisions or not any(
                k[0] == "specpride_autotune_knob" for k in samples):
            raise AssertionError("autotune: /metrics lacks the "
                                 "specpride_autotune_* series")
        res["status"] = status["autotune"]
        res["drain_s"] = stop_daemon(proc, "autotune daemon")
        # the daemon's launches since it started (it ran nothing else)
        last = max(stats, key=lambda s: s["backend"]["launches"]["seg_mean"])
        add_launches(res["launches"], last)
        ranks = [reap_child(donor, "autotune donor"),
                 reap_child(thief, "autotune thief")]
        fleet_out = reap_child(fleet, "autotune fleet")
    finally:
        for p in [proc, *children]:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    events = job_journal(journal, "autotune daemon")
    acted = [e for e in events if e["event"] == "autotune"
             and e["knob"] == "batch_window_ms" and e["acted"]]
    if not acted:
        raise AssertionError("autotune: no acted batch_window_ms decision")
    bundles = [os.path.join(d, "autotune.json")
               for d, _, fs in os.walk(path("incidents"))
               if "autotune.json" in fs]
    if not bundles:
        raise AssertionError("autotune: no bundle carries autotune.json")
    with open(bundles[0]) as fh:
        knobs = json.load(fh)["knobs"]
    _, replay = run_child("autotune-replay", journal)
    if not replay.strip().endswith("ok"):
        raise AssertionError(f"autotune: autotune-replay {replay}")
    res["daemon"] = {
        "decisions": [[e["knob"], e["old"], e["new"], e["acted"]]
                      for e in events if e["event"] == "autotune"],
        "submit_wall_s": burst_walls,
        "bundle_knobs": knobs}
    print(f"compare autotune serve (CLI-2k): {AUTOTUNE_BURST} jobs at once, "
          f"the one-shot bytes each; {len(acted)} acted batch_window_ms "
          f"decision(s) (first {acted[0]['old']} -> {acted[0]['new']} ms at "
          f"queue depth {acted[0]['signal']['queue_depth']}); /metrics "
          f"decisions {decisions}; the slo_breach bundle's autotune.json "
          f"{knobs}; autotune-replay ok; drain exit 0 in "
          f"{res['drain_s']:.3f} s", flush=True)

    merged = run_main("merge-parts", path("el.mgf"), "--elastic",
                      path("coord_el"), "--qc-report", path("el.qc.json"))
    if merged["rc"] != 0 or file_bytes(path("el.mgf"),
                                       path("el.qc.json")) != off_bytes:
        raise AssertionError("autotune elastic: the merged bytes differ from "
                             "the single run's")
    cuts = []
    for r in (0, 1):
        cuts += ceded_within_hint(
            job_journal(path(f"el.jsonl.part{r:05d}"), "autotune rank"), r)
    if not cuts:
        raise AssertionError("autotune elastic: the donor was never "
                             "relieved")
    if not any(c["capped"] for c in cuts):
        raise AssertionError(f"autotune elastic: no cede was capped by the "
                             f"split hint: {cuts}")
    hint = [c["hint"] for c in cuts if c["capped"]][0]
    _, replay = run_child("autotune-replay", path("el.jsonl"))
    if not replay.strip().endswith("ok"):
        raise AssertionError(f"autotune elastic: autotune-replay {replay}")
    for r in ranks:
        add_launches(res["launches"],
                     json.loads(r["stderr"].strip().splitlines()[-1]))
    res["elastic"] = {"walls_s": [r["wall_s"] for r in ranks], "cuts": cuts,
                      "hint": hint}
    print(f"compare autotune elastic (CLI-2k): two ranks --autotune on, the "
          f"donor stalled {AUTOTUNE_SLOW_S} s in its first "
          f"{AUTOTUNE_STALLS} dispatches: cuts {cuts}, the cede capped by "
          f"the hint {hint}, the merged bytes = the single run's "
          f"at --checkpoint-every {AUTOTUNE_EVERY}; both journals replayed "
          f"ok; walls {res['elastic']['walls_s']} s", flush=True)

    if "CHILD 0 False" not in fleet_out["stderr"]:
        raise AssertionError(f"autotune fleet: {fleet_out['stderr'][-3000:]}")
    merged = run_main("merge-parts", path("fleet.mgf"), "--elastic",
                      path("coord_fleet"), "--qc-report",
                      path("fleet.qc.json"))
    if merged["rc"] != 0 or file_bytes(path("fleet.mgf"),
                                       path("fleet.qc.json")) != golden:
        raise AssertionError("autotune fleet: the merged bytes differ")
    _, replay = run_child("autotune-replay", path("fleet.jsonl"))
    if not replay.strip().endswith("ok"):
        raise AssertionError(f"autotune fleet: autotune-replay {replay}")
    fleet_summary = json.loads([ln for ln in fleet_out["stderr"].splitlines()
                                if ln.startswith("{")][-1])
    res["fleet"] = {"wall_s": fleet_out["wall_s"],
                    "autotune": fleet_summary.get("autotune")}
    print(f"compare autotune fleet (CLI-2k): --ranks 2 --spares 1 --autotune "
          f"observe, the one-shot bytes, no torch in the supervisor, "
          f"{fleet_summary.get('autotune')}, its journal replayed ok; wall "
          f"{fleet_out['wall_s']:.3f} s", flush=True)
    print(f"autotune {json.dumps(res)}", flush=True)
    return res


def hint_cap(hint):
    """The most a donor cedes under the split hint ``hint`` on the
    ``AUTOTUNE_EVERY`` grid (``Coordinator.clip_or_ratify``); None, no
    hint, for steal-half's uncapped cede."""
    return (max(hint // AUTOTUNE_EVERY, 1) * AUTOTUNE_EVERY if hint
            else None)


def ceded_within_hint(events: list, rank: int) -> list:
    """Each ``lease_split`` of one rank's journal against the split hint
    its own controller had journaled (acted ``autotune`` decisions): the
    cede at most the hint's cap, and ``capped`` when it is the cap.  The
    controller sets the hint just after journaling it, so a ratification
    that read the previous hint can be journaled just after the new one:
    within ``HINT_RACE_S`` of a decision the previous hint's cap also
    holds.  ``after_claim_s``: the cut's seconds after the rank's first
    lease claim."""
    cuts, hint, prev, decided, claimed = [], None, None, None, None
    for e in events:
        if e["event"] == "lease_claim" and claimed is None:
            claimed = e["mono"]
        if e["event"] == "autotune" and e["acted"]:
            prev, hint, decided = hint, e["new"], e["mono"]
        if e["event"] != "lease_split":
            continue
        ceded, cap = e["n_clusters_split"], hint_cap(hint)
        caps = [cap]
        if decided is not None and e["mono"] - decided < HINT_RACE_S:
            caps.append(hint_cap(prev))
        if all(c is not None and ceded > c for c in caps):
            raise AssertionError(f"autotune elastic: rank {rank} ceded "
                                 f"{ceded} past the hint {hint}")
        cuts.append({"rank": rank, "split_at": e["split_at"],
                     "ceded": ceded, "hint": hint,
                     "capped": cap is not None and ceded == cap,
                     "after_claim_s": (e["mono"] - claimed
                                       if claimed is not None else None)})
    return cuts


HINT_RACE_S = 0.5
WARMUP_JOBS = 3  # per daemon, in turns: the first and two repeats


def warmup_phase(src: str, golden: list) -> dict:
    """warmup: warm start on CLI-2k (``golden`` as for the autotune phase).

    ``consensus --qc-report --warmup-manifest M`` in this process writes
    the manifest (the golden bytes); ``--warmup manifest`` without a
    manifest stops ``consensus`` and ``serve`` with the JAX CLI's
    message.  Then, started together: ``warmup M --journal`` in a fresh
    child (each entry's status and seconds) and two daemon processes,
    ``serve --warmup manifest --warmup-manifest M`` and ``serve --warmup
    off``; ``WARMUP_JOBS`` bin-mean-with-QC ``submit`` children each, in
    turns: every job the golden bytes and the launches of the cold
    daemon's job; ``warmed_kernels`` (the entries, and 0), each daemon's
    first and repeat submit walls, the warm's own launches (the warmed
    daemon's ``warmup`` events), both drains exit 0."""
    import shutil

    from specpride_tpu_torch import cli
    from specpride_tpu_torch.serve import client as sc
    from specpride_tpu_torch.warmstart.manifest import load_manifest

    work = os.path.join(ROOT, "build", "chip_smoke", "warmup")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def path(name: str) -> str:
        return os.path.join(work, name)

    res: dict = {"launches": {"seg_mean": 0, "seg_mean_heads": 0,
                              "seg_scan": 0}}
    manifest = path("shapes.json")
    seed = run_main("consensus", src, path("seed.mgf"), "--qc-report",
                    path("seed.qc.json"), "--warmup-manifest", manifest)
    if seed["rc"] != 0 or file_bytes(path("seed.mgf"),
                                     path("seed.qc.json")) != golden:
        raise AssertionError("warmup: the manifest's run differs from the "
                             "one-shot bytes")
    add_launches(res["launches"], seed["summary"])
    entries = load_manifest(manifest)
    want = "--warmup manifest: no shape manifest at <no --warmup-manifest " \
        "and no compile cache>"
    refusals = {}
    for what, argv in (("consensus", ["consensus", src, path("x.mgf"),
                                      "--warmup", "manifest"]),
                       ("serve", ["serve", "--warmup", "manifest",
                                  "--socket", path("x.sock")])):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc, refusals[what] = 1, str(e.code)
        if rc == 0 or want not in refusals.get(what, ""):
            raise AssertionError(f"warmup: {what} --warmup manifest without "
                                 f"one: {refusals.get(what)}")

    child = popen_child("warmup", manifest, "--journal",
                        path("warmup.jsonl"))
    daemons = {
        "warm": start_daemon(work, "warm", "--warmup", "manifest",
                             "--warmup-manifest", manifest),
        "cold": start_daemon(work, "cold", "--warmup", "off"),
    }
    walls: dict = {"warm": [], "cold": []}
    cum: dict = {"warm": [], "cold": []}
    try:
        warm = reap_child(child, "warmup child")
        counts = json.loads(warm["stdout"].strip().splitlines()[-1])
        if counts["compiled"] != len(entries):
            raise AssertionError(f"warmup child: {counts}")
        for arm, (_, sock, _) in daemons.items():
            if not sc.wait_for_socket(sock, timeout=180):
                raise AssertionError(f"warmup {arm}: no ping")
        status = {arm: sc.request(daemons[arm][1], {"op": "status"},
                                  timeout=30) for arm in daemons}
        for i in range(WARMUP_JOBS):
            for arm in ("cold", "warm") if i % 2 else ("warm", "cold"):
                out = path(f"{arm}{i}.mgf")
                wall, text = run_child(
                    "submit", "--socket", daemons[arm][1], "--",
                    "consensus", src, out, "--qc-report", f"{out}.qc.json")
                term = json.loads(text.strip().splitlines()[-1])
                if term.get("status") != "done" or file_bytes(
                        out, f"{out}.qc.json") != golden:
                    raise AssertionError(f"warmup {arm} job {i}: {term}")
                walls[arm].append(wall)
                cum[arm].append(term["stats"]["backend"]["launches"])
        res["drain_s"] = {arm: stop_daemon(daemons[arm][0], f"warmup {arm}")
                          for arm in daemons}
    finally:
        for proc, _, _ in daemons.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if child.poll() is None:
            child.kill()
            child.wait()
    warm_events = [e for e in job_journal(daemons["warm"][2], "warmup warm")
                   if e["event"] == "warmup"]
    warm_launches = {k: 0 for k in res["launches"]}
    for e in warm_events:
        for k, v in (e.get("launches") or {}).items():
            warm_launches[k] += v
    if [e["status"] for e in warm_events] != ["compiled"] * len(entries):
        raise AssertionError(f"warmup warm daemon: {warm_events}")
    if any(e["event"] == "warmup" for e in job_journal(
            daemons["cold"][2], "warmup cold")):
        raise AssertionError("warmup: the --warmup off daemon warmed")
    if (status["warm"]["warmed_kernels"] != len(entries)
            or status["cold"]["warmed_kernels"] != 0):
        raise AssertionError(f"warmup: warmed_kernels "
                             f"{status['warm']['warmed_kernels']} / "
                             f"{status['cold']['warmed_kernels']}")
    per_job: dict = {}
    for arm, before in (("warm", warm_launches),
                        ("cold", {k: 0 for k in warm_launches})):
        per_job[arm] = []
        for now in cum[arm]:
            per_job[arm].append({k: now[k] - before[k] for k in now})
            before = now
    if len({json.dumps(j, sort_keys=True)
            for arm in per_job for j in per_job[arm]}) != 1:
        raise AssertionError(f"warmup: per-job launches {per_job}")
    for k in res["launches"]:
        res["launches"][k] += cum["warm"][-1][k] + cum["cold"][-1][k]
    res.update(
        entries=[[e.kernel, list(e.shape_key)] for e in entries],
        warmup_child={"wall_s": warm["wall_s"], **counts},
        warmed_kernels={arm: status[arm]["warmed_kernels"]
                        for arm in status},
        warm_launches=warm_launches,
        warm_seconds=[e["seconds"] for e in warm_events],
        submit_wall_s=walls, job_launches=per_job["cold"][0],
        refusals=refusals)
    for e in counts["entries"]:
        print(f"warmup entry {e['kernel']} {e['shape_key']}: {e['status']} "
              f"in {e['seconds']} s", flush=True)
    print(f"warmup launches {json.dumps(warm_launches)} (the warmed "
          f"daemon's boot)", flush=True)
    print(f"compare warmup (CLI-2k): {len(entries)} manifest entries, the "
          f"warmup child {counts['compiled']} compiled in "
          f"{counts['seconds']} s; warmed_kernels {res['warmed_kernels']}; "
          f"{WARMUP_JOBS} + {WARMUP_JOBS} jobs the one-shot bytes and the "
          f"same launches {per_job['cold'][0]}; submit walls warm "
          f"{walls['warm']} s, cold {walls['cold']} s; both drains exit 0; "
          f"--warmup manifest without one refused as the JAX CLI does",
          flush=True)
    print(f"warmup {json.dumps(res)}", flush=True)
    return res


# each phase's wall (seconds), in the order run: chip_smoke.json's phase_s
PHASE_S: dict[str, float] = {}


def lint_phase() -> dict:
    """The port's static analyzer over this tree (``TORCH_FREE``, so the
    child fails unless it exits 0 without importing torch): no new
    finding, no baseline entry without a reason.  Prints its wall and
    checker count."""
    wall, out = run_child("lint", ROOT, "--json", "-")
    report = json.loads(out)
    summary, checkers = report["summary"], len(report["checks"])
    if summary["new"] or summary["baseline_entries_missing_reason"]:
        raise AssertionError(f"lint: {summary}")
    print(f"lint: {checkers} checkers, {summary['new']} new findings, "
          f"{summary['baselined']} baselined, wall {wall:.3f} s, no torch "
          "in the child", flush=True)
    return {"wall_s": wall, "checkers": checkers, **summary}


def timed(phase, *args):
    """``phase(*args)``, its wall kept in ``PHASE_S`` under its name."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        PHASE_S[phase.__name__.removesuffix("_phase")] = round(
            time.perf_counter() - t0, 3)


def main() -> int:
    start_launcher()  # before torch: see LAUNCHER
    try:
        return smoke()
    finally:
        stop_launcher()


def smoke() -> int:
    import torch

    start = time.perf_counter()
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
    lib = _build.load()
    info = _build.build_info or {}
    print(f"build {time.perf_counter() - t0:.2f} s (nvcc "
          f"{info.get('seconds', 0.0):.2f} s, compile "
          f"{info.get('compile_seconds', 0.0):.2f} s)", flush=True)
    print(info.get("log", "").strip(), flush=True)

    mres = timed(seg_mean_phase, kernels)
    kres = timed(seg_scan_phase, kernels)
    hres = timed(seg_mean_heads_phase, kernels)
    stres = timed(stress_phase, kernels, lib)
    xres = timed(extremes_phase, kernels)
    twores = timed(streams_phase, kernels, lib)
    t0 = time.perf_counter()
    clusters = make_workload(SLICE_CLUSTERS, seed=42)
    sres = timed(slice_phase, kernels, clusters, time.perf_counter() - t0)
    slice_reps, slice_cos = sres.pop("reps"), sres.pop("cosines")
    qres = timed(precision_phase, kernels, clusters, slice_reps,
                 sres["h2d_bytes"]["h2d"])
    gres = timed(gap_phase, kernels, clusters)
    dres = timed(medoid_phase, kernels, clusters)
    picks = dres.pop("picks")
    selres = timed(select_phase, kernels, clusters, picks)
    bres = timed(bucketized_phase, kernels, clusters, slice_reps)
    meshres = timed(mesh_phase, kernels, clusters, bres.pop("reps"),
                    bres.pop("cosines"))
    sortres = timed(sort_split_phase, clusters[:SORT_CLUSTERS],
                    slice_reps[:SORT_CLUSTERS])
    exres = timed(executor_phase, kernels, clusters, slice_cos, picks)
    exec_bytes = exres.pop("bytes")
    fres = timed(files_phase, kernels, clusters, slice_cos,
                 sres["cos_chunks"], exec_bytes)
    del slice_reps
    pres = timed(path_scan_phase, kernels, sres.pop("scan_shapes"))
    cres = timed(cli_phase)
    cli_src = os.path.join(ROOT, "build", "chip_smoke", "in.mgf")
    killres = timed(kill_resume_phase, cli_src)
    quarres = timed(quarantine_phase, cli_src)
    chaosres = timed(chaos_phase, cli_src)
    oomres = timed(real_oom_phase, kernels)
    rankres = timed(ranks_phase, cli_src)
    elres = timed(elastic_phase, cli_src, clusters, exec_bytes,
                  fres["stream"]["auto"])
    del exec_bytes
    telres = timed(telemetry_phase, kernels, cli_src)
    trres = timed(tracing_phase, kernels, cli_src, clusters)
    exec_bytes = trres.pop("exec_bytes")
    cacheres = timed(result_cache_phase, kernels, cli_src, clusters)
    serveres = timed(serve_phase, kernels, cli_src, clusters, exec_bytes)
    del clusters, exec_bytes
    serve_work = os.path.join(ROOT, "build", "chip_smoke", "serve")
    golden = file_bytes(os.path.join(serve_work, "cold_bin-mean.mgf"),
                        os.path.join(serve_work, "cold_bin-mean.qc.json"))
    frres = timed(flightrec_phase, cli_src, golden)
    atres = timed(autotune_phase, cli_src, golden)
    wres = timed(warmup_phase, cli_src, golden)
    startres = timed(process_start_phase, cli_src)
    lintres = timed(lint_phase)

    main_case = mres["cases"][0]
    path_case = pres["cases"][0]
    (heads_case,) = [c for c in hres["cases"] if c["case"] == HEAD_MAIN]
    # launches: the main path's runs, through the CLI's chunked executor
    # at its defaults (bin-mean with QC, select medoid with QC, gap f32
    # and bin-mean int8), the files phase's three consensus runs (streamed
    # and eager) and evaluate, the chaos runs and the real OOM run
    main_run = exres["defaults"]["launches"]
    robust = {k: chaosres["launches"][k] + oomres["launches"][k]
              for k in main_run}
    heads_launches = sum(exres[what]["launches"]["seg_mean_heads"]
                         for what in ("gap f32", "bin-mean int8"))
    # the bucketized path's runs: bucketized-20k, the mesh runs and the
    # ranks (their processes' own counts)
    bucket = {k: sum(r["launches"][k] for r in
                     [*bres.values(), *meshres.values(), rankres])
              for k in main_run}
    # the telemetry phase's runs (the journaled main path, the gap average
    # and evaluate), and the tracing and result-cache phases' runs
    tele = {k: sum(telres[what]["launches"][k]
                   for what in ("journal", "gap", "evaluate"))
            + trres["all_launches"][k] + cacheres["launches"][k]
            for k in main_run}
    # the elastic phase's ranks (their processes' own counts), its
    # single-process reference and survivor in this process
    elastic = elres["launches"]
    # the in-process serving daemons' runs (two lanes, then batched), and
    # the flight-recorder, autotune and warmup phases' daemon processes,
    # elastic ranks and in-process references (the processes' own counts)
    served = {k: sum(serveres["in_process"][what]["launches"][k]
                     for what in ("two lanes", "batched"))
              + frres["launches"][k] + atres["launches"][k]
              + wres["launches"][k]
              for k in main_run}
    entries = [{
        "name": "seg_mean",
        "route": "cuda",
        "source": "specpride_tpu_torch/ops/csrc/seg_mean.cu",
        "replaces": "specpride_tpu/ops/pallas_kernels.py:187",
        "launches": (main_run["seg_mean"]
                     + fres["consensus_launches"]["seg_mean"]
                     + robust["seg_mean"] + bucket["seg_mean"]
                     + tele["seg_mean"] + served["seg_mean"]
                     + elastic["seg_mean"]),
        "max_abs_err": max(c["max_abs_err"] for c in mres["cases"]),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
    }, {
        "name": "seg_mean_heads",
        "route": "cuda",
        "source": "specpride_tpu_torch/ops/csrc/seg_mean.cu",
        "replaces": "specpride_tpu/ops/pallas_kernels.py:187",
        "launches": (heads_launches + robust["seg_mean_heads"]
                     + bucket["seg_mean_heads"] + tele["seg_mean_heads"]
                     + served["seg_mean_heads"]
                     + elastic["seg_mean_heads"]),
        "max_abs_err": max(c["max_abs_err"] for c in hres["cases"]),
        "ms": heads_case["ms"],
        "plain_ms": heads_case["plain_ms"],
        "bound_ms": heads_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": heads_case["library_ms"],
    }, {
        "name": "seg_scan",
        "route": "cuda",
        "source": "specpride_tpu_torch/ops/csrc/seg_scan.cu",
        "replaces": "specpride_tpu/ops/pallas_kernels.py:148",
        "launches": (main_run["seg_scan"]
                     + exres["medoid"]["launches"]["seg_scan"]
                     + fres["consensus_launches"]["seg_scan"]
                     + fres["evaluate_launches"]["seg_scan"]
                     + robust["seg_scan"] + bucket["seg_scan"]
                     + tele["seg_scan"] + served["seg_scan"]
                     + elastic["seg_scan"]),
        "max_abs_err": max(
            c["max_abs_err"] for c in kres["cases"] + pres["cases"]
        ),
        "ms": path_case["ms"],
        "plain_ms": path_case["plain_ms"],
        "bound_ms": path_case["bound_ms"],
        "bound_by": "bytes",
        # no single PyTorch call computes a segmented scan
        "library_ms": None,
    }]
    wall = time.perf_counter() - start
    # the walls on stdout too: a run from a copy of the tree keeps its
    # chiprun_out/ there
    print(f"smoke {smi}: wall_s {wall}, build_s {info.get('seconds')}, "
          f"phase_s {json.dumps(PHASE_S)}", flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "seg_mean": mres, "seg_scan": kres,
                   "seg_mean_heads": hres, "stress": stres,
                   "extremes": xres, "streams": twores, "slice": sres,
                   "precision": qres, "gap": gres, "medoid": dres,
                   "select": selres, "path_scan": pres,
                   "host_sorts": sortres, "executor": exres,
                   "files": fres, "cli": cres, "kill_resume": killres,
                   "quarantine": quarres, "chaos": chaosres,
                   "real_oom": oomres, "bucketized": bres,
                   "mesh": meshres, "ranks": rankres, "elastic": elres,
                   "telemetry": telres, "tracing": trres,
                   "result_cache": cacheres, "serve": serveres,
                   "flightrec": frres, "autotune": atres, "warmup": wres,
                   "process_start": startres, "lint": lintres,
                   "build": info.get("seconds"), "phase_s": PHASE_S,
                   "wall_s": wall}, fh, indent=1)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
