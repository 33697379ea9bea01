"""The port's serving lanes and cross-job micro-batching on the CPU
(``serve --workers``, ``--batch-window``; ``serve/batcher.py``), the
counterpart of the JAX package's ``tests/test_workers.py`` and
``tests/test_batching.py``.

Two jobs on two lanes run side by side (each terminal line names its
lane) and write their solo bytes; two compatible jobs under a batch
window share one pass (one ``batch_dispatch`` event naming both) and
write their solo bytes and QC reports for every batchable method, while
a job with another config digest runs solo; ``run_shared`` on the flat
layout keeps each source's own layout, so its results are the solo
runs' exactly; a job resuming a checkpoint is not batched.  Every
daemon drains in a ``finally``; every join and read has a timeout."""

import json
import threading
import time

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu.io.mgf import write_mgf as jwrite_mgf
from specpride_tpu.observability.journal import read_events as jread_events
from specpride_tpu_torch import cli
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BinMeanConfig, CosineConfig
from specpride_tpu_torch.observability.journal import read_events
from specpride_tpu_torch.serve import batcher
from specpride_tpu_torch.serve import client as sc
from specpride_tpu_torch.serve.daemon import ServeDaemon

JOIN_S = 60
METHODS = [("bin-mean", "consensus"), ("gap-average", "consensus"),
           ("medoid", "select")]


@pytest.fixture(scope="module")
def halves(tmp_path_factory):
    """Two distinct inputs (the halves of one seeded workload)."""
    tmp = tmp_path_factory.mktemp("halves")
    rng = np.random.default_rng(7)
    clusters = [make_cluster(rng, f"cluster-{i}",
                             n_members=int(rng.integers(1, 5)), n_peaks=30)
                for i in range(12)]
    paths = []
    for k, part in enumerate((clusters[:6], clusters[6:])):
        path = tmp / f"half{k}.mgf"
        jwrite_mgf([s for c in part for s in c.members], path)
        paths.append(str(path))
    return paths


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _solo(src, out, method, command, qc=None, extra=()):
    argv = [command, src, out, "--method", method, "--device", "cpu",
            *extra]
    if qc:
        argv += ["--qc-report", qc]
    assert cli.main(argv) == 0


def _serve(tmp, **kw) -> tuple[ServeDaemon, threading.Thread]:
    d = ServeDaemon(str(tmp / "s.sock"), device="cpu",
                    journal_path=str(tmp / "serve.jsonl"), **kw)
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    assert sc.wait_for_socket(d.socket_path, timeout=60)
    return d, t


def _stop(d: ServeDaemon, t: threading.Thread) -> None:
    d._gate.set()
    d.drain()
    t.join(timeout=JOIN_S)
    assert not t.is_alive()


def _submit_held(d: ServeDaemon, jobs: dict, settle) -> dict:
    """Submit ``jobs`` ({tag: argv}) concurrently while every lane is held
    at the gate, each as its own client (the fair queue offers the head
    of each client's line to a batch), wait for ``settle(d)``, release
    the lanes and return the terminal lines."""
    terms: dict = {}

    def submit(tag, argv):
        terms[tag] = sc.submit_wait(d.socket_path, argv, client=str(tag),
                                    timeout=JOIN_S)

    d._gate.clear()
    threads = [threading.Thread(target=submit, args=item)
               for item in jobs.items()]
    for th in threads:
        th.start()
    deadline = time.time() + 30
    while not settle(d) and time.time() < deadline:
        time.sleep(0.01)
    assert settle(d)
    d._gate.set()
    for th in threads:
        th.join(timeout=JOIN_S)
        assert not th.is_alive()
    return terms


def test_two_lanes_run_two_jobs_side_by_side(tmp_path, halves):
    """``--workers 2``: two QC jobs on the two halves are in flight at
    once, one on each lane, and write their solo bytes."""
    for k, src in enumerate(halves):
        _solo(src, str(tmp_path / f"solo{k}.mgf"), "bin-mean", "consensus",
              str(tmp_path / f"solo{k}.qc.json"))
    d, t = _serve(tmp_path, workers=2)
    try:
        assert [s.describe() for s in d.slots] == ["cpu:shared"] * 2
        jobs = {k: ["consensus", src, str(tmp_path / f"srv{k}.mgf"),
                    "--qc-report", str(tmp_path / f"srv{k}.qc.json")]
                for k, src in enumerate(halves)}
        terms = _submit_held(d, jobs, lambda d: len(d._inflight_by) == 2)
    finally:
        _stop(d, t)
    assert sorted(terms[k]["worker"] for k in terms) == [0, 1]
    for k in terms:
        assert terms[k]["status"] == "done", terms[k]
        assert _read(tmp_path / f"srv{k}.mgf") == \
            _read(tmp_path / f"solo{k}.mgf")
        assert _read(tmp_path / f"srv{k}.qc.json") == \
            _read(tmp_path / f"solo{k}.qc.json")
    events, violations = read_events(str(tmp_path / "serve.jsonl"))
    assert not violations
    (start,) = [e for e in events if e["event"] == "serve_start"]
    assert start["workers"] == 2
    assert start["placement"] == ["cpu:shared", "cpu:shared"]


@pytest.mark.parametrize("qc", [False, True], ids=["noqc", "qc"])
@pytest.mark.parametrize("method,command", METHODS)
def test_batched_jobs_write_their_solo_bytes(tmp_path, halves, method,
                                             command, qc):
    """Two compatible jobs under ``--batch-window``: one
    ``batch_dispatch`` event names both, each terminal line carries the
    batch, and each job writes its solo output and QC report; a third job
    with another config digest stays out of the batch."""
    extra = ["--bin-size", "0.05"] if method == "bin-mean" else [
        "--mz-accuracy", "0.02"] if method == "gap-average" else [
        "--xcorr-bin", "0.2"]
    for k, src in enumerate(halves):
        _solo(src, str(tmp_path / f"solo{k}.mgf"), method, command,
              str(tmp_path / f"solo{k}.qc.json") if qc else None)
    _solo(halves[0], str(tmp_path / "solo_other.mgf"), method, command,
          extra=extra)
    d, t = _serve(tmp_path, workers=1, batch_window=0.2)
    try:
        jobs = {k: [command, src, str(tmp_path / f"srv{k}.mgf"), "--method",
                    method, "--journal", str(tmp_path / f"job{k}.jsonl"),
                    *(["--qc-report", str(tmp_path / f"srv{k}.qc.json")]
                      if qc else [])]
                for k, src in enumerate(halves)}
        jobs["other"] = [command, halves[0],
                         str(tmp_path / "srv_other.mgf"), "--method", method,
                         *extra]
        terms = _submit_held(
            d, jobs, lambda d: d._inflight is not None and len(d.queue) == 2)
    finally:
        _stop(d, t)
    for tag, term in terms.items():
        assert term["status"] == "done", (tag, term)
    batched = [tag for tag, term in terms.items() if "batch" in term]
    assert sorted(batched, key=str) == [0, 1], terms
    assert "batch" not in terms["other"]
    for k in (0, 1):
        assert _read(tmp_path / f"srv{k}.mgf") == \
            _read(tmp_path / f"solo{k}.mgf")
        if qc:
            assert _read(tmp_path / f"srv{k}.qc.json") == \
                _read(tmp_path / f"solo{k}.qc.json")
        for reader in (read_events, jread_events):
            events, violations = reader(str(tmp_path / f"job{k}.jsonl"))
            assert not violations, violations
            # a batch member's pipeline dispatches nothing itself
            assert not [e for e in events if e["event"] == "dispatch"]
    assert _read(tmp_path / "srv_other.mgf") == \
        _read(tmp_path / "solo_other.mgf")
    events, violations = read_events(str(tmp_path / "serve.jsonl"))
    assert not violations
    (batch,) = [e for e in events if e["event"] == "batch_dispatch"]
    assert batch["status"] == "shared" and batch["n_jobs"] == 2
    assert sorted(batch["jobs"]) == sorted(terms[k]["job_id"]
                                           for k in (0, 1))
    assert batch["n_clusters"] == 12
    assert batch["dispatches"] >= 1


def test_run_shared_on_the_flat_layout_equals_solo_runs(halves):
    """``run_shared`` keeps each source's flat layout: its
    representatives and QC cosines are each source's own run's,
    exactly."""
    parts = [cli.load_clusters(cli.build_parser().parse_args(
        ["consensus", src, "o.mgf"])) for src in halves]
    backend = TorchBackend(device="cpu")
    shared = backend.run_shared("bin-mean", parts, BinMeanConfig(),
                                CosineConfig())
    assert backend.chunks == 2 and backend.cos_chunks == 2
    for part, (reps, cosines) in zip(parts, shared):
        solo_reps, solo_cos = TorchBackend(
            device="cpu").run_bin_mean_with_cosines(part)
        for a, b in zip(reps, solo_reps):
            assert a.title == b.title
            np.testing.assert_array_equal(a.mz, b.mz)
            np.testing.assert_array_equal(a.intensity, b.intensity)
        np.testing.assert_array_equal(cosines, solo_cos)


def test_batch_key_keeps_job_scoped_runs_solo(tmp_path, halves):
    """Jobs whose chunking or semantics are their own run solo: a
    checkpoint to resume, ``--append``, ``--on-error skip``, faults,
    ``best``, a streamed input; the key carries the solo chunking."""
    ap = cli.build_parser()

    def key(*flags, command="consensus", method="bin-mean"):
        return batcher.batch_key(ap.parse_args(
            [command, halves[0], "o.mgf", "--method", method, *flags]),
            command)

    assert key() == ("consensus", "bin-mean", key()[2], 512)
    assert key("--prefetch", "0")[3] == 0
    assert key("--checkpoint-every", "7")[3] == 7
    assert key("--qc-report", "q.json")[2] != key()[2]
    ck = tmp_path / "ck.json"
    assert key("--checkpoint", str(ck)) is not None
    ck.write_text(json.dumps({"done": []}))
    for flags in (("--checkpoint", str(ck)), ("--append",),
                  ("--on-error", "skip"), ("--inject-faults", "qc:io:1"),
                  ("--stream-clusters", "64")):
        assert key(*flags) is None, flags
    assert key(command="select", method="best") is None
    assert key(command="select", method="medoid")[1] == "medoid"
