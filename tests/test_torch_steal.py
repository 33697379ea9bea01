"""Work stealing, the object-store coordinator and the fleet supervisor of
the port (``parallel/coordinator.py``, ``store.py``, ``fleet.py``, the
CLI's ``fleet`` and ``cas-server``) against the JAX package's, on the CPU.

The split handshake is driven step by step on a port coordinator pair:
the thief proposes, the donor ratifies at a chunk boundary (steal-half,
never its first chunk), the thief claims the tail; the donor's fence
refuses the stolen suffix; the donor defers its own tail for a full
expiry window; a committed tail is not claimed again.  The journals give
the JAX audit and rank view.  Then whole runs in subprocesses: a
deterministic forced steal (the handicapped donor starts first, the thief
only once the donor's lease is journaled, and the donor's ``rank_slow``
stalls long enough that the steal is certain), a run on the port's
``cas-server`` and ``fleet --ranks 2``.  Each merges to the bytes of the
single-process run with the same ``--checkpoint-every`` (identity)."""

import io
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu.parallel import elastic as jelastic
from specpride_tpu.parallel import fleet as jfleet
from specpride_tpu_torch import cli
from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.io.mgf import write_mgf
from specpride_tpu_torch.observability.journal import read_events
from specpride_tpu_torch.observability.stats_cli import _render_rank_view
from specpride_tpu_torch.parallel.coordinator import Coordinator
from specpride_tpu_torch.parallel.elastic import (
    audit_elastic,
    elastic_range_table,
    summarize_ranks,
)
from specpride_tpu_torch.parallel.fleet import (
    WORKER_MODULE,
    FleetSupervisor,
    extract_flag,
)
from specpride_tpu_torch.robustness.errors import LeaseExpiredError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240


class RecordingJournal:
    enabled = True

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        rec = {"event": event, "ts": time.time(),
               "mono": time.perf_counter(), **fields}
        self.events.append(rec)
        return rec

    def close(self):
        pass


def _pair(tmp_path, n=12, chunk=2):
    ja, jb = RecordingJournal(), RecordingJournal()
    a = Coordinator(str(tmp_path), 0, n, n, ttl=5.0, journal=ja,
                    chunk_hint=chunk)
    b = Coordinator(str(tmp_path), 1, n, n, ttl=5.0, journal=jb,
                    chunk_hint=chunk)
    return a, b, ja, jb


def _steal(thief, got):
    th = threading.Thread(
        target=lambda: got.update(c=thief.try_steal(poll_timeout=5.0)))
    th.start()
    # the proposal lands before the donor's next boundary
    deadline = time.perf_counter() + 5.0
    while not [k for k in thief.store.list_keys("split/")
               if ".proposed." in k]:
        assert time.perf_counter() < deadline
        time.sleep(0.01)
    return th


# -- the handshake, step by step ----------------------------------------------


def test_steal_handshake_moves_the_tail(tmp_path):
    a, b, ja, jb = _pair(tmp_path)
    try:
        assert a.claim_next().range.range_id == 0
        # the donor committed 2 chunks of 2
        for max_idx in (1, 3):
            a.commit_fence(0, max_idx=max_idx, n_clusters=2,
                           chunk_t0=time.perf_counter() - 0.1)
        a._beat()
        assert b.claim_next() is None  # everything is leased
        got = {}
        th = _steal(b, got)
        # the donor reaches its next chunk (cluster 4): 8 remain, it keeps
        # 4 and cedes [8, 12)
        assert a.clip_or_ratify(0, next_min_idx=4) == 8
        th.join()
        tail = got["c"]
        assert (tail.range.start, tail.range.stop) == (8, 12)
        assert tail.range.parent == 0 and tail.range.from_rank == 0
        splits = [e for e in ja.events if e["event"] == "lease_split"]
        assert [(e["split_at"], e["new_range"], e["n_clusters_split"])
                for e in splits] == [(8, tail.range.range_id, 4)]
        moved = [e for e in jb.events if e["event"] == "chunk_reassign"]
        assert [(e["range"], e["from_rank"], e["to_rank"], e["via"])
                for e in moved] == [(tail.range.range_id, 0, 1,
                                     "lease_split")]
        events = ja.events + jb.events
        assert audit_elastic(events) == [] == jelastic.audit_elastic(events)
        assert (a.lease_splits, b.steals) == (1, 1)
        assert a.effective_range(0).stop == 8
        # the cut is final: the next boundary reports it again
        assert a.clip_or_ratify(0, next_min_idx=6) == 8
        # both packages read the effective ranges in cluster order
        table = elastic_range_table(str(tmp_path))
        assert table == jelastic.elastic_range_table(str(tmp_path))
        assert [(r["start"], r["stop"]) for r in table[0]] == [(0, 8),
                                                               (8, 12)]
    finally:
        a.stop()
        b.stop()


def test_donor_fences_the_stolen_suffix(tmp_path):
    a, b, _, _ = _pair(tmp_path)
    try:
        assert a.claim_next() is not None
        a._beat()
        got = {}
        th = _steal(b, got)
        assert a.clip_or_ratify(0, next_min_idx=4) == 8
        th.join()
        assert got["c"] is not None
        a.commit_fence(0, max_idx=7, n_clusters=2)  # below the cut
        with pytest.raises(LeaseExpiredError):
            a.commit_fence(0, max_idx=8, n_clusters=2)
        a.check_lease(0)  # the lease stays the donor's
    finally:
        a.stop()
        b.stop()


def test_donor_keeps_its_first_chunk_and_declines_when_empty(tmp_path):
    a, b, ja, _ = _pair(tmp_path)
    try:
        assert a.claim_next() is not None
        nonce = a._held[0].nonce
        b.store.put_new(b._proposal_key(0, nonce),
                        {"parent": 0, "stealer_rank": 1,
                         "donor_nonce": nonce})
        assert a.clip_or_ratify(0, next_min_idx=0) is None
        # on the last chunk: a declined cut ends the thief's poll
        assert a.clip_or_ratify(0, next_min_idx=10) is None
        cut = a.store.get(a._cut_key(0, nonce))
        assert cut is not None and cut[0]["new_range"] is None
        assert not [e for e in ja.events if e["event"] == "lease_split"]
    finally:
        a.stop()
        b.stop()


def test_donor_defers_its_own_split_tail(tmp_path):
    a, b, _, _ = _pair(tmp_path)
    try:
        assert a.claim_next() is not None
        a._beat()
        got = {}
        th = _steal(b, got)
        assert a.clip_or_ratify(0, next_min_idx=4) == 8
        th.join()
        tail_id = got["c"].range.range_id
        b.release(tail_id)  # the thief abandons it (as if dead)
        a.release(0)
        a.commit(0, {"output_bytes": 0, "sha256": "x"})
        assert a.claim_next() is None  # inside the expiry window
        old = time.time() - 60
        os.utime(tmp_path / "overlay" / f"range_{tail_id:05d}.json",
                 (old, old))
        claim = a.claim_next()
        assert claim is not None and claim.range.range_id == tail_id
    finally:
        a.stop()
        b.stop()


def test_a_committed_tail_is_not_claimed_again(tmp_path):
    """The thief that ran a tail and proposes to the same donor tenure
    again finds the tail committed and claims nothing (the JAX package
    claims it again, resumes its part and rewrites its QC shard)."""
    a, b, _, jb = _pair(tmp_path)
    try:
        assert a.claim_next() is not None
        a._beat()
        got = {}
        th = _steal(b, got)
        assert a.clip_or_ratify(0, next_min_idx=2) is not None
        th.join()
        tail = got["c"]
        assert tail is not None
        b.commit(tail.range.range_id, {"output_bytes": 0, "sha256": "x"})
        b.release(tail.range.range_id)
        claims = sum(e["event"] == "lease_claim" for e in jb.events)
        assert b.try_steal(poll_timeout=1.0) is None
        assert sum(e["event"] == "lease_claim" for e in jb.events) == claims
    finally:
        a.stop()
        b.stop()


def test_stats_slow_marker_and_split_rollup():
    base = time.time()
    donor = [
        {"event": "heartbeat", "rank": 0, "holding": [0], "ttl": 1.0,
         "ts": base},
        {"event": "lease_claim", "rank": 0, "range": 0, "takeover": False,
         "ts": base},
        {"event": "lease_split", "range": 0, "new_range": 2, "rank": 0,
         "split_at": 8, "ts": base + 0.5},
    ]
    thief = [
        {"event": "heartbeat", "rank": 1, "holding": [], "ttl": 1.0,
         "ts": base + 5.0},
        {"event": "chunk_reassign", "range": 2, "from_rank": 0,
         "to_rank": 1, "via": "lease_split", "ts": base + 1.0},
    ]
    view = summarize_ranks([donor, thief])
    assert view == jelastic.summarize_ranks([donor, thief])
    assert view["lease_splits"] == 1
    r0, r1 = view["ranks"]["0"], view["ranks"]["1"]
    assert r0["slow"] is True and r0["lease_splits"] == 1
    assert r1["slow"] is False and r1["steals"] == 1
    out = io.StringIO()
    _render_rank_view(view, out)
    from specpride_tpu.observability.stats_cli import (
        _render_rank_view as jrender,
    )

    want = io.StringIO()
    jrender(view, want)
    assert out.getvalue() == want.getvalue()
    assert "slow: " in out.getvalue() and "1 split(s)" in out.getvalue()


def test_fleet_refuses_bad_argv_and_spawns_the_port(tmp_path):
    with pytest.raises(ValueError):
        FleetSupervisor(["consensus", "a", "b"], ranks=1)
    with pytest.raises(ValueError):
        FleetSupervisor(["consensus", "a", "b", "--elastic", str(tmp_path),
                         "--process-id", "0"], ranks=1)
    for plane in ({"autotune": "on"}, {"flightrec": "observe"}):
        # both planes fold the supervisor's journal, as in the JAX CLI
        for cls in (FleetSupervisor, jfleet.FleetSupervisor):
            with pytest.raises(ValueError, match="requires --journal"):
                cls(["consensus", "a", "b", "--elastic", str(tmp_path)],
                    ranks=1, **plane)
    argv = ["--elastic=x", "--elastic", "y", "--elastic-ttl=2"]
    for flag in ("--elastic", "--elastic-ttl", "--nope"):
        assert extract_flag(argv, flag) == jfleet.extract_flag(argv, flag)
    sup = FleetSupervisor(["consensus", "a", "b", "--elastic",
                           str(tmp_path), "--elastic-ttl", "3"], ranks=2)
    assert WORKER_MODULE == "specpride_tpu_torch"
    assert sup.worker_argv() == [sys.executable, "-m", "specpride_tpu_torch",
                                 "consensus", "a", "b", "--elastic",
                                 str(tmp_path), "--elastic-ttl", "3"]
    assert (sup.ttl, sup.max_ranks) == (3.0, 2)


# -- whole runs --------------------------------------------------------------


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    rng = np.random.default_rng(2024)
    spectra = []
    for i in range(24):
        c = make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 5)),
                         n_peaks=int(rng.integers(5, 40)), base_scan=100 * i)
        spectra += [Spectrum(s.mz, s.intensity, s.precursor_mz,
                             s.precursor_charge, s.rt, s.title)
                    for s in c.members]
    src = tmp_path_factory.mktemp("steal_wl") / "clustered.mgf"
    write_mgf(spectra, src)
    return str(src)


def _single(tmp_path, src, every):
    out, qc = tmp_path / "single.mgf", tmp_path / "single.qc.json"
    assert cli.main(["consensus", src, str(out), "--device", "cpu",
                     "--qc-report", str(qc), "--checkpoint",
                     str(tmp_path / "single.ck"), "--checkpoint-every",
                     str(every)]) == 0
    return out.read_bytes(), qc.read_bytes()


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, **extra)


def _merged(tmp_path, out, spec):
    assert cli.main(["merge-parts", str(out), "--elastic", spec,
                     "--qc-report", f"{out}.qc.json"]) == 0
    return out.read_bytes(), (tmp_path / f"{out.name}.qc.json").read_bytes()


def test_forced_steal_two_ranks_byte_identical(tmp_path, workload):
    """One range of 24 clusters in chunks of 1: the donor stalls 0.6 s at
    every dispatch (24 chunks, 14.4 s alone); the thief starts once the
    donor's lease_claim is journaled, so its proposal meets a range with
    chunks to spare however slowly the thief starts (up to about 12 s),
    and the steal is certain."""
    golden = _single(tmp_path, workload, 1)
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    journal = str(tmp_path / "j.jsonl")

    def argv(rank):
        return [sys.executable, "-m", "specpride_tpu_torch", "consensus",
                workload, str(out), "--device", "cpu", "--elastic",
                str(coord), "--process-id", str(rank), "--elastic-range",
                "24", "--checkpoint-every", "1", "--elastic-ttl", "5",
                "--qc-report", f"{out}.qc.json", "--journal", journal]

    donor = subprocess.Popen(
        argv(0), env=_env(SPECPRIDE_FAULTS="dispatch:rank_slow:1:0:9999",
                          SPECPRIDE_SLOW_S="0.6"),
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    procs = [donor]
    try:
        deadline = time.perf_counter() + CHILD_TIMEOUT_S
        while True:
            try:
                with open(journal + ".part00000") as fh:
                    if '"lease_claim"' in fh.read():
                        break
            except OSError:
                pass
            assert donor.poll() is None, donor.stderr.read().decode()
            assert time.perf_counter() < deadline
            time.sleep(0.05)
        procs.append(subprocess.Popen(argv(1), env=_env(), cwd=REPO,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
        for p in procs:
            _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert _merged(tmp_path, out, str(coord)) == golden
    events = []
    for r in (0, 1):
        ev, bad = read_events(f"{journal}.part0000{r}")
        assert bad == []
        events += ev
    splits = [e for e in events if e["event"] == "lease_split"]
    assert splits, "the slow rank was never relieved"
    moved = [e for e in events if e["event"] == "chunk_reassign"
             and e.get("via") == "lease_split"]
    assert [e["to_rank"] for e in moved] == [1] * len(splits)
    assert audit_elastic(events) == [] == jelastic.audit_elastic(events)
    ends = [e for e in events if e["event"] == "run_end"]
    assert sum(e["elastic"]["lease_splits"] for e in ends) == len(splits)
    assert sum(e["elastic"]["steals"] for e in ends) == len(splits)


def test_object_store_run_on_the_cas_server(tmp_path, workload):
    """A run whose records live only in the port's ``cas-server`` process
    (a URL file, SIGTERM to stop it) merges to the single-process bytes;
    the resume manifests stay in ``--elastic-local``."""
    golden = _single(tmp_path, workload, 3)
    url_file = tmp_path / "url"
    server = subprocess.Popen(
        [sys.executable, "-m", "specpride_tpu_torch", "cas-server",
         "--url-file", str(url_file)], env=_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        url = server.stdout.readline().decode().strip()
        assert url.startswith("http://127.0.0.1:")
        assert url_file.read_text().strip() == url
        out = tmp_path / "os.mgf"
        assert cli.main(["consensus", workload, str(out), "--device", "cpu",
                         "--elastic", url, "--elastic-local",
                         str(tmp_path / "local"), "--elastic-range", "6",
                         "--checkpoint-every", "3", "--qc-report",
                         f"{out}.qc.json", "--journal",
                         str(tmp_path / "j.jsonl")]) == 0
        assert sorted(os.listdir(tmp_path / "local" / "ck")) == [
            f"range_{k:05d}.json" for k in range(4)]
        assert _merged(tmp_path, out, url) == golden
        ev, bad = read_events(str(tmp_path / "j.jsonl.part00000"))
        assert bad == []
        assert ev[-1]["elastic"]["backend"] == f"object-store:{url}"
    finally:
        server.terminate()
        assert server.wait(timeout=30) == 0


def test_fleet_supervises_to_completion(tmp_path, workload):
    golden = _single(tmp_path, workload, 3)
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    fj = tmp_path / "fleet.jsonl"
    assert cli.main(["fleet", "--ranks", "2", "--timeout", "300",
                     "--journal", str(fj), "--",
                     "consensus", workload, str(out), "--device", "cpu",
                     "--elastic", str(coord), "--elastic-range", "6",
                     "--checkpoint-every", "3", "--elastic-ttl", "2",
                     "--qc-report", f"{out}.qc.json"]) == 0
    assert _merged(tmp_path, out, str(coord)) == golden
    events, bad = read_events(str(fj))
    assert bad == []
    spawns = [e for e in events if e["event"] == "rank_spawn"]
    assert [e["reason"] for e in spawns] == ["boot", "boot"]
    assert sorted(os.listdir(coord / "ranks")) == ["rank_00000",
                                                   "rank_00001"]
