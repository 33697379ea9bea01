"""The port's elastic runs (``parallel/coordinator.py``, ``elastic.py``,
the CLI's ``--elastic*`` and ``merge-parts --elastic``) against the JAX
package's, on the CPU.

The plan is the JAX ``plan_ranges`` over a table of sizes.  Coordinator
pairs on one temporary directory are driven step by step (liveness by
moving the observer's store clock, no sleeps to race): claim, renewal and
expiry; one of two commits counts; ``assign_rank`` is unique across both
packages; the journals they write give the JAX ``summarize_ranks`` and
``audit_elastic`` results.  Then the CLI on a seeded 40-cluster input: one
rank's ``--elastic`` run and ``merge-parts --elastic`` give the bytes of a
single-process run with the same ``--checkpoint-every`` (bin-mean with
QC, gap-average, ``select --method medoid``), and the JAX package's
``merge-parts --elastic`` over the port's store gives them too; a rank
killed by ``rank_kill`` (clean, and with a torn tail) is taken over by a
survivor that resumes, with the same bytes and clean audits; a sticky
CUDA error ends a rank without a commit; ``stats`` renders the JAX rank
view.  Every check is an identity, except a custom
``--elastic-range`` that is not a multiple of ``--checkpoint-every``:
its f32 bin-mean changes chunk layouts and is held at the m/z rtol 1e-5
and intensity rtol 1e-4 / atol 1e-3, its QC cosines at rtol 1e-5 /
atol 1e-6, with the changed bits pinned; medoid and int8 stay
identical."""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu import cli as jcli
from specpride_tpu.observability.stats_cli import run_stats as jrun_stats
from specpride_tpu.parallel import coordinator as jcoord
from specpride_tpu.parallel import elastic as jelastic
from specpride_tpu_torch import cli
from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.io.mgf import read_mgf, write_mgf
from specpride_tpu_torch.observability.journal import read_events
from specpride_tpu_torch.observability.stats_cli import run_stats
from specpride_tpu_torch.parallel.coordinator import Coordinator, plan_ranges
from specpride_tpu_torch.parallel.elastic import (
    audit_elastic,
    elastic_range_table,
    sha256_file,
    summarize_ranks,
    verify_part_manifest,
)
from specpride_tpu_torch.robustness.errors import LeaseExpiredError
from specpride_tpu_torch.robustness.faults import audit_fault_recovery

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLUSTERS = 40
EVERY = 8


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


def _quiet(coord):
    """Stop a coordinator's heartbeat thread without releasing anything:
    the steps below renew by hand (``_beat``), and a stopped thread is a
    crash's silence."""
    coord._stop.set()
    coord._hb_thread.join()


# -- the plan and the coordinator, step by step -----------------------------


@pytest.mark.parametrize("n,size", [(0, 3), (1, 1), (7, 3), (9, 3),
                                    (10, 1024), (2000, 1024), (2048, 1024),
                                    (20000, 1024), (5, 0), (5, -2)])
def test_plan_ranges_equal_the_jax_plan(n, size):
    got = [(r.range_id, r.start, r.stop, r.parent)
           for r in plan_ranges(n, size)]
    want = [(r.range_id, r.start, r.stop, r.parent)
            for r in jcoord.plan_ranges(n, size)]
    assert got == want and got


def test_plan_mismatch_refuses_in_both_packages(tmp_path):
    Coordinator(str(tmp_path), 0, 10, 5, ttl=5.0).stop()
    with pytest.raises(SystemExit, match="plan mismatch"):
        Coordinator(str(tmp_path), 1, 12, 5, ttl=5.0)
    with pytest.raises(SystemExit, match="plan mismatch"):
        jcoord.Coordinator(str(tmp_path), 1, 10, 4, ttl=5.0)
    # the JAX coordinator takes the port's plan as its own
    jcoord.Coordinator(str(tmp_path), 2, 10, 5, ttl=5.0).stop()


def test_lease_claim_renew_and_expiry(tmp_path):
    ja, jb = RecordingJournal(), RecordingJournal()
    a = Coordinator(str(tmp_path), 0, 4, 4, ttl=1.0, journal=ja)
    b = Coordinator(str(tmp_path), 1, 4, 4, ttl=1.0, journal=jb)
    try:
        _quiet(a)
        _quiet(b)
        claim = a.claim_next()
        assert claim is not None and not claim.takeover
        assert claim.range.range_id == 0
        real_now = time.time
        # past the TTL, inside the grace: live
        b.store._now = lambda: real_now() + 1.4
        assert b.claim_next() is None
        # a renewal restarts the age: 1.4 s on the skewed clock again
        a._beat()
        assert b.claim_next() is None
        a.check_lease(0)
        # silence past TTL + grace: the observer steals, journaling the
        # expiry and its reassignment
        b.store._now = lambda: real_now() + 1.6
        stolen = b.claim_next()
        assert stolen is not None and stolen.takeover
        assert stolen.from_rank == 0 and stolen.range.range_id == 0
        names = [e["event"] for e in jb.events]
        assert names.count("lease_expire") == names.count(
            "chunk_reassign") == 1
        assert audit_elastic(jb.events) == []
        assert jelastic.audit_elastic(jb.events) == []
        assert (b.lease_expires_observed, b.reassignments) == (1, 1)
        # the loser's fence refuses, and its renewal marks the claim lost
        with pytest.raises(LeaseExpiredError):
            a.check_lease(0)
        with pytest.raises(LeaseExpiredError):
            a.commit_fence(0, max_idx=0, n_clusters=1)
    finally:
        a.stop()
        b.stop()


def test_double_commit_counts_once(tmp_path):
    a = Coordinator(str(tmp_path), 0, 4, 4, ttl=5.0)
    b = Coordinator(str(tmp_path), 1, 4, 4, ttl=5.0)
    payload = {"output_bytes": 3, "sha256": "abc"}
    try:
        assert sorted([a.commit(0, payload), b.commit(0, payload)]) == [
            False, True]
        assert a.done_count() == b.done_count() == 1
        assert a.all_committed() and b.all_committed()
        # the JAX package reads the marker as committed
        assert jelastic.read_done_marker(str(tmp_path), 0)["sha256"] == "abc"
    finally:
        a.stop()
        b.stop()


def test_assign_rank_is_unique_across_packages(tmp_path):
    got = [Coordinator.assign_rank(str(tmp_path)) for _ in range(2)]
    got.append(jcoord.Coordinator.assign_rank(str(tmp_path)))
    got.append(Coordinator.assign_rank(str(tmp_path)))
    assert got == [0, 1, 2, 3]


AUDIT_CASES = {
    "paired expiry": [
        {"event": "lease_expire", "rank": 1, "range": 3},
        {"event": "chunk_reassign", "range": 3, "from_rank": 1,
         "to_rank": 0}],
    "unpaired expiry": [{"event": "lease_expire", "rank": 1, "range": 3}],
    "other range": [
        {"event": "lease_expire", "rank": 1, "range": 3},
        {"event": "chunk_reassign", "range": 4, "from_rank": 1,
         "to_rank": 0}],
    "split claimed": [
        {"event": "lease_split", "range": 0, "new_range": 5, "rank": 0,
         "split_at": 8},
        {"event": "chunk_reassign", "range": 5, "from_rank": 0,
         "to_rank": 1, "via": "lease_split"}],
    "split unclaimed": [
        {"event": "lease_split", "range": 0, "new_range": 5, "rank": 0,
         "split_at": 8}],
    "one reassignment, two expiries": [
        {"event": "lease_expire", "rank": 1, "range": 2},
        {"event": "lease_expire", "rank": 3, "range": 2},
        {"event": "chunk_reassign", "range": 2, "from_rank": 1,
         "to_rank": 0}],
}


@pytest.mark.parametrize("name", sorted(AUDIT_CASES))
def test_audit_elastic_equals_the_jax_audit(name):
    events = AUDIT_CASES[name]
    got = audit_elastic(events)
    assert got == jelastic.audit_elastic(events)
    assert bool(got) == ("unpaired" in name or "unclaimed" in name
                         or "other" in name or "two" in name)


def test_verify_part_manifest_and_sha256_equal_jax(tmp_path):
    part = tmp_path / "out.part00000"
    part.write_bytes(b"BEGIN IONS\nTITLE=x\nEND IONS\n" * 3)
    good = {"output_bytes": part.stat().st_size,
            "sha256": sha256_file(str(part))}
    assert good["sha256"] == jelastic.sha256_file(str(part))
    assert sha256_file(str(part), 10) == jelastic.sha256_file(str(part), 10)
    for manifest in (good, {}, dict(good, output_bytes=1),
                     dict(good, sha256="0" * 64), dict(good, sha256="")):
        got = verify_part_manifest(str(part), manifest)
        assert got == jelastic.verify_part_manifest(str(part), manifest)
        assert (got is None) == (manifest is good)


def test_elastic_range_table_equals_jax_and_rejects_gaps(tmp_path):
    Coordinator(str(tmp_path), 0, 10, 5, ttl=5.0).stop()
    table, problem = elastic_range_table(str(tmp_path))
    assert problem is None
    assert [(r["start"], r["stop"]) for r in table] == [(0, 5), (5, 10)]
    assert (table, problem) == jelastic.elastic_range_table(str(tmp_path))
    coord = Coordinator(str(tmp_path), 0, 10, 5, ttl=5.0)
    # an overlay allocated by a donor that died before its cut: invisible
    coord.store.put_new("overlay/range_00002.json",
                        {"range_id": 2, "start": 3, "stop": 10,
                         "parent": 1})
    assert elastic_range_table(str(tmp_path))[0] == table
    # a cut whose tail overlaps the plan leaves a gap-free tiling
    # impossible: both packages refuse
    coord.store.put_new("split/range_00001.cut.deadbeef.json",
                        {"cut": 3, "new_range": 2, "stop": 10, "parent": 1})
    coord.stop()
    got = elastic_range_table(str(tmp_path))
    assert got[0] is None and "tile" in got[1]
    assert got == jelastic.elastic_range_table(str(tmp_path))


def test_journals_give_the_jax_rank_view(tmp_path):
    """A takeover and a split, journaled by a port coordinator pair: the
    JAX ``summarize_ranks`` and ``audit_elastic`` read the same view."""
    ja, jb = RecordingJournal(), RecordingJournal()
    a = Coordinator(str(tmp_path), 0, 16, 8, ttl=1.0, journal=ja,
                    chunk_hint=2)
    b = Coordinator(str(tmp_path), 1, 16, 8, ttl=1.0, journal=jb,
                    chunk_hint=2)
    try:
        _quiet(a)
        _quiet(b)
        assert a.claim_next().range.range_id == 0
        assert b.claim_next().range.range_id == 1
        # rank 1 falls silent on range 1: rank 0 takes it over
        real_now = time.time
        a.store._now = lambda: real_now() + 5.0
        a.commit_fence(0, max_idx=1, n_clusters=2,
                       chunk_t0=time.perf_counter())
        a.commit(0, {"output_bytes": 0, "sha256": "x"})
        a.release(0)
        took = a.claim_next()
        assert took.range.range_id == 1 and took.takeover
        for j in (ja, jb):
            for e in j.events:
                e.setdefault("ts", time.time())
        views = [summarize_ranks([ja.events, jb.events]),
                 jelastic.summarize_ranks([ja.events, jb.events])]
        assert views[0] == views[1]
        assert views[0]["reassignments"] == 1
        assert views[0]["unpaired_lease_expiries"] == 0
        assert views[0]["ranks"]["0"]["ranges_claimed"] == 2
        assert views[0]["ranks"]["1"]["reassigned_away"] == 1
    finally:
        a.stop()
        b.stop()


# -- the CLI -----------------------------------------------------------------


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    rng = np.random.default_rng(1515)
    spectra = []
    for i in range(N_CLUSTERS):
        c = make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 6)),
                         n_peaks=int(rng.integers(5, 60)), base_scan=100 * i)
        spectra += [Spectrum(s.mz, s.intensity, s.precursor_mz,
                             s.precursor_charge, s.rt, s.title)
                    for s in c.members]
    src = tmp_path_factory.mktemp("elastic_wl") / "clustered.mgf"
    write_mgf(spectra, src)
    return str(src)


CONFIGS = {
    "bin-mean QC": ("consensus", ["--qc-report", "{qc}"]),
    "gap-average": ("consensus", ["--method", "gap-average"]),
    "medoid QC": ("select", ["--method", "medoid", "--qc-report", "{qc}"]),
    "bin-mean int8": ("consensus", ["--precision", "int8"]),
}


def _flags(config, qc):
    command, flags = CONFIGS[config]
    return command, [f.format(qc=qc) for f in flags]


def _single(tmp_path, src, config):
    """The single-process run with a checkpoint at the same chunks."""
    command, flags = _flags(config, str(tmp_path / "single.qc.json"))
    out = tmp_path / "single.mgf"
    assert cli.main([command, src, str(out), "--device", "cpu",
                     "--checkpoint", str(tmp_path / "single.ck"),
                     "--checkpoint-every", str(EVERY), *flags]) == 0
    qc = tmp_path / "single.qc.json"
    return out.read_bytes(), qc.read_bytes() if qc.exists() else None


def _elastic(src, out, coord, config, *extra):
    command, flags = _flags(config, f"{out}.qc.json")
    return [command, src, str(out), "--device", "cpu", "--elastic",
            str(coord), "--checkpoint-every", str(EVERY), *flags, *extra]


def _merge(out, coord, config, main=cli.main):
    qc = ["--qc-report", f"{out}.qc.json"] if "QC" in config else []
    return main(["merge-parts", str(out), "--elastic", str(coord), *qc])


@pytest.mark.parametrize("config", ["bin-mean QC", "gap-average",
                                    "medoid QC"])
def test_one_rank_merges_to_the_single_process_bytes(tmp_path, workload,
                                                     config):
    single, single_qc = _single(tmp_path, workload, config)
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    assert cli.main(_elastic(workload, out, coord, config, "--journal",
                             str(tmp_path / "j.jsonl"))) == 0
    assert _merge(out, coord, config) == 0
    assert out.read_bytes() == single
    if single_qc is not None:
        assert (tmp_path / "out.mgf.qc.json").read_bytes() == single_qc
    # the JAX package's merge-parts over the port's store: the same bytes
    os.remove(out)
    assert _merge(out, coord, config, main=jcli.main) == 0
    assert out.read_bytes() == single
    events, bad = read_events(str(tmp_path / "j.jsonl.part00000"))
    assert bad == []
    end = events[-1]
    assert end["event"] == "run_end"
    assert end["elastic"]["ranges_run"] == end["elastic"]["n_ranges"] == 3
    assert end["elastic"]["range_size"] == 2 * EVERY
    # a second rank over the finished store runs nothing
    part0 = (tmp_path / "out.mgf.part00000").read_bytes()
    assert cli.main(_elastic(workload, out, coord, config, "--journal",
                             str(tmp_path / "j2.jsonl"))) == 0
    assert (tmp_path / "out.mgf.part00000").read_bytes() == part0
    events, _ = read_events(str(tmp_path / "j2.jsonl.part00001"))
    assert events[-1]["elastic"]["ranges_run"] == 0
    assert events[-1]["elastic"]["ranges_committed"] == 3


def test_merge_refuses_a_corrupt_elastic_part(tmp_path, workload, capsys):
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    assert cli.main(_elastic(workload, out, coord, "gap-average")) == 0
    part = tmp_path / "out.mgf.part00001"
    data = bytearray(part.read_bytes())
    data[10] ^= 1
    part.write_bytes(bytes(data))
    assert _merge(out, coord, "gap-average") == 1
    assert "sha256 mismatch" in capsys.readouterr().err
    assert not out.exists()


def test_elastic_refuses_append_and_checkpoint(tmp_path, workload):
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    for flag in (["--append"], ["--checkpoint", str(tmp_path / "ck")]):
        with pytest.raises(SystemExit):
            cli.main(_elastic(workload, out, coord, "gap-average", *flag))


def _changed_bits(got, want) -> int:
    n = 0
    for g, w in zip(got, want):
        for a, b in ((g.mz, w.mz), (g.intensity, w.intensity)):
            n += int(np.sum(np.asarray(a).view(np.uint64)
                            != np.asarray(b).view(np.uint64)))
    return n


@pytest.mark.parametrize("config", ["bin-mean QC", "medoid QC",
                                    "bin-mean int8"])
def test_custom_range_off_the_chunk_grid(tmp_path, workload, config):
    """``--elastic-range 12`` with ``--checkpoint-every 8``: chunks of 8
    and 4 clusters instead of the single run's 8s.  Medoid and int8
    write the same bytes; the f32 bin-mean's sums round by the new
    layouts, held at the stated tolerances with the changed peaks
    counted (pinned: on this input the CPU path's plain scans change
    none, the card's tiles may)."""
    single, single_qc = _single(tmp_path, workload, config)
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    assert cli.main(_elastic(workload, out, coord, config,
                             "--elastic-range", "12")) == 0
    assert _merge(out, coord, config) == 0
    if config != "bin-mean QC":
        assert out.read_bytes() == single
        return
    got, want = read_mgf(str(out)), read_mgf(str(tmp_path / "single.mgf"))
    assert [g.title for g in got] == [w.title for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.mz, w.mz, rtol=1e-5, atol=0)
        np.testing.assert_allclose(g.intensity, w.intensity, rtol=1e-4,
                                   atol=1e-3)
    gq = json.loads((tmp_path / "out.mgf.qc.json").read_text())
    wq = json.loads(single_qc)
    np.testing.assert_allclose(
        [r["avg_cosine"] for r in gq["clusters"]],
        [r["avg_cosine"] for r in wq["clusters"]], rtol=1e-5, atol=1e-6)
    assert _changed_bits(got, want) == CUSTOM_RANGE_CHANGED_BITS


# the f32 bin-mean peaks a 12-cluster range changes on this input on the
# CPU path (its plain versions sum each run alone, whatever the layout)
CUSTOM_RANGE_CHANGED_BITS = 0


def _victim(src, out, coord, journal, fault):
    """Rank 1 in a subprocess, killed by ``fault``: it scans from range 1,
    so it commits ranges 1 and 2 (write visits 0-2) and then range 0's
    first chunk (visit 3) before ``write:rank_kill:1:4`` kills it."""
    env = dict(os.environ, PYTHONPATH=REPO, SPECPRIDE_FAULTS=fault)
    proc = subprocess.run(
        [sys.executable, "-m", "specpride_tpu_torch",
         *_elastic(src, out, coord, "bin-mean QC", "--process-id", "1",
                   "--elastic-ttl", "0.5", "--journal", journal)],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, timeout=240)
    assert proc.returncode in (-9, 137), proc.stderr.decode()[-2000:]


@pytest.mark.parametrize("damage", ["clean", "torn"])
def test_a_killed_rank_is_taken_over_and_resumed(tmp_path, workload,
                                                 damage):
    single, single_qc = _single(tmp_path, workload, "bin-mean QC")
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    journal = str(tmp_path / "j.jsonl")
    _victim(workload, out, coord, journal, "write:rank_kill:1:4")
    assert os.path.exists(coord / "done" / "range_00001.json")
    assert os.path.exists(coord / "done" / "range_00002.json")
    assert not os.path.exists(coord / "done" / "range_00000.json")
    assert os.path.exists(coord / "leases" / "range_00000.json")
    manifest = json.loads((coord / "ck" / "range_00000.json").read_text())
    assert len(manifest["done"]) == EVERY
    part = tmp_path / "out.mgf.part00000"
    assert part.stat().st_size == manifest["output_bytes"]
    if damage == "torn":
        with open(part, "ab") as fh:
            fh.write(b"BEGIN IONS\nTITLE=torn-tail\n123 4")
    assert cli.main(_elastic(workload, out, coord, "bin-mean QC",
                             "--process-id", "0", "--elastic-ttl", "0.5",
                             "--journal", journal)) == 0
    assert _merge(out, coord, "bin-mean QC") == 0
    assert out.read_bytes() == single
    assert (tmp_path / "out.mgf.qc.json").read_bytes() == single_qc
    victim, bad = read_events(journal + ".part00001")
    assert bad == [] or all("torn" in b or "line" in b for b in bad)
    survivor, bad = read_events(journal + ".part00000")
    assert bad == []
    assert [e["kind"] for e in victim if e["event"] == "fault"] == [
        "rank_kill"]
    assert [e["event"] for e in survivor
            if e["event"] in ("lease_expire", "chunk_reassign")] == [
        "lease_expire", "chunk_reassign"]
    moved = [e for e in survivor if e["event"] == "chunk_reassign"][0]
    assert (moved["range"], moved["from_rank"], moved["to_rank"]) == (0, 1,
                                                                     0)
    assert moved["n_clusters_remaining"] == 2 * EVERY - EVERY
    merged = victim + survivor
    assert audit_elastic(merged) == [] == jelastic.audit_elastic(merged)
    assert audit_fault_recovery(merged) == []
    # the survivor resumed the range from its manifest
    assert [e["n_done"] for e in survivor if e["event"] == "resume"] == [
        EVERY]
    repairs = [e["action"] for e in survivor
               if e["event"] == "resume_repair"]
    assert repairs == (["truncate_tail"] if damage == "torn" else [])
    # the rank view: the port's stats and the JAX stats' --json agree
    got_json, want_json = tmp_path / "port.json", tmp_path / "jax.json"
    assert run_stats([journal], json_out=str(got_json),
                     out=io.StringIO()) in (0, 1)
    jrun_stats([journal], json_out=str(want_json), out=io.StringIO())
    got = json.loads(got_json.read_text())["elastic"]
    assert got == json.loads(want_json.read_text())["elastic"]
    assert got["reassignments"] == 1 and got["unpaired_lease_expiries"] == 0
    text = io.StringIO()
    run_stats([journal], out=text)
    assert "ranks: 2 seen, 1 reassignment(s)" in text.getvalue()
    assert "elastic: rank=0" in text.getvalue()


def test_a_sticky_cuda_error_ends_the_rank_without_a_commit(
        tmp_path, workload, monkeypatch):
    """A sticky CUDA error in a rank's dispatch (here the card's message
    raised on the CPU path) is never retried, never split and never
    moved to the CPU: the rank raises with nothing of the range
    committed, and a survivor takes the range and gives the bytes."""
    from specpride_tpu_torch.backends.torch_backend import TorchBackend

    single, single_qc = _single(tmp_path, workload, "bin-mean QC")
    out, coord = tmp_path / "out.mgf", tmp_path / "coord"
    calls = []

    def poisoned(self, prepared):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with monkeypatch.context() as m:
        m.setattr(TorchBackend, "run_prepared", poisoned)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            cli.main(_elastic(workload, out, coord, "bin-mean QC",
                              "--on-error", "skip", "--retries", "3"))
    assert len(calls) == 1
    assert not os.path.exists(coord / "done")
    assert os.listdir(coord / "leases") == []  # released at the rank's stop
    assert cli.main(_elastic(workload, out, coord, "bin-mean QC",
                             "--process-id", "1")) == 0
    assert _merge(out, coord, "bin-mean QC") == 0
    assert out.read_bytes() == single
    assert (tmp_path / "out.mgf.qc.json").read_bytes() == single_qc
