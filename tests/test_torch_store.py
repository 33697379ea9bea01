"""The port's coordinator store (``parallel/store.py``) against the JAX
package's, on the CPU.

One contract holds on both backends of both packages: the port's
``FsStore`` and ``HttpCasStore`` (against the port's ``CasServer``), the
JAX ``HttpCasStore`` against the port's server and the port's client
against the JAX server.  The records are the JAX package's: its
``FsStore`` reads what the port's wrote with the same payloads and ETags,
and the two servers answer one scripted sequence alike.  Every check is
an identity.  Then the store-side liveness (a skewed observer cannot
steal inside the grace), and the fault plan's ``cas_conflict`` and
``rank_slow`` kinds on the port's coordinator, paired by both
packages' ``audit_fault_recovery``."""

import time

import pytest

from specpride_tpu.parallel import store as jstore
from specpride_tpu.robustness import faults as jfaults
from specpride_tpu_torch.parallel.coordinator import Coordinator
from specpride_tpu_torch.parallel.store import (
    CasServer,
    FsStore,
    HttpCasStore,
    is_remote_spec,
    store_from_spec,
)
from specpride_tpu_torch.robustness import faults


@pytest.fixture()
def port_server():
    server = CasServer().start()
    yield server
    server.stop()


@pytest.fixture()
def jax_server():
    server = jstore.CasServer().start()
    yield server
    server.stop()


def _contract(store):
    """The step contract every backend satisfies alike."""
    # create-if-absent: exactly one winner
    assert store.put_new("leases/range_00000.json", {"nonce": "a"})
    assert not store.put_new("leases/range_00000.json", {"nonce": "b"})
    payload, etag = store.get("leases/range_00000.json")
    assert payload == {"nonce": "a"} and etag
    # touch restarts the age and keeps the content
    time.sleep(0.05)
    before = store.age_s("leases/range_00000.json")
    assert store.touch("leases/range_00000.json")
    after = store.age_s("leases/range_00000.json")
    assert after is not None and after <= before
    assert store.get("leases/range_00000.json")[0] == {"nonce": "a"}
    got = store.get_with_age("leases/range_00000.json")
    assert got[0] == {"nonce": "a"} and got[2] is not None
    # compare-and-delete: a stale token loses, the current one wins once
    assert not store.delete_if("leases/range_00000.json", "bogus-etag")
    current = store.get("leases/range_00000.json")[1]
    assert store.delete_if("leases/range_00000.json", current)
    assert store.get("leases/range_00000.json") is None
    assert not store.delete_if("leases/range_00000.json", current)
    # unconditional put: the last writer wins; a listing sees live keys
    store.put("hb/rank_00000.json", {"rank": 0})
    store.put("hb/rank_00000.json", {"rank": 0, "ts": 1})
    store.put("hb/rank_00001.json", {"rank": 1})
    assert store.list_keys("hb/") == ["hb/rank_00000.json",
                                      "hb/rank_00001.json"]
    assert store.get("hb/rank_00000.json")[0]["ts"] == 1
    # absent keys
    assert store.get("nope.json") is None
    assert store.get_with_age("nope.json") is None
    assert store.age_s("nope.json") is None
    assert not store.touch("nope.json")
    store.delete("hb/rank_00001.json")
    store.delete("hb/rank_00001.json")  # absent: no error
    assert store.list_keys("hb/") == ["hb/rank_00000.json"]


@pytest.mark.parametrize("backend", ["port-fs", "port-http",
                                     "jax-client-port-server",
                                     "port-client-jax-server"])
def test_store_contract(tmp_path, port_server, jax_server, backend):
    store = {
        "port-fs": lambda: FsStore(str(tmp_path)),
        "port-http": lambda: HttpCasStore(port_server.url),
        "jax-client-port-server": lambda: jstore.HttpCasStore(
            port_server.url),
        "port-client-jax-server": lambda: HttpCasStore(jax_server.url),
    }[backend]()
    _contract(store)


def test_jax_fs_store_reads_the_port_records(tmp_path):
    """Same files, same payloads, same content ETags; a lease the port
    created is one the JAX store cannot create again, and a JAX
    compare-and-delete with the port's ETag takes it."""
    port, jax = FsStore(str(tmp_path)), jstore.FsStore(str(tmp_path))
    records = {"plan.json": {"schema": 1, "n_clusters": 9, "range_size": 4,
                             "n_ranges": 3},
               "leases/range_00001.json": {"rank": 2, "nonce": "ab12"},
               "done/range_00000.json": {"range": 0, "sha256": "f" * 64}}
    for key, payload in records.items():
        assert port.put_new(key, payload)
    for key, payload in records.items():
        assert jax.get(key) == port.get(key)
        assert jax.get(key)[0] == payload
        assert not jax.put_new(key, {"other": 1})
    assert jax.list_keys("leases/") == port.list_keys("leases/")
    etag = port.get("leases/range_00001.json")[1]
    assert jax.delete_if("leases/range_00001.json", etag)
    assert port.get("leases/range_00001.json") is None
    # the tombstone is debris both listings skip
    assert port.list_keys("leases/") == jax.list_keys("leases/") == []
    with open(tmp_path / "leases" / "range_00001.json", "wb") as fh:
        fh.write(b'{"torn"')
    assert port.get("leases/range_00001.json") is None
    assert jax.get("leases/range_00001.json") is None


def _script(url, client):
    """One sequence of raw steps: status codes and bodies as seen."""
    s = client(url)
    out = [s.put_new("a/x.json", {"v": 1}), s.put_new("a/x.json", {"v": 2})]
    payload, etag = s.get("a/x.json")
    out += [payload, s.touch("a/x.json"), s.delete_if("a/x.json", "0-0"),
            s.get("a/x.json")[0]]
    new_etag = s.get("a/x.json")[1]
    out += [new_etag != etag, s.delete_if("a/x.json", new_etag),
            s.get("a/x.json"), s.list_keys("a/")]
    s.put("a/y.json", {"v": 3})
    out += [s.list_keys("a/"), s.list_keys("b/")]
    return out


def test_servers_answer_one_script_alike(port_server, jax_server):
    """Revision ETags: a touch (a rewrite of the same bytes) changes the
    ETag on both servers."""
    got = _script(port_server.url, HttpCasStore)
    assert got == _script(jax_server.url, jstore.HttpCasStore)
    assert got[6] is True


def test_fs_etag_stable_under_touch_distinct_per_content(tmp_path):
    store = FsStore(str(tmp_path))
    store.put_new("leases/r.json", {"nonce": "first"})
    etag = store.get("leases/r.json")[1]
    store.touch("leases/r.json")
    assert store.get("leases/r.json")[1] == etag
    store.delete("leases/r.json")
    store.put_new("leases/r.json", {"nonce": "second"})
    assert store.get("leases/r.json")[1] != etag


def test_store_from_spec_dispatch(tmp_path):
    assert isinstance(store_from_spec(str(tmp_path)), FsStore)
    assert isinstance(store_from_spec("http://127.0.0.1:1"), HttpCasStore)
    assert isinstance(store_from_spec("https://h/p"), HttpCasStore)
    for spec in ("http://x", "https://x", str(tmp_path), "rel/dir"):
        assert is_remote_spec(spec) == jstore.is_remote_spec(spec)
    assert store_from_spec(str(tmp_path)).describe() == \
        jstore.store_from_spec(str(tmp_path)).describe()


def test_http_age_is_the_server_clock(port_server):
    store = HttpCasStore(port_server.url)
    store.put("hb/r.json", {"rank": 0})
    age = store.age_s("hb/r.json")
    assert age is not None and age < 1.0
    time.sleep(0.15)
    assert store.age_s("hb/r.json") > age


def test_skewed_observer_cannot_steal_inside_grace(tmp_path):
    """TTL 1 s, grace 0.5 s: an observer 1.2 s ahead sees the lease past
    its TTL but inside the grace and takes nothing; 2 s ahead it may."""
    holder = Coordinator(str(tmp_path), 0, 4, 4, ttl=1.0)
    assert holder.claim_next() is not None
    observer = Coordinator(str(tmp_path), 1, 4, 4, ttl=1.0)
    real_now = time.time
    try:
        observer.store._now = lambda: real_now() + 1.2
        assert observer.claim_next() is None
        holder.check_lease(0)
        observer.store._now = lambda: real_now() + 2.0
        stolen = observer.claim_next()
        assert stolen is not None and stolen.takeover
    finally:
        holder.stop()
        observer.stop()


class RecordingJournal:
    enabled = True

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        rec = {"event": event, "mono": time.perf_counter(), **fields}
        self.events.append(rec)
        return rec

    def close(self):
        pass


def test_cas_conflict_injection_loses_gracefully(tmp_path):
    """An injected ``cas`` conflict loses the claim like a real race: no
    lease, a ``retry`` at ``cas``, and the next scan claims; both
    packages' audits pair the fault."""
    journal = RecordingJournal()
    plan = faults.FaultPlan.parse("cas:cas_conflict:1", seed=0)
    prev = faults.install(plan, journal=journal)
    try:
        coord = Coordinator(str(tmp_path), 0, 4, 4, ttl=5.0,
                            journal=journal)
        try:
            assert coord.claim_next() is None
            assert coord.cas_conflicts == 1
            assert coord.claim_next() is not None  # MAX 1: clean scan
            retries = [e for e in journal.events
                       if e["event"] == "retry" and e["site"] == "cas"]
            assert len(retries) == 1
            fired = [e for e in journal.events if e["event"] == "fault"]
            assert [f["kind"] for f in fired] == ["cas_conflict"]
            assert faults.audit_fault_recovery(journal.events) == []
            assert jfaults.audit_fault_recovery(journal.events) == []
        finally:
            coord.stop()
    finally:
        faults.install(prev)


def test_rank_slow_stalls_without_failing(monkeypatch):
    monkeypatch.setenv("SPECPRIDE_SLOW_S", "0.05")
    plan = faults.FaultPlan.parse("dispatch:rank_slow:1:0:3", seed=0)
    t0 = time.perf_counter()
    for _ in range(3):
        plan.check("dispatch")
    assert time.perf_counter() - t0 >= 0.15
    assert plan.fired_by_site == {"dispatch": 3}
    events = [{"event": "fault", "site": "dispatch", "kind": "rank_slow",
               "visit": i, "mono": float(i)} for i in range(3)]
    assert faults.audit_fault_recovery(events) == []
    assert jfaults.audit_fault_recovery(events) == []


def test_rank_kill_pairs_only_with_a_reassignment():
    """A killed rank's recovery is a survivor's ``chunk_reassign`` (no
    mono order: another process's journal); a reassignment never backs
    another kind of fault.  The JAX audit decides alike."""
    kill = {"event": "fault", "site": "write", "kind": "rank_kill",
            "visit": 3, "mono": 50.0}
    io = {"event": "fault", "site": "write", "kind": "io", "visit": 0,
          "mono": 1.0}
    moved = {"event": "chunk_reassign", "range": 2, "from_rank": 1,
             "to_rank": 0, "mono": 2.0}
    for events, want in (([kill, moved], []), ([kill], [kill]),
                         ([io, moved], [io]),
                         ([io, kill, moved], [io])):
        assert faults.audit_fault_recovery(events) == want
        assert jfaults.audit_fault_recovery(events) == want
