"""The port's result cache (``--result-cache``, ``cache/``) against the JAX
package's, on the CPU.

The cases mirror ``tests/test_result_cache.py``'s local-tier ones: the
content digest gives the JAX package's hex on the same clusters (peak
order and spelling invariant, member order and values content); the
port's entries pass the JAX seal check and decode to the same arrays
there (and the JAX package's pass the port's); the local tier's atomic
commit, quarantine of a corrupt or misfiled entry as a miss and its LRU
cap; the run context's gates and keys.  Then the CLI: for bin-mean,
gap-average and medoid at f32, bf16 and int8, a cold and a warm run with
the cache write the output and QC report bytes of a run without it, the
warm run journals no ``dispatch`` event, a corrupt tier recomputes the
same bytes, a change of method, config or precision misses, and a killed
run resumed with the cache on gives the bytes of a run without it."""

import json
import os

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu.cache import digest as jdigest
from specpride_tpu.cache import result_cache as jrc
from specpride_tpu.serve import batcher as jbatcher
from specpride_tpu.cli import build_parser as jbuild_parser
from specpride_tpu_torch import cli
from specpride_tpu_torch.cache import digest as cd
from specpride_tpu_torch.cache import result_cache as rc
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.io.mgf import write_mgf
from specpride_tpu_torch.observability.journal import read_events
from specpride_tpu_torch.serve import batcher

METHODS = [("bin-mean", "consensus"), ("gap-average", "consensus"),
           ("medoid", "select")]
N_CLUSTERS = 8


@pytest.fixture(autouse=True)
def _fresh_singleton():
    rc.reset()
    yield
    rc.reset()


def _port_cluster(c) -> Cluster:
    """A JAX-package cluster (``conftest.make_cluster``) as the port's."""
    return Cluster(c.cluster_id, [
        Spectrum(mz=s.mz, intensity=s.intensity,
                 precursor_mz=s.precursor_mz,
                 precursor_charge=s.precursor_charge, rt=s.rt,
                 title=s.title, extra=dict(s.extra))
        for s in c.members])


def _respell(s: Spectrum, perm) -> Spectrum:
    return Spectrum(mz=np.asarray(s.mz)[perm],
                    intensity=np.asarray(s.intensity)[perm],
                    precursor_mz=s.precursor_mz,
                    precursor_charge=s.precursor_charge, rt=s.rt,
                    title=s.title, extra=dict(s.extra))


# -- digests -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 17, 40])
def test_cluster_digest_is_the_jax_hex(seed):
    rng = np.random.default_rng(seed)
    jc = make_cluster(rng, f"c-{seed}", n_members=int(rng.integers(1, 5)),
                      n_peaks=int(rng.integers(5, 40)))
    c = _port_cluster(jc)
    assert cd.cluster_digest(c) == jdigest.cluster_digest(jc)
    # spelling-invariant: the peaks in another order digest alike
    shuffled = Cluster(c.cluster_id, [
        _respell(s, rng.permutation(s.n_peaks)) for s in c.members])
    assert cd.cluster_digest(shuffled) == cd.cluster_digest(c)
    key = ("cfg", "bin-mean", "0123abcd", "bf16", rc.CODE_VERSION)
    assert cd.result_key(*key) == jdigest.result_key(*key)


def test_member_order_titles_and_values_are_content(rng):
    c = _port_cluster(make_cluster(rng, "c-1", n_members=3, n_peaks=10))
    base = cd.cluster_digest(c)
    assert cd.cluster_digest(
        Cluster(c.cluster_id, list(reversed(c.members)))) != base
    m0 = c.members[0]
    retitled = Spectrum(mz=m0.mz, intensity=m0.intensity,
                        precursor_mz=m0.precursor_mz,
                        precursor_charge=m0.precursor_charge, rt=m0.rt,
                        title="other-title")
    assert cd.cluster_digest(
        Cluster(c.cluster_id, [retitled, *c.members[1:]])) != base
    bumped = Spectrum(mz=m0.mz, intensity=m0.intensity * 2.0,
                      precursor_mz=m0.precursor_mz,
                      precursor_charge=m0.precursor_charge, rt=m0.rt,
                      title=m0.title)
    assert cd.cluster_digest(
        Cluster(c.cluster_id, [bumped, *c.members[1:]])) != base


def test_file_digest_is_content_only(tmp_path):
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    a.write_bytes(b"same bytes")
    b.write_bytes(b"same bytes")
    assert cd.file_digest(str(a)) == cd.file_digest(str(b)) \
        == jdigest.file_digest(str(a))
    assert cd.file_digest(str(tmp_path / "missing")) is None


def test_config_digest_is_the_jax_digest(tmp_path):
    """The same flags key alike in both packages, with and without QC."""
    for flags in (["--method", "bin-mean"],
                  ["--method", "gap-average", "--qc-report", "q.json"],
                  ["--method", "bin-mean", "--bin-size", "0.05",
                   "--qc-report", "q.json", "--qc-normalization", "sqrt"]):
        argv = ["consensus", "in.mgf", "out.mgf", *flags]
        port = batcher.config_digest(cli.build_parser().parse_args(argv),
                                     "consensus")
        jax = jbatcher.config_digest(jbuild_parser().parse_args(argv),
                                     "consensus")
        assert port == jax and port is not None
    argv = ["select", "in.mgf", "out.mgf", "--method", "medoid"]
    assert batcher.config_digest(cli.build_parser().parse_args(argv),
                                 "select") == jbatcher.config_digest(
        jbuild_parser().parse_args(argv), "select")


# -- entries -----------------------------------------------------------------


def _entry_for(rng, key, cid="c-e"):
    c = _port_cluster(make_cluster(rng, cid, n_members=2, n_peaks=10))
    return c, rc.make_entry(key, c.members[0], c, 0.99)


def test_entries_pass_the_jax_seal_and_decode_alike(rng):
    key = "a" * 64
    c, entry = _entry_for(rng, key)
    assert jrc._verify(entry) and rc._verify(entry)
    got = jrc.decode_rep(entry["rep"])
    np.testing.assert_array_equal(got.mz, c.members[0].mz)
    np.testing.assert_array_equal(got.intensity, c.members[0].intensity)
    assert (got.title, got.precursor_mz, got.precursor_charge, got.rt) == (
        c.members[0].title, c.members[0].precursor_mz,
        c.members[0].precursor_charge, c.members[0].rt)
    jc = make_cluster(rng, "c-j", n_members=2, n_peaks=10)
    jentry = jrc.make_entry(key, jc.members[1], jc, None)
    assert rc._verify(jentry)
    assert json.dumps(rc.make_entry(key, _port_cluster(jc).members[1],
                                    _port_cluster(jc), None),
                      sort_keys=True) == json.dumps(jentry, sort_keys=True)
    assert not rc._verify(dict(entry, cosine=0.5))


# -- the local tier ----------------------------------------------------------


class TestLocalTier:
    def test_roundtrip_and_decode(self, tmp_path, rng):
        tier = rc.LocalTier(str(tmp_path))
        key = "a" * 64
        c, entry = _entry_for(rng, key)
        tier.put(key, entry)
        got = tier.get(key)
        assert got is not None and got is not rc.CORRUPT
        rep = rc.decode_rep(got["rep"])
        np.testing.assert_array_equal(rep.mz, c.members[0].mz)
        np.testing.assert_array_equal(rep.intensity, c.members[0].intensity)
        assert rep.title == c.members[0].title
        assert tier.info()["entries"] == 1
        # the JAX package's tier reads the port's entry
        assert jrc.LocalTier(str(tmp_path)).get(key)["key"] == key

    def test_tmp_debris_never_parses_as_entry(self, tmp_path, rng):
        tier = rc.LocalTier(str(tmp_path))
        key = "b" * 64
        _, entry = _entry_for(rng, key)
        (tmp_path / ".tmp-dead1234.part").write_text(json.dumps(entry)[:40])
        assert tier.get(key) is None
        assert tier.info()["entries"] == 0
        tier.put(key, entry)
        assert tier.get(key) is not rc.CORRUPT
        assert tier.info()["entries"] == 1

    def test_corrupt_entry_quarantined_as_miss(self, tmp_path, rng):
        tier = rc.LocalTier(str(tmp_path))
        key = "c" * 64
        _, entry = _entry_for(rng, key)
        tier.put(key, entry)
        path = tmp_path / (key + ".json")
        path.write_text(path.read_text().replace('"cosine":0.99',
                                                 '"cosine":0.5'))
        assert tier.get(key) is rc.CORRUPT
        assert not path.exists()
        assert (tmp_path / (key + ".json.corrupt")).exists()
        assert tier.get(key) is None
        cache = rc.ResultCache(rc.LocalTier(str(tmp_path)))
        tier.put(key, entry)
        (tmp_path / (key + ".json")).write_text("{not json")
        assert cache.lookup(key) == (None, "corrupt")

    def test_wrong_key_entry_is_corrupt(self, tmp_path, rng):
        tier = rc.LocalTier(str(tmp_path))
        key, other = "d" * 64, "e" * 64
        _, entry = _entry_for(rng, key)
        tier.put(key, entry)
        os.replace(tmp_path / (key + ".json"), tmp_path / (other + ".json"))
        assert tier.get(other) is rc.CORRUPT

    def test_lru_bound_and_eviction_accounting(self, tmp_path, rng):
        tier = rc.LocalTier(str(tmp_path))
        keys = [ch * 64 for ch in "fghi"]
        entries = {k: _entry_for(rng, k, cid=f"c-{k[0]}")[1] for k in keys}
        tier.put(keys[0], entries[keys[0]])
        size = os.path.getsize(tmp_path / (keys[0] + ".json"))
        tier.max_bytes = int(size * 2.5)  # room for two entries
        for i, k in enumerate(keys[1:], 1):
            tier.put(k, entries[k])
            os.utime(tmp_path / (k + ".json"), (i, i))
        os.utime(tmp_path / (keys[0] + ".json"), (0, 0))
        tier.put(keys[0], entries[keys[0]])  # a put touches: newest
        info = tier.info()
        assert info["bytes"] <= tier.max_bytes and info["entries"] == 2
        assert tier.evictions == 2 and tier.evicted_bytes > 0
        assert tier.get(keys[1]) is None  # the oldest mtime went first
        assert tier.get(keys[0]) not in (None, rc.CORRUPT)


# -- the run context ---------------------------------------------------------


class TestRuntime:
    def test_parse_spec(self):
        assert rc.parse_spec("/tmp/x") == ("/tmp/x", rc.DEFAULT_MAX_MB)
        assert rc.parse_spec("/tmp/x:64") == ("/tmp/x", 64)

    def test_configure_active_reset(self, tmp_path):
        assert rc.active() is None
        cache = rc.configure(str(tmp_path / "t"))
        assert rc.active() is cache
        rc.configure(None)
        assert rc.active() is None

    def test_runtime_for_gates(self, tmp_path):
        tier = str(tmp_path / "t")

        def _args(extra):
            return cli.build_parser().parse_args(
                ["consensus", "in.mgf", "out.mgf", *extra])

        cached = _args(["--method", "bin-mean", "--result-cache", tier])
        assert rc.runtime_for(cached, "evaluate") is None
        best = _args(["--method", "bin-mean", "--result-cache", tier])
        best.method = "best"  # a per-run score table: never cacheable
        assert rc.runtime_for(best, "consensus") is None
        assert rc.runtime_for(_args(["--method", "bin-mean"]),
                              "consensus") is None
        ctx = rc.runtime_for(cached, "consensus")
        assert ctx is not None and ctx.method == "bin-mean"
        assert ctx.precision == "f32"
        rc.configure(tier)  # the process singleton stands in for the flag
        assert rc.runtime_for(_args(["--method", "bin-mean"]),
                              "consensus") is not None

    def test_keys_split_on_qc_config_and_precision(self, tmp_path, rng):
        tier = str(tmp_path / "t")
        base = ["consensus", "in.mgf", "out.mgf", "--method", "bin-mean",
                "--result-cache", tier]
        c = _port_cluster(make_cluster(rng, "c-1", n_members=2, n_peaks=10))
        keys = {
            rc.runtime_for(cli.build_parser().parse_args(base + extra),
                           "consensus").key_of(c)
            for extra in ([], ["--qc-report", "q.json"],
                          ["--precision", "bf16"], ["--bin-size", "0.05"])
        }
        assert len(keys) == 4


# -- the CLI -----------------------------------------------------------------


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    rng = np.random.default_rng(424)
    clusters = [_port_cluster(make_cluster(rng, f"cluster-{i}",
                                           n_members=1 + i % 4, n_peaks=20))
                for i in range(N_CLUSTERS)]
    src = tmp_path_factory.mktemp("rc_wl") / "clustered.mgf"
    write_mgf([s for c in clusters for s in c.members], src)
    return str(src)


def _run(command, src, out, *flags):
    assert cli.main([command, src, str(out), "--device", "cpu",
                     "--checkpoint-every", "3", *flags]) == 0


def _events(path):
    events, bad = read_events(str(path))
    assert bad == []
    return events


def _rc_event(events):
    got = [e for e in events if e["event"] == "result_cache"]
    return got[-1] if got else None


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("method,command", METHODS)
def test_off_cold_warm_bytes_and_qc(tmp_path, workload, method, command,
                                    precision):
    tier = tmp_path / "tier"
    outs, qcs = {}, {}
    for mode in ("off", "cold", "warm"):
        out, qc = tmp_path / f"{mode}.mgf", tmp_path / f"{mode}.qc.json"
        flags = ["--method", method, "--precision", precision,
                 "--qc-report", str(qc), "--journal",
                 str(tmp_path / f"{mode}.jsonl")]
        if mode != "off":
            flags += ["--result-cache", str(tier)]
        _run(command, workload, out, *flags)
        outs[mode], qcs[mode] = out.read_bytes(), qc.read_bytes()
    assert outs["cold"] == outs["off"] and outs["warm"] == outs["off"]
    assert qcs["cold"] == qcs["off"] and qcs["warm"] == qcs["off"]
    off = _events(tmp_path / "off.jsonl")
    assert _rc_event(off) is None  # cache off: no event at all
    cold = _events(tmp_path / "cold.jsonl")
    ev = _rc_event(cold)
    assert (ev["hits"], ev["misses"], ev["populated"]) == (0, N_CLUSTERS,
                                                           N_CLUSTERS)
    assert (sum(e["event"] == "dispatch" for e in cold)
            == sum(e["event"] == "dispatch" for e in off))
    warm = _events(tmp_path / "warm.jsonl")
    ev = _rc_event(warm)
    assert (ev["hits"], ev["misses"]) == (N_CLUSTERS, 0)
    assert ev["bytes_saved"] > 0
    # the warm run dispatched nothing: not the method, not the QC (the
    # precision gate's twins journal nowhere)
    assert not any(e["event"] == "dispatch" for e in warm)
    end = warm[-1]
    assert end["event"] == "run_end"
    assert end["counters"]["result_cache_hits"] == N_CLUSTERS


def test_corrupt_tier_recomputes_identical(tmp_path, workload):
    tier = tmp_path / "tier"
    base = tmp_path / "base.mgf"
    _run("consensus", workload, base, "--result-cache", str(tier))
    for name in os.listdir(tier):
        if name.endswith(".json"):
            path = tier / name
            path.write_text(path.read_text()[:-20] + "garbage")
    out, jp = tmp_path / "after.mgf", tmp_path / "after.jsonl"
    _run("consensus", workload, out, "--result-cache", str(tier),
         "--journal", str(jp))
    assert out.read_bytes() == base.read_bytes()
    events = _events(jp)
    ev = _rc_event(events)
    assert ev["hits"] == 0 and ev["corrupt"] == N_CLUSTERS
    assert any(e["event"] == "dispatch" for e in events)
    assert sum(n.endswith(".corrupt") for n in os.listdir(tier)) == N_CLUSTERS


@pytest.mark.parametrize("change", [
    ["--method", "gap-average"], ["--bin-size", "0.05"],
    ["--precision", "bf16"], ["--qc-report", "QC"]])
def test_a_change_of_method_config_or_precision_misses(tmp_path, workload,
                                                       change):
    tier = tmp_path / "tier"
    _run("consensus", workload, tmp_path / "a.mgf", "--result-cache",
         str(tier))
    change = [str(tmp_path / "qc.json") if f == "QC" else f for f in change]
    jp = tmp_path / "b.jsonl"
    _run("consensus", workload, tmp_path / "b.mgf", "--result-cache",
         str(tier), "--journal", str(jp), *change)
    ev = _rc_event(_events(jp))
    assert (ev["hits"], ev["misses"]) == (0, N_CLUSTERS)


def test_stats_renders_the_result_cache_line(tmp_path, workload, capsys):
    tier, jp = tmp_path / "tier", tmp_path / "j.jsonl"
    for name in ("one.mgf", "two.mgf"):
        _run("consensus", workload, tmp_path / name, "--result-cache",
             str(tier), "--journal", str(jp))
    capsys.readouterr()
    agg = tmp_path / "agg.json"
    assert cli.main(["stats", str(jp), "--json", str(agg)]) == 0
    text = capsys.readouterr().out
    assert "result-cache:" in text
    assert f"hits={N_CLUSTERS}" in text and "hit_rate=100.0%" in text
    doc = json.loads(agg.read_text())
    assert doc["runs"][-1]["result_cache"]["hit_rate"] == 1.0
    # the JAX package's stats reads the port's result_cache event alike
    from specpride_tpu.observability import stats_cli as jstats_cli

    jagg = tmp_path / "jagg.json"
    assert jstats_cli.run_stats([str(jp)], json_out=str(jagg)) == 0
    assert (json.loads(jagg.read_text())["runs"][-1]["result_cache"]
            == doc["runs"][-1]["result_cache"])


@pytest.mark.parametrize("warm", [False, True])
def test_kill_and_resume_with_the_cache_gives_the_cache_off_bytes(
        tmp_path, workload, warm):
    """A write fault with no retries kills the run after two chunks were
    committed (their entries populated after the append); the resume,
    cache on, skips the committed chunks and computes (or, ``warm``,
    replays from a full earlier run's entries) the rest."""
    off, off_qc = tmp_path / "off.mgf", tmp_path / "off.qc.json"
    _run("consensus", workload, off, "--qc-report", str(off_qc))
    tier = tmp_path / "tier"
    if warm:
        _run("consensus", workload, tmp_path / "earlier.mgf",
             "--result-cache", str(tier), "--qc-report",
             str(tmp_path / "earlier.qc.json"))
    out, ck = tmp_path / "out.mgf", tmp_path / "ck.json"
    qc = tmp_path / "out.qc.json"
    flags = ["--result-cache", str(tier), "--checkpoint", str(ck),
             "--qc-report", str(qc)]
    with pytest.raises(OSError):
        cli.main(["consensus", workload, str(out), "--device", "cpu",
                  "--checkpoint-every", "3", *flags, "--retries", "0",
                  "--inject-faults", "write:io:1:2:1"])
    assert json.loads(ck.read_text())["done"]
    jp = tmp_path / "resume.jsonl"
    _run("consensus", workload, out, *flags, "--journal", str(jp))
    assert out.read_bytes() == off.read_bytes()
    assert qc.read_bytes() == off_qc.read_bytes()
    ev = _rc_event(_events(jp))
    assert ev["hits"] + ev["misses"] == N_CLUSTERS - 6
    assert ev["hits"] == (N_CLUSTERS - 6 if warm else 0)


# -- the shared tier (--result-store) ----------------------------------------


def test_shared_tier_contract_and_cross_package_reads(tmp_path, rng):
    """The port's ``SharedTier`` on a directory store: a put is
    create-if-absent under ``rc-<key>``, the JAX ``SharedTier`` reads it
    (and the port reads the JAX one's), a tampered entry is a corrupt
    miss left in place, and a shared hit is copied to the local tier."""
    from specpride_tpu.parallel.store import FsStore as JFsStore
    from specpride_tpu_torch.parallel.store import FsStore

    shared = rc.SharedTier(FsStore(str(tmp_path / "store")))
    jshared = jrc.SharedTier(JFsStore(str(tmp_path / "store")))
    key, jkey = "d" * 64, "e" * 64
    c, entry = _entry_for(rng, key)
    shared.put(key, entry)
    shared.put(key, dict(entry, cosine=0.1))  # the first put stays
    assert os.path.exists(tmp_path / "store" / f"rc-{key}")
    assert jshared.get(key) == shared.get(key) == entry
    _, jentry = _entry_for(rng, jkey, cid="c-j")
    jshared.put(jkey, jentry)
    assert shared.get(jkey) == jentry
    assert shared.describe() == jshared.describe()
    path = tmp_path / "store" / f"rc-{key}"
    path.write_text(path.read_text().replace('"cosine": 0.99',
                                             '"cosine": 0.5'))
    assert shared.get(key) is rc.CORRUPT and path.exists()
    cache = rc.ResultCache(rc.LocalTier(str(tmp_path / "local")), shared)
    assert cache.lookup(key) == (None, "corrupt")
    doc, tier = cache.lookup(jkey)
    assert doc == jentry and tier == "shared"
    assert cache.lookup(jkey) == (jentry, "local")
    assert cache.info()["shared"] == f"filesystem:{tmp_path / 'store'}"


@pytest.mark.parametrize("method,command", METHODS)
def test_a_fleet_warms_through_the_shared_tier(tmp_path, workload, method,
                                               command):
    """A cold run with local tier A and ``--result-store S`` populates S;
    a run with a fresh local tier B and S replays every cluster from S
    (``shared_hits``), dispatches nothing and writes the bytes of a run
    without the cache.  The JAX ``SharedTier`` finds every entry under
    the JAX key of the same cluster and configuration."""
    from specpride_tpu.parallel.store import FsStore as JFsStore

    store = str(tmp_path / "store")
    outs = {}
    for mode, tier in (("off", None), ("cold", "A"), ("warm", "B")):
        out, qc = tmp_path / f"{mode}.mgf", tmp_path / f"{mode}.qc.json"
        flags = ["--method", method, "--qc-report", str(qc), "--journal",
                 str(tmp_path / f"{mode}.jsonl")]
        if tier:
            flags += ["--result-cache", str(tmp_path / tier),
                      "--result-store", store]
        _run(command, workload, out, *flags)
        outs[mode] = (out.read_bytes(), qc.read_bytes())
    assert outs["cold"] == outs["off"] == outs["warm"]
    ev = _rc_event(_events(tmp_path / "warm.jsonl"))
    assert (ev["hits"], ev["shared_hits"], ev["misses"]) == (
        N_CLUSTERS, N_CLUSTERS, 0)
    assert not any(e["event"] == "dispatch"
                   for e in _events(tmp_path / "warm.jsonl"))
    args = jbuild_parser().parse_args([
        command, workload, "o.mgf", "--method", method, "--qc-report",
        "q.json", "--checkpoint-every", "3"])
    jctx = jrc.RunContext(jrc.ResultCache(jrc.LocalTier(str(tmp_path / "x"))),
                          method, jbatcher.config_digest(args, command),
                          "f32")
    from specpride_tpu.io.mgf import read_mgf as jread_mgf
    from specpride_tpu.data.peaks import group_into_clusters as jgroup

    jshared = jrc.SharedTier(JFsStore(store))
    clusters = jgroup(jread_mgf(workload, use_native=False))
    assert len(clusters) == N_CLUSTERS
    for c in clusters:
        doc = jshared.get(jctx.key_of(c))
        assert doc is not None and doc is not jrc.CORRUPT
        assert jrc._verify(doc)
