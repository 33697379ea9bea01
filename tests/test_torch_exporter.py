"""The port's metrics registry and live exporter
(``observability/registry.py``, ``observability/exporter.py``) against
the JAX package's, on the CPU.

The same observations render the same Prometheus text in both
registries (histograms with exemplars, ``render_labeled``'s worker
labels, ``to_json``); the port's serving exposition passes the JAX
package's ``validate_exposition`` and carries the JAX daemon's series
less ``JAX_ONLY_SERIES``; both packages' ``parse_exposition`` agree on
the same text; ``/metrics`` and ``/healthz`` answer on a local port; a
drained daemon's ``--metrics-out`` renders the zero-at-start families at
0 and counts the jobs it served; and the backend's dispatches land in
the ``specpride_dispatch_seconds`` histogram (host time, one
observation per dispatch)."""

import fnmatch
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu.io.mgf import write_mgf as jwrite_mgf
from specpride_tpu.observability import exporter as jexporter
from specpride_tpu.observability import registry as jregistry
from specpride_tpu.serve import ingest_cache as jingest_cache
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.observability import exporter, registry
from specpride_tpu_torch.serve import client as sc
from specpride_tpu_torch.serve import ingest_cache
from specpride_tpu_torch.serve.daemon import ServeDaemon

# the JAX daemon's series whose source the port has not got: the XLA
# compile cache and the bucket plan cache (no counterpart)
JAX_ONLY_SERIES = (
    "specpride_compile_cache_*",
    "specpride_plan_cache_*",
)


def _fill(mod):
    """The same operations on a registry of ``mod``."""
    r = mod.MetricsRegistry()
    c = r.counter("specpride_dispatches_total", "dispatches",
                  labels=("kernel",))
    c.inc(3, kernel="a")
    c.inc(0, kernel='we"ird\\name')
    g = r.gauge("specpride_serve_inflight_worker", "occupancy",
                labels=("worker",))
    g.set(1, worker="0")
    g.set(0.25, worker="1")
    g.zero_all()
    g.set(2, worker="1")
    h = r.histogram("specpride_dispatch_seconds", "dispatch",
                    labels=("kernel",))
    for v, ex in ((0.0004, None), (0.02, {"trace_id": "a" * 32}),
                  (30.0, {"trace_id": "b" * 32}), (0.02, None)):
        h.observe(v, exemplar=ex, kernel="a")
    q = r.gauge("specpride_serve_queue_depth_client", "depth",
                labels=("client",))
    q.set(4, client="gone")
    q.clear()
    q.set(1, client="team # 1")
    return r


def test_registry_renders_as_the_jax_registry():
    port, jax = _fill(registry), _fill(jregistry)
    assert port.to_prometheus_text() == jax.to_prometheus_text()
    assert port.to_json() == jax.to_json()
    assert port.sum_counter("specpride_dispatches_total") == 3.0
    assert port.sum_counter("specpride_dispatch_seconds") == 0.0
    assert registry.render_labeled({"0": port, "1": _fill(registry)}) == \
        jregistry.render_labeled({"0": jax, "1": _fill(jregistry)})
    text = port.to_prometheus_text()
    assert jexporter.validate_exposition(text) == []
    assert ' # {trace_id="' + "b" * 32 + '"} 30' in text


def test_render_labeled_refuses_disagreeing_registries():
    a, b = registry.MetricsRegistry(), registry.MetricsRegistry()
    a.counter("specpride_x_total", labels=("kernel",)).inc(1, kernel="k")
    b.gauge("specpride_x_total").set(1)
    with pytest.raises(ValueError, match="disagrees"):
        registry.render_labeled({"0": a, "1": b})


def test_device_summary_since_a_snapshot():
    r = registry.MetricsRegistry()
    d = r.counter("specpride_dispatches_total", labels=("kernel",))
    d.inc(5, kernel="a")
    snap = registry.device_counters_snapshot(r)
    d.inc(2, kernel="b")
    assert registry.device_summary(r)["dispatches"] == 7
    assert registry.device_summary(r, since=snap)["dispatches"] == 2
    assert registry.device_summary(r, since=snap) == \
        jregistry.device_summary(_as_jax(r), since=snap)


def _as_jax(r):
    j = jregistry.MetricsRegistry()
    for name, samples in r.to_json().items():
        c = j.counter(name, labels=("kernel",))
        for key, v in samples.items():
            c.inc(v, kernel=key)
    return j


def _series_names(text):
    samples, problems = jexporter.parse_exposition(text)
    assert problems == []
    return {name for name, _ in samples}


def _base(name):
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def test_serving_exposition_is_the_jax_series_less_jax_only():
    """A telemetry plane that served a job and a batch: the port's
    exposition validates under the JAX checker, and its series are the
    JAX daemon's, less ``JAX_ONLY_SERIES``.  Both ingest caches start
    empty: their totals are process-wide, and an earlier test in this
    process may have served jobs."""
    ingest_cache.clear()
    jingest_cache.clear()
    texts = []
    for mod in (exporter, jexporter):
        t = mod.ServeTelemetry(slo={"bin-mean": 0.5, "*": 10.0})
        t.job_done(command="consensus", method="bin-mean", status="done",
                   wall_s=0.7, queue_wait_s=0.1, worker=0,
                   trace_id="c" * 32,
                   summary={"phases_s": {"pack": 0.2, "compute": 0.3}})
        t.job_rejected("queue_full")
        t.batch_dispatch(n_jobs=2, n_clusters=10, window_wait_s=0.01,
                         occupancy_frac=0.5)
        t.inflight_worker.set(1, worker="0")
        texts.append(t.exposition())
    port, jax = texts
    assert jexporter.validate_exposition(port) == []
    assert exporter.validate_exposition(port) == []
    port_names = {_base(n) for n in _series_names(port)}
    jax_names = {_base(n) for n in _series_names(jax)}
    jax_only = {n for n in jax_names
                if any(fnmatch.fnmatchcase(n, p) for p in JAX_ONLY_SERIES)}
    assert jax_only  # the list names real JAX series
    assert port_names == jax_names - jax_only
    for pattern in exporter.ZERO_AT_START_FAMILIES:
        assert fnmatch.filter(port_names, pattern), pattern


@pytest.mark.parametrize("text", [
    "# TYPE a_total counter\na_total{x=\"1\"} 2\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1 # {trace_id=\"ab\"} 0.5\n"
    "h_bucket{le=\"+Inf\"} 2\nh_sum 3\nh_count 2\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 3\nh_bucket{le=\"+Inf\"} 2\n"
    "h_sum 3\nh_count 2\n",  # not cumulative
    "# TYPE g gauge\ng{c=\"team # 1\"} 1\ng{c=\"team # 1\"} 2",  # dup, no \n
    "g 1\n# TYPE g gauge\n",  # TYPE after samples
    "# TYPE g gauge\ng{a=\"1\",a=\"2\"} 1\n",  # duplicate label
])
def test_parse_exposition_agrees_with_jax(text):
    assert exporter.parse_exposition_full(text) == \
        jexporter.parse_exposition_full(text)
    assert exporter.validate_exposition(text) == \
        jexporter.validate_exposition(text)


def test_metrics_and_healthz_answer_on_a_local_port():
    t = exporter.ServeTelemetry()
    health = {"ok": True}
    ex = exporter.MetricsExporter(
        t.exposition, port=0,
        health=lambda: (health["ok"], "workers=1")).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ex.port}/metrics", timeout=10) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert "specpride_serve_batch_dispatches_total 0" in body
        assert jexporter.validate_exposition(body) == []
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ex.port}/healthz", timeout=10) as r:
            assert r.status == 200 and r.read() == b"ok workers=1\n"
        health["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{ex.port}/healthz",
                                   timeout=10)
        assert e.value.code == 503
    finally:
        ex.stop()


def test_drained_daemon_textfile_counts_its_jobs(tmp_path):
    """A two-lane daemon with ``--metrics-port 0 --metrics-out``: the
    drain snapshot validates, renders the zero-at-start families and
    every client ever admitted at 0, counts the jobs served, and carries
    each lane's dispatch histogram under a ``worker`` label."""
    rng = np.random.default_rng(11)
    src = tmp_path / "in.mgf"
    jwrite_mgf([s for i in range(5)
                for s in make_cluster(rng, f"c-{i}", n_members=3,
                                      n_peaks=20).members], src)
    out = tmp_path / "m.prom"
    d = ServeDaemon(str(tmp_path / "s.sock"), device="cpu", workers=2,
                    metrics_port=0, metrics_out=str(out), slo={"*": 60.0})
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    try:
        assert sc.wait_for_socket(d.socket_path, timeout=60)
        for i in range(3):
            term = sc.submit_wait(d.socket_path, [
                "consensus", str(src), str(tmp_path / f"o{i}.mgf"),
                "--qc-report", str(tmp_path / f"q{i}.json")],
                client=f"tenant{i % 2}", timeout=60)
            assert term["status"] == "done", term
        assert d.wait_idle(timeout=30)
        with urllib.request.urlopen(d.exporter.url, timeout=10) as r:
            live = r.read().decode()
        assert jexporter.validate_exposition(live) == []
    finally:
        d.drain()
        t.join(timeout=60)
    assert not t.is_alive()
    text = out.read_text()
    assert jexporter.validate_exposition(text) == []
    samples, _ = exporter.parse_exposition(text)
    done = sum(v for (name, _), v in samples.items()
               if name == "specpride_serve_jobs_done_total")
    assert done == 3 == d.jobs_done
    assert samples[("specpride_serve_batch_dispatches_total", ())] == 0
    assert samples[("specpride_result_cache_hits_total", ())] == 0
    for client in ("tenant0", "tenant1"):
        assert samples[("specpride_serve_queue_depth_client",
                        (("client", client),))] == 0
    assert samples[("specpride_serve_slo_jobs_total",
                    (("method", "bin-mean"),))] == 3
    lanes = {dict(labels)["worker"] for (name, labels) in samples
             if name == "specpride_dispatch_seconds_count"}
    assert lanes <= {"0", "1"} and lanes
    assert samples[("specpride_h2d_bytes_total", ())] > 0


def test_dispatches_land_in_the_dispatch_histogram():
    rng = np.random.default_rng(4)
    clusters = []
    for i in range(6):
        c = make_cluster(rng, f"c-{i}", n_members=3, n_peaks=20)
        clusters.append(Cluster(c.cluster_id, [
            Spectrum(mz=s.mz, intensity=s.intensity,
                     precursor_mz=s.precursor_mz,
                     precursor_charge=s.precursor_charge, rt=s.rt,
                     title=s.title) for s in c.members]))
    backend = TorchBackend(device="cpu")
    backend.run_bin_mean_with_cosines(clusters)
    data = backend.metrics.to_json()
    dispatches = data["specpride_dispatches_total"]
    hist = data["specpride_dispatch_seconds"]
    assert set(hist) == set(dispatches)
    for kernel, n in dispatches.items():
        assert hist[kernel]["count"] == n
        assert hist[kernel]["sum"] >= 0


# -- an elastic rank's /metrics (ElasticTelemetry) ---------------------------


def _families(text):
    """``{(name, labels): value}`` of a valid exposition."""
    samples, problems = exporter.parse_exposition(text)
    assert problems == []
    return samples


def test_elastic_telemetry_matches_the_jax_exposition(tmp_path):
    """For one coordinator state, the port's ``ElasticTelemetry`` and the
    JAX package's render the same families, types and samples (each
    rank's heartbeat age is sampled at its own scrape, so only its label
    set is compared); both validators pass, counters mirror by delta, and
    ``/healthz`` turns degraded on a stale peer with ranges left."""
    from specpride_tpu_torch.parallel.coordinator import Coordinator

    coord = Coordinator(str(tmp_path), 0, 8, 4, ttl=5.0)
    peer = Coordinator(str(tmp_path), 3, 8, 4, ttl=5.0)
    try:
        coord.commit(0, {"output_bytes": 0, "sha256": "x"})
        coord.lease_expires_observed, coord.reassignments = 2, 1
        coord.lease_splits, coord.steals = 1, 3
        backend = TorchBackend(device="cpu")
        tel = exporter.ElasticTelemetry(coord,
                                        extra_registries=(backend.metrics,))
        jtel = jexporter.ElasticTelemetry(coord,
                                          extra_registries=(backend.metrics,))
        text, jtext = tel.exposition(), jtel.exposition()
        assert exporter.validate_exposition(text) == []
        assert jexporter.validate_exposition(text) == []
        got, want = _families(text), _families(jtext)
        assert sorted(got) == sorted(want)
        age = "specpride_rank_heartbeat_age_seconds"
        assert sorted(labels for name, labels in got if name == age) == [
            (("rank", "0"),), (("rank", "3"),)]
        assert {k: v for k, v in got.items() if k[0] != age} == {
            k: v for k, v in want.items() if k[0] != age}
        assert "specpride_elastic_ranges 2" in text
        assert "specpride_elastic_ranges_committed 1" in text
        assert "specpride_elastic_lease_expires_total 2" in text
        assert "specpride_elastic_steals_total 3" in text
        # a second scrape does not count twice
        assert "specpride_elastic_lease_expires_total 2" in tel.exposition()
        assert tel.health() == jtel.health()
        assert tel.health()[0]
        # the peer falls silent mid-run: degraded, in both packages
        peer._stop.set()
        peer._hb_thread.join()
        real_now = time.time
        coord.store._now = lambda: real_now() + 60.0
        assert tel.health() == jtel.health()
        ok, detail = tel.health()
        # the skewed clock ages this rank's own beat too
        assert not ok and detail.startswith("stale_ranks=0,3 rank=0")
    finally:
        coord.stop()
        peer.stop()
