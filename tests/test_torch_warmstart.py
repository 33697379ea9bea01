"""The port's warm start (``specpride_tpu_torch/warmstart/``: the shape
manifest, the warmup registry, ``warm_entries``; the ``warmup`` command,
``--warmup``/``--warmup-manifest`` and ``serve --warmup*``) against the
JAX package's ``warmstart/``, on the CPU.

Manifests cross both ways (either package's ``load_manifest`` reads the
other's file); concurrent merges keep every entry; ``warm_entries`` gives
``compiled`` for the port's kernels and ``skipped`` for JAX-only names
and for the JAX keys of the port's names, journaled in the JAX schema;
the ``--warmup manifest`` refusals carry the JAX messages; a warmed run
writes an unwarmed run's bytes; a CPU daemon warms every lane at boot and
counts the entries; ``--jobs`` / ``--warmup-jobs`` above 1 are refused by
name."""

import argparse
import json
import os
import threading

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu import cli as jcli
from specpride_tpu.observability.journal import read_events as jread_events
from specpride_tpu.observability.journal import validate_event
from specpride_tpu.observability.stats_cli import run_stats as jrun_stats
from specpride_tpu.warmstart import manifest as jmanifest
from specpride_tpu.warmstart import registry as jregistry
from specpride_tpu_torch import cli
from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.io.mgf import write_mgf
from specpride_tpu_torch.observability.journal import Journal, read_events
from specpride_tpu_torch.serve import client as sc
from specpride_tpu_torch.serve.daemon import ServeDaemon
from specpride_tpu_torch.warmstart import manifest, registry, warmup

PORT_KEYS = [
    ("bin_mean_flat_intensity", ("f32",)),
    ("bin_mean_flat_q", ("bf16",)),
    ("bin_mean_flat_q", ("int8",)),
    ("bin_mean_bucketized", (2048, "f32")),
    ("bin_mean_bucketized", (8192, "int8")),
    ("gap_average_compact", ("f32",)),
    ("gap_average_compact", (2048, "bf16")),
    ("shared_bins_packed", (2048, 32, "i32")),
    ("shared_bins_packed", (8192, 128, "i16")),
    ("cosine_packed", (2048, 256, 4)),
    ("cosine_packed", (32768, 1024, 2)),
    ("cosine_flat", ()),
]

# shape keys as the JAX package's dispatch sites write them
JAX_KEYS = [
    ("bin_mean_flat_intensity", (262144, 1536, 1536, 8)),
    ("bin_mean_flat_q", (262144, 1536, 1536, 8, "int8")),
    ("bin_mean_bucketized", (64, 2048, 1536, 8, "bf16", "f32")),
    ("gap_average_compact", (64, 2048, 1536)),
    ("shared_bins_packed", (64, 2048, 32, 8, "i16")),
    ("cosine_packed", (64, 2048, 256, 4)),
    ("cosine_flat", (4096, 1024, 64, 128, 20, 8, 8, 8, 8, 8)),
]
JAX_ONLY = [
    ("bin_mean_flat_intensity_pallas", (262144, 1536, 1536, 8)),
    ("gap_average_compact_pallas", (64, 2048, 1536)),
    ("medoid_select_packed", (64, 2048, 32, 8)),
]


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    rng = np.random.default_rng(606)
    spectra = []
    for i in range(10):
        c = make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 5)),
                         n_peaks=int(rng.integers(5, 50)), base_scan=100 * i)
        spectra += [Spectrum(s.mz, s.intensity, s.precursor_mz,
                             s.precursor_charge, s.rt, s.title)
                    for s in c.members]
    src = tmp_path_factory.mktemp("warm_wl") / "clustered.mgf"
    write_mgf(spectra, src)
    return str(src)


# -- manifests ------------------------------------------------------------


def test_manifests_cross_both_ways(tmp_path):
    from specpride_tpu_torch.config import BinMeanConfig

    seen = {(k, *key) for k, key in PORT_KEYS}
    entries = manifest.entries_from_seen(seen, BinMeanConfig())
    kernels = {e.kernel for e in entries}
    # the config-keyed kernels of another method are left out
    assert "gap_average_compact" not in kernels
    assert "shared_bins_packed" not in kernels
    assert {"bin_mean_flat_intensity", "cosine_flat"} <= kernels
    port_path = str(tmp_path / "port.json")
    assert manifest.merge_manifest(port_path, entries) == len(entries)
    got = jmanifest.load_manifest(port_path)
    assert [e.to_json() for e in got] == [e.to_json() for e in entries]
    jentries = [jmanifest.ShapeEntry(k, key) for k, key in JAX_KEYS
                if k not in jmanifest.CONFIG_KERNELS] + [
        jmanifest.ShapeEntry("gap_average_compact", (64, 2048, 1536),
                             {"type": "GapAverageConfig",
                              "mz_accuracy": 0.01, "dyn_range": 1000.0,
                              "min_fraction": 0.5,
                              "tail_mode": "reference",
                              "pepmass": "lower_median", "rt": "median"})]
    jax_path = str(tmp_path / "jax.json")
    jmanifest.merge_manifest(jax_path, jentries)
    back = manifest.load_manifest(jax_path)
    assert sorted(json.dumps(e.to_json(), sort_keys=True) for e in back) == \
        sorted(json.dumps(e.to_json(), sort_keys=True) for e in jentries)
    assert manifest.MANIFEST_VERSION == jmanifest.MANIFEST_VERSION == 1
    # a merge is idempotent, and refuses a file from another version
    assert manifest.merge_manifest(port_path, entries) == len(entries)
    with open(port_path, "w") as fh:
        json.dump({"version": 2, "entries": []}, fh)
    for mod in (manifest, jmanifest):
        with pytest.raises(ValueError, match="unsupported manifest version"):
            mod.load_manifest(port_path)


def test_merge_manifest_under_concurrent_lanes_keeps_every_entry(tmp_path):
    path = str(tmp_path / "m.json")
    errors = []

    def lane(i):
        try:
            for j in range(10):
                manifest.merge_manifest(path, [manifest.ShapeEntry(
                    "cosine_packed", (2048, 256, 2 ** (i % 4)), None),
                    manifest.ShapeEntry("bin_mean_bucketized",
                                        (1000 * i + j, "f32"), None)])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=lane, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    entries = manifest.load_manifest(path)
    assert len(entries) == 4 + 80
    assert len(jmanifest.load_manifest(path)) == 84
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


# -- the registry and warm_entries ------------------------------------------


def test_registry_names_the_ports_dispatched_kernels():
    assert registry.known_kernels() == tuple(sorted(
        {k for k, _ in PORT_KEYS}))
    # every port name is a JAX registry name too (the same manifests)
    assert set(registry.known_kernels()) <= set(jregistry.known_kernels())
    assert registry.build(manifest.ShapeEntry("no_such", ())) is None
    for kernel, key in JAX_KEYS + [("cosine_flat", (1, 2)),
                                   ("bin_mean_flat_q", ("f32",)),
                                   ("gap_average_compact", ("f64",))]:
        with pytest.raises(ValueError, match=kernel):
            registry.build(manifest.ShapeEntry(kernel, key))


def test_warm_entries_on_the_cpu(tmp_path):
    entries = [manifest.ShapeEntry(k, key) for k, key in
               PORT_KEYS + JAX_KEYS + JAX_ONLY]
    path = str(tmp_path / "w.jsonl")
    j = Journal(path)
    results = warmup.warm_entries(entries, journal=j, device="cpu")
    j.close()
    status = [r.status for r in results]
    n_port, n_jax = len(PORT_KEYS), len(JAX_KEYS)
    assert status == ["compiled"] * n_port + ["skipped"] * (
        n_jax + len(JAX_ONLY))
    # the JAX keys of the port's names are bad entries for the port;
    # the JAX-only names are not in its registry
    assert all(r.detail.startswith("bad entry: ")
               for r in results[n_port:n_port + n_jax])
    assert {r.detail for r in results[n_port + n_jax:]} == {
        "kernel not in warmup registry"}
    # the CPU path launches no kernel
    assert all(r.launches == {} for r in results)
    events, bad = read_events(path)
    assert bad == []
    warm = [e for e in events if e["event"] == "warmup"]
    assert len(warm) == len(entries)
    for e in warm:
        assert validate_event(e) == []
        assert e["status"] in ("compiled", "skipped")
        assert e["cache_hit"] is False
    assert jread_events(path)[1] == []
    # a warm keeps no memory of an earlier one: the same classes again
    # are dispatched again
    again = warmup.warm_entries(entries[:3], device="cpu")
    assert [r.status for r in again] == ["compiled"] * 3


def test_a_backend_that_dispatched_a_class_is_a_cache_hit():
    from specpride_tpu_torch.backends.torch_backend import TorchBackend

    backend = TorchBackend(device="cpu")
    backend._seen_shapes.add(("cosine_flat",))
    got = warmup.warm_entries([manifest.ShapeEntry("cosine_flat", ()),
                               manifest.ShapeEntry(
                                   "bin_mean_flat_intensity", ("f32",))],
                              backend=backend)
    assert [r.status for r in got] == ["cache_hit", "compiled"]
    # the warm ran on a backend of its own: this one saw no dispatch
    assert backend._seen_shapes == {("cosine_flat",)}
    assert backend.chunks == 0


@pytest.mark.parametrize("jobs,ok", [(0, True), (1, True), (2, False),
                                     (-1, False)])
def test_jobs_above_one_are_refused_by_name(tmp_path, jobs, ok):
    path = str(tmp_path / "m.json")
    manifest.merge_manifest(path, [manifest.ShapeEntry("cosine_flat", ())])
    argv = ["warmup", path, "--device", "cpu", "--jobs", str(jobs)]
    if ok:
        assert cli.main(argv) == 0
        return
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert "--jobs" in str(exc.value)
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--device", "cpu", "--warmup-jobs", str(jobs)])
    assert "--warmup-jobs" in str(exc.value)


def test_warmup_command_journals_and_counts(tmp_path, capsys):
    path = str(tmp_path / "m.json")
    manifest.merge_manifest(path, [
        manifest.ShapeEntry(k, key) for k, key in
        PORT_KEYS + JAX_KEYS + JAX_ONLY])
    journal = str(tmp_path / "w.jsonl")
    capsys.readouterr()
    assert cli.main(["warmup", path, "--device", "cpu", "--journal",
                     journal]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n = len(jmanifest.load_manifest(path))
    assert n == len(PORT_KEYS + JAX_KEYS + JAX_ONLY)
    assert out["kernels"] == n
    assert out["compiled"] == len(PORT_KEYS)
    assert out["skipped_or_failed"] == n - len(PORT_KEYS)
    assert out["cache_dir"] is None
    events, bad = jread_events(journal)
    assert bad == []
    assert events[-1]["counters"]["kernels_warmed"] == n
    text = []
    for fn in (jrun_stats,):
        import io

        buf = io.StringIO()
        assert fn([journal], out=buf) == 0
        text.append(buf.getvalue())
    assert f"kernels_warmed={n}" in text[0]


# -- the CLI's --warmup -----------------------------------------------------


def test_warmup_manifest_refusal_carries_the_jax_message(tmp_path,
                                                         workload):
    missing = str(tmp_path / "nope" / "m.json")
    with pytest.raises(SystemExit) as port:
        cli.main(["consensus", workload, str(tmp_path / "o.mgf"),
                  "--device", "cpu", "--warmup", "manifest",
                  "--warmup-manifest", missing])

    class _Backend:
        _seen_shapes = set()

    with pytest.raises(SystemExit) as jax:
        jcli._run_warmup(argparse.Namespace(
            warmup="manifest", warmup_manifest=missing, method="bin-mean"),
            _Backend(), None)
    assert str(port.value) == str(jax.value)
    assert str(port.value).startswith("--warmup manifest: no shape manifest")
    with pytest.raises(SystemExit) as none:
        cli.main(["consensus", workload, str(tmp_path / "o.mgf"),
                  "--device", "cpu", "--warmup", "manifest"])
    assert "<no --warmup-manifest and no compile cache>" in str(none.value)
    d = ServeDaemon(str(tmp_path / "s.sock"), device="cpu",
                    warmup="manifest", warmup_manifest=missing)
    with pytest.raises(SystemExit) as serve:
        d.boot()
    assert str(serve.value) == \
        f"serve --warmup manifest: no shape manifest at {missing}"
    d.journal.close()


@pytest.mark.parametrize("command,flags", [
    ("consensus", ["--qc-report", "{qc}"]),
    ("consensus", ["--method", "gap-average", "--precision", "int8"]),
    ("select", ["--method", "medoid", "--qc-report", "{qc}"]),
    ("consensus", ["--layout", "bucketized", "--qc-report", "{qc}"]),
])
def test_a_warmed_run_writes_the_unwarmed_bytes(tmp_path, workload, command,
                                                flags):
    def run(tag, *extra):
        out = tmp_path / f"{tag}.mgf"
        qc = tmp_path / f"{tag}.qc.json"
        argv = [command, workload, str(out), "--device", "cpu",
                *[f.format(qc=qc) for f in flags], *extra]
        assert cli.main(argv) == 0
        return out.read_bytes(), qc.read_bytes() if qc.exists() else None

    plain_journal = str(tmp_path / "p.jsonl")
    plain = run("plain", "--warmup", "off", "--journal", plain_journal)
    m = str(tmp_path / "m.json")
    seeded = run("seed", "--warmup-manifest", m)
    entries = manifest.load_manifest(m)
    assert entries and jmanifest.load_manifest(m)
    journal = str(tmp_path / "w.jsonl")
    warmed = run("warm", "--warmup", "manifest", "--warmup-manifest", m,
                 "--journal", journal)
    assert plain == seeded == warmed
    events, bad = read_events(journal)
    assert bad == []
    warm = [e for e in events if e["event"] == "warmup"]
    assert [e["status"] for e in warm] == ["compiled"] * len(entries)
    names = [e["event"] for e in events]
    # the warm comes before the first chunk, under its one span; its own
    # method and kernel spans stay out of the run's trace
    assert names.index("warmup") < names.index("chunk_start")
    cold = read_events(plain_journal)[0]

    def spans(evs):
        return sorted(e["name"] for e in evs if e["event"] == "span"
                      and e["name"] != "warmup")

    assert spans(events) == spans(cold)
    assert [e["name"] for e in events if e["event"] == "span"].count(
        "warmup") == 1
    # the warmed run dispatched what a cold one does: the same classes
    assert len(manifest.load_manifest(m)) == len(entries)


def test_a_cpu_daemon_warms_every_lane(tmp_path, workload):
    m = str(tmp_path / "m.json")
    assert cli.main(["consensus", workload, str(tmp_path / "seed.mgf"),
                     "--device", "cpu", "--qc-report",
                     str(tmp_path / "seed.qc"), "--warmup-manifest", m]) == 0
    n = len(manifest.load_manifest(m))
    journal = str(tmp_path / "serve.jsonl")
    d = ServeDaemon(str(tmp_path / "s.sock"), device="cpu", workers=2,
                    journal_path=journal, warmup="manifest",
                    warmup_manifest=m)
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    assert sc.wait_for_socket(d.socket_path, timeout=60)
    try:
        assert sc.request(d.socket_path, {"op": "status"})[
            "warmed_kernels"] == n
        out = str(tmp_path / "served.mgf")
        term = sc.submit_wait(d.socket_path, [
            "consensus", workload, out, "--qc-report",
            str(tmp_path / "served.qc"), "--warmup-manifest", m],
            timeout=120)
        assert term["status"] == "done", term
    finally:
        d.drain()
        t.join(timeout=60)
    assert not t.is_alive()
    assert open(out, "rb").read() == \
        open(tmp_path / "seed.mgf", "rb").read()
    events, bad = read_events(journal)
    assert bad == []
    start = next(e for e in events if e["event"] == "serve_start")
    assert start["warmed_kernels"] == n
    warm = [e for e in events if e["event"] == "warmup"]
    # each lane dispatches each class
    assert [e["status"] for e in warm] == ["compiled"] * (2 * n)
    assert max(i for i, e in enumerate(events) if e["event"] == "warmup") \
        < events.index(start)
