"""The port's chunked CLI executor (``cli._checkpointed_run``) on the CPU:
the same output, manifest and QC-report bytes at every executor setting
(``--prefetch``, ``--pack-workers``, ``--async-write``, ``--h2d-buffer``)
for every method and precision; the resume repairs (torn tail, missing
or shorter output, corrupt prefix, unreadable manifest, ``--append``
refusal); ``--on-error skip``; and the JAX CLI run with the same executor
flags: ``select --method medoid`` byte for byte, manifests included, the
consensus within the tolerances of ``tests/test_torch_cli.py`` (m/z rtol
1e-5 / atol 1e-3, intensity rtol 1e-4 / atol 1e-3, cosines rtol 1e-5 /
atol 1e-6) with equal manifest ``done``, ``failed`` and ``schema``."""

import json
import threading

import numpy as np
import pytest

from specpride_tpu import cli as jcli
from specpride_tpu.io import mgf as jmgf
from specpride_tpu.robustness import integrity as jintegrity
from specpride_tpu_torch import cli
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.io import mgf
from specpride_tpu_torch.robustness import integrity


def _cluster(rng, cid, n_members, n_peaks=25, charge=2, scan0=1000):
    skeleton = np.sort(rng.uniform(120.0, 1800.0, n_peaks))
    members = [
        Spectrum(
            mz=np.sort(skeleton + rng.normal(0.0, 0.004, n_peaks)),
            intensity=rng.uniform(10.0, 1e4, n_peaks),
            precursor_mz=500.0 + float(rng.normal(0, 0.01)),
            precursor_charge=charge, rt=100.0 + m,
            title=f"{cid};mzspec:PXD004732:run1.raw:scan:{scan0 + m}",
        )
        for m in range(n_members)
    ]
    return Cluster(cid, members)


def _workload(seed=5, n=9):
    rng = np.random.default_rng(seed)
    return [_cluster(rng, f"cluster-{i}", n_members=1 + i % 4,
                     scan0=1000 * (i + 1)) for i in range(n)]


def _write(path, clusters):
    mgf.write_mgf([s for c in clusters for s in c.members], path)
    return str(path)


def _msms(path, clusters, scoreless=("cluster-4",)):
    rng = np.random.default_rng(9)
    rows = ["Raw file\tScan number\tScore"]
    for c in clusters:
        if c.cluster_id in scoreless:
            continue
        for s in c.members:
            scan = s.title.rsplit(":", 1)[1]
            rows.append(f"run1\t{scan}\t{rng.uniform(0, 200):.3f}")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _port(command, src, out, *flags, ckpt=None, every=2, qc=None):
    argv = [command, src, str(out), "--device", "cpu", *flags]
    if ckpt is not None:
        argv += ["--checkpoint", str(ckpt), "--checkpoint-every", str(every)]
    if qc is not None:
        argv += ["--qc-report", str(qc)]
    assert cli.main(argv) == 0


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().err.strip().splitlines()[-1])


def test_write_mgf_append_matches_jax(tmp_path):
    """``write_mgf(append=)`` gives the JAX writer's bytes, chunk after
    chunk, after content that was there before."""
    spectra = [s for c in _workload(n=4) for s in c.members]
    paths = {"port": tmp_path / "p.mgf", "jax": tmp_path / "j.mgf"}
    for path in paths.values():
        path.write_bytes(b"BEGIN IONS\nTITLE=earlier\nEND IONS\n\n")
    for lo in range(0, len(spectra), 3):
        mgf.write_mgf(spectra[lo : lo + 3], paths["port"], append=True)
        jmgf.write_mgf(spectra[lo : lo + 3], str(paths["jax"]), append=True)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    mgf.write_mgf(spectra[:2], paths["port"])
    jmgf.write_mgf(spectra[:2], str(paths["jax"]))
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()


@pytest.mark.parametrize("cut", ["boundary", "torn", "zero", "inside"])
def test_truncate_tail_matches_jax(cut, tmp_path):
    """The resume repair of a torn append: the same bytes left and the same
    verdict on the record boundary as the JAX function."""
    spectra = [s for c in _workload(n=3) for s in c.members]
    head = mgf.format_spectrum(spectra[0]).encode()
    body = b"".join(mgf.format_spectrum(s).encode() for s in spectra)
    offset = {"boundary": len(head), "torn": len(head),
              "zero": 0, "inside": len(head) - 7}[cut]
    data = body if cut != "torn" else head + b"BEGIN IONS\nTITLE=x\n"
    got = {}
    for name, fn in (("port", mgf.truncate_tail),
                     ("jax", jmgf.truncate_tail)):
        path = tmp_path / f"{name}.mgf"
        path.write_bytes(data)
        got[name] = (fn(str(path), offset), path.read_bytes())
    assert got["port"] == got["jax"]
    assert got["port"][0] == (cut != "inside")


@pytest.mark.parametrize("failed", [None, ["c-9", "c-2"]])
def test_manifest_payload_matches_jax(failed, tmp_path):
    """``OutputIntegrity`` and ``manifest_payload`` give the JAX package's
    manifest JSON: a running hash over two appends, then a reseed."""
    path = tmp_path / "o.mgf"
    ours, theirs = integrity.OutputIntegrity(), jintegrity.OutputIntegrity()
    path.write_bytes(b"BEGIN IONS\nEND IONS\n\n")
    for integ in (ours, theirs):
        integ.absorb(str(path), path.stat().st_size)
    with open(path, "ab") as fh:
        fh.write(b"BEGIN IONS\nTITLE=2\nEND IONS\n\n")
    for integ in (ours, theirs):
        integ.absorb(str(path), path.stat().st_size)
    done = {"c-3", "c-1", "c-2"}
    size = path.stat().st_size
    assert json.dumps(integrity.manifest_payload(done, size, ours, failed)) \
        == json.dumps(jintegrity.manifest_payload(done, size, theirs, failed))
    assert ours.seed_file(str(path), 10) == theirs.seed_file(str(path), 10)
    assert integrity.MANIFEST_SCHEMA == jintegrity.MANIFEST_SCHEMA


SETTINGS = {
    "prefetch0": ("--prefetch", "0"),
    "prefetch1": ("--prefetch", "1", "--pack-workers", "0"),
    "prefetch4": ("--prefetch", "4"),
    "workers0": ("--pack-workers", "0"),
    "workers2": ("--pack-workers", "2"),
    "async_on": ("--prefetch", "0", "--async-write", "on"),
    "async_off": ("--async-write", "off"),
    "h2d0": ("--h2d-buffer", "0"),
    "h2d2": ("--h2d-buffer", "2", "--pack-workers", "2"),
}
VARIANTS = {
    "bin-mean": ("consensus", (), False),
    "bin-mean-qc": ("consensus", (), True),
    "gap-average": ("consensus", ("--method", "gap-average"), True),
    "medoid": ("select", (), True),
    "best": ("select", ("--method", "best"), True),
    "bin-mean-bf16": ("consensus", ("--precision", "bf16"), True),
    "bin-mean-int8": ("consensus", ("--precision", "int8"), False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_setting_writes_the_same_bytes(variant, tmp_path, capsys):
    command, flags, with_qc = VARIANTS[variant]
    clusters = _workload()
    src = _write(tmp_path / "in.mgf", clusters)
    if variant == "best":
        flags = flags + ("--msms", _msms(tmp_path / "msms.txt", clusters))
    got = {}
    for name, setting in SETTINGS.items():
        out, ck = tmp_path / f"{name}.mgf", tmp_path / f"{name}.ck.json"
        qc = tmp_path / f"{name}.qc.json" if with_qc else None
        _port(command, src, out, *flags, *setting, ckpt=ck, qc=qc)
        summary = _summary(capsys)
        got[name] = (out.read_bytes(), ck.read_bytes(),
                     qc.read_bytes() if qc else None)
        pipe = summary.get("pipeline")
        if name in ("prefetch0",):
            assert pipe is None
        elif name != "async_on":
            assert pipe["n_chunks"] == 5 and pipe["prefetch"] >= 1
        if name == "h2d2" and command == "consensus" \
                and "gap-average" not in flags:
            assert pipe["h2d"]["bytes"] > 0
    want = got["prefetch0"]
    for name, value in got.items():
        assert value == want, name
    manifest = json.loads(want[1])
    assert manifest["schema"] == 2 and len(manifest["sha256"]) == 64
    assert manifest["done"] == sorted(c.cluster_id for c in clusters)
    assert manifest["output_bytes"] == len(want[0])


def _serial(tmp_path, src, every=2):
    """The uninterrupted serial run (output, manifest, QC report)."""
    out, ck, qc = (tmp_path / "serial.mgf", tmp_path / "serial.ck.json",
                   tmp_path / "serial.qc.json")
    _port("consensus", src, out, "--prefetch", "0", ckpt=ck, every=every,
          qc=qc)
    return out.read_bytes(), ck.read_bytes(), qc.read_bytes()


def _committed_head(tmp_path, clusters, n_head, name="out"):
    """The state a kill leaves after ``n_head`` clusters were committed: a
    run over the head of the input, with its manifest."""
    head = _write(tmp_path / f"{name}.head.mgf", clusters[:n_head])
    out, ck = tmp_path / f"{name}.mgf", tmp_path / f"{name}.ck.json"
    _port("consensus", head, out, "--prefetch", "0", ckpt=ck)
    return out, ck


@pytest.mark.parametrize("legacy", [False, True])
def test_resume_from_manifest_and_torn_tail(legacy, tmp_path, capsys):
    """A committed prefix, then an orphaned partial append the manifest
    never recorded: the resume under the pipelined executor truncates it
    and converges to the serial bytes, QC report included (the resumed
    clusters' cosines recomputed from the output).  ``legacy``: a manifest
    without schema and sha256."""
    clusters = _workload(n=8)
    src = _write(tmp_path / "in.mgf", clusters)
    want_out, _, want_qc = _serial(tmp_path, src)
    out, ck = _committed_head(tmp_path, clusters, 4)
    assert want_out.startswith(out.read_bytes())
    if legacy:
        m = json.loads(ck.read_text())
        ck.write_text(json.dumps({"done": m["done"],
                                  "output_bytes": m["output_bytes"]}))
    with open(out, "ab") as fh:
        fh.write(b"BEGIN IONS\nTITLE=torn-orphan\n")
    capsys.readouterr()
    qc = tmp_path / "resumed.qc.json"
    _port("consensus", src, out, "--prefetch", "4", ckpt=ck, qc=qc)
    assert _summary(capsys)["counters"]["clusters_skipped_done"] == 4
    assert out.read_bytes() == want_out
    assert qc.read_bytes() == want_qc


@pytest.mark.parametrize("damage", ["missing", "shorter", "corrupt",
                                    "unreadable"])
def test_unusable_resume_state_restarts(damage, tmp_path, capsys, caplog):
    clusters = _workload(n=8)
    src = _write(tmp_path / "in.mgf", clusters)
    want_out, want_ck, want_qc = _serial(tmp_path, src)
    out, ck = _committed_head(tmp_path, clusters, 4)
    if damage == "missing":
        out.unlink()
    elif damage == "shorter":
        data = out.read_bytes()
        out.write_bytes(data[:-10])
    elif damage == "corrupt":
        data = bytearray(out.read_bytes())
        data[len(data) // 2] ^= 0x01  # inside the committed prefix
        out.write_bytes(bytes(data))
    else:
        ck.write_text('{"done": ["cluster-0"')
    capsys.readouterr()
    qc = tmp_path / "restarted.qc.json"
    _port("consensus", src, out, "--prefetch", "2", ckpt=ck, qc=qc)
    assert _summary(capsys)["counters"]["clusters_skipped_done"] == 0
    assert "restarting from scratch" in caplog.text
    assert (out.read_bytes(), ck.read_bytes(), qc.read_bytes()) == (
        want_out, want_ck, want_qc)


@pytest.mark.parametrize("damage", ["shorter", "corrupt"])
def test_append_refuses_a_restart(damage, tmp_path):
    clusters = _workload(n=6)
    src = _write(tmp_path / "in.mgf", clusters)
    out, ck = _committed_head(tmp_path, clusters, 2)
    data = bytearray(out.read_bytes())
    if damage == "shorter":
        data = data[:-5]
    else:
        data[3] ^= 0x01
    out.write_bytes(bytes(data))
    with pytest.raises(SystemExit, match="--append cannot safely redo"):
        cli.main(["consensus", src, str(out), "--device", "cpu", "--append",
                  "--checkpoint", str(ck), "--checkpoint-every", "2"])
    assert out.read_bytes() == bytes(data)


def test_append_adds_after_existing_content(tmp_path):
    clusters = _workload(n=5)
    src = _write(tmp_path / "in.mgf", clusters)
    alone = tmp_path / "alone.mgf"
    _port("consensus", src, alone)
    out, ck = tmp_path / "out.mgf", tmp_path / "ck.json"
    out.write_bytes(b"BEGIN IONS\nTITLE=earlier\nEND IONS\n\n")
    before = out.read_bytes()
    _port("consensus", src, out, "--append", ckpt=ck)
    assert out.read_bytes() == before + alone.read_bytes()
    m = json.loads(ck.read_text())
    assert m["output_bytes"] == out.stat().st_size


def _with_bad_cluster(tmp_path):
    good = _workload(n=5)
    rng = np.random.default_rng(2)
    bad = _cluster(rng, "cluster-bad", n_members=2, scan0=90_000)
    bad.members[1].precursor_charge = bad.members[0].precursor_charge + 1
    clusters = good[:2] + [bad] + good[2:]
    return good, _write(tmp_path / "in.mgf", clusters)


def test_on_error_skip_records_the_bad_cluster(tmp_path):
    """A mixed-charge cluster fails its chunk's pack (on a pack worker
    when pipelined); the chunk is retried cluster by cluster: exactly
    ``failed == ["cluster-bad"]`` and the serial run's bytes."""
    good, src = _with_bad_cluster(tmp_path)
    outs = {}
    for p in ("0", "2"):
        out, ck = tmp_path / f"o{p}.mgf", tmp_path / f"c{p}.json"
        qc = tmp_path / f"q{p}.json"
        _port("consensus", src, out, "--prefetch", p, "--on-error", "skip",
              ckpt=ck, qc=qc)
        outs[p] = (out.read_bytes(), ck.read_bytes(), qc.read_bytes())
        assert json.loads(ck.read_text())["failed"] == ["cluster-bad"]
        report = json.loads(qc.read_text())["summary"]
        assert report["method_failed_cluster_ids"] == ["cluster-bad"]
    assert outs["0"] == outs["2"]
    assert [s.title for s in mgf.read_mgf(tmp_path / "o2.mgf")] == [
        c.cluster_id for c in good]


@pytest.mark.parametrize("policy", ["abort", "skip"])
def test_failed_qc_pass_aborts_unless_skip(policy, tmp_path, monkeypatch):
    """A QC pass that fails (here every ``average_cosines`` call) stops
    the run under ``--on-error abort``; under ``skip`` the chunk's rows
    are omitted and recorded, and the representatives are the bytes of a
    run without QC."""
    clusters = _workload(n=5)
    src = _write(tmp_path / "in.mgf", clusters)
    want = tmp_path / "want.mgf"
    _port("select", src, want, ckpt=tmp_path / "want.json")

    def fail(*args, **kwargs):
        raise RuntimeError("qc fault")

    monkeypatch.setattr(cli.TorchBackend, "average_cosines", fail)
    out, ck, qc = (tmp_path / "o.mgf", tmp_path / "o.json",
                   tmp_path / "q.json")
    flags = ("--on-error", policy)
    if policy == "abort":
        with pytest.raises(RuntimeError, match="qc fault"):
            _port("select", src, out, *flags, ckpt=ck, qc=qc)
        return
    _port("select", src, out, *flags, ckpt=ck, qc=qc)
    assert out.read_bytes() == want.read_bytes()
    summary = json.loads(qc.read_text())["summary"]
    assert summary["qc_failed_cluster_ids"] == sorted(
        c.cluster_id for c in clusters)
    assert summary["n_clusters"] == 0


def test_abort_propagates_and_stops_the_lanes(tmp_path):
    _, src = _with_bad_cluster(tmp_path)
    with pytest.raises(ValueError, match="charges"):
        cli.main(["consensus", src, str(tmp_path / "x.mgf"), "--device",
                  "cpu", "--prefetch", "2", "--checkpoint",
                  str(tmp_path / "c.json"), "--checkpoint-every", "1",
                  "--async-write", "on", "--h2d-buffer", "2"])
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("specpride-packer", "specpride-committer",
                                   "specpride-h2d")) and t.is_alive()]
    assert alive == []


def test_pipeline_summary_and_pack_phase(tmp_path, capsys):
    src = _write(tmp_path / "in.mgf", _workload())
    _port("consensus", src, tmp_path / "o.mgf", ckpt=tmp_path / "c.json",
          qc=tmp_path / "q.json")
    summary = _summary(capsys)
    pipe = summary["pipeline"]
    assert pipe["prefetch"] == 2 and pipe["async_write"] is True
    assert pipe["pack_workers"] == len(pipe["pack_busy_s"]) >= 1
    assert 0.0 <= pipe["device_idle_s"] <= pipe["wall_s"]
    for key in ("overlap_efficiency", "write_busy_s", "reorder_stall_s"):
        assert key in pipe
    assert summary["phases_s"]["pack"] > 0.0
    assert summary["backend"]["chunks"] == 5
    assert summary["backend"]["cos_chunks"] == 5


def _jax(command, src, out, *flags, ckpt, every=2, qc=None):
    argv = [command, src, str(out), *flags, "--checkpoint", str(ckpt),
            "--checkpoint-every", str(every)]
    if qc is not None:
        argv += ["--qc-report", str(qc)]
    assert jcli.main(argv) == 0


EXECUTOR = ("--prefetch", "2", "--pack-workers", "2", "--async-write", "on")


def test_select_medoid_matches_jax_cli_bytes(tmp_path):
    src = _write(tmp_path / "in.mgf", _workload(n=11))
    _port("select", src, tmp_path / "p.mgf", *EXECUTOR,
          ckpt=tmp_path / "p.json")
    _jax("select", src, tmp_path / "j.mgf", *EXECUTOR,
         ckpt=tmp_path / "j.json")
    assert (tmp_path / "p.mgf").read_bytes() == \
        (tmp_path / "j.mgf").read_bytes()
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def _assert_close_mgf(got_path, want_path):
    got, want = mgf.read_mgf(got_path), mgf.read_mgf(want_path)
    assert [s.title for s in got] == [s.title for s in want]
    for g, w in zip(got, want):
        assert g.n_peaks == w.n_peaks
        np.testing.assert_allclose(g.mz, w.mz, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(g.intensity, w.intensity, rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("method", ["bin-mean", "gap-average"])
def test_consensus_matches_jax_cli(method, tmp_path):
    """Same executor flags, ``--on-error skip`` over a mixed-charge
    cluster (which only bin-mean refuses; the gap average takes its
    estimators' charge): equal manifest ``schema``, ``done`` and
    ``failed``, outputs and QC cosines within the stated tolerances."""
    _, src = _with_bad_cluster(tmp_path)
    flags = ("--method", method, "--on-error", "skip", *EXECUTOR)
    jflags = flags + (("--layout", "flat") if method == "bin-mean" else ())
    _port("consensus", src, tmp_path / "p.mgf", *flags,
          ckpt=tmp_path / "p.json", qc=tmp_path / "pq.json")
    _jax("consensus", src, tmp_path / "j.mgf", *jflags,
         ckpt=tmp_path / "j.json", qc=tmp_path / "jq.json")
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    for key in ("schema", "done", "failed"):
        assert got.get(key) == want.get(key), key
    assert got.get("failed") == (["cluster-bad"] if method == "bin-mean"
                                 else None)
    _assert_close_mgf(tmp_path / "p.mgf", tmp_path / "j.mgf")
    got = json.loads((tmp_path / "pq.json").read_text())
    want = json.loads((tmp_path / "jq.json").read_text())
    assert [r["cluster_id"] for r in got["clusters"]] == \
        [r["cluster_id"] for r in want["clusters"]]
    np.testing.assert_allclose(
        [r["avg_cosine"] for r in got["clusters"]],
        [r["avg_cosine"] for r in want["clusters"]], rtol=1e-5, atol=1e-6)
    assert got["summary"].get("method_failed_cluster_ids") == \
        want["summary"].get("method_failed_cluster_ids")
