"""The cluster split of the port (``parallel/mesh.py``, ``parallel/
parts.py``, the CLI's ``--mesh``, ``--coordinator`` and ``merge-parts``)
on the CPU.

A ``DeviceMesh(["cpu"] * 4)`` split of every bucketized method must give
the one-device bytes.  The CLI rehearses a 4-rank run as 4 ``--device
cpu`` processes joined through ``--coordinator 127.0.0.1:<port>`` (a
port the OS picked, a timeout on every process and on the process
group, torch's default thread count): ``merge-parts`` of their parts
must give the single-process ``--mesh`` run's bytes (output and QC report),
and the JAX package's ``merge-parts`` over the same parts the same
bytes."""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
from conftest import make_cluster

from specpride_tpu import cli as jcli
from specpride_tpu_torch import cli
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BatchConfig, GapAverageConfig
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.io.mgf import write_mgf
from specpride_tpu_torch.parallel import mesh as pmesh
from specpride_tpu_torch.parallel import parts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = BatchConfig(total_peak_buckets=(256, 1024, 4096),
                    clusters_per_batch=9)
RANK_TIMEOUT_S = 240


def _clusters(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = make_cluster(rng, f"c{i}", n_members=int(rng.integers(1, 7)),
                         n_peaks=int(rng.integers(5, 90)), base_scan=100 * i)
        out.append(Cluster(c.cluster_id, [
            Spectrum(s.mz, s.intensity, s.precursor_mz, s.precursor_charge,
                     s.rt, s.title) for s in c.members]))
    return out


def _key(reps):
    return [(r.title, r.precursor_mz, r.mz.tobytes(), r.intensity.tobytes())
            for r in reps]


def test_blocks_cut_at_aligned_rows_in_order():
    m = pmesh.DeviceMesh(["cpu"] * 4)
    assert m.size == 4
    assert m.blocks(0, 10) == [(0, 0, 3), (1, 3, 6), (2, 6, 9), (3, 9, 10)]
    assert m.blocks(5, 6) == [(0, 5, 6)]
    assert m.blocks(3, 3) == []
    # cuts at lo plus multiples of the alignment
    assert m.blocks(2, 40, align=8) == [(0, 2, 18), (1, 18, 34), (2, 34, 40)]
    assert pmesh.row_align(2048) == pmesh.row_align(8192) == 1
    assert pmesh.row_align(256) == 8
    assert pmesh.row_align(8192, 512) == 4
    assert pmesh.row_align(100) == 512
    assert m.map_rows(0, 7, lambda dev, a, b: (dev.type, a, b)) == [
        ("cpu", 0, 2), ("cpu", 2, 4), ("cpu", 4, 6), ("cpu", 6, 7)]
    with pytest.raises(ValueError):
        pmesh.DeviceMesh([])


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_four_device_split_gives_the_one_device_bytes(precision):
    clusters = _clusters(4, 40)
    one = TorchBackend(device="cpu", layout="bucketized", precision=precision,
                       batch_config=SMALL)
    four = TorchBackend(device="cpu", precision=precision, batch_config=SMALL,
                        mesh=pmesh.DeviceMesh(["cpu"] * 4))
    assert four.bucketized
    reps1, cos1 = one.run_bin_mean_with_cosines(clusters)
    reps4, cos4 = four.run_bin_mean_with_cosines(clusters)
    assert _key(reps4) == _key(reps1)
    np.testing.assert_array_equal(cos4, cos1)
    assert four.chunks > one.chunks and four.cos_chunks > one.cos_chunks
    gap1 = one.run_gap_average(clusters, GapAverageConfig())
    gap4 = four.run_gap_average(clusters, GapAverageConfig())
    assert _key(gap4) == _key(gap1)
    assert four.medoid_indices(clusters) == one.medoid_indices(clusters)
    assert (four.bucket_elements["real"] == one.bucket_elements["real"])


def test_initialize_distributed_without_a_coordinator_is_rank_zero():
    assert pmesh.initialize_distributed(None, None, None) == (0, 1)
    with pytest.raises(ValueError, match="--num-processes"):
        pmesh.initialize_distributed("127.0.0.1:1", None, 0)
    with pytest.raises(ValueError, match="not a rank"):
        pmesh.initialize_distributed("127.0.0.1:1", 2, 2)
    pmesh.shutdown_distributed()  # no group: a no-op


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(n, command, src, out, *flags):
    """``n`` CPU ranks of ``command`` through one coordinator; each must
    exit 0 within ``RANK_TIMEOUT_S``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "specpride_tpu_torch", command, str(src),
             str(out), "--device", "cpu", "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(i), *flags],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
        )
        for i in range(n)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:  # a failed rank must not leave its peers waiting
            if p.poll() is None:
                p.kill()
                p.wait()


def _single(command, src, out, *flags):
    proc = subprocess.run(
        [sys.executable, "-m", "specpride_tpu_torch", command, str(src),
         str(out), "--device", "cpu", *flags],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("command,flags", [
    ("consensus", ("--checkpoint-every", "64")),
    ("select", ("--precision", "int8", "--checkpoint-every", "64")),
])
def test_four_ranks_merge_to_the_single_process_bytes(command, flags,
                                                      tmp_path):
    src = tmp_path / "in.mgf"
    write_mgf([s for c in _clusters(7, 300) for s in c.members], src)
    single, single_qc = tmp_path / "single.mgf", tmp_path / "single.json"
    _single(command, src, single, "--mesh", "--qc-report", single_qc,
            *flags)

    out, qc, ck = tmp_path / "out.mgf", tmp_path / "qc.json", tmp_path / "ck"
    _ranks(4, command, src, out, "--qc-report", qc, "--checkpoint", ck,
           *flags)
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["in.mgf", "single.mgf", "single.json"]
        + [f"{n}.part{i:05d}" for n in ("out.mgf", "qc.json", "ck")
           for i in range(4)])
    for i in range(4):  # every rank took a block of the 300 clusters
        with open(f"{qc}.part{i:05d}") as fh:
            assert json.load(fh)["summary"]["n_input_clusters"] == 75

    # the JAX package's merge-parts over a copy of the same parts
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for i in range(4):
        for n in ("out.mgf", "qc.json", "ck"):
            shutil.copy(f"{tmp_path / n}.part{i:05d}", jdir)
    assert jcli.main(["merge-parts", str(jdir / "out.mgf"),
                      "--num-processes", "4", "--qc-report",
                      str(jdir / "qc.json"), "--checkpoint",
                      str(jdir / "ck")]) == 0

    assert cli.main(["merge-parts", str(out), "--num-processes", "4",
                     "--qc-report", str(qc), "--checkpoint", str(ck),
                     "--remove-parts"]) == 0
    assert _bytes(out) == _bytes(single) == _bytes(jdir / "out.mgf")
    assert _bytes(qc) == _bytes(single_qc) == _bytes(jdir / "qc.json")
    # --remove-parts deletes the output's parts, as the JAX CLI's does
    assert not any(f.startswith("out.mgf.part")
                   for f in os.listdir(tmp_path))


def test_merge_parts_refuses_gaps_and_bad_manifests(tmp_path, capsys):
    out = tmp_path / "o.mgf"
    assert cli.main(["merge-parts", str(out)]) == 1
    assert "no part files" in capsys.readouterr().err
    for i in (0, 2):
        (tmp_path / f"o.mgf.part{i:05d}").write_text(f"part {i}\n")
    assert cli.main(["merge-parts", str(out)]) == 1
    assert "missing [1]" in capsys.readouterr().err
    (tmp_path / "o.mgf.part00001").write_text("part 1\n")
    assert cli.main(["merge-parts", str(out), "--num-processes", "4"]) == 1
    assert "missing [3]" in capsys.readouterr().err
    manifest = {"schema": 2, "done": [], "output_bytes": 7,
                "sha256": "0" * 64}
    for i in range(3):
        (tmp_path / f"ck.part{i:05d}").write_text(json.dumps(manifest))
    assert cli.main(["merge-parts", str(out), "--checkpoint",
                     str(tmp_path / "ck")]) == 1
    assert "sha256 mismatch" in capsys.readouterr().err
    assert cli.main(["merge-parts", str(out), "--qc-report",
                     str(tmp_path / "qc.json")]) == 1
    assert "no QC shard" in capsys.readouterr().err
    assert not out.exists()
    assert cli.main(["merge-parts", str(out)]) == 0
    assert out.read_text() == "part 0\npart 1\npart 2\n"
    assert parts.part_path("x", 12) == "x.part00012"
