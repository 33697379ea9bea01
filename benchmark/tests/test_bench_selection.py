"""A selection's check: the expected title of each representative comes
from the reference (``Reps.titles``), so a wrong pick of an existing
member shows as one ``mismatched_reps`` a cluster, and a control can be
named in the configuration (``check.control``).  Also that neither
change moves what the consensus cells read: a reference that gives no
titles is compared as before, and the input's bytes stay the same."""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest

from benchmark import check, control, generate, run, spec
from benchmark.reference.result import Reps

CELL = "medoid.run8k"
STUB = "_stub_first_member"
CONFIG = {
    "name": "tiny-medoid",
    "argv": ["select", "{input}", "{output}", "--method", "medoid"],
    "precision": "f32",
    "reference": STUB,
    "check": {"limits": {"mismatched_reps": 0, "peak_gap": 1e-4},
              "control": {"xcorr_bin_0.11": ["--xcorr-bin", "0.11"]}},
}
SEED = 2**31 + 13


def first_member(w: generate.Workload, config: dict) -> Reps:
    """A stub reference that names member 0 of each cluster, as the input
    carries it (title, peaks, precursor m/z, charge, RT)."""
    first = w.member_offsets[:-1]
    lengths = np.diff(w.offsets)[first]
    offsets = np.zeros(first.size + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    idx = np.repeat(w.offsets[first], lengths) + (
        np.arange(int(offsets[-1])) - np.repeat(offsets[:-1], lengths))
    titles = [generate.member_title(cid, w.scans[m])
              for cid, m in zip(w.cluster_ids, first)]
    return Reps(offsets, w.mz[idx], w.intensity[idx], w.precursor_mz[first],
                w.charge[first], w.rt[first], None, {}, titles)


@pytest.fixture
def medoid_root(tiny_root, monkeypatch):
    """The tiny copy with a selection configuration and its cell, added
    as files and entries only; its stub reference found by name."""
    with open(os.path.join(tiny_root, "benchmark", "configs",
                           "tiny-medoid.json"), "w",
              encoding="utf-8") as fh:
        json.dump(CONFIG, fh)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path, encoding="utf-8") as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny-medoid", "source": "test",
                             "file": "benchmark/configs/tiny-medoid.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-medoid",
                               "traffic": "run8k", "chips": 1,
                               "why": "test"})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(bench, fh)
    stub = type(sys)("benchmark.reference." + STUB)
    stub.run = first_member
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    return tiny_root


def pick(which: str):
    """A ``medoid_finalize`` that picks each cluster's first or last
    member, whatever the shared bins say."""
    def finalize(shared, n_peaks, member_mask, n_members):
        if which == "first":
            return np.zeros(len(n_members), dtype=np.int32)
        return (np.asarray(n_members) - 1).astype(np.int32)
    return finalize


def medoid_run(root: str) -> dict:
    r = run.Run(spec.Cell(CELL, root), SEED, 0.3, False, device="cpu",
                t_start=time.perf_counter())
    return r.execute()


def multi_member_clusters(root: str) -> int:
    members, _ = generate.shapes(spec.Cell(CELL, root).traffic)
    return int(np.count_nonzero(members > 1))


def test_the_pick_that_the_reference_names_is_correct(medoid_root,
                                                      monkeypatch):
    from specpride_tpu_torch.ops import similarity

    monkeypatch.setattr(similarity, "medoid_finalize", pick("first"))
    res = medoid_run(medoid_root)
    assert res["correct"] is True
    assert res["check"]["mismatched_reps"]["value"] == 0
    assert res["check"]["peak_gap"]["value"] <= 1e-4


def test_the_last_member_fails_once_a_cluster_with_more(medoid_root,
                                                         monkeypatch):
    from specpride_tpu_torch.ops import similarity

    monkeypatch.setattr(similarity, "medoid_finalize", pick("last"))
    res = medoid_run(medoid_root)
    assert res["correct"] is False
    assert res["check"]["mismatched_reps"]["value"] == \
        multi_member_clusters(medoid_root)


def test_the_medoid_fails_where_it_is_not_the_first_member(medoid_root,
                                                            monkeypatch):
    """Unpatched, the harness counts exactly the clusters whose medoid is
    not member 0 (the picks, read where the port makes them)."""
    from specpride_tpu_torch.ops import similarity

    picks = []
    real = similarity.medoid_finalize

    def spy(*args):
        out = real(*args)
        picks.append(out)
        return out

    monkeypatch.setattr(similarity, "medoid_finalize", spy)
    (row,) = control.readings(spec.Cell(CELL, medoid_root), ["f32"],
                              [SEED], device="cpu")
    not_first = int(np.count_nonzero(np.concatenate(picks)))
    assert row["ok"] and row["variant"] == "f32"
    assert 0 < not_first <= multi_member_clusters(medoid_root)
    assert row["mismatched_reps"] == not_first
    # the clusters where both name member 0 match
    assert row["peak_gap"] <= CONFIG["check"]["limits"]["peak_gap"]


# -- no titles: the consensus cells compare as before ---------------------

def _f32(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).astype(np.float32) \
        .astype(np.float64)


def rounded(w: generate.Workload, ref: Reps) -> tuple[check.Output,
                                                      dict | None]:
    """The reference's answer rounded through float32, with cluster 3's
    title, cluster 5's charge and cluster 7's QC row wrong."""
    titles = list(w.cluster_ids)
    titles[3] += "x"
    charge = ref.charge.copy()
    charge[5] += 1
    out = check.Output(titles, ref.offsets.copy(), _f32(ref.mz),
                       _f32(ref.intensity), _f32(ref.pepmass), charge,
                       ref.rt.copy())
    if ref.cosines is None:
        return out, None
    n = np.diff(w.member_offsets)
    rows = [{"cluster_id": cid, "n_members": int(n[i]),
             "avg_cosine": float(np.float32(ref.cosines[i]))}
            for i, cid in enumerate(w.cluster_ids)]
    del rows[7]
    return out, {"clusters": rows}


# compare's numbers on ``rounded`` before references could give titles
PINNED = {
    ("binmean_qc.run8k", 2**31 + 11): {
        "mismatched_reps": 3, "peak_gap": 5.954111299581205e-08,
        "cosine_gap": 2.9755258368346915e-08},
    ("binmean_qc.run8k", 2**40 + 3): {
        "mismatched_reps": 3, "peak_gap": 5.947117337851917e-08,
        "cosine_gap": 2.9435020199031214e-08},
    ("gap.run8k", 2**31 + 11): {
        "mismatched_reps": 2, "peak_gap": 5.9501083466634766e-08},
    ("gap.run8k", 2**40 + 3): {
        "mismatched_reps": 2, "peak_gap": 5.947117337851917e-08},
}


@pytest.mark.parametrize("cell,seed", sorted(PINNED))
def test_a_reference_without_titles_compares_as_before(tiny_root, cell,
                                                       seed):
    c = spec.Cell(cell, tiny_root)
    w = generate.make_workload(c.traffic, seed)
    ref = c.reference().run(w, c.config)
    assert ref.titles is None
    out, qc = rounded(w, ref)
    n_members = np.diff(w.member_offsets)
    numbers = check.compare(out, qc, ref, w.cluster_ids, n_members)
    assert numbers == PINNED[cell, seed]
    # titles equal to the cluster ids read the same
    ref.titles = list(w.cluster_ids)
    assert check.compare(out, qc, ref, w.cluster_ids, n_members) == numbers


def test_the_input_is_the_same_bytes(tiny_root):
    """``write_mgf``'s bytes for a fixed seed, as before the title had a
    function of its own (``member_title``)."""
    traffic = dict(spec.Cell("gap.run8k", tiny_root).traffic, clusters=40)
    w = generate.make_workload(traffic, 2**35 + 17)
    path = os.path.join(tiny_root, "input.mgf")
    generate.write_mgf(w, path)
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    assert digest == ("a622e2bd8520663ea36881e80782e5353a4035c666a21cdda98b"
                      "7cb50f293443")


# -- the control's variants -----------------------------------------------

def _argvs(monkeypatch) -> list:
    seen = []

    def job(cli, argv):
        seen.append(argv)
        return None

    monkeypatch.setattr(control, "run_job", job)
    return seen


def test_a_named_variant_appends_its_argv(medoid_root, monkeypatch):
    seen = _argvs(monkeypatch)
    c = spec.Cell(CELL, medoid_root)
    rows = control.readings(c, ["f32", "xcorr_bin_0.11"], [7], device="cpu")
    assert [r["variant"] for r in rows] == ["f32", "xcorr_bin_0.11"]
    assert [r["precision"] for r in rows] == ["f32", "f32"]
    base = seen[0]
    assert base[:5] == ["select", base[1], base[2], "--method", "medoid"]
    assert seen[1] == base + ["--xcorr-bin", "0.11"]


def test_a_precision_keeps_its_meaning(tiny_root, monkeypatch):
    seen = _argvs(monkeypatch)
    c = spec.Cell("binmean_qc.run8k", tiny_root)
    rows = control.readings(c, ["f32", "bf16", "int8"], [7], device="cpu")
    assert [(r["precision"], r["variant"]) for r in rows] == \
        [("f32", "f32"), ("bf16", "bf16"), ("int8", "int8")]
    assert seen[1] == seen[0] + ["--precision", "bf16"]
    assert seen[2] == seen[0] + ["--precision", "int8"]
    assert "--precision" not in seen[0]


def test_an_unknown_variant_names_the_cells_variants(medoid_root,
                                                     monkeypatch):
    seen = _argvs(monkeypatch)
    with pytest.raises(SystemExit) as exc:
        control.readings(spec.Cell(CELL, medoid_root), ["f32", "fp4"], [7],
                         device="cpu")
    message = str(exc.value)
    assert message.startswith(f"{CELL}: no control variant fp4;")
    for name in ("f32", "bf16", "int8", "xcorr_bin_0.11"):
        assert name in message.split("it has:")[1]
    # the command exits so, before any job
    with pytest.raises(SystemExit, match="it has: f32, bf16, int8$"):
        control.main(["gap.run8k", "f32,fp4", "7"])
    assert not seen
