"""The port's streamed input (``--stream-clusters``) on the CPU: the host
library's byte index (``io/native.py::index_mgf``) against the Python scan
(``StreamedClusters._scan_plain``) and the JAX package's
``StreamedClusters._scan`` on damaged and unusual files; the port's
``StreamedClusters`` and ``IndexedMGF`` against the JAX package's on the
same files (the same ids, member titles and bit-identical arrays, every
window size, contiguous and scattered members); slices and
``drain_malformed``; and the CLI: ``--stream-clusters off``, ``2`` and
``auto`` write the same output, QC report and manifest, equal to the JAX
CLI's with the same flags (``select --method medoid`` byte for byte, the
consensus within the tolerances of ``tests/test_torch_cli.py``: m/z rtol
1e-5 / atol 1e-3, intensity rtol 1e-4 / atol 1e-3, cosines rtol 1e-5 /
atol 1e-6), checkpoint and resume across streamed runs, and each window
parsed once per run."""

import json

import numpy as np
import pytest

from specpride_tpu import cli as jcli
from specpride_tpu.io import mgf as jmgf
from specpride_tpu_torch import cli
from specpride_tpu_torch.data.peaks import (
    Spectrum,
    build_title,
    group_into_clusters,
)
from specpride_tpu_torch.io import mgf, native


def _spectra(seed=3, n_clusters=9, scatter=False, n_peaks=25):
    rng = np.random.default_rng(seed)
    spectra = []
    for ci in range(n_clusters):
        skeleton = np.sort(rng.uniform(100.0, 1500.0, n_peaks))
        for m in range(2 + ci % 3):
            spectra.append(Spectrum(
                mz=np.sort(skeleton + rng.normal(0.0, 0.004, n_peaks)),
                intensity=rng.uniform(1.0, 100.0, n_peaks),
                precursor_mz=400.0 + ci, precursor_charge=2, rt=float(m),
                title=build_title(f"cluster-{ci}", "PXD1", "r.raw",
                                  ci * 100 + m),
            ))
    if scatter:
        # members of one cluster interleaved with other clusters' members
        order = rng.permutation(len(spectra))
        spectra = [spectra[i] for i in order]
    return spectra


def _write(path, spectra):
    mgf.write_mgf(spectra, path)
    return path


def _same_spectrum(a, b):
    assert a.title == b.title
    assert a.precursor_mz == b.precursor_mz and a.rt == b.rt
    assert a.precursor_charge == b.precursor_charge
    assert a.extra == b.extra
    assert a.mz.dtype == b.mz.dtype == np.float64
    assert np.array_equal(a.mz, b.mz)
    assert np.array_equal(a.intensity, b.intensity)


def _groups_of(view):
    """A port view's ``(cluster id, [(begin, end), ...])`` pairs off its
    index arrays: what the JAX package's ``_groups`` holds."""
    rec = view._records
    return [(cid, list(zip(rec.member_begin[a:b].tolist(),
                           rec.member_end[a:b].tolist())))
            for cid, a, b in zip(view._names, view._first.tolist(),
                                 view._last.tolist())]


def _same_clusters(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.cluster_id == b.cluster_id
        assert [s.title for s in a.members] == [s.title for s in b.members]
        for sa, sb in zip(a.members, b.members):
            _same_spectrum(sa, sb)


# -- the TestStreamedClusters cases of tests/test_mgf_io.py, on the port ---


class TestStreamedClusters:
    def test_matches_eager_grouping(self, tmp_path):
        spectra = _spectra()
        path = _write(tmp_path / "clustered.mgf", spectra)
        eager = group_into_clusters(mgf.read_mgf(path))
        streamed = mgf.StreamedClusters(path, window=3)
        assert len(streamed) == len(eager)
        assert streamed.cluster_ids == [c.cluster_id for c in eager]
        assert streamed.n_spectra == len(spectra)
        _same_clusters(list(streamed), eager)

    def test_scattered_members(self, tmp_path):
        """Members scattered through the file regroup in in-file order, as
        the eager grouping does."""
        path = _write(tmp_path / "clustered.mgf", _spectra(scatter=True))
        eager = group_into_clusters(mgf.read_mgf(path))
        streamed = mgf.StreamedClusters(path, window=2)
        assert streamed.cluster_ids == [c.cluster_id for c in eager]
        _same_clusters(list(streamed), eager)

    def test_window_cache_stays_bounded(self, tmp_path):
        path = _write(tmp_path / "clustered.mgf", _spectra(n_clusters=12))
        streamed = mgf.StreamedClusters(path, window=4)
        for _ in streamed:
            assert len(streamed._windows) <= 2
            assert all(len(w) <= 4 for w in streamed._windows.values())
        assert streamed.windows_parsed == 3
        # jumping back parses the earlier window again
        first = streamed[0]
        assert 0 in streamed._windows and streamed.windows_parsed == 4
        assert first.cluster_id == "cluster-0"

    def test_slicing_returns_view(self, tmp_path):
        path = _write(tmp_path / "clustered.mgf", _spectra(n_clusters=10))
        streamed = mgf.StreamedClusters(path, window=4)
        view = streamed[3:7]
        assert len(view) == 4
        assert view.cluster_ids == streamed.cluster_ids[3:7]
        assert view[0].cluster_id == "cluster-3"


# -- the port against the JAX package on the same files --------------------


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("window", [1, 2, 3, 512])
def test_streamed_clusters_match_jax(window, scatter, tmp_path):
    path = _write(tmp_path / "clustered.mgf",
                  _spectra(seed=11, scatter=scatter))
    got = mgf.StreamedClusters(path, window=window)
    want = jmgf.StreamedClusters(path, window=window)
    assert got.cluster_ids == want.cluster_ids
    assert got.n_spectra == want.n_spectra
    assert _groups_of(got) == want._groups
    _same_clusters(list(got), list(want))
    # random access in another order: the same clusters
    for i in (len(got) - 1, 0, len(got) // 2, -1):
        _same_clusters([got[i]], [want[i]])


def _damaged_text(spectra) -> str:
    """Records with a truncated block in the middle (BEGIN IONS inside an
    open record) and one at the end (EOF before END IONS)."""
    blocks = mgf.write_mgf(spectra, None).split("\n\n")
    blocks.insert(3, "BEGIN IONS\nTITLE=cluster-trunc;mzspec:PXD1:r:scan:1"
                     "\nPEPMASS=500.0\n123.4 10.0")
    blocks[-1] = ("BEGIN IONS\nTITLE=cluster-tail;mzspec:PXD1:r:scan:2\n"
                  "PEPMASS=501.0\n124.5 11.0\n")
    return "\n\n".join(blocks)


def test_slices_and_drain_malformed_match_jax(tmp_path):
    path = tmp_path / "damaged.mgf"
    path.write_text(_damaged_text(_spectra(seed=5, n_clusters=6)))
    got = mgf.StreamedClusters(path, window=2)
    want = jmgf.StreamedClusters(path, window=2)
    assert got.malformed_spans == want.malformed_spans
    assert len(got.malformed_spans) == 2
    seen = {"port": [], "jax": []}
    got.on_malformed = want.on_malformed = print  # carried to sub-views
    for view, key in ((got, "port"), (want, "jax")):
        assert view.drain_malformed(
            lambda raw, why, key=key: seen[key].append((raw, why))) == 2
        assert view.malformed_spans == []
        assert view.drain_malformed(lambda raw, why: None) == 0
    assert seen["port"] == seen["jax"]
    assert "cluster-trunc" in seen["port"][0][0]
    assert seen["port"][1][0].endswith("124.5 11.0")
    for key in (slice(1, 4), slice(None, 2), slice(3, None), slice(0, 6, 2)):
        gv, wv = got[key], want[key]
        assert gv.cluster_ids == wv.cluster_ids
        assert gv.on_malformed is print and gv.malformed_spans == []
        _same_clusters(list(gv), list(wv))
    # without a quarantine the host parser's span runs on over the
    # truncated block between two records of a window: the same clusters
    for window in (2, 512):
        _same_clusters(list(mgf.StreamedClusters(path, window=window)),
                       list(jmgf.StreamedClusters(path, window=window)))


def test_window_parse_quarantines_like_jax(tmp_path):
    """With ``on_malformed`` set a window parses through the tolerant
    Python parser: an unparseable record goes to the callback, as in the
    JAX package; without it the host parser raises."""
    blocks = mgf.write_mgf(_spectra(seed=8, n_clusters=4), None).split(
        "\n\n")
    blocks.insert(2, "BEGIN IONS\nTITLE=cluster-1;mzspec:PXD1:r:scan:77\n"
                     "PEPMASS=500.0\n123.4 banana\nEND IONS")
    path = tmp_path / "bad.mgf"
    path.write_text("\n\n".join(blocks))
    seen = {"port": [], "jax": []}
    views = {}
    for key, cls in (("port", mgf.StreamedClusters),
                     ("jax", jmgf.StreamedClusters)):
        view = views[key] = cls(path, window=3)
        view.on_malformed = (lambda raw, why, key=key:
                             seen[key].append((raw, why)))
    _same_clusters(list(views["port"]), list(views["jax"]))
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1
    with pytest.raises(RuntimeError, match="bad peak intensity"):
        mgf.StreamedClusters(path, window=3)[0]


INDEX_CASES = {
    "crlf": lambda text: text.replace("\n", "\r\n"),
    "tabs_and_spaces": lambda text: text.replace(
        "BEGIN IONS\n", " BEGIN IONS\t \n").replace(
        "END IONS\n", "\tEND IONS  \n").replace("TITLE=", "  TITLE="),
    "titleless": lambda text: text.replace(
        "TITLE=cluster-1;mzspec:PXD1:r.raw:scan:100\n", "", 1),
    "truncated_middle": lambda text: text.replace(
        "END IONS\n", "", 3).replace("BEGIN IONS\n", "BEGIN IONS\n", 1),
    "truncated_last": lambda text: text.rstrip()[: -len("END IONS")],
    "non_ascii": lambda text: text.replace(
        "cluster-2;", "clüster-2→;").replace("cluster-5;", "群-5;"),
    "no_final_newline": lambda text: text.rstrip("\n"),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_native_index_matches_jax_scan(case, tmp_path):
    """The host library's one-pass index, the port's Python scan and the
    JAX package's scan give the same records (titles, byte offsets,
    ``index=N`` for a record without a title) and truncated spans."""
    text = INDEX_CASES[case](mgf.write_mgf(_spectra(seed=2, n_clusters=7),
                                           None))
    path = tmp_path / f"{case}.mgf"
    path.write_bytes(text.encode("utf-8"))
    records, spans = native.index_mgf(path)
    plain = mgf.StreamedClusters(path, window=2)
    assert plain._scan_plain() == records
    assert plain.malformed_spans == spans
    jax_view = jmgf.StreamedClusters(path, window=2)
    jax_spans = list(jax_view.malformed_spans)
    assert jax_view._scan() == records
    assert jax_spans == spans
    if case.startswith("truncated"):
        assert spans
    if case == "titleless":
        assert any(t.startswith("index=") for t, _, _ in records)
    if case == "non_ascii":
        assert any("群" in t for t, _, _ in records)
    # the records' bytes parse to the records themselves
    with open(path, "rb") as fh:
        data = fh.read()
    for title, begin, end in records:
        got = native.parse_mgf_bytes(data[begin:end], threads=1)
        assert len(got) == 1
        if not title.startswith("index="):
            assert got[0].title == title.strip()


def test_indexed_mgf_matches_jax(tmp_path):
    path = _write(tmp_path / "in.mgf", _spectra(seed=4, n_clusters=5))
    got, want = mgf.IndexedMGF(path), jmgf.IndexedMGF(path)
    assert got.titles == want.titles and len(got) == len(want)
    for title in reversed(got.titles):
        _same_spectrum(got[title], want[title])
    batch = got.titles[1:4]
    for a, b in zip(got[batch], want[batch]):
        _same_spectrum(a, b)


# -- the CLI ---------------------------------------------------------------


def _clustered(tmp_path, n_clusters=9, seed=7):
    return str(_write(tmp_path / "in.mgf",
                      _spectra(seed=seed, n_clusters=n_clusters,
                               n_peaks=40)))


EXEC = ("--prefetch", "2", "--pack-workers", "2", "--checkpoint-every", "2")


def _port(command, src, out, *flags, ck=None, qc=None):
    argv = [command, src, str(out), "--device", "cpu", *flags]
    if ck is not None:
        argv += ["--checkpoint", str(ck)]
    if qc is not None:
        argv += ["--qc-report", str(qc)]
    assert cli.main(argv) == 0


def _jax(command, src, out, *flags, ck=None, qc=None):
    argv = [command, src, str(out), *flags]
    if ck is not None:
        argv += ["--checkpoint", str(ck)]
    if qc is not None:
        argv += ["--qc-report", str(qc)]
    assert jcli.main(argv) == 0


def _assert_close_mgf(got_path, want_path):
    got, want = mgf.read_mgf(got_path), mgf.read_mgf(want_path)
    assert [s.title for s in got] == [s.title for s in want]
    for g, w in zip(got, want):
        assert g.n_peaks == w.n_peaks
        np.testing.assert_allclose(g.mz, w.mz, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(g.intensity, w.intensity, rtol=1e-4,
                                   atol=1e-3)


def _assert_close_qc(got_path, want_path):
    got = json.loads(open(got_path).read())
    want = json.loads(open(want_path).read())
    assert [r["cluster_id"] for r in got["clusters"]] == \
        [r["cluster_id"] for r in want["clusters"]]
    np.testing.assert_allclose(
        [r["avg_cosine"] for r in got["clusters"]],
        [r["avg_cosine"] for r in want["clusters"]], rtol=1e-5, atol=1e-6)


COMMANDS = {
    "consensus": ("consensus", (), ("--layout", "flat")),
    "medoid": ("select", (), ()),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_stream_modes_write_the_same_bytes_as_jax(name, tmp_path,
                                                  monkeypatch):
    """``off``, ``2`` and ``auto`` (the threshold lowered under the file's
    size in both packages): the same output, QC report and manifest bytes
    in the port, and the JAX CLI's with the same flags."""
    command, flags, jflags = COMMANDS[name]
    src = _clustered(tmp_path)
    monkeypatch.setattr(cli, "_STREAM_AUTO_BYTES", 1024)
    monkeypatch.setattr(jcli, "_STREAM_AUTO_BYTES", 1024)
    streamed = []
    real = cli.StreamedClusters

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            streamed.append(self)

    monkeypatch.setattr(cli, "StreamedClusters", Recorded)
    got = {}
    for mode in ("off", "2", "auto"):
        p = {k: tmp_path / f"p_{mode}.{k}" for k in ("mgf", "ck", "qc")}
        j = {k: tmp_path / f"j_{mode}.{k}" for k in ("mgf", "ck", "qc")}
        n_before = len(streamed)
        _port(command, src, p["mgf"], *flags, *EXEC,
              "--stream-clusters", mode, ck=p["ck"], qc=p["qc"])
        assert len(streamed) - n_before == (0 if mode == "off" else 1)
        if mode == "auto":
            assert streamed[-1].window == 512
        _jax(command, src, j["mgf"], *flags, *jflags, *EXEC,
             "--stream-clusters", mode, ck=j["ck"], qc=j["qc"])
        got[mode] = tuple(p[k].read_bytes() for k in ("mgf", "ck", "qc"))
        if command == "select":
            assert p["mgf"].read_bytes() == j["mgf"].read_bytes()
            assert p["ck"].read_bytes() == j["ck"].read_bytes()
        else:
            _assert_close_mgf(p["mgf"], j["mgf"])
            pm, jm = (json.loads(x["ck"].read_text()) for x in (p, j))
            assert pm["done"] == jm["done"] and pm["schema"] == jm["schema"]
        _assert_close_qc(p["qc"], j["qc"])
    assert got["2"] == got["off"] and got["auto"] == got["off"]


def test_streamed_checkpoint_and_resume(tmp_path):
    """Streaming composes with checkpoint and resume (the JAX package's
    ``TestStreamingIngest``): a run killed after its first chunks resumes
    on a streamed view to the uninterrupted bytes, and a resume over a
    finished run recomputes the QC report of the skipped clusters off the
    output, the uninterrupted report's bytes."""
    spectra = _spectra(seed=9, n_clusters=8, n_peaks=30)
    src = str(_write(tmp_path / "in.mgf", spectra))
    flags = ("--stream-clusters", "3", "--checkpoint-every", "3")
    _port("consensus", src, tmp_path / "full.mgf", *flags,
          ck=tmp_path / "full.ck", qc=tmp_path / "full.qc")
    # a killed run: the committed head (its first two chunks), streamed
    head_ids = {f"cluster-{i}" for i in range(6)}
    head = str(_write(tmp_path / "head.mgf",
                      [s for s in spectra if s.cluster_id in head_ids]))
    out, ck = tmp_path / "out.mgf", tmp_path / "out.ck"
    _port("consensus", head, out, *flags, ck=ck)
    with open(out, "ab") as fh:
        fh.write(b"BEGIN IONS\nTITLE=torn")
    qc = tmp_path / "out.qc"
    _port("consensus", src, out, *flags, "--prefetch", "0", ck=ck, qc=qc)
    assert out.read_bytes() == (tmp_path / "full.mgf").read_bytes()
    assert ck.read_bytes() == (tmp_path / "full.ck").read_bytes()
    assert qc.read_bytes() == (tmp_path / "full.qc").read_bytes()
    # a resume over the finished run: everything skipped, QC recomputed
    qc2 = tmp_path / "again.qc"
    _port("consensus", src, out, *flags, ck=ck, qc=qc2)
    assert qc2.read_bytes() == (tmp_path / "full.qc").read_bytes()
    assert out.read_bytes() == (tmp_path / "full.mgf").read_bytes()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_each_window_parsed_once(precision, tmp_path, monkeypatch):
    """The executor parses each window once (the ids of the QC report and
    the resume come off the index); a reduced precision's gate adds the
    parses of its sample's windows."""
    src = _clustered(tmp_path, n_clusters=10)
    views = []
    real = cli.StreamedClusters

    class Counted(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            views.append(self)

    monkeypatch.setattr(cli, "StreamedClusters", Counted)
    monkeypatch.setattr(mgf, "StreamedClusters", Counted)
    _port("consensus", src, tmp_path / "o.mgf", "--stream-clusters", "2",
          "--precision", precision, *EXEC, ck=tmp_path / "o.ck",
          qc=tmp_path / "o.qc")
    parent, subs = views[0], views[1:]
    assert parent.windows_parsed == 5  # 10 clusters in windows of 2
    # the gate's sample (its first 32 clusters: all 10 here) is a sub-view
    # of the same window size
    assert len(subs) == (1 if precision == "bf16" else 0)
    assert sum(v.windows_parsed for v in subs) == (
        5 if precision == "bf16" else 0)
