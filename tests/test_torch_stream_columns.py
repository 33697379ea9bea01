"""The streamed reader in columns, on the CPU.

The host library's grouped byte index (``io/native.py::index_clusters``)
against the Python scan (``StreamedClusters._scan_plain``) and the
``parse_title`` grouping of its records, at several scan thread counts; a
window's ``SpectraTable`` against ``SpectraTable.from_clusters`` of the
eager clusters, column for column and bit for bit, and its views' members
against the eager ``Spectrum``s; and the CLI on a streamed input against
the same input read whole: the same output and QC report bytes, the
representatives' precursor values those of the members' ``Spectrum``s,
and the run summary's ``stream`` counters."""

import gc
import json
import re
import threading
import time

import numpy as np
import pytest

from specpride_tpu_torch import cli
from specpride_tpu_torch.backends import numpy_backend
from specpride_tpu_torch.config import GapAverageConfig
from specpride_tpu_torch.data.peaks import (
    Spectrum,
    build_title,
    group_into_clusters,
    parse_title,
)
from specpride_tpu_torch.data.table import ClusterView, SpectraTable
from specpride_tpu_torch.io import mgf, native


def _spectra(seed=3, n_clusters=8, scatter=False, n_peaks=20):
    """Clusters of 1-4 members, each member its own precursor m/z and RT,
    one charge per cluster, and two extra headers."""
    rng = np.random.default_rng(seed)
    spectra = []
    for ci in range(n_clusters):
        skeleton = np.sort(rng.uniform(100.0, 1500.0, n_peaks))
        for m in range(1 + ci % 4):
            scan = ci * 100 + m
            spectra.append(Spectrum(
                mz=np.sort(skeleton + rng.normal(0.0, 0.004, n_peaks)),
                intensity=rng.uniform(1.0, 100.0, n_peaks),
                precursor_mz=float(rng.uniform(300.0, 900.0)),
                precursor_charge=2 + ci % 2,
                rt=float(rng.uniform(0.0, 3600.0)),
                title=build_title(f"cluster-{ci}", "PXD004732", "r.raw",
                                  scan),
                extra={"SCANS": str(scan), "COMMENT": f"member {m}=x"},
            ))
    if scatter:
        # members of one cluster interleaved with other clusters' members
        order = rng.permutation(len(spectra))
        spectra = [spectra[i] for i in order]
    return spectra


def _text(**kw) -> str:
    return mgf.write_mgf(_spectra(**kw), None)


# -- the byte index and its grouping ----------------------------------------


INDEX_CASES = {
    "plain": lambda: _text(),
    "titleless": lambda: _text().replace(
        "TITLE=cluster-0;mzspec:PXD004732:r.raw:scan:0\n", "", 1).replace(
        "TITLE=cluster-5;mzspec:PXD004732:r.raw:scan:501\n", "", 1),
    # the untitled record's name, index=0, is also a title here: one
    # cluster, as the grouping of the records' ids makes it
    "titled_like_index": lambda: _text().replace(
        "TITLE=cluster-0;mzspec:PXD004732:r.raw:scan:0\n", "", 1).replace(
        "TITLE=cluster-2;", "TITLE=index=0;"),
    "recurring_ids": lambda: _text(scatter=True),
    "blank_lines": lambda: _text().replace("END IONS\n",
                                           "END IONS\n\n \t\n\n"),
    "truncated_middle_and_end": lambda: _text().replace(
        "END IONS\n", "", 2).rstrip()[: -len("END IONS")],
    "non_ascii": lambda: _text().replace(
        "cluster-2;", "clüster-2→;").replace("cluster-5;", "群-5;"),
    "title_without_semicolon": lambda: re.sub(
        r"TITLE=cluster-3;[^\n]*", "TITLE=cluster-3", _text()),
    "crlf": lambda: _text().replace("\n", "\r\n"),
    "no_final_newline": lambda: _text().rstrip("\n"),
    # records of ~60 kB, so a scan's blocks and the split search's end
    # inside records
    "large_records": lambda: _text(n_clusters=12, n_peaks=1800),
}


def _plain_index(path):
    """The Python scan's records and spans, grouped by ``parse_title``:
    ``(groups, begins, spans)``."""
    view = mgf.StreamedClusters(path)
    records = view._scan_plain()
    by_id: dict[str, list] = {}
    for title, begin, end in records:
        by_id.setdefault(parse_title(title)[0], []).append((begin, end))
    return (list(by_id.items()), [b for _, b, _ in records],
            view.malformed_spans, records)


def _native_groups(index):
    return [(name, list(zip(index.member_begin[a:b].tolist(),
                            index.member_end[a:b].tolist())))
            for name, a, b in zip(index.names,
                                  index.group_offsets[:-1].tolist(),
                                  index.group_offsets[1:].tolist())]


@pytest.mark.parametrize("threads", [1, 2, 3, 7])
@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_native_grouping_matches_plain_scan(case, threads, tmp_path):
    """Every cluster's name, the clusters' order, every record's bytes and
    the truncated spans: the Python scan's, whatever ranges the threads
    split the file into."""
    path = tmp_path / f"{case}.mgf"
    path.write_bytes(INDEX_CASES[case]().encode("utf-8"))
    groups, begins, spans, records = _plain_index(path)
    got = native.index_clusters(path, threads=threads)
    assert _native_groups(got) == groups
    assert got.begins.tolist() == begins
    assert got.spans == spans
    assert native.index_mgf(path, threads=threads) == (records, spans)
    if case.startswith("truncated"):
        assert len(spans) == 3  # two in the middle, one at the end
    if case == "titleless":
        assert [n for n in got.names if n.startswith("index=")] == [
            "index=0", "index=12"]
    if case == "titled_like_index":
        assert got.names.count("index=0") == 1
        assert len(dict(groups)["index=0"]) == 4


@pytest.mark.parametrize("threads", [1, 3])
def test_title_not_utf8_raises(threads, tmp_path):
    """A title that is not UTF-8, past its cluster id, raises as the
    Python scan's decode does."""
    text = _text().encode("utf-8").replace(
        b"cluster-4;mzspec", b"cluster-4;mz\xffspec", 1)
    path = tmp_path / "bad.mgf"
    path.write_bytes(text)
    with pytest.raises(UnicodeDecodeError):
        mgf.StreamedClusters(path)._scan_plain()
    with pytest.raises(UnicodeDecodeError):
        native.index_clusters(path, threads=threads)
    with pytest.raises(UnicodeDecodeError):
        mgf.StreamedClusters(path)


# -- a window's table and its views -----------------------------------------


def _same_table(got: SpectraTable, want: SpectraTable):
    for field in ("mz", "intensity", "peak_offsets", "precursor_mz",
                  "precursor_charge", "rt", "cluster_code"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        assert a.tobytes() == b.tobytes(), field
    assert got.titles == want.titles
    assert got.cluster_names == want.cluster_names


def _same_spectrum(a: Spectrum, b: Spectrum):
    assert a.title == b.title and a.extra == b.extra
    assert a.precursor_mz == b.precursor_mz and a.rt == b.rt
    assert a.precursor_charge == b.precursor_charge
    assert type(a.precursor_charge) is type(b.precursor_charge) is int
    assert a.mz.dtype == b.mz.dtype == np.float64
    assert a.mz.tobytes() == b.mz.tobytes()
    assert a.intensity.tobytes() == b.intensity.tobytes()


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("window", [1, 3, 512])
def test_window_table_equals_object_table(window, scatter, tmp_path):
    """``from_clusters`` of a streamed input's views (a whole window, part
    of one, a run over two windows, and clusters out of order) is the
    table of the eager clusters, and makes no ``Spectrum``."""
    path = tmp_path / "in.mgf"
    path.write_text(_text(n_clusters=9, scatter=scatter))
    eager = group_into_clusters(mgf.read_mgf(path))
    streamed = mgf.StreamedClusters(path, window=window)
    views = list(streamed)
    assert all(isinstance(v, ClusterView) for v in views)
    n = len(views)
    picks = [range(min(window, n)), range(1, min(n, window + 2)),
             range(n), [n - 1, 0, 2], [4]]
    for pick in picks:
        _same_table(SpectraTable.from_clusters([views[i] for i in pick]),
                    SpectraTable.from_clusters([eager[i] for i in pick]))
    assert [v.n_members for v in views] == [c.n_members for c in eager]
    assert [v.total_peaks for v in views] == [c.total_peaks for c in eager]
    assert streamed.counts.summary() == {
        "windows": -(-n // window), "columnar_windows": -(-n // window),
        "spectrum_objects": 0}


@pytest.mark.parametrize("scatter", [False, True])
def test_view_members_equal_eager_spectra(scatter, tmp_path):
    """A view's members, made when asked for: the eager ``Spectrum``s,
    headers included, each counted once."""
    path = tmp_path / "in.mgf"
    path.write_text(_text(n_clusters=7, scatter=scatter))
    eager = group_into_clusters(mgf.read_mgf(path))
    streamed = mgf.StreamedClusters(path, window=3)
    for view, cluster in zip(streamed, eager):
        assert view.cluster_id == cluster.cluster_id
        assert len(view.members) == cluster.n_members
        for a, b in zip(view.members, cluster.members):
            _same_spectrum(a, b)
        assert view.members is view.members  # made once
    assert streamed.counts.spectrum_objects == sum(
        c.n_members for c in eager)


def test_lanes_share_one_parse_of_a_window(tmp_path):
    """Lanes that ask for one cold window at once wait for one parse of
    it (a second parse would quarantine its damaged records twice)."""
    path = tmp_path / "in.mgf"
    path.write_text(_text(n_clusters=6))
    streamed = mgf.StreamedClusters(path, window=4)
    real = streamed._materialize

    def slow(lo, hi):
        time.sleep(0.2)
        return real(lo, hi)

    streamed._materialize = slow
    got = {}
    lanes = [threading.Thread(target=lambda i=i: got.update({i: streamed[i]}))
             for i in (0, 1, 3)]
    for lane in lanes:
        lane.start()
    for lane in lanes:
        lane.join(timeout=30)
    assert not any(lane.is_alive() for lane in lanes)
    assert sorted(got) == [0, 1, 3]
    assert len({id(view.source) for view in got.values()}) == 1
    assert streamed.windows_parsed == 1
    assert streamed.counts.windows == 1


def test_parsed_peaks_outlive_their_parse(tmp_path):
    """The parser's peaks reach numpy without a copy; a view of them, or
    a ``Spectrum`` made from them, keeps the parse alive after the columns
    are dropped."""
    text = _text(n_clusters=5).encode("utf-8")
    cols = native.parse_mgf_columns(text, threads=2)
    want = [s for s in mgf.parse_mgf_stream(iter(text.decode().splitlines()))]
    tail, spectra = cols.mz[7:], cols.spectra(2, 5)
    mz = cols.mz.copy()
    del cols
    gc.collect()
    churn = [np.full(1 << 16, 7.0) for _ in range(64)]
    assert tail.tobytes() == mz[7:].tobytes()
    for a, b in zip(spectra, want[2:5]):
        _same_spectrum(a, b)
    del churn


# -- the CLI: streamed against eager ----------------------------------------


EXEC = ("--prefetch", "2", "--pack-workers", "2", "--checkpoint-every", "2")


def _msms(path, spectra):
    rng = np.random.default_rng(1)
    rows = ["Raw file\tScan number\tModified sequence\tScore"]
    for s in spectra:
        scan = s.usi.rsplit(":", 1)[1]
        rows.append(f"r\t{scan}\t_PEPTIDER_\t{rng.uniform(50, 150):.3f}")
    path.write_text("\n".join(rows) + "\n")
    return path


def _damage(text: str) -> str:
    """A truncated record, then an unparseable member of a cluster that
    keeps others.  (A damaged record alone in its cluster leaves that
    cluster in the streamed input's index with no member, which the run
    reports as a failed cluster, as the JAX package's stream does; read
    whole, the cluster is never seen.)"""
    blocks = text.split("\n\n")
    blocks.insert(3, "BEGIN IONS\nTITLE=cluster-trunc;mzspec:PXD004732:"
                     "r.raw:scan:8\nPEPMASS=500.0\n123.4 10.0")
    blocks.insert(6, "BEGIN IONS\nTITLE=cluster-3;mzspec:PXD004732:r.raw:"
                     "scan:9\nPEPMASS=500.0\n123.4 banana\nEND IONS")
    return "\n\n".join(blocks)


CLI_CASES = {
    # name: (argv after the paths, damaged input, reads members)
    "bin_mean_qc": (("consensus", "--method", "bin-mean"), False, False),
    "gap_average": (("consensus", "--method", "gap-average"), False, False),
    "bucketized": (("consensus", "--layout", "bucketized"), False, True),
    "select_best": (("select", "--method", "best"), False, True),
    "on_error_skip": (("consensus", "--on-error", "skip"), True, True),
}


def _run(capsys, command, src, out, qc, *flags) -> dict:
    capsys.readouterr()
    assert cli.main([command, str(src), str(out), "--device", "cpu",
                     "--qc-report", str(qc), *flags]) == 0
    return json.loads(capsys.readouterr().err.strip().splitlines()[-1])


@pytest.mark.parametrize("window", ["2", "3"])
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_streamed_outputs_equal_eager(case, window, tmp_path, capsys):
    """Each case streamed in windows of 2 (a chunk a window) and 3 (chunks
    across windows) writes the eager run's output and QC bytes; on the
    consensus path no ``Spectrum`` of a member is made, and every window
    hands the pack a table, except under the tolerant parser."""
    (command, *flags), damaged, reads_members = CLI_CASES[case]
    spectra = _spectra(seed=5, n_clusters=9, scatter=True, n_peaks=30)
    text = mgf.write_mgf(spectra, None)
    src = tmp_path / "in.mgf"
    src.write_text(_damage(text) if damaged else text)
    if command == "select":
        flags += ["--msms", str(_msms(tmp_path / "msms.txt", spectra))]
    got = {}
    for mode in ("off", window):
        out, qc = tmp_path / f"{mode}.mgf", tmp_path / f"{mode}.qc.json"
        summary = _run(capsys, command, src, out, qc, *flags, *EXEC,
                       "--stream-clusters", mode)
        got[mode] = (out.read_bytes(), qc.read_bytes())
        if damaged:
            got[mode] += ((tmp_path / f"{mode}.mgf.quarantine.mgf")
                          .read_bytes(),)
    assert got[window] == got["off"]
    assert "stream" not in _run(capsys, command, src, tmp_path / "e.mgf",
                                tmp_path / "e.qc", *flags)
    stream = summary["stream"]
    # each window parsed once, also where two lanes' chunks share it
    assert stream["windows"] == -(-9 // int(window))
    if damaged:  # the tolerant parser's objects
        assert stream["columnar_windows"] == 0
        assert stream["spectrum_objects"] > 0
    else:
        assert stream["columnar_windows"] == stream["windows"]
        assert (stream["spectrum_objects"] > 0) == reads_members


@pytest.mark.parametrize("method", ["bin-mean", "gap-average"])
def test_streamed_precursors_equal_member_estimates(method, tmp_path,
                                                    capsys):
    """The representatives' precursor m/z, charge and RT, read off the
    window's table, equal the estimates over the members' ``Spectrum``s:
    the bin-mean's mean m/z and first charge, the gap average's
    estimators of the configuration."""
    spectra = _spectra(seed=8, n_clusters=9, scatter=True)
    src = tmp_path / "in.mgf"
    src.write_text(mgf.write_mgf(spectra, None))
    out = tmp_path / "out.mgf"
    _run(capsys, "consensus", src, out, tmp_path / "qc.json", "--method",
         method, "--stream-clusters", "2", *EXEC)
    clusters = group_into_clusters(mgf.read_mgf(src))
    reps = mgf.read_mgf(out)
    assert [r.title for r in reps] == [c.cluster_id for c in clusters]
    pepmass, rt = numpy_backend.resolve_gap_estimators(GapAverageConfig())
    for rep, c in zip(reps, clusters):
        if method == "bin-mean":
            want = (float(np.mean([s.precursor_mz for s in c.members])),
                    c.members[0].precursor_charge, 0.0)
        else:
            want = (*pepmass(c.members), rt(c.members))
        assert (rep.precursor_mz, rep.precursor_charge, rep.rt) == want
