"""The port's MGF parser and peak formatter (``ops/csrc/mgf_parser.cpp``
and ``ops/csrc/mgf_format.cpp`` through ``io/native.py``) against its
pure-Python parser and numpy writer and against the JAX package's
Python parser and writer.

Parsing must be exact: identical titles, headers and float64 bit
patterns (every parser rounds decimal to double correctly), and a
malformed number raises in every parser.  Writing must be byte-identical:
the shortest round-trip digits laid out as Python's ``repr``, the bytes of
numpy's ``astype("U32")``, over the golden files and seeded float64 bit
patterns with their extremes.  The resume manifest hashes these bytes, so
one byte of difference would break a resume across versions."""

import ctypes
import gzip
import io
import os

import numpy as np
import pytest

from specpride_tpu.data.peaks import Spectrum as JSpectrum
from specpride_tpu.io import mgf as jmgf
from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.io import mgf, native
from specpride_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
GOLDEN = ["golden_clustered.mgf", "golden_bin_mean.mgf",
          "golden_gap_average.mgf", "golden_medoid.mgf", "golden_best.mgf"]


def _plain(path):
    with mgf._open_text(path) as fh:
        return list(mgf.parse_mgf_stream(fh))


def _fields(s):
    return (s.title, s.precursor_mz, s.precursor_charge, s.rt, s.extra,
            s.mz.tobytes(), s.intensity.tobytes())


def _assert_identical(*runs):
    first = [_fields(s) for s in runs[0]]
    for run in runs[1:]:
        assert [_fields(s) for s in run] == first


def _random_spectra(rng, n=40):
    """The JAX package's native-parser parity input
    (tests/test_native_mgf.py)."""
    return [
        Spectrum(
            mz=np.sort(rng.uniform(100, 2000, k)),
            intensity=rng.uniform(0, 1e6, k),
            precursor_mz=float(rng.uniform(300, 900)),
            precursor_charge=int(rng.integers(-3, 4)),
            rt=float(rng.uniform(0, 3600)) if i % 3 else 0.0,
            title=f"cluster-{i};mzspec:PXD004732:run a;b=c:scan:{i}",
            extra={"SEQUENCE": "PEPTIDE", "SCANS": str(i)} if i % 2 else {},
        )
        for i, k in enumerate(rng.integers(1, 300, n))
    ]


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_parse_and_write_match_plain_and_jax(name, tmp_path):
    path = os.path.join(DATA, name)
    got = mgf.read_mgf(path)
    _assert_identical(got, _plain(path),
                      jmgf.read_mgf(path, use_native=False))
    for s in got:
        assert mgf.format_spectrum(s) == mgf.format_spectrum_plain(s) == \
            jmgf.format_spectrum(JSpectrum(s.mz, s.intensity, s.precursor_mz,
                                           s.precursor_charge, s.rt, s.title,
                                           dict(s.extra)))
    mgf.write_mgf(got, tmp_path / "port.mgf")
    jmgf.write_mgf(jmgf.read_mgf(path, use_native=False),
                   tmp_path / "jax.mgf")
    assert (tmp_path / "port.mgf").read_bytes() == \
        (tmp_path / "jax.mgf").read_bytes()


ODDITIES = """# a comment outside any record
random garbage
BEGIN IONS
TITLE=c1;mzspec:PXD1:r:scan:1

pepmass=445.12 1000.5
CHARGE=2+
rtinseconds=12.5
SEQUENCE=PEPTIDE
100.5 200.25
101.5
.5 7
+2.5 8

END IONS
stray line between records
BEGIN IONS
TITLE=c2;u2
PEPMASS=
CHARGE=3-
300.1 1.0
END IONS
"""

MALFORMED = ["100.5 12,3", "1.5.5 7", "RTINSECONDS=12.5 min", "CHARGE=abc",
             "PEPMASS=abc 100"]


def _write_case(case, tmp_path):
    """The file of one dialect case of tests/test_native_mgf.py:55-169."""
    path = tmp_path / "case.mgf"
    if case in ("random", "gzip"):
        mgf.write_mgf(_random_spectra(np.random.default_rng(11)), path)
        if case == "gzip":
            gz = tmp_path / "case.mgf.gz"
            with gzip.open(gz, "wb") as fo:
                fo.write(path.read_bytes())
            return gz
    elif case == "oddities":
        path.write_text(ODDITIES)
    elif case == "unterminated":
        path.write_text("BEGIN IONS\nTITLE=c1;u\n100.0 1.0\n")
    elif case == "truncated":
        # a record cut short by the next BEGIN IONS, and one by the end
        path.write_text("BEGIN IONS\nTITLE=c0;u\n123.4 10.0\n\nBEGIN IONS\n"
                        "TITLE=c1;u\n100.0 1.0\nEND IONS\nBEGIN IONS\n"
                        "TITLE=c2;u\n7.0 8.0\n")
    elif case == "charge_plus":
        path.write_text(
            "BEGIN IONS\nTITLE=c1;u\nCHARGE=+2\n100.0 1.0\nEND IONS\n")
    else:
        bad = MALFORMED[int(case.split("-")[1])]
        path.write_text(
            f"BEGIN IONS\nTITLE=c1;u\n{bad}\n100.0 1.0\nEND IONS\n")
    return path


@pytest.mark.parametrize("case", [
    "random", "gzip", "oddities", "unterminated", "charge_plus",
    "truncated", *(f"malformed-{i}" for i in range(len(MALFORMED))),
])
def test_dialect_cases_match_plain_and_jax(case, tmp_path):
    path = _write_case(case, tmp_path)
    if case.startswith("malformed"):
        with pytest.raises(RuntimeError, match="line 3"):
            mgf.read_mgf(path)
        with pytest.raises(ValueError):
            _plain(path)
        with pytest.raises(ValueError):
            jmgf.read_mgf(path, use_native=False)
        return
    got = mgf.read_mgf(path)
    _assert_identical(got, _plain(path),
                      jmgf.read_mgf(path, use_native=False))
    if case == "unterminated":
        assert got == []
    if case == "truncated":
        # the peaks of the cut-short records belong to no spectrum
        assert [s.title for s in got] == ["c1;u"]
        np.testing.assert_array_equal(got[0].mz, [100.0])
    if case == "charge_plus":
        assert got[0].precursor_charge == 2
    if case == "oddities":
        assert (got[0].precursor_mz, got[0].precursor_charge, got[0].rt,
                got[0].extra) == (445.12, 2, 12.5, {"SEQUENCE": "PEPTIDE"})
        np.testing.assert_array_equal(got[0].mz, [100.5, 101.5, 0.5, 2.5])
        np.testing.assert_array_equal(got[0].intensity,
                                      [200.25, 0.0, 7.0, 8.0])
        assert (got[1].precursor_mz, got[1].precursor_charge) == (0.0, -3)


def test_truncated_records_drop_their_peaks_in_every_thread():
    """Records cut short by the next BEGIN IONS, spread through a buffer
    that four parse threads split: the Python parser's spectra, none with
    a peak of a truncated record (the JAX package's C++ parser, which this
    one was copied from, kept such peaks at the head of the next
    record)."""
    spectra = _random_spectra(np.random.default_rng(5), n=4000)
    blocks = mgf.write_mgf(spectra, None).split("\n\n")
    for i in range(3990, 0, -997):
        blocks.insert(i, "BEGIN IONS\nTITLE=cut;u\n123.4 10.0\n55.5 1.0")
    text = "\n\n".join(blocks) + "BEGIN IONS\nTITLE=cut;u\n9.0 9.0\n"
    assert len(text) > 16 << 20  # four threads' worth of 4 MB
    got = native.parse_mgf_bytes(text.encode(), threads=4)
    _assert_identical(got, list(mgf.parse_mgf_stream(io.StringIO(text))))
    assert _fields(got[0]) == _fields(spectra[0])
    assert all(123.4 not in s.mz for s in got)


def test_threaded_split_ignores_begin_ions_prefix():
    """Two parse threads split the text at a line that trims to exactly
    "BEGIN IONS": a header line merely starting with those bytes, placed
    just past the midpoint inside one giant record, is no split point
    (tests/test_native_mgf.py:171)."""
    parts = ["BEGIN IONS\nTITLE=cluster-0;u0\nPEPMASS=500.25\nCHARGE=2+\n"]
    parts.append("\n".join(f"{100.0 + i * 0.001:.3f} {i % 997}.5"
                           for i in range(450000)))
    parts.append("\nBEGIN IONSFAKE=1\nBEGIN IONS EXTRA=x\n")
    parts.append("".join(f"{600.0 + i:.1f} 1.0\n" for i in range(5)))
    parts.append("END IONS\n")
    small = ("BEGIN IONS\nTITLE=cluster-{i};u{i}\nPEPMASS=400.5\n"
             "CHARGE=2+\n"
             + "".join(f"{200.0 + j * 0.5:.1f} {j + 1}.0\n"
                       for j in range(400))
             + "END IONS\n")
    parts.extend(small.replace("{i}", str(i)) for i in range(1, 600))
    text = "".join(parts)
    assert len(text) >= 8 << 20, "the split needs two 4 MB halves"
    want = list(mgf.parse_mgf_stream(io.StringIO(text)))
    assert len(want) == 600 and want[0].extra["BEGIN IONSFAKE"] == "1"
    for threads in (2, 1):
        _assert_identical(native.parse_mgf_bytes(text.encode(), threads),
                          want)


def _bit_patterns(seed, n=20000):
    """Seeded float64 bit patterns (every class: normals, subnormals, both
    zeros, infinities, NaNs) and the layout's edges."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**64, size=n, dtype=np.uint64).view(np.float64)
    edges = np.array([
        0.0, -0.0, 5e-324, -5e-324, 2.2250738585072014e-308,
        2.225073858507201e-308, 1.7976931348623157e308,
        -1.7976931348623157e308, np.inf, -np.inf, np.nan,
        1e16, 9999999999999998.0, 1e16 + 2, 1.2345678901234567e16,
        1e-4, 1e-5, 9.999999999999999e-05, 0.00012345, 1.5e-5,
        1.0, 100.0, -3.0, 123456789012345.0, 1e15, 0.1, 1 / 3, 1e22,
        1e100, 1e-100, 1e-310,
    ])
    ints = np.arange(-300, 300, dtype=np.float64)
    f32 = rng.uniform(100, 2000, 2000).astype(np.float32).astype(np.float64)
    return np.concatenate([bits, edges, ints, f32,
                           rng.uniform(0, 1e6, 2000)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_formatter_matches_numpy_on_bit_patterns(seed):
    vals = _bit_patterns(seed)
    mz, inten = vals, np.roll(vals, 13)  # NaN lands in either column
    s = Spectrum(mz, inten, 500.5, 2, 12.5, "c;u", {"K": "v"})
    j = JSpectrum(mz, inten, 500.5, 2, 12.5, "c;u", {"K": "v"})
    want = jmgf.format_spectrum(j)
    assert mgf.format_spectrum_plain(s) == want
    assert mgf.format_spectrum(s) == want
    # the batch entry, split into spectra of ragged sizes (empty included)
    cuts = np.sort(np.random.default_rng(seed).integers(0, vals.size, 40))
    pieces = np.split(np.arange(vals.size), cuts)
    spectra = [Spectrum(mz[p], inten[p], title=f"c{i}")
               for i, p in enumerate(pieces)]
    assert native.format_peaks_many([x.mz for x in spectra],
                                    [x.intensity for x in spectra]) == [
        native.format_peaks(x.mz, x.intensity) for x in spectra]
    assert mgf.write_mgf(spectra, None) == "".join(
        mgf.format_spectrum_plain(x) for x in spectra)


def test_formatter_never_writes_past_cap():
    lib = _build.load_host()
    mz = np.array([1.5, 1.7976931348623157e308, 2.0])
    inten = np.array([2.5, -5e-324, np.nan])
    pd = ctypes.POINTER(ctypes.c_double)
    full = "1.5 2.5\n1.7976931348623157e+308 -5e-324\n"
    for cap in (0, 7, 8, len(full) - 1, len(full), len(full) + 10):
        buf = ctypes.create_string_buffer(b"#" * 100, 100)
        n = lib.mgf_format_peaks(mz.ctypes.data_as(pd),
                                 inten.ctypes.data_as(pd), 3, buf, cap)
        assert buf.raw[cap:] == b"#" * (100 - cap)
        if cap >= len(full):
            assert buf.raw[:n].decode() == full
        else:
            assert n == -1
    offsets = np.array([0, 1, 3], dtype=np.int64)
    out_offsets = np.zeros(3, dtype=np.int64)
    buf = ctypes.create_string_buffer(b"#" * 100, 100)
    p64 = ctypes.POINTER(ctypes.c_int64)
    n = lib.mgf_format_batch(mz.ctypes.data_as(pd), inten.ctypes.data_as(pd),
                             offsets.ctypes.data_as(p64), 2, buf,
                             len(full) - 1, out_offsets.ctypes.data_as(p64),
                             2)
    assert n == -1 and buf.raw == b"#" * 100


def test_write_mgf_targets_give_the_same_bytes(tmp_path):
    spectra = _random_spectra(np.random.default_rng(5), n=25)
    jspectra = [JSpectrum(s.mz, s.intensity, s.precursor_mz,
                          s.precursor_charge, s.rt, s.title, dict(s.extra))
                for s in spectra]
    want = jmgf.write_mgf(jspectra, None)
    assert mgf.write_mgf(spectra, None) == want
    mgf.write_mgf(spectra, tmp_path / "path.mgf")
    assert (tmp_path / "path.mgf").read_text() == want
    with open(tmp_path / "handle.mgf", "w", encoding="utf-8") as fh:
        fh.write("# kept\n")
        assert mgf.write_mgf(iter(spectra[:10]), fh) is None
        mgf.write_mgf(spectra[10:], fh)
    assert (tmp_path / "handle.mgf").read_text() == "# kept\n" + want
    mgf.write_mgf(spectra[:3], tmp_path / "app.mgf")
    mgf.write_mgf(spectra[3:], tmp_path / "app.mgf", append=True)
    assert (tmp_path / "app.mgf").read_text() == want
    _assert_identical(mgf.read_mgf(tmp_path / "path.mgf"), spectra)


def test_write_batches_past_the_batch_bound(monkeypatch, tmp_path):
    """Records stream out in several formatter calls when their peaks pass
    ``WRITE_BATCH_PEAKS``; the bytes are those of one call."""
    spectra = _random_spectra(np.random.default_rng(6), n=30)
    want = "".join(mgf.format_spectrum_plain(s) for s in spectra)
    monkeypatch.setattr(mgf, "WRITE_BATCH_PEAKS", 100)
    assert mgf.write_mgf(spectra, None) == want


def test_failed_host_build_raises_for_the_parser(tmp_path, monkeypatch):
    """No fallback: a host library that does not build raises from
    ``read_mgf`` and from the writer, never taking the Python parser or
    the numpy formatter."""
    path = tmp_path / "a.mgf"
    path.write_text("BEGIN IONS\nTITLE=c;u\n100.0 1.0\nEND IONS\n")
    monkeypatch.setattr(_build, "_host_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_find_cxx", lambda: "false")
    with pytest.raises(RuntimeError, match="host library build failed"):
        mgf.read_mgf(path)
    with pytest.raises(RuntimeError, match="host library build failed"):
        mgf.write_mgf([Spectrum(np.ones(1), np.ones(1))], None)
