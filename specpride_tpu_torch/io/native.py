"""The MGF parser, byte index and peak formatter of the port's host
library (``ops/csrc/mgf_parser.cpp`` and ``ops/csrc/mgf_format.cpp``,
built by ``ops/_build.load_host``; ctypes releases the interpreter lock
for each call).

``read_mgf_native`` gives the ``Spectrum``s of the pure-Python parser
(``io/mgf.py::parse_mgf_stream``): the same titles, headers and float64
bit patterns; ``parse_mgf_columns`` gives the same records as columns
(``MgfColumns``), with no ``Spectrum`` made until one is asked for.
``index_clusters`` is the byte index of a streamed input with its records
grouped into clusters, all in arrays.  ``format_peaks`` and
``format_peaks_many`` give the peak lines of the numpy writer
(``io/mgf.py::format_spectrum_plain``) byte for byte.  A failed build
raises: nothing here falls back to the Python versions, which only the
tests run."""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gzip
import os

import numpy as np

from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.ops import _build

_PD = ctypes.POINTER(ctypes.c_double)
_P64 = ctypes.POINTER(ctypes.c_int64)
# a peak line is at most two 24-byte reprs, a space and a newline
MAX_LINE = 50


def _column(ptr, n: int, dtype) -> np.ndarray:
    """A copy of the n-element column at ``ptr``."""
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


class _Parse:
    """A parse's handle, freed when the last column over it goes."""

    def __init__(self, lib, handle):
        self.lib, self.handle = lib, handle

    def __del__(self):
        self.lib.mgf_free(self.handle)


def _peaks(ptr, n: int, owner: _Parse) -> np.ndarray:
    """The n float64 values at ``ptr`` in place (no copy: a window's peaks
    are most of its bytes), keeping ``owner`` alive while any view of
    them lives."""
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    buf = (ctypes.c_char * (8 * n)).from_address(
        ctypes.cast(ptr, ctypes.c_void_p).value)
    buf.owner = owner
    return np.frombuffer(buf, dtype=np.float64)


def _split(buf: bytes, offsets: np.ndarray) -> list[str]:
    """The UTF-8 strings ``buf[offsets[i]:offsets[i+1]]``."""
    text = buf.decode("utf-8")
    bounds = offsets.tolist()
    if len(text) != len(buf):  # not ASCII: byte offsets are not str's
        return [buf[a:b].decode("utf-8")
                for a, b in zip(bounds[:-1], bounds[1:])]
    return [text[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


@dataclasses.dataclass
class MgfColumns:
    """The records of one parse, in input order, as columns (the names of
    ``SpectraTable``'s), and each one's other headers: ``extras[i]`` is
    record i's "KEY=VALUE\\n" lines, every header but TITLE, PEPMASS,
    CHARGE and RTINSECONDS, keys uppercased."""

    mz: np.ndarray  # (P,) f64
    intensity: np.ndarray  # (P,) f64
    peak_offsets: np.ndarray  # (S+1,) i64
    precursor_mz: np.ndarray  # (S,) f64
    precursor_charge: np.ndarray  # (S,) i32
    rt: np.ndarray  # (S,) f64
    titles: list[str]
    extras: list[str]

    def spectra(self, r0: int = 0, r1: int | None = None) -> list[Spectrum]:
        """The ``Spectrum``s of records ``r0:r1`` (peaks as views of the
        columns)."""
        r1 = len(self.titles) if r1 is None else r1
        bounds = self.peak_offsets[r0 : r1 + 1].tolist()
        prec_mz = self.precursor_mz[r0:r1].tolist()
        charge = self.precursor_charge[r0:r1].tolist()
        rt = self.rt[r0:r1].tolist()
        spectra = []
        for i in range(r1 - r0):
            lo, hi = bounds[i], bounds[i + 1]
            extra: dict[str, str] = {}
            # a value holds no "\n" (lines end there)
            for line in self.extras[r0 + i].split("\n")[:-1]:
                key, _, value = line.partition("=")
                extra[key] = value
            spectra.append(Spectrum(
                mz=self.mz[lo:hi], intensity=self.intensity[lo:hi],
                precursor_mz=prec_mz[i], precursor_charge=charge[i],
                rt=rt[i], title=self.titles[r0 + i], extra=extra,
            ))
        return spectra


def _columns(lib, handle, owner: _Parse) -> MgfColumns:
    n = int(lib.mgf_n_spectra(handle))
    n_peaks = int(lib.mgf_n_peaks(handle))
    title_off = _column(lib.mgf_title_offsets(handle), n + 1, np.int64)
    extra_off = _column(lib.mgf_extra_offsets(handle), n + 1, np.int64)
    return MgfColumns(
        mz=_peaks(lib.mgf_mz(handle), n_peaks, owner),
        intensity=_peaks(lib.mgf_intensity(handle), n_peaks, owner),
        peak_offsets=_column(lib.mgf_peak_offsets(handle), n + 1, np.int64),
        precursor_mz=_column(lib.mgf_precursor_mz(handle), n, np.float64),
        precursor_charge=_column(lib.mgf_charge(handle), n, np.int32),
        rt=_column(lib.mgf_rt(handle), n, np.float64),
        titles=_split(ctypes.string_at(lib.mgf_titles(handle),
                                       int(title_off[-1])), title_off),
        extras=_split(ctypes.string_at(lib.mgf_extras(handle),
                                       int(extra_off[-1])), extra_off),
    )


def _parsed(lib, handle, errbuf, what: str) -> MgfColumns:
    if not handle:
        raise RuntimeError(f"MGF parse of {what} failed: "
                           f"{errbuf.value.decode(errors='replace')}")
    return _columns(lib, handle, _Parse(lib, handle))


def parse_mgf_columns(data: bytes, threads: int = 0) -> MgfColumns:
    """The records of the MGF text ``data`` as columns; ``threads`` <= 0
    uses one parse thread per hardware thread (records split at ``BEGIN
    IONS`` lines)."""
    lib = _build.load_host()
    errbuf = ctypes.create_string_buffer(256)
    handle = lib.mgf_parse_buffer(data, len(data), threads, errbuf,
                                  len(errbuf))
    return _parsed(lib, handle, errbuf, "a buffer")


def parse_mgf_bytes(data: bytes, threads: int = 0) -> list[Spectrum]:
    """Spectra of the MGF text ``data`` (``parse_mgf_columns``)."""
    return parse_mgf_columns(data, threads).spectra()


def read_mgf_native(path: str | os.PathLike) -> list[Spectrum]:
    """Spectra of the MGF file at ``path``; a ``.gz`` file is decompressed
    here (Python's gzip) and parsed from memory.  A malformed number
    raises ``RuntimeError`` with its line."""
    path = os.fspath(path)
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            return parse_mgf_bytes(fh.read())
    lib = _build.load_host()
    errbuf = ctypes.create_string_buffer(256)
    handle = lib.mgf_parse(path.encode(), errbuf, len(errbuf))
    return _parsed(lib, handle, errbuf, path).spectra()


@contextlib.contextmanager
def _index(path, threads: int):
    """The host library's index handle of the file at ``path``."""
    lib = _build.load_host()
    errbuf = ctypes.create_string_buffer(256)
    handle = lib.mgf_index(os.fspath(path).encode(), threads, errbuf,
                           len(errbuf))
    if not handle:
        raise OSError(f"MGF index of {os.fspath(path)} failed: "
                      f"{errbuf.value.decode(errors='replace')}")
    try:
        yield lib, handle
    finally:
        lib.mgf_index_free(handle)


def _spans(lib, handle) -> list[tuple[int, int]]:
    n_spans = int(lib.mgf_index_n_spans(handle))
    return list(zip(
        _column(lib.mgf_index_span_begin(handle), n_spans, np.int64).tolist(),
        _column(lib.mgf_index_span_end(handle), n_spans, np.int64).tolist(),
    ))


def index_mgf(path: str | os.PathLike, threads: int = 0):
    """The byte index of the plain MGF file at ``path``, in one pass
    (``threads`` as ``index_clusters``'s): ``(records, spans)``, each
    record ``(title, begin, end)`` (a record without a title named
    ``index=N``, N its place among the records) and each span ``(begin,
    end)`` a truncated block (a ``BEGIN IONS`` inside an open record, or
    one open at EOF).  The records and spans of
    ``io/mgf.py::StreamedClusters._scan_plain``; a title that is not UTF-8
    raises ``UnicodeDecodeError`` as there."""
    with _index(path, threads) as (lib, handle):
        n = int(lib.mgf_index_n_records(handle))
        begin = _column(lib.mgf_index_begin(handle), n, np.int64).tolist()
        end = _column(lib.mgf_index_end(handle), n, np.int64).tolist()
        has_title = _column(lib.mgf_index_has_title(handle), n,
                            np.uint8).tolist()
        title_off = _column(lib.mgf_index_title_offsets(handle), n + 1,
                            np.int64)
        titles = _split(ctypes.string_at(lib.mgf_index_titles(handle),
                                         int(title_off[-1])), title_off)
        spans = _spans(lib, handle)
    records = [(t if h else f"index={i}", b, e)
               for i, (t, h, b, e) in enumerate(zip(titles, has_title,
                                                    begin, end))]
    return records, spans


@dataclasses.dataclass
class MgfClusterIndex:
    """The byte index of a clustered MGF, grouped as
    ``data/peaks.py::group_into_clusters`` groups its spectra: cluster
    ``k``, ``names[k]`` (first-seen order), has the records
    ``member_begin[j]:member_end[j]`` for j in ``group_offsets[k]:
    group_offsets[k + 1]``, in file order; ``begins`` is every record's
    first byte, in file order; ``spans`` the truncated blocks."""

    names: list[str]
    group_offsets: np.ndarray  # (C+1,) i64
    member_begin: np.ndarray  # (S,) i64, cluster-major
    member_end: np.ndarray  # (S,) i64
    begins: np.ndarray  # (S,) i64, ascending
    spans: list[tuple[int, int]]


def index_clusters(path: str | os.PathLike,
                   threads: int = 0) -> MgfClusterIndex:
    """``index_mgf``'s records grouped into clusters by the id in their
    titles (the title up to its first ";", or ``index=N``) in the host
    library, in arrays; ``threads`` <= 0 scans with up to four threads
    (more contend for the file's pages).  A title that is not UTF-8
    raises ``UnicodeDecodeError``."""
    with _index(path, threads) as (lib, handle):
        n = int(lib.mgf_index_n_records(handle))
        bad = int(lib.mgf_index_bad_title(handle))
        if bad >= 0:
            title_off = _column(lib.mgf_index_title_offsets(handle), n + 1,
                                np.int64)
            lo, hi = int(title_off[bad]), int(title_off[bad + 1])
            ctypes.string_at(lib.mgf_index_titles(handle) + lo,
                             hi - lo).decode("utf-8")  # raises
        c = int(lib.mgf_index_n_clusters(handle))
        name_off = _column(lib.mgf_index_name_offsets(handle), c + 1,
                           np.int64)
        return MgfClusterIndex(
            names=_split(ctypes.string_at(lib.mgf_index_names(handle),
                                          int(name_off[-1])), name_off),
            group_offsets=_column(lib.mgf_index_group_offsets(handle),
                                  c + 1, np.int64),
            member_begin=_column(lib.mgf_index_member_begin(handle), n,
                                 np.int64),
            member_end=_column(lib.mgf_index_member_end(handle), n,
                               np.int64),
            begins=_column(lib.mgf_index_begin(handle), n, np.int64),
            spans=_spans(lib, handle),
        )


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def format_peaks(mz, intensity) -> str:
    """``"<mz> <intensity>\\n"`` per pair without NaN, each value as
    Python's ``repr`` writes it."""
    mz, intensity = _f64(mz), _f64(intensity)
    if mz.shape != intensity.shape or mz.ndim != 1:
        raise ValueError("mz and intensity must be 1-D and of equal length")
    cap = MAX_LINE * mz.size
    out = ctypes.create_string_buffer(max(cap, 1))
    n = _build.load_host().mgf_format_peaks(
        mz.ctypes.data_as(_PD), intensity.ctypes.data_as(_PD), mz.size,
        out, cap,
    )
    if n < 0:
        raise RuntimeError("mgf_format_peaks: output buffer too small")
    return out.raw[:n].decode("ascii")


def format_peaks_many(spectra_mz, spectra_intensity) -> list[str]:
    """``format_peaks`` of many spectra in one threaded call."""
    counts = np.array([np.size(m) for m in spectra_mz], dtype=np.int64)
    if [np.size(i) for i in spectra_intensity] != counts.tolist():
        raise ValueError("mz and intensity must be of equal length")
    offsets = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    if counts.size == 0:
        return []
    mz = _f64(np.concatenate(spectra_mz))
    intensity = _f64(np.concatenate(spectra_intensity))
    cap = MAX_LINE * mz.size
    out = np.empty(max(cap, 1), dtype=np.uint8)
    out_offsets = np.empty(counts.size + 1, dtype=np.int64)
    n = _build.load_host().mgf_format_batch(
        mz.ctypes.data_as(_PD), intensity.ctypes.data_as(_PD),
        offsets.ctypes.data_as(_P64), counts.size, out.ctypes.data, cap,
        out_offsets.ctypes.data_as(_P64), 0,
    )
    if n < 0:
        raise RuntimeError("mgf_format_batch: output buffer too small")
    text = out[:n].tobytes().decode("ascii")
    bounds = out_offsets.tolist()
    return [text[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
