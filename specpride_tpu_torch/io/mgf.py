"""MGF (Mascot Generic Format) reading and writing.

Accepts the clustered-MGF interchange dialect: BEGIN IONS / TITLE= /
PEPMASS= / CHARGE=N+ / RTINSECONDS= / other KEY=value headers / numeric
peak lines "mz intensity" / END IONS.  Gzip-transparent.  ``read_mgf``
parses through the host library's C++ parser and the writer formats peak
lines through its C++ formatter (``io/native.py``); ``parse_mgf_stream``
and ``format_spectrum_plain`` are the pure-Python and numpy versions the
tests hold them to.  The writer is byte-compatible with the JAX
package's, so outputs of the two compare with ``cmp``.
"""

from __future__ import annotations

import gzip
import io
import os
import threading
from typing import IO, Iterator, Sequence

import numpy as np

from specpride_tpu_torch.data.peaks import Cluster, Spectrum, parse_title
from specpride_tpu_torch.io import native
from specpride_tpu_torch.observability import tracing


def _open_text(path: str | os.PathLike) -> IO[str]:
    path = os.fspath(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "rt", encoding="utf-8")


def _parse_charge(value: str) -> int:
    """CHARGE=2+ / 2- / 2 → signed int (ref src/binning.py:148 strips '+')."""
    value = value.strip()
    sign = 1
    if value.endswith("+"):
        value = value.rstrip("+")
    elif value.endswith("-"):
        value = value.rstrip("-")
        sign = -1
    return sign * int(value) if value else 0


def _finish_spectrum(
    headers: dict[str, str], mzs: list[float], intensities: list[float]
) -> Spectrum:
    pepmass = headers.get("PEPMASS", "0")
    # PEPMASS may carry "mz intensity"; only the first field is the m/z
    pepmass_mz = float(pepmass.split()[0]) if pepmass.split() else 0.0
    return Spectrum(
        mz=np.array(mzs, dtype=np.float64),
        intensity=np.array(intensities, dtype=np.float64),
        precursor_mz=pepmass_mz,
        precursor_charge=_parse_charge(headers.get("CHARGE", "0")),
        rt=float(headers.get("RTINSECONDS", 0.0) or 0.0),
        title=headers.get("TITLE", ""),
        extra={k: v for k, v in headers.items()
               if k not in ("TITLE", "PEPMASS", "CHARGE", "RTINSECONDS")},
    )


def _ingest_line(line: str, headers: dict[str, str], mzs: list[float],
                 intensities: list[float]) -> None:
    """Fold one stripped in-record line into the record being read: the
    one copy of the peak and header grammar both Python parsers run."""
    if line[0].isdigit() or line[0] in "+-.":
        fields = line.split()
        if len(fields) >= 2:
            mzs.append(float(fields[0]))
            intensities.append(float(fields[1]))
        elif len(fields) == 1:
            mzs.append(float(fields[0]))
            intensities.append(0.0)
    else:
        key, sep, value = line.partition("=")
        if sep:
            headers[key.strip().upper()] = value.strip()


def _parse_block(lines: list[str]) -> Spectrum:
    """One buffered record's lines, between BEGIN IONS and END IONS."""
    headers: dict[str, str] = {}
    mzs: list[float] = []
    intensities: list[float] = []
    for line in lines:
        _ingest_line(line, headers, mzs, intensities)
    return _finish_spectrum(headers, mzs, intensities)


def _parse_mgf_quarantining(stream: IO[str], malformed) -> Iterator[Spectrum]:
    """The tolerant parse: each record is buffered, and one that does not
    parse, or is truncated (a BEGIN IONS inside an open record, EOF
    before END IONS), goes to ``malformed(raw, reason)`` as its stripped
    lines instead of ending the stream.  The strict parsers cannot even
    see a truncated record: a BEGIN resets them."""
    block: list[str] = []
    in_ions = False
    for line in stream:
        line = line.strip()
        if not line:
            continue
        if line == "BEGIN IONS":
            if in_ions:
                malformed("\n".join(block),
                          "truncated record (BEGIN IONS inside an open "
                          "record)")
            block = [line]
            in_ions = True
        elif line == "END IONS":
            if in_ions:
                try:
                    spectrum = _parse_block(block[1:])
                except (ValueError, OverflowError) as e:
                    malformed("\n".join(block + [line]),
                              f"unparseable record ({e})")
                else:
                    yield spectrum
            in_ions = False
            block = []
        elif in_ions:
            block.append(line)
    if in_ions and block:
        malformed("\n".join(block), "truncated record (EOF before END IONS)")


def parse_mgf_stream(stream: IO[str], malformed=None) -> Iterator[Spectrum]:
    """Yield spectra from an MGF text stream; a malformed number raises.
    With ``malformed`` (``callable(raw_block, reason)``) a damaged record
    goes there instead and the stream goes on (``--on-error skip``'s
    quarantine)."""
    if malformed is not None:
        yield from _parse_mgf_quarantining(stream, malformed)
        return
    headers: dict[str, str] = {}
    mzs: list[float] = []
    intensities: list[float] = []
    in_ions = False
    for line in stream:
        line = line.strip()
        if not line:
            continue
        if line == "BEGIN IONS":
            in_ions = True
            headers, mzs, intensities = {}, [], []
        elif line == "END IONS":
            if in_ions:
                yield _finish_spectrum(headers, mzs, intensities)
            in_ions = False
        elif in_ions:
            _ingest_line(line, headers, mzs, intensities)


def read_mgf(path: str | os.PathLike, malformed=None) -> list[Spectrum]:
    """Read all spectra from an MGF file (``.gz`` transparently) with the
    C++ parser; a malformed number raises ``RuntimeError``.

    ``malformed`` (the quarantine) reads through the tolerant Python
    parser instead, as the JAX package does: the C++ parser stops at a
    damaged record and cannot see a truncated one (a BEGIN resets it),
    and the quarantine exists to make both auditable.  Eager reads stay
    under the 256 MB streaming threshold, which bounds the cost."""
    with tracing.span("parse:mgf", path=os.fspath(path)) as sp:
        if malformed is not None:
            with _open_text(path) as fh:
                spectra = list(parse_mgf_stream(fh, malformed=malformed))
            sp.note(n_spectra=len(spectra), parser="python-quarantine")
            return spectra
        spectra = native.read_mgf_native(path)
        sp.note(n_spectra=len(spectra), parser="native")
        return spectra


class IndexedMGF:
    """Random access to an MGF file by TITLE (pyteomics ``IndexedMGF`` as
    ref src/average_spectrum_clustering.py:156-160 uses it): the in-file
    title order and fetches by title, off one byte-offset index pass (the
    host library's ``index_mgf``).  A ``.gz`` file is read whole."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._offsets: dict[str, tuple[int, int]] = {}
        self._titles: list[str] = []
        self._spectra: dict[str, Spectrum] | None = None
        if self.path.endswith(".gz"):
            self._spectra = {s.title: s for s in read_mgf(self.path)}
            self._titles = list(self._spectra)
            return
        records, _ = native.index_mgf(self.path)
        for title, begin, end in records:
            self._offsets[title] = (begin, end)
            self._titles.append(title)

    @property
    def titles(self) -> list[str]:
        return list(self._titles)

    def __len__(self) -> int:
        return len(self._titles)

    def __getitem__(self, key: str | Sequence[str]):
        if isinstance(key, str):
            return self._get_one(key)
        return [self._get_one(k) for k in key]

    def _get_one(self, title: str) -> Spectrum:
        if self._spectra is not None:
            return self._spectra[title]
        begin, end = self._offsets[title]
        with open(self.path, "rb") as fh:
            fh.seek(begin)
            chunk = fh.read(end - begin)
        return native.parse_mgf_bytes(chunk, threads=1)[0]


class StreamedClusters:
    """Bounded-memory, list-like access to the clusters of a clustered MGF
    (the reference streams clusters off an indexed MGF, ref
    src/average_spectrum_clustering.py:151-160).  One pass of the host
    library's byte index records every record's (title, byte range)
    without parsing a peak; member spectra are parsed later, in windows of
    ``window`` clusters, and only ``cache_slots`` windows stay cached, so
    host memory is the index plus a few windows whatever the file's size.

    The order of ``read_mgf`` + ``group_into_clusters``: first-seen
    cluster order and in-file member order (a cluster's members may be
    scattered through the file).  An integer index parses the window that
    holds the cluster; a slice is a sub-view sharing the index.  Plain
    files only (the CLI reads a ``.gz`` eagerly)."""

    def __init__(self, path: str | os.PathLike, window: int = 512,
                 _groups=None, _begins=None):
        self.path = os.fspath(path)
        self.window = max(int(window), 1)
        # the byte ranges of truncated records the index found (never
        # indexed: without the quarantine they would vanish silently), and
        # the per-record malformed callback of the window parses, set by
        # the CLI when --on-error skip arms the quarantine (thread-safe:
        # pack workers parse windows at once)
        self.malformed_spans: list[tuple[int, int]] = []
        self.on_malformed = None
        # host threads per window parse: 0 is one per hardware thread.  The
        # CLI's pack pool sets it to cores / workers, so its workers parsing
        # windows at once never run more parse threads than the host has
        # cores.
        self.parse_threads = 0
        # windows parsed so far (a cache miss each)
        self.windows_parsed = 0
        if _groups is not None:
            self._groups, self._begins = _groups, _begins
        else:
            with tracing.span("parse:mgf_index"):
                records, self.malformed_spans = native.index_mgf(self.path)
            # every record's first byte, in file order: two records of a
            # window with no record between them parse as one span
            self._begins = np.fromiter((b for _, b, _ in records),
                                       dtype=np.int64, count=len(records))
            by_id: dict[str, list[tuple[int, int]]] = {}
            for title, begin, end in records:
                cid, _ = parse_title(title)
                by_id.setdefault(cid, []).append((begin, end))
            self._groups = list(by_id.items())
        # an LRU of windows keyed by window start, not one slot: a pack
        # worker parses window W+1 ahead while the dispatch lane may walk
        # window W again cluster by cluster (--on-error skip), and one
        # slot would parse a whole window per index.  The pack pool raises
        # ``cache_slots`` to workers + 1, so workers on distinct windows
        # never evict each other's.  The lock covers the cache only.
        self.cache_slots = 2
        self._windows: dict[int, list[Cluster]] = {}
        self._cache_lock = threading.RLock()

    def _scan_plain(self) -> list[tuple[str, int, int]]:
        """The JAX package's Python scan (``StreamedClusters._scan``): the
        records and the truncated spans (into ``malformed_spans``) that
        the host library's ``index_mgf`` must give; the tests' plain
        version."""
        records = []
        spans = []
        with open(self.path, "rb") as fh:
            offset = 0
            begin = -1
            title = None
            for line in fh:
                stripped = line.strip()
                if stripped == b"BEGIN IONS":
                    if begin >= 0:
                        spans.append((begin, offset))
                    begin = offset
                    title = None
                elif stripped.startswith(b"TITLE="):
                    title = stripped[6:].decode("utf-8")
                elif stripped == b"END IONS" and begin >= 0:
                    records.append((
                        title if title is not None
                        else f"index={len(records)}",
                        begin, offset + len(line),
                    ))
                    begin = -1
                offset += len(line)
            if begin >= 0:
                spans.append((begin, offset))
        with self._cache_lock:  # drain_malformed swaps it under the lock
            self.malformed_spans = spans
        return records

    def drain_malformed(self, malformed) -> int:
        """Hand every truncated block the index found to ``malformed(raw,
        reason)`` and forget them; returns their count."""
        with self._cache_lock:
            spans, self.malformed_spans = self.malformed_spans, []
        with open(self.path, "rb") as fh:
            for begin, end in spans:
                fh.seek(begin)
                raw = fh.read(end - begin).decode("utf-8", errors="replace")
                malformed(raw.strip(), "truncated record (no END IONS)")
        return len(spans)

    @property
    def cluster_ids(self) -> list[str]:
        return [cid for cid, _ in self._groups]

    @property
    def n_spectra(self) -> int:
        return sum(len(r) for _, r in self._groups)

    def __len__(self) -> int:
        return len(self._groups)

    def __getitem__(self, key):
        if isinstance(key, slice):
            sub = StreamedClusters(self.path, self.window,
                                   _groups=self._groups[key],
                                   _begins=self._begins)
            # a sub-view quarantines per-record damage too; the index's
            # truncated spans stay with the parent (drained once)
            sub.on_malformed = self.on_malformed
            sub.parse_threads = self.parse_threads
            return sub
        i = int(key)
        if i < 0:
            i += len(self._groups)
        if not 0 <= i < len(self._groups):
            raise IndexError(key)
        lo = (i // self.window) * self.window
        with self._cache_lock:
            cached = self._windows.get(lo)
            if cached is not None:
                # LRU touch: a window walked again must not be the one the
                # workers' lookahead evicts
                self._windows.pop(lo)
                self._windows[lo] = cached
                return cached[i - lo]
        # parse outside the lock, so the other lanes' cache hits never wait
        # on a whole window's parse; two threads racing on one cold window
        # parse it twice and keep one copy
        parsed = self._materialize(self._groups[lo : lo + self.window])
        with self._cache_lock:
            self.windows_parsed += 1
            cached = self._windows.pop(lo, parsed)
            slots = max(int(self.cache_slots), 1)
            while len(self._windows) >= slots:  # evict least recently used
                self._windows.pop(next(iter(self._windows)))
            self._windows[lo] = cached
            return cached[i - lo]

    def __iter__(self):
        for i in range(len(self._groups)):
            yield self[i]

    @tracing.traced("parse:mgf_window")
    def _materialize(self, groups) -> list[Cluster]:
        """The window's clusters, each span of its records parsed once: by
        the host library's parser, or by the tolerant Python parser when
        ``on_malformed`` is set.  For the host parser a span runs on over
        the bytes between two of the window's records when no record lies
        there (blank lines; a truncated block, which the host parser drops
        as it does in a whole read), so a cluster-contiguous file parses
        as a few large spans.  The tolerant parser takes only records that
        touch (the JAX package's spans): the bytes between them may hold a
        truncated block the index already quarantined."""
        ranges = sorted((begin, end) for _, recs in groups
                        for begin, end in recs)
        spans: list[list[int]] = []
        if self.on_malformed is None and ranges:
            ranks = np.searchsorted(self._begins, [b for b, _ in ranges])
            prev = -2
            for (begin, end), rank in zip(ranges, ranks.tolist()):
                if rank == prev + 1:
                    spans[-1][1] = end
                else:
                    spans.append([begin, end])
                prev = rank
        else:
            for begin, end in ranges:
                if spans and begin == spans[-1][1]:
                    spans[-1][1] = end
                else:
                    spans.append([begin, end])
        members: dict[str, list[Spectrum]] = {cid: [] for cid, _ in groups}
        with open(self.path, "rb") as fh:
            for begin, end in spans:
                fh.seek(begin)
                chunk = fh.read(end - begin)
                if self.on_malformed is None:
                    spectra = native.parse_mgf_bytes(
                        chunk, threads=self.parse_threads)
                else:
                    spectra = parse_mgf_stream(
                        io.StringIO(chunk.decode("utf-8")),
                        malformed=self.on_malformed)
                for s in spectra:
                    got = members.get(s.cluster_id)
                    if got is not None:
                        got.append(s)
        return [Cluster(cid, members[cid]) for cid, _ in groups]


def _header(spectrum: Spectrum) -> str:
    """The record's lines up to its peaks, each ending in a newline."""
    lines = ["BEGIN IONS", f"TITLE={spectrum.title}"]
    lines.append(f"PEPMASS={spectrum.precursor_mz}")
    if spectrum.rt:
        lines.append(f"RTINSECONDS={spectrum.rt}")
    z = spectrum.precursor_charge
    if z:
        lines.append(f"CHARGE={abs(z)}{'+' if z > 0 else '-'}")
    for key, value in spectrum.extra.items():
        lines.append(f"{key}={value}")
    lines.append("")
    return "\n".join(lines)


def format_spectrum(spectrum: Spectrum) -> str:
    """Format one spectrum as an MGF record.

    Field order TITLE / PEPMASS / RTINSECONDS / CHARGE, then extra
    headers in insertion order; NaN peaks are skipped as in the reference
    writer (ref src/binning.py:242).  The peak lines come from the C++
    formatter: the bytes of ``format_spectrum_plain``."""
    return (_header(spectrum)
            + native.format_peaks(spectrum.mz, spectrum.intensity)
            + "END IONS\n\n")


def format_spectrum_plain(spectrum: Spectrum) -> str:
    """numpy version of ``format_spectrum``, the JAX package's writer."""
    lines = [_header(spectrum)[:-1]]
    # float64 -> 'U32' is the same shortest repr as str(), vectorized
    mz = np.asarray(spectrum.mz, dtype=np.float64)
    inten = np.asarray(spectrum.intensity, dtype=np.float64)
    ok = ~(np.isnan(mz) | np.isnan(inten))
    mz, inten = mz[ok], inten[ok]
    if mz.size:
        lines.append(
            "\n".join(
                np.char.add(
                    np.char.add(mz.astype("U32"), " "), inten.astype("U32")
                )
            )
        )
    lines.append("END IONS")
    return "\n".join(lines) + "\n\n"


def truncate_tail(path: str | os.PathLike, offset: int) -> bool:
    """Drop the bytes of ``path`` past ``offset``: the resume repair of a
    torn append (a kill between an MGF append and its checkpoint).
    Returns True when what is left ends on a record boundary (``END
    IONS``), as every offset a manifest records does; False means the
    damage reaches into the committed prefix."""
    path = os.fspath(path)
    with open(path, "r+b") as fh:
        fh.truncate(int(offset))
    if offset <= 0:
        return True
    with open(path, "rb") as fh:
        fh.seek(max(0, int(offset) - 4096))
        tail = fh.read()
    return tail.rstrip().endswith(b"END IONS")


# spectra formatted per call of the C++ formatter: a bound on the text
# held in memory, not on the records written
WRITE_BATCH_PEAKS = 1 << 20


def _write_records(fh: IO[str], spectra) -> int:
    """Stream records into an open text sink, the peak lines of a batch of
    spectra formatted in one threaded call; returns the record count."""
    n = 0
    batch: list[Spectrum] = []
    peaks = 0

    def flush() -> None:
        texts = native.format_peaks_many([s.mz for s in batch],
                                         [s.intensity for s in batch])
        fh.write("".join(
            f"{_header(s)}{t}END IONS\n\n" for s, t in zip(batch, texts)
        ))
        batch.clear()

    for s in spectra:
        batch.append(s)
        peaks += s.n_peaks
        n += 1
        if peaks >= WRITE_BATCH_PEAKS:
            flush()
            peaks = 0
    if batch:
        flush()
    return n


def write_mgf(
    spectra: Sequence[Spectrum] | Iterator[Spectrum],
    path_or_file: str | os.PathLike | IO[str] | None,
    append: bool = False,
) -> str | None:
    """Write spectra to an MGF file, an open text file or (``None``) a
    string, which is returned.  ``append`` adds them after what the file
    at a path holds (ref src/average_spectrum_clustering.py:183-184,198);
    an open file is written where it stands."""
    if path_or_file is None:
        with tracing.span("write:mgf", path=None, append=False) as sp:
            buf = io.StringIO()
            sp.note(n_spectra=_write_records(buf, spectra))
            return buf.getvalue()
    if hasattr(path_or_file, "write"):
        # the caller opened the file: its mode is unknown here
        with tracing.span(
            "write:mgf", path=str(getattr(path_or_file, "name", "<stream>")),
            append=None,
        ) as sp:
            sp.note(n_spectra=_write_records(path_or_file, spectra))
        return None
    with tracing.span("write:mgf", path=os.fspath(path_or_file),
                      append=append) as sp:
        with open(os.fspath(path_or_file), "a" if append else "w",
                  encoding="utf-8") as fh:
            sp.note(n_spectra=_write_records(fh, spectra))
    return None
