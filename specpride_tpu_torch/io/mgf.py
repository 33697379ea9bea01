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
from typing import IO, Iterator, Sequence

import numpy as np

from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.io import native


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


def parse_mgf_stream(stream: IO[str]) -> Iterator[Spectrum]:
    """Yield spectra from an MGF text stream; a malformed number raises."""
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
        elif not in_ions:
            continue
        elif line[0].isdigit() or line[0] in "+-.":
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


def read_mgf(path: str | os.PathLike) -> list[Spectrum]:
    """Read all spectra from an MGF file (``.gz`` transparently) with the
    C++ parser; a malformed number raises ``RuntimeError``."""
    return native.read_mgf_native(path)


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
        buf = io.StringIO()
        _write_records(buf, spectra)
        return buf.getvalue()
    if hasattr(path_or_file, "write"):
        _write_records(path_or_file, spectra)
        return None
    with open(os.fspath(path_or_file), "a" if append else "w",
              encoding="utf-8") as fh:
        _write_records(fh, spectra)
    return None
