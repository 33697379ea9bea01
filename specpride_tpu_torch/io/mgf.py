"""MGF (Mascot Generic Format) reading and writing, pure Python.

Accepts the clustered-MGF interchange dialect: BEGIN IONS / TITLE= /
PEPMASS= / CHARGE=N+ / RTINSECONDS= / other KEY=value headers / numeric
peak lines "mz intensity" / END IONS.  Gzip-transparent.  The writer is
byte-compatible with the JAX package's, so outputs of the two compare
with ``cmp``.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import IO, Iterator, Sequence

import numpy as np

from specpride_tpu_torch.data.peaks import Spectrum


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
    """Read all spectra from an MGF file (``.gz`` transparently)."""
    with _open_text(path) as fh:
        return list(parse_mgf_stream(fh))


def format_spectrum(spectrum: Spectrum) -> str:
    """Format one spectrum as an MGF record.

    Field order TITLE / PEPMASS / RTINSECONDS / CHARGE, then extra
    headers in insertion order; NaN peaks are skipped as in the reference
    writer (ref src/binning.py:242)."""
    lines = ["BEGIN IONS", f"TITLE={spectrum.title}"]
    lines.append(f"PEPMASS={spectrum.precursor_mz}")
    if spectrum.rt:
        lines.append(f"RTINSECONDS={spectrum.rt}")
    z = spectrum.precursor_charge
    if z:
        lines.append(f"CHARGE={abs(z)}{'+' if z > 0 else '-'}")
    for key, value in spectrum.extra.items():
        lines.append(f"{key}={value}")
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


def write_mgf(
    spectra: Sequence[Spectrum] | Iterator[Spectrum],
    path: str | os.PathLike,
    append: bool = False,
) -> None:
    """Write spectra to an MGF file, one record at a time; ``append`` adds
    them after what the file holds (ref
    src/average_spectrum_clustering.py:183-184,198)."""
    with open(os.fspath(path), "a" if append else "w",
              encoding="utf-8") as fh:
        for s in spectra:
            fh.write(format_spectrum(s))
