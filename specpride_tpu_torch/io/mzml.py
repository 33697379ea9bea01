"""mzML reading and writing, from scratch (stdlib XML + base64/zlib): the
port's copy of the JAX package's ``io/mzml.py``.

Covers the capabilities the reference consumes from three different mzML
libraries:

* iterate MS2 spectra with peaks, precursor m/z/charge, RT and scan number
  (pyteomics ``mzml.read`` at ref src/binning.py:80-118; pymzml at ref
  src/plot_cluster.py:71-86)
* random access by scan number (pyOpenMS ``MzMLFile`` + ``SpectrumLookup``
  regex scan indexing at ref src/convert_mgf_cluster.py:101-118)

Supported encodings: 32/64-bit floats, zlib or no compression — the
combinations standard instruments emit.  Gzip-transparent like the MGF
reader (ref src/binning.py:72-77).
"""

from __future__ import annotations

import base64
import gzip
import os
import re
import zlib
import xml.etree.ElementTree as ET
from xml.sax.saxutils import quoteattr
from typing import IO, Iterator

import numpy as np

from specpride_tpu_torch.data.peaks import Spectrum

# mzML controlled-vocabulary accessions
_CV_MS_LEVEL = "MS:1000511"
_CV_SCAN_START_TIME = "MS:1000016"
_CV_SELECTED_MZ = "MS:1000744"
_CV_CHARGE = "MS:1000041"
_CV_MZ_ARRAY = "MS:1000514"
_CV_INTENSITY_ARRAY = "MS:1000515"
_CV_64BIT = "MS:1000523"
_CV_32BIT = "MS:1000521"
_CV_ZLIB = "MS:1000574"

_SCAN_RE = re.compile(r"scan=(\d+)")


def _open_binary(path: str | os.PathLike) -> IO[bytes]:
    path = os.fspath(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _local(tag: str) -> str:
    """Strip the XML namespace."""
    return tag.rpartition("}")[2]


def _decode_binary(text: str, bits: int, compressed: bool) -> np.ndarray:
    raw = base64.b64decode(text)
    if compressed:
        raw = zlib.decompress(raw)
    dtype = np.float64 if bits == 64 else np.float32
    return np.frombuffer(raw, dtype=dtype).astype(np.float64)


def scan_from_id(spectrum_id: str) -> int | None:
    """Scan number from an mzML spectrum id (``... scan=17555``) — the
    capability of pyOpenMS ``SpectrumLookup`` with the default regex
    (ref src/convert_mgf_cluster.py:103-104)."""
    m = _SCAN_RE.search(spectrum_id)
    if m:
        return int(m.group(1))
    # fall back: trailing integer (some converters emit bare numeric ids)
    tail = spectrum_id.rsplit("=", 1)[-1].rsplit(" ", 1)[-1]
    return int(tail) if tail.isdigit() else None


def _parse_spectrum_elem(elem: ET.Element) -> tuple[Spectrum, int, int | None]:
    """One <spectrum> element → (Spectrum, ms_level, scan)."""
    ms_level = 0
    rt = 0.0
    rt_minutes = False
    precursor_mz = 0.0
    charge = 0
    mz = np.zeros((0,), np.float64)
    intensity = np.zeros((0,), np.float64)

    for cv in elem.iter():
        tag = _local(cv.tag)
        if tag == "cvParam":
            acc = cv.get("accession", "")
            if acc == _CV_MS_LEVEL:
                ms_level = int(cv.get("value", "0") or 0)
            elif acc == _CV_SCAN_START_TIME:
                rt = float(cv.get("value", "0") or 0.0)
                rt_minutes = cv.get("unitName", "") == "minute"
            elif acc == _CV_SELECTED_MZ:
                precursor_mz = float(cv.get("value", "0") or 0.0)
            elif acc == _CV_CHARGE:
                charge = int(cv.get("value", "0") or 0)

    for bda in elem.iter():
        if _local(bda.tag) != "binaryDataArray":
            continue
        bits = 64
        compressed = False
        kind = None
        text = ""
        for child in bda.iter():
            tag = _local(child.tag)
            if tag == "cvParam":
                acc = child.get("accession", "")
                if acc == _CV_64BIT:
                    bits = 64
                elif acc == _CV_32BIT:
                    bits = 32
                elif acc == _CV_ZLIB:
                    compressed = True
                elif acc == _CV_MZ_ARRAY:
                    kind = "mz"
                elif acc == _CV_INTENSITY_ARRAY:
                    kind = "intensity"
            elif tag == "binary":
                text = child.text or ""
        if kind == "mz":
            mz = _decode_binary(text, bits, compressed)
        elif kind == "intensity":
            intensity = _decode_binary(text, bits, compressed)

    sid = elem.get("id", "")
    scan = scan_from_id(sid)
    if rt_minutes:
        rt *= 60.0
    spec = Spectrum(
        mz=mz,
        intensity=intensity,
        precursor_mz=precursor_mz,
        precursor_charge=charge,
        rt=rt,
        title=sid,
    )
    return spec, ms_level, scan


def iter_mzml(
    path: str | os.PathLike, ms_level: int | None = 2
) -> Iterator[tuple[int | None, Spectrum]]:
    """Yield (scan, Spectrum) from an mzML file, streaming.

    ``ms_level`` filters (None = all levels); the reference skips non-MS2
    scans with a printed error (ref src/binning.py:104-106) — here they are
    silently filtered, callers count them via ``read_mzml_scans``.
    """
    with _open_binary(path) as fh:
        for _, elem in ET.iterparse(fh, events=("end",)):
            if _local(elem.tag) != "spectrum":
                continue
            spec, level, scan = _parse_spectrum_elem(elem)
            if ms_level is None or level == ms_level:
                yield scan, spec
            elem.clear()


def write_mzml(
    spectra: list[tuple[int, Spectrum, dict]],
    path: str | os.PathLike,
) -> None:
    """Minimal mzML writer: (scan, spectrum, userParams) triples.

    Capability parity with pyOpenMS ``MzMLFile().store`` as used by the
    mzML converter variant (ref src/convert_mgf_cluster.py:120-134), which
    attaches 'Cluster accession' / 'Peptide sequence' metaValues — written
    here as <userParam> entries.  64-bit, zlib-compressed arrays.
    """

    def b64(arr: np.ndarray) -> str:
        return base64.b64encode(
            zlib.compress(np.asarray(arr, np.float64).tobytes())
        ).decode("ascii")

    with open(os.fspath(path), "w", encoding="utf-8") as fh:
        fh.write('<?xml version="1.0" encoding="utf-8"?>\n')
        fh.write('<mzML xmlns="http://psi.hupo.org/ms/mzml" version="1.1.0">\n')
        fh.write(f'  <run id="run"><spectrumList count="{len(spectra)}">\n')
        for index, (scan, s, params) in enumerate(spectra):
            fh.write(
                f'    <spectrum index="{index}" id={quoteattr(f"scan={scan}")} '
                f'defaultArrayLength="{s.n_peaks}">\n'
            )
            fh.write(
                '      <cvParam accession="MS:1000511" name="ms level" value="2"/>\n'
            )
            # userParams carry free text (cluster ids, peptide sequences) —
            # quoteattr so &/</quotes survive a round-trip as valid XML
            for key, value in params.items():
                fh.write(
                    f"      <userParam name={quoteattr(str(key))} "
                    f"value={quoteattr(str(value))}/>\n"
                )
            fh.write(
                '      <precursorList count="1"><precursor><selectedIonList '
                'count="1"><selectedIon>\n'
                f'        <cvParam accession="MS:1000744" name="selected ion '
                f'm/z" value="{s.precursor_mz}"/>\n'
                f'        <cvParam accession="MS:1000041" name="charge state" '
                f'value="{s.precursor_charge}"/>\n'
                "      </selectedIon></selectedIonList></precursor>"
                "</precursorList>\n"
                "      <scanList count=\"1\"><scan>\n"
                f'        <cvParam accession="MS:1000016" name="scan start '
                f'time" value="{s.rt}" unitName="second"/>\n'
                "      </scan></scanList>\n"
            )
            fh.write('      <binaryDataArrayList count="2">\n')
            for acc, name, arr in (
                ("MS:1000514", "m/z array", s.mz),
                ("MS:1000515", "intensity array", s.intensity),
            ):
                fh.write(
                    "        <binaryDataArray>"
                    '<cvParam accession="MS:1000523" name="64-bit float"/>'
                    '<cvParam accession="MS:1000574" name="zlib compression"/>'
                    f'<cvParam accession="{acc}" name="{name}"/>'
                    f"<binary>{b64(arr)}</binary></binaryDataArray>\n"
                )
            fh.write("      </binaryDataArrayList>\n    </spectrum>\n")
        fh.write("  </spectrumList></run>\n</mzML>\n")


def read_mzml_scans(
    path: str | os.PathLike,
    scans: set[int] | None = None,
    ms_level: int | None = 2,
) -> dict[int, Spectrum]:
    """Random access by scan number (one streaming pass, dict-keyed — the
    capability of pyteomics random access at ref src/binning.py:83 and
    pyOpenMS SpectrumLookup at ref src/convert_mgf_cluster.py:103-118,
    without the reference's O(scans × spectra) linear rescan)."""
    out: dict[int, Spectrum] = {}
    for scan, spec in iter_mzml(path, ms_level):
        if scan is None:
            continue
        if scans is None or scan in scans:
            out[scan] = spec
    return out
