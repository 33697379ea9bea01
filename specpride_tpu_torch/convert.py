"""Format conversion: build the clustered-MGF interchange file, the port's
copy of the JAX package's ``convert.py``.

Joins MaxQuant peptide IDs (msms.txt) and MaRaCluster assignments onto
raw spectra and emits spectra titled
``cluster-N;mzspec:PX:raw:scan:N[:PEPTIDE/z]`` (ref file_formats.md:5-9,
ref src/convert_mgf_cluster.py:14-18).  Only scans that have BOTH a
peptide and a cluster assignment are emitted, as the reference does
(ref src/convert_mgf_cluster.py:56-86).  An MGF input is read with the
host library's parser and written through its formatter.
"""

from __future__ import annotations

import os
import re
from typing import Iterator

from specpride_tpu_torch.config import BestSpectrumConfig
from specpride_tpu_torch.data.peaks import Spectrum, build_title
from specpride_tpu_torch.io.maracluster import scan_to_cluster
from specpride_tpu_torch.io.maxquant import read_msms_peptides
from specpride_tpu_torch.io.mgf import read_mgf, write_mgf
from specpride_tpu_torch.io.mzml import read_mzml_scans, write_mzml

_SCAN_IN_TITLE = re.compile(r"scan=(\d+)\s*$")


def _scan_from_mgf_title(title: str) -> int | None:
    """The reference matches ``title.endswith('scan=N')``
    (ref src/convert_mgf_cluster.py:74-77)."""
    m = _SCAN_IN_TITLE.search(title)
    return int(m.group(1)) if m else None


def convert_mgf(
    mgf_path: str | os.PathLike,
    msms_path: str | os.PathLike,
    clusters_path: str | os.PathLike,
    out_path: str | os.PathLike,
    raw_name: str,
    config: BestSpectrumConfig = BestSpectrumConfig(),
) -> int:
    """MGF variant (ref src/convert_mgf_cluster.py:47-86
    convert-mq-marcluster).  Returns the number of spectra written."""
    peptides = read_msms_peptides(msms_path)
    clusters = scan_to_cluster(clusters_path)

    out = []
    for spec in read_mgf(mgf_path):
        scan = _scan_from_mgf_title(spec.title)
        if scan is None or scan not in peptides or scan not in clusters:
            continue
        spec.title = build_title(
            clusters[scan], config.px_accession, raw_name, scan,
            peptides[scan], spec.precursor_charge,
        )
        out.append(spec)
    with open(os.fspath(out_path), "w", encoding="utf-8") as fh:
        write_mgf(out, fh)
    return len(out)


def convert_mzml(
    mzml_path: str | os.PathLike,
    msms_path: str | os.PathLike,
    clusters_path: str | os.PathLike,
    out_path: str | os.PathLike,
    raw_name: str | None = None,
    config: BestSpectrumConfig = BestSpectrumConfig(),
) -> int:
    """mzML variant (ref src/convert_mgf_cluster.py:89-134).

    The reference stores matched spectra back to mzML with 'Cluster
    accession' / 'Peptide sequence' metaValues; ``out_path`` ending in
    ``.mgf`` writes the clustered-MGF interchange format instead (it feeds
    the consensus stage directly)."""
    peptides = read_msms_peptides(msms_path)
    clusters = scan_to_cluster(clusters_path)
    wanted = set(peptides) & set(clusters)
    spectra = read_mzml_scans(mzml_path, scans=wanted)
    raw = raw_name or os.path.basename(os.fspath(mzml_path)).rsplit(".", 1)[0]

    out_path = os.fspath(out_path)
    if out_path.endswith(".mgf"):
        def emit() -> Iterator[Spectrum]:
            for scan in sorted(spectra):
                spec = spectra[scan]
                spec.title = build_title(
                    clusters[scan], config.px_accession, raw, scan,
                    peptides[scan], spec.precursor_charge,
                )
                yield spec

        write_mgf(emit(), out_path)
        return len(spectra)

    write_mzml(
        [
            (
                scan,
                spectra[scan],
                {
                    "Cluster accession": clusters[scan],
                    "Peptide sequence": peptides[scan],
                },
            )
            for scan in sorted(spectra)
        ],
        out_path,
    )
    return len(spectra)
