"""PSM score sources for ``select --method best``: MaxQuant ``msms.txt``
(ref src/best_spectrum.py:43-64 get_scores) and crux/percolator PSM
tables, both read header-aware with ``csv`` (no pandas) into one
USI → score dict; and the scan → peptide map of ``msms.txt`` that
``convert`` and direct mzML input title spectra with.
"""

from __future__ import annotations

import csv
import os


def _score_usi(
    px_accession: str, raw: str, scan: str, raw_suffix: str
) -> str:
    """The score-side USI both readers share:
    ``mzspec:<PX>:<raw><suffix>::scan:<n>``, with the reference's double
    colon (ref src/best_spectrum.py:61-62).  ``raw_suffix`` is appended
    only when ``raw`` does not end in it already (MaxQuant's 'Raw file'
    column has no extension; a ``--raw-name`` usually does)."""
    if raw_suffix and not raw.endswith(raw_suffix):
        raw = raw + raw_suffix
    return f"mzspec:{px_accession}:{raw}::scan:{scan}"


def _add_score(scores: dict[str, float], usi: str, score: float) -> None:
    """The highest score wins on duplicate USIs."""
    if usi not in scores or score > scores[usi]:
        scores[usi] = score


def read_msms_scores(
    path: str | os.PathLike,
    px_accession: str = "PXD004732",
    raw_suffix: str = ".raw",
) -> dict[str, float]:
    """USI → MaxQuant PSM score (ref src/best_spectrum.py:43-64)."""
    scores: dict[str, float] = {}
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh, delimiter="\t")
        for row in reader:
            usi = _score_usi(
                px_accession, row["Raw file"], row["Scan number"], raw_suffix
            )
            _add_score(scores, usi, float(row["Score"]))
    return scores


def read_percolator_scores(
    path: str | os.PathLike,
    px_accession: str = "PXD004732",
    raw_suffix: str = ".raw",
    raw_name: str | None = None,
) -> dict[str, float]:
    """USI → percolator (crux) PSM score, from a tab-separated table with
    a ``scan`` column and the first of ``percolator score`` /
    ``xcorr score`` / ``score``.  The raw-file name is ``raw_name`` if
    given, else the basename of the ``file`` column without its extension,
    else empty.  A table with rows but no usable column raises
    ValueError."""
    score_cols = ("percolator score", "xcorr score", "score")
    scores: dict[str, float] = {}
    n_rows = 0
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh, delimiter="\t")
        header = reader.fieldnames or []
        for row in reader:
            n_rows += 1
            scan = row.get("scan")
            if scan is None:
                continue
            col = next((c for c in score_cols if c in row), None)
            if col is None:
                continue
            if raw_name is not None:
                raw = raw_name
            else:
                raw = os.path.basename(row.get("file", ""))
                raw = raw.rsplit(".", 1)[0] if "." in raw else raw
            usi = _score_usi(px_accession, raw, scan, raw_suffix)
            _add_score(scores, usi, float(row[col]))
    if n_rows and not scores:
        missing = [c for c in ("scan",) if c not in header]
        if not any(c in header for c in score_cols):
            missing.append("|".join(score_cols))
        raise ValueError(
            f"{path}: {n_rows} rows but none yielded a score — "
            f"missing column(s): {missing or 'unknown'}; header={header}. "
            "Expected crux/percolator TSV with a 'scan' column and one of "
            f"{score_cols} (native percolator 'PSMId' output is not "
            "supported; re-export via crux percolator)."
        )
    return scores


def read_msms_peptides(path: str | os.PathLike) -> dict[int, str]:
    """Scan number → (modified) peptide sequence.

    Positional parity with ref src/convert_mgf_cluster.py:21-30: column 1 is
    the scan, column 7 the sequence with its first and last characters
    stripped.  Later rows overwrite earlier ones for the same scan, as the
    reference dict assignment does.
    """
    peptides: dict[int, str] = {}
    with open(path) as fh:
        next(fh)  # header
        for line in fh:
            words = line.rstrip("\n").split("\t")
            if len(words) <= 7:
                continue
            scan = int(words[1])
            peptides[scan] = words[7][1:-1]
    return peptides
