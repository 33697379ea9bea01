"""Peptide fragment theory: monoisotopic masses, b/y ion m/z generation and
tolerance-window peak annotation, on the host in numpy.

The port's own copy of the JAX package's ``ops/fragments.py``.  The
reference consumes this capability from spectrum_utils
(``annotate_peptide_fragments`` at ref src/benchmark.py:47-52) and
pyteomics (``parser.fast_valid`` at ref src/benchmark.py:41); the tables
below are the standard IUPAC/Unimod monoisotopic values.
``fraction_of_by_batch`` builds one fragment table per unique
peptide/charge and matches each representative's peaks against it with a
searchsorted.  No kernel: the tables hold tens of entries and the match
is a few numpy passes per spectrum.
"""

from __future__ import annotations

import numpy as np

# Monoisotopic masses (Da).  PROTON_MASS is the H+ mass used for
# neutral-mass arithmetic (ref src/average_spectrum_clustering.py:6:
# pyteomics mass.nist_mass['H+'][0][0]).
PROTON_MASS = 1.00727646677
H_MASS = 1.0078250319
O_MASS = 15.9949146221
WATER_MASS = 2 * H_MASS + O_MASS  # 18.0105646...

# Standard amino-acid residue monoisotopic masses.
RESIDUE_MASSES: dict[str, float] = {
    "G": 57.02146, "A": 71.03711, "S": 87.03203, "P": 97.05276,
    "V": 99.06841, "T": 101.04768, "C": 103.00919, "L": 113.08406,
    "I": 113.08406, "N": 114.04293, "D": 115.02694, "Q": 128.05858,
    "K": 128.09496, "E": 129.04259, "M": 131.04049, "H": 137.05891,
    "F": 147.06841, "R": 156.10111, "Y": 163.06333, "W": 186.07931,
    "U": 150.95364, "O": 237.14773,
}

# Common fixed/variable modification deltas for MaxQuant-style annotations.
MOD_MASSES: dict[str, float] = {
    "ox": 15.9949146221,          # oxidation (M)
    "oxidation": 15.9949146221,
    "ac": 42.0105646863,          # acetyl
    "acetyl": 42.0105646863,
    "ph": 79.96633,               # phospho
    "phospho": 79.96633,
    "cam": 57.02146,              # carbamidomethyl
    "carbamidomethyl": 57.02146,
}

def is_valid_peptide(sequence: str) -> bool:
    """Capability of pyteomics ``parser.fast_valid``
    (ref src/benchmark.py:41): every character is a standard residue."""
    return bool(sequence) and all(c in RESIDUE_MASSES for c in sequence)


def _scan_mod(sequence: str, start: int) -> tuple[str, int]:
    """Read a parenthesised modification starting at ``start`` (which must be
    '('), handling MaxQuant's nested form '(Oxidation (M))'.  Returns the
    inner name and the index one past the closing paren."""
    depth = 0
    for i in range(start, len(sequence)):
        if sequence[i] == "(":
            depth += 1
        elif sequence[i] == ")":
            depth -= 1
            if depth == 0:
                return sequence[start + 1 : i], i + 1
    raise ValueError(f"unbalanced modification in {sequence!r}")


def parse_peptide(sequence: str) -> tuple[list[str], list[float]]:
    """Parse a peptide with optional '(mod)' annotations into residues and
    per-residue mass deltas.

    Accepts MaxQuant 'Modified sequence' dialect: flanking underscores,
    nested-paren mod names ('(Oxidation (M))'), and N-terminal mods before
    the first residue ('(ac)PEPTIDEK' — the delta attaches to the first
    residue, as N-term mods ride the b1 ion).  Unknown modifications raise
    ValueError.
    """
    residues: list[str] = []
    deltas: list[float] = []
    nterm_delta = 0.0
    i = 0
    while i < len(sequence):
        c = sequence[i]
        if c == "(":
            name, i = _scan_mod(sequence, i)
            key = name.strip().lower().split(" ")[0].split("(")[0].strip()
            if key not in MOD_MASSES:
                raise ValueError(f"unknown modification {name!r} in {sequence!r}")
            if residues:
                deltas[-1] += MOD_MASSES[key]
            else:
                nterm_delta += MOD_MASSES[key]
            continue
        if c == "_":  # MaxQuant flanking underscores
            i += 1
            continue
        if c not in RESIDUE_MASSES:
            raise ValueError(f"unknown residue {c!r} in {sequence!r}")
        residues.append(c)
        deltas.append(0.0)
        i += 1
    if nterm_delta:
        if not residues:
            raise ValueError(f"modification with no residues in {sequence!r}")
        deltas[0] += nterm_delta
    return residues, deltas


def peptide_mass(sequence: str) -> float:
    """Neutral monoisotopic peptide mass (residues + water)."""
    residues, deltas = parse_peptide(sequence)
    return sum(RESIDUE_MASSES[r] for r in residues) + sum(deltas) + WATER_MASS


def fragment_mzs(
    sequence: str,
    ion_types: str = "by",
    max_charge: int = 1,
) -> np.ndarray:
    """All theoretical fragment m/z values for the given ion types/charges.

    b_k = prefix residue mass + z*proton, y_k = suffix residue mass + water
    + z*proton; a_k = b_k - CO.  Fragment lengths 1..len-1, charges
    1..max_charge.  This is the capability of spectrum_utils'
    ``_get_theoretical_peptide_fragments`` (ref src/plot_cluster.py:36-38).
    """
    residues, deltas = parse_peptide(sequence)
    masses = np.array([RESIDUE_MASSES[r] + d for r, d in zip(residues, deltas)])
    if masses.size < 2:
        return np.array([])
    prefix = np.cumsum(masses)[:-1]  # b_1 .. b_{n-1}
    suffix = np.cumsum(masses[::-1])[:-1]  # y_1 .. y_{n-1}
    co_mass = 12.0 + O_MASS

    neutral: list[np.ndarray] = []
    for ion in ion_types:
        if ion == "b":
            neutral.append(prefix)
        elif ion == "y":
            neutral.append(suffix + WATER_MASS)
        elif ion == "a":
            neutral.append(prefix - co_mass)
        else:
            raise ValueError(f"unsupported ion type {ion!r}")
    frags = np.concatenate(neutral)

    mzs = []
    for z in range(1, max_charge + 1):
        mzs.append((frags + z * PROTON_MASS) / z)
    return np.sort(np.concatenate(mzs))


def fragment_annotations(
    sequence: str,
    ion_types: str = "by",
    max_charge: int = 1,
) -> tuple[np.ndarray, list[str]]:
    """``fragment_mzs`` with ion labels: (sorted m/z, aligned labels like
    ``b3`` / ``y5^2+``) — the identity information spectrum_utils renders
    on its annotated mirror plots (ref src/plot_cluster.py:33-45), which
    ``viz.mirror_plot`` writes next to matched peaks."""
    residues, deltas = parse_peptide(sequence)
    masses = np.array(
        [RESIDUE_MASSES[r] + d for r, d in zip(residues, deltas)]
    )
    if masses.size < 2:
        return np.array([]), []
    prefix = np.cumsum(masses)[:-1]
    suffix = np.cumsum(masses[::-1])[:-1]
    co_mass = 12.0 + O_MASS

    neutral: list[np.ndarray] = []
    labels: list[str] = []
    ks = [str(k) for k in range(1, masses.size)]
    for ion in ion_types:
        if ion == "b":
            neutral.append(prefix)
        elif ion == "y":
            neutral.append(suffix + WATER_MASS)
        elif ion == "a":
            neutral.append(prefix - co_mass)
        else:
            raise ValueError(f"unsupported ion type {ion!r}")
        labels.extend(ion + k for k in ks)
    frags = np.concatenate(neutral)

    mzs, labs = [], []
    for z in range(1, max_charge + 1):
        mzs.append((frags + z * PROTON_MASS) / z)
        suffix_z = "" if z == 1 else f"^{z}+"
        labs.extend(lab + suffix_z for lab in labels)
    flat = np.concatenate(mzs)
    order = np.argsort(flat, kind="stable")
    return flat[order], [labs[i] for i in order]


def match_fragments(
    mz: np.ndarray,
    fragment_mz: np.ndarray,
    tol: float = 50.0,
    tol_mode: str = "ppm",
) -> np.ndarray:
    """Boolean mask: which peaks fall within the tolerance window of any
    theoretical fragment (the annotation capability of ref
    src/benchmark.py:47-52, 50 ppm)."""
    if fragment_mz.size == 0 or mz.size == 0:
        return np.zeros(mz.shape, dtype=bool)
    frag = np.sort(fragment_mz)
    idx = np.searchsorted(frag, mz)
    lo = frag[np.clip(idx - 1, 0, frag.size - 1)]
    hi = frag[np.clip(idx, 0, frag.size - 1)]
    nearest = np.minimum(np.abs(mz - lo), np.abs(mz - hi))
    if tol_mode == "ppm":
        window = mz * tol * 1e-6
    else:
        window = np.full_like(mz, tol)
    return nearest <= window


def _by_fragment_table(sequence: str, max_charge: int) -> np.ndarray | None:
    """Sorted b/y fragment m/z table, or None for unparseable / too-short
    sequences (which score 0, ref src/benchmark.py:41-43)."""
    try:
        residues, _ = parse_peptide(sequence)
    except ValueError:
        return None
    if not residues or len(residues) < 2:
        return None
    return fragment_mzs(sequence, "by", max_charge)


def fraction_of_by(
    sequence: str,
    precursor_mz: float,
    precursor_charge: int,
    mz: np.ndarray,
    intensity: np.ndarray,
    tol: float = 50.0,
    tol_mode: str = "ppm",
    min_mz: float = 100.0,
    max_mz: float = 1400.0,
) -> float:
    """Fraction of total ion current explained by b/y fragments.

    Reimplements ref src/benchmark.py:40-61 (whose body references an
    undefined ``spectrum`` variable — a known reference bug; this is the
    working version).  Preprocessing per ref :49-50: restrict to
    [min_mz, max_mz], remove peaks within the tolerance window of the
    precursor.  Invalid sequences score 0 (ref :41-43).
    """
    max_charge = max(1, precursor_charge - 1)
    frags = _by_fragment_table(sequence, max_charge)
    if frags is None:
        return 0.0
    return _fraction_with_table(
        frags, precursor_mz, mz, intensity, tol, tol_mode, min_mz, max_mz
    )


def _fraction_with_table(
    frags: np.ndarray,
    precursor_mz: float,
    mz: np.ndarray,
    intensity: np.ndarray,
    tol: float,
    tol_mode: str,
    min_mz: float,
    max_mz: float,
) -> float:
    mz = np.asarray(mz, dtype=np.float64)
    intensity = np.asarray(intensity, dtype=np.float64)

    keep = (mz >= min_mz) & (mz <= max_mz)
    if tol_mode == "ppm":
        prec_window = precursor_mz * tol * 1e-6
    else:
        prec_window = tol
    keep &= np.abs(mz - precursor_mz) > prec_window
    mz, intensity = mz[keep], intensity[keep]
    if mz.size == 0:
        return 0.0

    matched = match_fragments(mz, frags, tol, tol_mode)
    total = float(intensity.sum())
    if total <= 0.0:
        return 0.0
    return float(intensity[matched].sum()) / total


def fraction_of_by_batch(
    sequences: "list[str | None]",
    precursor_mz: np.ndarray,
    precursor_charge: np.ndarray,
    spectra_mz: "list[np.ndarray]",
    spectra_intensity: "list[np.ndarray]",
    tol: float = 50.0,
    tol_mode: str = "ppm",
    min_mz: float = 100.0,
    max_mz: float = 1400.0,
) -> np.ndarray:
    """``fraction_of_by`` over many representatives with the expensive
    per-call work amortised: ONE peptide parse + fragment-table build per
    unique (sequence, charge) pair — real runs identify the same peptide
    across many clusters — and the per-spectrum window match unchanged
    (so each entry equals its ``fraction_of_by`` value bit for bit).
    ``None`` sequences yield NaN (caller decides how to report "no
    peptide"); unparseable sequences yield 0.0 as in the scalar form."""
    n = len(sequences)
    out = np.full(n, np.nan, dtype=np.float64)
    tables: dict[tuple[str, int], np.ndarray | None] = {}
    for i, seq in enumerate(sequences):
        if seq is None:
            continue
        max_charge = max(1, int(precursor_charge[i]) - 1)
        key = (seq, max_charge)
        if key not in tables:
            tables[key] = _by_fragment_table(seq, max_charge)
        frags = tables[key]
        if frags is None:
            out[i] = 0.0
            continue
        out[i] = _fraction_with_table(
            frags, float(precursor_mz[i]), spectra_mz[i],
            spectra_intensity[i], tol, tol_mode, min_mz, max_mz,
        )
    return out
