"""Mirror plots: member vs theoretical peptide, member vs consensus (the
port's copy of the JAX package's ``viz.py``, on the port's
``ops.fragments``, ``config.FragmentConfig`` and ``data.peaks``).

Re-designed equivalents of ref src/plot_cluster.py (member spectra mirrored
against the theoretical b/y spectrum of the identified peptide) and ref
src/plot_cluster_vs_consensus.py (members mirrored against the cluster's
representative — which is broken as written in the reference: undefined
``tspec`` at :48 plus loop-indentation bugs :24-43; this is the working
equivalent).  Pure host-side matplotlib on its non-interactive Agg
backend (set at the first plot, never at import); no spectrum_utils
dependency: fragment theory comes from ``ops.fragments``.  ``plot`` needs
no card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from specpride_tpu_torch.config import FragmentConfig
from specpride_tpu_torch.data.peaks import Spectrum
from specpride_tpu_torch.ops.fragments import (
    fragment_annotations,
    fragment_mzs,
    match_fragments,
)


def _normalized(intensity: np.ndarray, mode: str = "root") -> np.ndarray:
    """'root' reproduces the reference's ``scale_intensity('root')``
    preprocessing (ref src/plot_cluster.py:32)."""
    if intensity.size == 0:
        return intensity
    if mode == "root":
        v = np.sqrt(np.abs(intensity))
    else:
        v = np.abs(intensity)
    peak = v.max()
    return v / peak if peak > 0 else v


def preprocess(
    spec: Spectrum,
    min_mz: float = 100.0,
    max_mz: float = 1400.0,
    min_intensity_fraction: float = 0.05,
    max_peaks: int = 50,
) -> Spectrum:
    """The reference's plotting chain: m/z window, remove precursor peak,
    intensity filter, top-N (ref src/plot_cluster.py:29-33)."""
    keep = (spec.mz >= min_mz) & (spec.mz <= max_mz)
    keep &= np.abs(spec.mz - spec.precursor_mz) > 0.5
    mz, inten = spec.mz[keep], spec.intensity[keep]
    if inten.size:
        keep2 = inten >= min_intensity_fraction * inten.max()
        mz, inten = mz[keep2], inten[keep2]
    if inten.size > max_peaks:
        top = np.argsort(inten)[-max_peaks:]
        top.sort()
        mz, inten = mz[top], inten[top]
    return Spectrum(
        mz=mz,
        intensity=inten,
        precursor_mz=spec.precursor_mz,
        precursor_charge=spec.precursor_charge,
        rt=spec.rt,
        title=spec.title,
    )


def theoretical_spectrum(
    peptide: str,
    charge: int,
    config: FragmentConfig = FragmentConfig(),
) -> Spectrum:
    """Unit-intensity b/y theoretical spectrum
    (ref src/plot_cluster.py:36-41 via spectrum_utils internals)."""
    mzs = fragment_mzs(peptide, config.ion_types, max(1, charge - 1))
    return Spectrum(
        mz=mzs,
        intensity=np.ones_like(mzs),
        precursor_mz=0.0,
        precursor_charge=charge,
        title=f"theoretical {peptide}",
    )


def mirror_plot(
    top: Spectrum,
    bottom: Spectrum,
    ax=None,
    annotate_peptide: str | None = None,
    normalize: str = "root",
    config: FragmentConfig = FragmentConfig(),
):
    """Mirror plot: ``top`` upward, ``bottom`` downward.

    Peaks within the fragment tolerance of the annotated peptide's b/y ions
    are coloured AND labelled with the matching ion (``b3``, ``y5^2+`` —
    the visible output of the spectrum_utils plots the reference wraps,
    ref src/plot_cluster.py:33-45).  Returns the matplotlib Axes.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 5))

    if annotate_peptide:
        frags, frag_labels = fragment_annotations(
            annotate_peptide, config.ion_types, 2
        )
    else:
        frags, frag_labels = np.zeros((0,)), []

    for spec, sign in ((top, 1.0), (bottom, -1.0)):
        inten = _normalized(spec.intensity, normalize) * sign
        matched = match_fragments(spec.mz, frags, config.tol, config.tol_mode)
        for sel, color in ((~matched, "#888888"), (matched, "#d62728")):
            if np.any(sel):
                ax.vlines(
                    spec.mz[sel], 0, inten[sel], color=color, linewidth=1.0
                )
        if frags.size and np.any(matched):
            # label each matched peak with its nearest fragment's identity
            pos = np.clip(
                np.searchsorted(frags, spec.mz[matched]), 1, frags.size - 1
            )
            left, right = frags[pos - 1], frags[pos]
            nearest = np.where(
                np.abs(spec.mz[matched] - left)
                <= np.abs(spec.mz[matched] - right),
                pos - 1,
                pos,
            )
            va = "bottom" if sign > 0 else "top"
            for x, y, fi in zip(spec.mz[matched], inten[matched], nearest):
                ax.annotate(
                    frag_labels[int(fi)], (x, y), ha="center", va=va,
                    fontsize=7, color="#d62728", rotation=90,
                    textcoords="offset points",
                    xytext=(0, 2 if sign > 0 else -2),
                )

    ax.axhline(0.0, color="black", linewidth=0.8)
    ax.set_xlabel("m/z")
    ax.set_ylabel("normalized intensity")
    ax.set_ylim(-1.05, 1.05)
    ax.set_title(f"{top.title}  vs  {bottom.title}"[:120])
    return ax


def plot_cluster_vs_theoretical(
    members: Sequence[Spectrum],
    peptide: str,
    charge: int,
    out_prefix: str,
    config: FragmentConfig = FragmentConfig(),
) -> list[str]:
    """Ref src/plot_cluster.py:10-47 / main.sh: one mirror plot per
    member against the theoretical peptide spectrum.  Returns file paths."""
    import matplotlib.pyplot as plt

    theo = theoretical_spectrum(peptide, charge, config)
    paths = []
    for i, member in enumerate(members):
        ax = mirror_plot(
            preprocess(member), theo, annotate_peptide=peptide, config=config
        )
        path = f"{out_prefix}_{i}.png"
        ax.figure.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(ax.figure)
        paths.append(path)
    return paths


def plot_cluster_vs_consensus(
    members: Sequence[Spectrum],
    consensus: Spectrum,
    out_prefix: str,
    config: FragmentConfig = FragmentConfig(),
) -> list[str]:
    """Ref src/plot_cluster_vs_consensus.py, fixed: one mirror plot per
    member against the cluster's representative."""
    import matplotlib.pyplot as plt

    paths = []
    for i, member in enumerate(members):
        ax = mirror_plot(preprocess(member), preprocess(consensus), config=config)
        path = f"{out_prefix}_{i}.png"
        ax.figure.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(ax.figure)
        paths.append(path)
    return paths
