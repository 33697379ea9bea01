"""Quality evaluation of representative spectra (ref src/benchmark.py),
the port's copy of the JAX package's ``metrics.py``.

Two metrics, per cluster:

* mean binned cosine of the representative to the cluster members
  (ref src/benchmark.py:31-38): ``TorchBackend.average_cosines``, on the
  card through ``cosine_flat`` and the ``seg_scan`` kernel, or the numpy
  oracle;
* fraction of the representative's ion current explained by b/y fragments
  of the identified peptide (ref src/benchmark.py:40-61), on the host
  (``ops/fragments.py``, which fixes the reference's undefined-variable
  bug).

The peptide is taken from the first USI interpretation suffix
(``...:PEPTIDE/z``) among the representative and its members.
"""

from __future__ import annotations

import csv
import dataclasses
import json
from typing import Sequence

import numpy as np

from specpride_tpu_torch.backends import numpy_backend
from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import CosineConfig, FragmentConfig
from specpride_tpu_torch.data.peaks import Cluster, Spectrum, peptide_from_usi
from specpride_tpu_torch.ops.fragments import fraction_of_by_batch


@dataclasses.dataclass
class ClusterQuality:
    cluster_id: str
    n_members: int
    n_peaks: int
    avg_cosine: float
    by_fraction: float | None  # None when no peptide is known

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def evaluate(
    representatives: Sequence[Spectrum],
    clusters: Sequence[Cluster],
    backend: TorchBackend | str,
    cosine_config: CosineConfig = CosineConfig(),
    fragment_config: FragmentConfig = FragmentConfig(),
) -> list[ClusterQuality]:
    """Score each representative against its cluster.  ``backend`` is a
    ``TorchBackend`` (its device runs the cosines) or ``"numpy"`` (the
    oracle)."""
    if len(representatives) != len(clusters):
        raise ValueError("representatives and clusters must align")
    if backend == "numpy":
        cosines = np.array([
            numpy_backend.average_cosine(r, c.members, cosine_config)
            for r, c in zip(representatives, clusters)
        ])
    elif isinstance(backend, TorchBackend):
        cosines = backend.average_cosines(
            list(representatives), list(clusters), cosine_config)
    else:
        raise ValueError(f"backend must be a TorchBackend or 'numpy', got "
                         f"{backend!r}")

    peptides: list[str | None] = []
    for rep, cluster in zip(representatives, clusters):
        peptide = None
        for s in [rep, *cluster.members]:
            pep, _ = peptide_from_usi(s.usi)
            if pep:
                peptide = pep
                break
        peptides.append(peptide)
    # one fragment table per unique peptide/charge; NaN = no peptide
    fracs = fraction_of_by_batch(
        peptides,
        np.array([r.precursor_mz for r in representatives]),
        np.array([r.precursor_charge for r in representatives]),
        [r.mz for r in representatives],
        [r.intensity for r in representatives],
        tol=fragment_config.tol,
        tol_mode=fragment_config.tol_mode,
        min_mz=fragment_config.min_mz,
        max_mz=fragment_config.max_mz,
    )
    return [
        ClusterQuality(
            cluster_id=cluster.cluster_id,
            n_members=cluster.n_members,
            n_peaks=rep.n_peaks,
            avg_cosine=float(cos),
            by_fraction=None if np.isnan(frac) else float(frac),
        )
        for rep, cluster, cos, frac in zip(
            representatives, clusters, cosines, fracs
        )
    ]


def summarize(results: Sequence[ClusterQuality]) -> dict:
    """Aggregate metrics across clusters (the numbers the reference prints
    one at a time in its __main__ self-test, ref src/benchmark.py:63-80)."""
    cosines = [r.avg_cosine for r in results]
    fracs = [r.by_fraction for r in results if r.by_fraction is not None]
    return {
        "n_clusters": len(results),
        "mean_cosine": float(np.mean(cosines)) if cosines else 0.0,
        "median_cosine": float(np.median(cosines)) if cosines else 0.0,
        "mean_by_fraction": float(np.mean(fracs)) if fracs else None,
        "n_with_peptide": len(fracs),
    }


def write_report(
    results: Sequence[ClusterQuality], path: str, fmt: str = "json"
) -> None:
    """JSON or CSV report, in the JAX package's layout."""
    if fmt == "json":
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(
                {
                    "summary": summarize(results),
                    "clusters": [r.to_dict() for r in results],
                },
                fh,
                indent=1,
            )
    elif fmt == "csv":
        with open(path, "w", encoding="utf-8", newline="") as fh:
            # quotes ids holding commas or quotes; LF line ends, as the
            # JAX package's reports have (csv's default is CRLF)
            w = csv.writer(fh, lineterminator="\n")
            w.writerow(
                ["cluster_id", "n_members", "n_peaks", "avg_cosine",
                 "by_fraction"]
            )
            for r in results:
                frac = "" if r.by_fraction is None else f"{r.by_fraction:.6f}"
                w.writerow(
                    [r.cluster_id, r.n_members, r.n_peaks,
                     f"{r.avg_cosine:.6f}", frac]
                )
    else:
        raise ValueError(f"unknown report format {fmt!r}")
