"""What a reference gives for a job: every cluster's representative, in
cluster order, as flat arrays, and the problem sizes the work models
count."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Reps:
    offsets: np.ndarray  # (C + 1,): cluster c's peaks are [offsets[c], [c+1])
    mz: np.ndarray  # float64
    intensity: np.ndarray  # float64
    pepmass: np.ndarray  # (C,) float64
    charge: np.ndarray  # (C,) int64
    rt: np.ndarray  # (C,) float64; 0 where the record carries no RT
    cosines: np.ndarray | None  # (C,) mean member cosine, with a QC report
    sizes: dict  # problem sizes of the job (work/<config>.py reads them)
