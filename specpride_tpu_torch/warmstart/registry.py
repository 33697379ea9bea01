"""Warmup registry: for a manifest entry, the smallest inputs that take the
same path through the port as the dispatch it records.

The port's backend passes six kernel names to ``_note_dispatch``
(``backends/torch_backend.py``): ``bin_mean_flat_intensity`` and
``bin_mean_flat_q`` (the flat bin-mean at f32 and at a reduced
precision), ``bin_mean_bucketized`` (the (B, K) bin-mean),
``gap_average_compact`` (the flat gap average, keyed ``(precision,)``,
and the (B, K) one, keyed ``(K, precision)``), ``shared_bins_packed``
(the medoid, ``(K, M, encoding)``) and ``cosine_packed`` /
``cosine_flat`` (the QC cosine on either layout).  Each builder here
makes a few seeded synthetic clusters sized to land in the entry's shape
class (the precision, the bucket width K, the member bucket M, the
representative width) and names the method and the backend settings that
dispatch it.  Nothing is compiled per shape on the card: a warm pays the
first-dispatch costs of the path instead (the kernel library's load, the
lane's workspace, the device code of the torch ops around the kernels,
the allocator's first blocks).

A builder reads the port's keys only: a JAX manifest's keys (the padded
sizes of its XLA programs) raise ``ValueError``, and warmup skips them
as bad entries; kernels the port has not got (the JAX ``*_pallas``
routes and ``medoid_select_packed``) are not in the registry, and warmup
skips them with a journal note.  ``build`` keeps the JAX signature;
``donate`` is accepted and ignored (the port donates no buffers).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from specpride_tpu_torch.warmstart.manifest import ShapeEntry

PRECISIONS = ("f32", "bf16", "int8")


def _configs() -> dict:
    from specpride_tpu_torch import config

    return {"BinMeanConfig": config.BinMeanConfig,
            "GapAverageConfig": config.GapAverageConfig,
            "MedoidConfig": config.MedoidConfig}


def _rebuild_config(config: dict | None, type_name: str):
    """The entry's method configuration, or the default one of
    ``type_name`` for an entry without one (a JAX manifest records no
    configuration for most kernels).  Fields this package's dataclass has
    not got are dropped."""
    if config is None:
        return _configs()[type_name]()
    fields = dict(config)
    name = fields.pop("type", None)
    cls = _configs().get(name)
    if cls is None:
        raise ValueError(f"unknown config type {name!r}")
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in fields.items() if k in known})


def _precision(prec) -> str:
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision token {prec!r}")
    return prec


def _floor(k: int, buckets: tuple) -> int:
    """The largest bucket below ``k`` (0 below the first): a cluster of
    ``floor + 1`` total peaks lands in bucket ``k``."""
    below = [b for b in buckets if b < k]
    return max(below) if below else 0


def _clusters(n_clusters: int, members: int, peaks: int,
              rep_peaks: int | None = None) -> list:
    """Seeded charge-2 clusters of ``members`` members of ``peaks`` peaks
    each, on one m/z skeleton with 3 mDa jitter (the members share bins).
    With ``rep_peaks``, member 0 (the cosine's representative) has that
    many peaks instead."""
    from specpride_tpu_torch.data.peaks import Cluster, Spectrum, build_title

    rng = np.random.default_rng(20240611)
    out = []
    scan = 0
    for ci in range(n_clusters):
        cid = f"warmup-{ci}"
        specs = []
        for j in range(members):
            n = rep_peaks if (j == 0 and rep_peaks) else peaks
            mz = np.sort(np.linspace(150.0, 1800.0, n)
                         + rng.normal(0.0, 0.003, n))
            scan += 1
            specs.append(Spectrum(
                mz, rng.uniform(10.0, 1e4, n), 500.0 + ci, 2,
                100.0 + j, build_title(cid, "PXD000000", "warmup.raw",
                                       scan)))
        out.append(Cluster(cid, specs))
    return out


def _batch_config():
    from specpride_tpu_torch.config import BatchConfig

    return BatchConfig()


def _bucket_clusters(k: int, members: int, rep_peaks: int | None = None):
    """Two clusters of ``members`` members whose total peaks land in the
    (B, K) bucket ``k``."""
    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
        raise ValueError(f"bucket width {k!r} is not a size")
    floor = _floor(k, _batch_config().total_peak_buckets)
    peaks = max(4, math.ceil((floor + 1) / members))
    if members * peaks > k:
        raise ValueError(f"no {members}-member cluster fits bucket {k}")
    return _clusters(2, members, peaks, rep_peaks)


def _bin_mean_flat(entry: ShapeEntry, quantized: bool) -> tuple:
    (prec,) = entry.shape_key  # (precision,)
    if prec not in PRECISIONS or quantized == (prec == "f32"):
        raise ValueError(f"{entry.kernel} does not run at {prec!r}")
    return (_clusters(2, 3, 16),), dict(
        method="bin-mean", precision=prec, layout="flat",
        config=_rebuild_config(entry.config, "BinMeanConfig"))


def _bin_mean_bucketized(entry: ShapeEntry) -> tuple:
    k, prec = entry.shape_key  # (K, precision)
    return (_bucket_clusters(k, 3),), dict(
        method="bin-mean", precision=_precision(prec), layout="bucketized",
        config=_rebuild_config(entry.config, "BinMeanConfig"))


def _gap_average(entry: ShapeEntry) -> tuple:
    # (precision,) on the flat layout, (K, precision) on the (B, K) one
    *k, prec = entry.shape_key
    if len(k) > 1:
        raise ValueError("not (precision,) or (K, precision)")
    clusters = _bucket_clusters(*k, 3) if k else _clusters(2, 3, 16)
    return (clusters,), dict(
        method="gap-average", precision=_precision(prec),
        layout="bucketized" if k else "flat",
        config=_rebuild_config(entry.config, "GapAverageConfig"))


def _shared_bins(entry: ShapeEntry) -> tuple:
    k, m, encoding = entry.shape_key  # (K, M, encoding)
    members = max(2, _floor(m, _batch_config().member_buckets) + 1)
    # the medoid ships int16 bins and member ids only at a reduced
    # precision
    return (_bucket_clusters(k, members),), dict(
        method="medoid", precision="bf16" if encoding == "i16" else "f32",
        layout="flat", config=_rebuild_config(entry.config, "MedoidConfig"))


def _cosine_packed(entry: ShapeEntry) -> tuple:
    k, pr, m = entry.shape_key  # (K, Pr, M)
    # M is the batch's member count rounded up to a power of two; Pr the
    # representative's peaks, likewise, at least 256
    members = m // 2 + 1 if m > 2 else max(m, 1)
    rep = pr // 2 + 1 if pr > 256 else None
    return (_bucket_clusters(k, members, rep),), dict(
        method="cosine", precision="f32", layout="bucketized", config=None)


def _cosine_flat(entry: ShapeEntry) -> tuple:
    if tuple(entry.shape_key):  # the one flat class: ()
        raise ValueError(f"cosine_flat key {list(entry.shape_key)}")
    return (_clusters(2, 3, 16),), dict(
        method="cosine", precision="f32", layout="flat", config=None)


def dispatch(device, clusters, *, method: str, precision: str, layout: str,
             config) -> None:
    """Run ``method`` over ``clusters`` once on a backend of its own on
    ``device`` (on the current CUDA stream): the resident backend's
    counters, shape classes and journal stay untouched, and the outputs
    are dropped."""
    from specpride_tpu_torch.backends.torch_backend import TorchBackend
    from specpride_tpu_torch.config import CosineConfig

    backend = TorchBackend(device=device, precision=precision,
                           layout=layout)
    if method == "bin-mean":
        backend.run_bin_mean(clusters, config)
    elif method == "gap-average":
        backend.run_gap_average(clusters, config)
    elif method == "medoid":
        backend.run_medoid(clusters, config)
    else:
        backend.average_cosines([c.members[0] for c in clusters], clusters,
                                CosineConfig())


_WARM_BUILDERS = {
    "bin_mean_flat_intensity": lambda e: _bin_mean_flat(e, False),
    "bin_mean_flat_q": lambda e: _bin_mean_flat(e, True),
    "bin_mean_bucketized": _bin_mean_bucketized,
    "gap_average_compact": _gap_average,
    "shared_bins_packed": _shared_bins,
    "cosine_packed": _cosine_packed,
    "cosine_flat": _cosine_flat,
}


def known_kernels() -> tuple[str, ...]:
    return tuple(sorted(_WARM_BUILDERS))


def build(entry: ShapeEntry, donate: bool = True):
    """``(dispatch, args, statics)`` for a manifest entry, called as
    ``dispatch(device, *args, **statics)``, or None for a kernel this
    registry has not got.  Raises ``ValueError`` on a key it cannot
    read."""
    builder = _WARM_BUILDERS.get(entry.kernel)
    if builder is None:
        return None
    try:
        args, statics = builder(entry)
    except (TypeError, ValueError) as e:  # a key of another form
        raise ValueError(f"{entry.kernel} key {list(entry.shape_key)}: "
                         f"{e}") from None
    return dispatch, args, statics
