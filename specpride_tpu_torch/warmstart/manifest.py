"""Shape manifests: the persisted record of every (kernel, shape class) a
workload dispatched (the JAX package's ``warmstart/manifest.py``; the same
format, version 1, so either package reads the other's file).

The backend tracks the shape classes it dispatched
(``TorchBackend._seen_shapes``, the set behind the journal's ``compile``
events).  A manifest keeps them on disk, so a later process can dispatch
each class once before its first chunk (``warmup``, ``--warmup``) and pay
the first-dispatch costs there: the kernel library's load, each lane's
workspace, the lazily loaded device code of the torch ops around the
kernels.  The port compiles nothing per shape, so its shape keys are
short: the channel precision of the flat paths, the bucket widths of the
(B, K) ones.

Format (JSON, versioned, additive)::

    {"version": 1,
     "entries": [
       {"kernel": "bin_mean_flat_intensity", "shape_key": ["f32"],
        "config": {"type": "BinMeanConfig", "min_mz": 100.0, ...}},
       {"kernel": "cosine_flat", "shape_key": [], "config": null}]}

``config`` is present only for the kernels whose path runs with the
method's configuration (``CONFIG_KERNELS``), so a warm runs the run's own
configuration.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

MANIFEST_VERSION = 1

# the port's kernels whose path runs with the method's configuration
CONFIG_KERNELS = {
    "bin_mean_flat_intensity": "BinMeanConfig",
    "bin_mean_flat_q": "BinMeanConfig",
    "bin_mean_bucketized": "BinMeanConfig",
    "gap_average_compact": "GapAverageConfig",
    "shared_bins_packed": "MedoidConfig",
}


@dataclasses.dataclass(frozen=True)
class ShapeEntry:
    kernel: str
    shape_key: tuple
    config: dict | None = None  # {"type": <dataclass name>, **fields}

    def identity(self) -> tuple:
        return (
            self.kernel,
            tuple(self.shape_key),
            json.dumps(self.config, sort_keys=True),
        )

    def to_json(self) -> dict:
        return {
            "kernel": self.kernel,
            "shape_key": list(self.shape_key),
            "config": self.config,
        }


def _order(key: tuple) -> tuple:
    """A sort key for ``(kernel, *shape_key)`` tuples whose shape keys mix
    numbers and dtype tokens (the flat and the (B, K) classes of one
    kernel): the kernel, then the key's JSON text."""
    return key[0], json.dumps(list(key[1:]))


def config_dict(config_obj) -> dict:
    return {
        "type": type(config_obj).__name__,
        **dataclasses.asdict(config_obj),
    }


def entries_from_seen(
    seen_shapes, method_config=None
) -> list[ShapeEntry]:
    """Manifest entries from a backend's ``_seen_shapes`` set (tuples of
    ``(kernel, *shape_key)``).  ``method_config`` is the run's method
    config object, attached to the kernels whose path runs with it."""
    cfg = config_dict(method_config) if method_config is not None else None
    out = []
    for key in sorted(seen_shapes, key=_order):
        kernel, shape_key = key[0], tuple(key[1:])
        want = CONFIG_KERNELS.get(kernel)
        entry_cfg = (
            cfg if want is not None and cfg is not None
            and cfg.get("type") == want else None
        )
        if want is not None and entry_cfg is None:
            # a config-keyed kernel without its config cannot be rebuilt;
            # skip rather than record an unwarmable entry
            continue
        out.append(ShapeEntry(kernel, shape_key, entry_cfg))
    return out


def load_manifest(path: str) -> list[ShapeEntry]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "entries" not in doc:
        raise ValueError(f"{path}: not a shape manifest")
    version = doc.get("version")
    if version != MANIFEST_VERSION:
        raise ValueError(
            f"{path}: unsupported manifest version {version!r}"
        )
    out = []
    for i, e in enumerate(doc["entries"]):
        try:
            out.append(
                ShapeEntry(
                    str(e["kernel"]), tuple(e["shape_key"]),
                    e.get("config"),
                )
            )
        except (KeyError, TypeError) as err:
            raise ValueError(f"{path}: bad entry #{i}: {err}") from err
    return out


def merge_manifest(path: str, entries: list[ShapeEntry]) -> int:
    """Union ``entries`` into the manifest at ``path`` (created if
    absent), atomically.  Returns the total entry count after the merge.
    Identity is (kernel, shape_key, config) — re-running the same
    workload leaves the manifest unchanged.

    The read-modify-write runs under an ``flock`` on ``path + ".lock"``:
    concurrent finishers sharing one manifest (ranks, parallel CLI runs)
    would otherwise each union only their own entries and the last
    ``os.replace`` would drop the others' shape classes.  Threads of one
    process share the lock too (each opens its own lock file).  The
    temporary file is named per process and thread, so two writers never
    share it."""
    lock_path = path + ".lock"
    lock_fh = None
    try:
        try:
            import fcntl

            lock_fh = open(lock_path, "a")
            fcntl.flock(lock_fh.fileno(), fcntl.LOCK_EX)
        except (ImportError, OSError):
            lock_fh = None  # non-POSIX / unwritable: best-effort merge
        have: dict[tuple, ShapeEntry] = {}
        if os.path.exists(path):
            for e in load_manifest(path):
                have[e.identity()] = e
        for e in entries:
            have.setdefault(e.identity(), e)
        doc = {
            "version": MANIFEST_VERSION,
            "entries": [e.to_json() for e in sorted(
                have.values(), key=lambda e: _order(
                    (e.kernel, *e.shape_key, json.dumps(e.config,
                                                        sort_keys=True))))],
        }
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, path)
        return len(have)
    finally:
        if lock_fh is not None:
            lock_fh.close()  # closing drops the flock
