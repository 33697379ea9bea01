"""Content-addressed consensus result cache (the port's copy of the JAX
package's ``cache/result_cache.py``), in two tiers:

* a bounded LOCAL tier (on-disk JSON entries, atomic rename commits,
  mtime-LRU eviction under a byte cap), ``--result-cache DIR[:MB]``;
* a SHARED tier (``--result-store DIR|URL``) on the elastic
  coordinator's store (:mod:`specpride_tpu_torch.parallel.store`): a
  directory or a conditional-put object store that a whole fleet
  populates and consults, entries under ``rc-<key>``.

Entries are keyed by ``(cluster content digest, method, config digest,
precision, schema rev)`` (see :mod:`specpride_tpu_torch.cache.digest`).
The entry format, the seal, the keys and the shared tier's key prefix are
the JAX package's, so either package reads the other's entries.

Design invariants:

* **Byte parity.**  A hit replays the representative's stored float64
  peak bits and MGF headers exactly, so cache-on output bytes and the
  QC report equal a cache-off run's for every method and precision.
  Any axis that could change the bytes is in the key (content, method,
  config with the QC configuration, precision, schema rev): there is no
  explicit invalidation, only keys that no longer match.
* **Corruption is a miss.**  Every entry is sealed with a digest of its
  own canonical body; a read-back whose seal does not verify (torn
  write, bit rot, stale schema) is quarantined aside and counted as a
  miss, never served.  The miss recomputes on the card like any other.
* **Crash safety.**  A commit writes a private temporary file then
  ``os.replace``; readers only ever open ``*.json``, so debris from a
  killed writer never parses as an entry.

The module-level singleton (``configure``/``active``/``reset``) is how a
long-lived process owns the tier: configured once, every run consults
it under its own :class:`RunContext` counters.  ``totals()`` aggregates
across runs.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import tempfile
import threading

import numpy as np

from specpride_tpu_torch.cache.digest import cluster_digest, result_key
from specpride_tpu_torch.observability import tracing

logger = logging.getLogger("specpride_tpu_torch.cache")

# the schema revision baked into every key: bump when the entry layout
# or replay semantics change and old entries become unservable
CODE_VERSION = "rc1"
ENTRY_VERSION = 1
DEFAULT_MAX_MB = 256
# the shared tier's key prefix in the store
_SHARED_PREFIX = "rc-"

# read-back outcome: the entry existed but failed its seal (quarantined,
# counted corrupt, treated as a miss)
CORRUPT = object()

# methods whose representative is a pure function of (cluster, config).
# "best" is excluded: it reads a per-run score table that is not part of
# the cluster's content.
CACHEABLE_METHODS = ("bin-mean", "gap-average", "medoid")


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(a, dtype=np.float64).tobytes()
    ).decode("ascii")


def _unb64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype=np.float64).copy()


def encode_rep(rep) -> dict:
    """A representative Spectrum as a JSON-safe doc.  Peak arrays ride as
    base64 float64 bytes (a bit-exact round trip); ``extra`` rides as an
    ordered pair list because the MGF writer emits it in insertion
    order."""
    return {
        "title": rep.title,
        "pepmass": float(rep.precursor_mz),
        "charge": int(rep.precursor_charge),
        "rt": float(rep.rt),
        "mz": _b64(rep.mz),
        "intensity": _b64(rep.intensity),
        "extra": [[str(k), str(v)] for k, v in rep.extra.items()],
    }


def decode_rep(doc: dict):
    from specpride_tpu_torch.data.peaks import Spectrum

    return Spectrum(
        mz=_unb64(doc["mz"]),
        intensity=_unb64(doc["intensity"]),
        precursor_mz=doc["pepmass"],
        precursor_charge=doc["charge"],
        rt=doc["rt"],
        title=doc["title"],
        extra=dict(tuple(kv) for kv in doc.get("extra", [])),
    )


def _canonical(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def _seal(doc: dict) -> dict:
    body = {k: v for k, v in doc.items() if k != "seal"}
    doc["seal"] = hashlib.sha256(_canonical(body)).hexdigest()
    return doc


def _verify(doc) -> bool:
    if not isinstance(doc, dict) or doc.get("v") != ENTRY_VERSION:
        return False
    seal = doc.get("seal")
    body = {k: v for k, v in doc.items() if k != "seal"}
    return isinstance(seal, str) and \
        hashlib.sha256(_canonical(body)).hexdigest() == seal


def make_entry(key: str, rep, cluster, cosine: float | None) -> dict:
    """One sealed cache entry: the representative, its QC cosine (None
    under a QC-off config key), and enough provenance to debug with."""
    return _seal({
        "v": ENTRY_VERSION,
        "key": key,
        "cluster_id": cluster.cluster_id,
        "n_members": cluster.n_members,
        "rep": encode_rep(rep),
        "cosine": None if cosine is None else float(cosine),
    })


class _Counters:
    """Thread-safe monotone counters shared by every RunContext."""

    FIELDS = (
        "hits", "misses", "populated", "evictions", "bytes_saved",
        "shared_hits", "corrupt",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self.FIELDS, 0)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)

    def zero(self) -> None:
        with self._lock:
            self._c = dict.fromkeys(self.FIELDS, 0)


_totals = _Counters()


def totals() -> dict:
    """Process-lifetime counters across every run."""
    return _totals.snapshot()


class LocalTier:
    """Bounded on-disk LRU of sealed JSON entries.

    One file per key under ``root``; recency is the file mtime (reads
    touch), and the byte cap is enforced after every put by evicting
    oldest first.  Every mutation is rename-atomic, so pack workers and
    the write lane need no cross-process lock: the worst race is two
    writers of the same key, with identical sealed bytes, and the
    loser's replace rewrites the same entry.

    The directory is scanned only when the cap may be exceeded: the
    tier's bytes as last scanned plus every put since (a rewrite counted
    again, so the sum only overestimates) stand in for a scan after each
    put.  A run populating N entries then makes O(N) file operations, not
    a scan of the whole directory per entry.  Another process's puts are
    seen at the next scan."""

    def __init__(self, root: str, max_mb: int = DEFAULT_MAX_MB):
        self.root = root
        self.max_bytes = int(max_mb) * 1024 * 1024
        self.evictions = 0
        self.evicted_bytes = 0
        self._lock = threading.Lock()
        self._bytes: int | None = None  # None: not scanned yet
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def get(self, key: str):
        """The sealed entry dict, ``CORRUPT`` (quarantined aside), or
        ``None``."""
        path = self._path(key)
        try:
            with open(path, "r") as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            self._quarantine(path)
            return CORRUPT
        if not _verify(doc) or doc.get("key") != key:
            self._quarantine(path)
            return CORRUPT
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        return doc

    def _quarantine(self, path: str) -> None:
        """Move a failed entry aside (never delete evidence, never serve
        it): ``<name>.corrupt`` in the same directory."""
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        logger.warning("result cache: quarantined corrupt entry %s", path)

    def put(self, key: str, entry: dict) -> None:
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(
            dir=self.root, prefix=".tmp-", suffix=".part"
        )
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(entry, fh, separators=(",", ":"))
                size = fh.tell()
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._enforce_cap(size)

    def _entries(self) -> list[tuple[float, int, str]]:
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue  # tmp debris and quarantined entries never count
            path = os.path.join(self.root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((st.st_mtime, st.st_size, path))
        return out

    def _enforce_cap(self, added: int) -> None:
        with self._lock:
            if (self._bytes is not None
                    and self._bytes + added <= self.max_bytes):
                self._bytes += added
                return
            entries = self._entries()
            total = sum(size for _, size, _ in entries)
            self._bytes = total
            if total <= self.max_bytes:
                return
            entries.sort()  # oldest mtime first
            for _, size, path in entries:
                if total <= self.max_bytes:
                    break
                try:
                    os.unlink(path)
                except OSError:
                    continue
                total -= size
                self._bytes = total
                self.evictions += 1
                self.evicted_bytes += size
                _totals.add("evictions")

    def info(self) -> dict:
        entries = self._entries()
        return {
            "entries": len(entries),
            "bytes": sum(size for _, size, _ in entries),
            "evictions": self.evictions,
        }


class SharedTier:
    """The fleet's tier on a coordinator ``Store`` (a directory or an
    object-store URL), entries under ``rc-<key>``.  A create-if-absent
    put makes racing populations harmless; an entry whose seal fails is a
    corrupt miss and stays where it is (another reader's copy may be
    fine, and a shared store is not this process's to quarantine)."""

    def __init__(self, store):
        self.store = store

    def get(self, key: str):
        try:
            got = self.store.get(_SHARED_PREFIX + key)
        except OSError as e:
            logger.warning("result cache: shared-tier get failed: %s", e)
            return None
        if got is None:
            return None
        doc = got[0]
        if not _verify(doc) or doc.get("key") != key:
            logger.warning("result cache: shared entry for %s failed "
                           "verification; treating as a miss", key[:16])
            return CORRUPT
        return doc

    def put(self, key: str, entry: dict) -> None:
        try:
            self.store.put_new(_SHARED_PREFIX + key, entry)
        except OSError as e:
            logger.warning("result cache: shared-tier put failed: %s", e)

    def describe(self) -> str:
        return self.store.describe()


class ResultCache:
    """The two tiers: local first, then the shared one on a local miss
    (a shared hit is copied to the local tier, so the next lookup stays on
    the host)."""

    def __init__(self, local: LocalTier, shared: SharedTier | None = None):
        self.local = local
        self.shared = shared

    def lookup(self, key: str):
        """``(entry, "local"|"shared")``, or ``(None, "corrupt"|"miss")``."""
        doc = self.local.get(key)
        # a corrupt local copy falls through: the fleet's may be sound
        corrupt = doc is CORRUPT
        if doc is not None and not corrupt:
            return doc, "local"
        if self.shared is not None:
            doc = self.shared.get(key)
            if doc is CORRUPT:
                return None, "corrupt"
            if doc is not None:
                try:
                    self.local.put(key, doc)
                except OSError:
                    pass
                return doc, "shared"
        return None, "corrupt" if corrupt else "miss"

    def populate(self, key: str, entry: dict) -> None:
        self.local.put(key, entry)
        if self.shared is not None:
            self.shared.put(key, entry)

    def info(self) -> dict:
        out = self.local.info()
        if self.shared is not None:
            out["shared"] = self.shared.describe()
        return out


class RunContext:
    """One run's view of the cache: the key axes fixed at run start
    (method, config digest, precision) plus per-run counters, which ride
    the ``result_cache`` journal event and ``run_end.counters``."""

    def __init__(self, cache: ResultCache, method: str, config: str,
                 precision: str):
        self.cache = cache
        self.method = method
        self.config = config
        self.precision = precision
        self.counters = _Counters()
        # the local tier outlives runs in a long-lived process, so the
        # run's eviction count is a delta
        self._evict0 = cache.local.evictions

    def key_of(self, cluster) -> str:
        return result_key(
            cluster_digest(cluster), self.method, self.config,
            self.precision, CODE_VERSION,
        )

    def consult(self, clusters) -> dict:
        """Look every cluster up under a ``cache:consult`` span; returns
        ``{cluster_id: (rep or None, cosine, key)}`` covering every
        cluster: ``rep`` is None on a miss, and the key is kept so the
        populate path never digests the content again."""
        out: dict = {}
        with tracing.span("cache:consult", n_clusters=len(clusters)):
            for c in clusters:
                key = self.key_of(c)
                entry, tier = self.cache.lookup(key)
                if entry is not None:
                    rep = decode_rep(entry["rep"])
                    out[c.cluster_id] = (rep, entry.get("cosine"), key)
                    self.counters.add("hits")
                    _totals.add("hits")
                    saved = int(rep.mz.nbytes + rep.intensity.nbytes)
                    self.counters.add("bytes_saved", saved)
                    _totals.add("bytes_saved", saved)
                    if tier == "shared":
                        self.counters.add("shared_hits")
                        _totals.add("shared_hits")
                else:
                    out[c.cluster_id] = (None, None, key)
                    self.counters.add("misses")
                    _totals.add("misses")
                    if tier == "corrupt":
                        self.counters.add("corrupt")
                        _totals.add("corrupt")
        return out

    @staticmethod
    def hit_ids(consulted: dict | None) -> set:
        return {
            cid for cid, (rep, _, _) in (consulted or {}).items()
            if rep is not None
        }

    def populate(self, items) -> None:
        """Commit computed results, ``(key, rep, cluster, cosine)`` each.
        Exceptions are contained: a cache that cannot persist never fails
        the run that already wrote its output."""
        for key, rep, cluster, cosine in items:
            try:
                self.cache.populate(key, make_entry(key, rep, cluster,
                                                    cosine))
            except Exception as e:  # noqa: BLE001 - the cache is best-effort
                logger.warning(
                    "result cache: populate failed for %s: %s",
                    cluster.cluster_id, e,
                )
                continue
            self.counters.add("populated")
            _totals.add("populated")

    def snapshot(self) -> dict:
        snap = self.counters.snapshot()
        info = self.cache.local.info()
        snap["entries"] = info["entries"]
        snap["bytes"] = info["bytes"]
        snap["evictions"] = self.cache.local.evictions - self._evict0
        return snap


# -- process-wide singleton -------------------------------------------------

_active: ResultCache | None = None
_active_lock = threading.Lock()


def parse_spec(spec: str) -> tuple[str, int]:
    """``DIR[:MB]`` as ``(dir, max_mb)``."""
    path, sep, mb = spec.rpartition(":")
    if sep and mb.isdigit():
        return path, int(mb)
    return spec, DEFAULT_MAX_MB


def build(spec: str, store_url: str | None = None) -> ResultCache:
    """The cache of a ``--result-cache DIR[:MB]`` spec, with the shared
    tier on ``store_url`` (``--result-store DIR|URL``) when given."""
    from specpride_tpu_torch.parallel.store import store_from_spec

    root, max_mb = parse_spec(spec)
    shared = SharedTier(store_from_spec(store_url)) if store_url else None
    return ResultCache(LocalTier(root, max_mb), shared)


def configure(spec: str | None,
              store_url: str | None = None) -> ResultCache | None:
    """Install (or, spec None, clear) the process-wide cache.  Returns
    the installed instance."""
    global _active
    with _active_lock:
        _active = build(spec, store_url) if spec else None
        return _active


def active() -> ResultCache | None:
    with _active_lock:
        return _active


def reset() -> None:
    """Drop the singleton and zero the process totals."""
    global _active
    with _active_lock:
        _active = None
        _totals.zero()


def runtime_for(args, command: str, backend=None):
    """The run's :class:`RunContext`, or None when the cache does not
    apply: no cache configured (the flag, else the process singleton), a
    method that is not cacheable, a config the digest cannot fix, or a
    served batch member (its batch's leader consulted for it)."""
    if getattr(backend, "is_batch_view", False):
        return None
    method = getattr(args, "method", None)
    if command not in ("consensus", "select") or \
            method not in CACHEABLE_METHODS:
        return None
    spec = getattr(args, "result_cache", None)
    cache = (build(spec, getattr(args, "result_store", None)) if spec
             else active())
    if cache is None:
        return None
    from specpride_tpu_torch.serve.batcher import config_digest

    config = config_digest(args, command)
    if config is None:
        return None
    precision = str(
        getattr(backend, "precision", None)
        or getattr(args, "precision", None) or "f32"
    )
    return RunContext(cache, method, config, precision)
