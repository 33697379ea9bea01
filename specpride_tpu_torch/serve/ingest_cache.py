"""Parsed-input residency for the serving daemon's lanes (the port's copy
of the JAX package's ``serve/ingest_cache.py``).

A served job over an input an earlier job parsed skips the parse: a
bounded process-wide LRU of eagerly parsed cluster lists keyed by
``(abspath, size, mtime_ns)``, so a changed input misses by
construction.  ``SPECPRIDE_INGEST_CACHE`` bounds the entries (0 turns it
off).

Safety contract:

* Cached cluster lists are shared read-only across jobs and lanes; no
  consumer mutates a cluster or a spectrum.
* Only eager, quarantine-free, non-``.gz`` parses on a serving lane
  cache (``cli._load_clusters_served``); a streamed input is a view, not
  a list, and ``--on-error skip`` must see the malformed blocks again.  A
  one-shot CLI run never consults it.
* Content fallback: a stat miss against a non-empty cache hashes the
  file (``cache.digest.file_digest``) and matches it against the resident
  entries, so a copied or touched identical input still skips its parse;
  the entry is then re-keyed under the new stat identity.

Each job counts ``ingest_cache_hits`` / ``ingest_cache_misses`` (content
matches also as ``ingest_cache_content_hits``) in its ``run_end``
counters; the daemon's ``/metrics`` carries the process totals
(``specpride_serve_ingest_cache_*_total``).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from specpride_tpu_torch.cache.digest import file_digest

# entries, not bytes: a handful of distinct inputs covers repeated jobs
DEFAULT_MAX_ENTRIES = 4

_lock = threading.Lock()
_cache: "OrderedDict[tuple, list]" = OrderedDict()
_counts = {"hits": 0, "misses": 0, "content_hits": 0}
# file sha256 -> the stat key holding those bytes' parse, and back
_by_content: dict = {}
_content_of: dict = {}


def _max_entries() -> int:
    try:
        return int(os.environ.get("SPECPRIDE_INGEST_CACHE",
                                  DEFAULT_MAX_ENTRIES))
    except ValueError:
        return DEFAULT_MAX_ENTRIES


def _key(path: str) -> tuple | None:
    try:
        st = os.stat(path)
    except OSError:
        return None  # the parser reports the real error
    return (os.path.abspath(path), st.st_size, st.st_mtime_ns)


def lookup(path: str) -> "tuple[list | None, str]":
    """``(clusters, kind)``: kind ``"stat"`` (an unchanged path),
    ``"content"`` (the bytes of a resident entry under a new stat
    identity, now re-keyed) or ``"miss"`` (clusters None)."""
    if _max_entries() <= 0:
        return None, "miss"
    key = _key(path)
    if key is None:
        return None, "miss"
    with _lock:
        entry = _cache.get(key)
        if entry is not None:
            _counts["hits"] += 1
            _cache.move_to_end(key)
            return entry, "stat"
        populated = bool(_by_content)
    if not populated:
        # a miss counts at put(): a parse that then fails populates
        # nothing, and the miss total counts parses that populated
        return None, "miss"
    digest = file_digest(path)  # one read, far cheaper than the parse
    if digest is None:
        return None, "miss"
    with _lock:
        old_key = _by_content.get(digest)
        entry = _cache.get(old_key) if old_key is not None else None
        if entry is None:
            return None, "miss"
        del _cache[old_key]
        _content_of.pop(old_key, None)
        _cache[key] = entry
        _by_content[digest] = key
        _content_of[key] = digest
        _counts["hits"] += 1
        _counts["content_hits"] += 1
        return entry, "content"


def put(path: str, clusters: list) -> None:
    """Keep one eagerly parsed input (nothing when off or the file cannot
    be stat'd: it may have been replaced during the parse)."""
    limit = _max_entries()
    if limit <= 0:
        return
    key = _key(path)
    if key is None:
        return
    digest = file_digest(path)  # outside the lock: one sequential read
    with _lock:
        _counts["misses"] += 1
        _cache[key] = clusters
        _cache.move_to_end(key)
        if digest is not None:
            _by_content[digest] = key
            _content_of[key] = digest
        while len(_cache) > limit:
            old, _ = _cache.popitem(last=False)
            d = _content_of.pop(old, None)
            if d is not None and _by_content.get(d) == old:
                del _by_content[d]


def info() -> dict:
    """``{"hits", "misses", "content_hits", "size"}``."""
    with _lock:
        return dict(_counts, size=len(_cache))


def clear() -> None:
    with _lock:
        _cache.clear()
        _by_content.clear()
        _content_of.clear()
        _counts.update(hits=0, misses=0, content_hits=0)
