"""Canonical content digests for the result cache: the port's copy of
the JAX package's ``cache/digest.py``, which gives the same hex on the
same clusters.

The cache key's first component is a digest of WHAT a cluster *is*, not
how it was spelled on disk: two MGF files that differ only in peak
order, float formatting (``1.5`` vs ``1.50`` vs ``1.5e0``) or file path
must produce the same digest, because the consensus result depends on
neither.  Two rules make that hold:

* peaks are sorted by ``(mz, intensity)`` before hashing — MGF peak
  lists carry no semantic order and several writers emit them unsorted;
* floats are hashed as their IEEE-754 float64 *bytes*, never their text
  representation — the parser already normalized every spelling of the
  same value to one bit pattern.

Member ORDER stays part of the digest on purpose: float reduction order
is visible in the output bits (bin-mean accumulates members in file
order), so clusters whose members were reordered are different inputs
for byte-parity purposes.  The cluster id and member titles are hashed
too — both land verbatim in the output records (a medoid representative
IS a member spectrum), so they are output-relevant content.
"""

from __future__ import annotations

import hashlib

import numpy as np

# bump when the canonicalization itself changes (sort rule, field set):
# old entries then miss by key instead of being served stale
DIGEST_VERSION = "cd1"


def _hash_floats(h, *values: float) -> None:
    h.update(np.asarray(values, dtype=np.float64).tobytes())


def spectrum_digest_into(h, s) -> None:
    """Fold one spectrum into an open hash: title, precursor fields,
    then the peak list in canonical ``(mz, intensity)`` order."""
    h.update(s.title.encode("utf-8"))
    h.update(b"\x00")
    _hash_floats(h, float(s.precursor_mz), float(s.rt))
    h.update(int(s.precursor_charge).to_bytes(4, "little", signed=True))
    mz = np.asarray(s.mz, dtype=np.float64)
    inten = np.asarray(s.intensity, dtype=np.float64)
    order = np.lexsort((inten, mz))
    h.update(mz[order].tobytes())
    h.update(inten[order].tobytes())


def cluster_digest(cluster) -> str:
    """Spelling- and peak-order-invariant digest of one cluster's
    content (hex sha256)."""
    h = hashlib.sha256()
    h.update(DIGEST_VERSION.encode("ascii"))
    h.update(cluster.cluster_id.encode("utf-8"))
    h.update(len(cluster.members).to_bytes(4, "little"))
    for s in cluster.members:
        h.update(b"\x01")  # member framing: no cross-member ambiguity
        spectrum_digest_into(h, s)
    return h.hexdigest()


def result_key(
    content: str, method: str, config: str, precision: str, schema: str
) -> str:
    """The full cache key: cluster content x method x config digest x
    packed-channel precision x entry-schema revision.  Any axis changing
    invalidates by construction — there is no explicit invalidation."""
    raw = "\x00".join((content, method, config, precision, schema))
    return hashlib.sha256(raw.encode("utf-8")).hexdigest()


def file_digest(path: str, chunk: int = 1 << 20) -> str | None:
    """Content digest of a file's bytes (hex sha256), ``None`` if it
    cannot be read — the ingest cache's copied-dataset fallback key."""
    h = hashlib.sha256()
    try:
        with open(path, "rb") as fh:
            while True:
                block = fh.read(chunk)
                if not block:
                    break
                h.update(block)
    except OSError:
        return None
    return h.hexdigest()
