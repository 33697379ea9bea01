"""Checkpoint integrity: schema-versioned manifests with a sha256 over the
committed MGF bytes (the port's copy of the JAX package's
``robustness/integrity.py``; the manifests are the same JSON).

The commit protocol (``cli._commit_chunk``) appends chunk *i*'s bytes,
then atomically replaces the manifest recording ``{schema, done,
output_bytes, sha256}``.  The hash covers exactly the first
``output_bytes`` bytes of the output, the committed prefix, and is kept
incrementally by :class:`OutputIntegrity`: each commit hashes only the
bytes it appended.  A resume verifies it in one pass over the file, which
also seeds the running hash, so a bit flip inside the committed region,
which every byte count passes, still restarts the run.
"""

from __future__ import annotations

import hashlib

# 1 = the legacy {done, output_bytes, failed} shape (no version field);
# 2 adds "schema" and "sha256".  A legacy manifest resumes with the byte
# count checks only.
MANIFEST_SCHEMA = 2

_CHUNK = 1 << 20


class OutputIntegrity:
    """Running sha256 over the committed prefix of one output file."""

    def __init__(self) -> None:
        self._hasher = hashlib.sha256()
        self.offset = 0

    def reset(self) -> None:
        self._hasher = hashlib.sha256()
        self.offset = 0

    def hexdigest(self) -> str:
        return self._hasher.hexdigest()

    def absorb(self, path: str, new_size: int) -> None:
        """Advance the committed prefix to ``new_size``, hashing the bytes
        appended since the last commit."""
        if new_size <= self.offset:
            return
        with open(path, "rb") as fh:
            fh.seek(self.offset)
            remaining = new_size - self.offset
            while remaining > 0:
                block = fh.read(min(_CHUNK, remaining))
                if not block:
                    break
                self._hasher.update(block)
                remaining -= len(block)
        self.offset = new_size

    def seed_file(self, path: str, upto: int) -> str:
        """Restart the running hash from the first ``upto`` bytes of
        ``path``; returns their digest, for the caller to verify against a
        manifest in the same read."""
        self.reset()
        self.absorb(path, upto)
        return self.hexdigest()


def manifest_payload(done, output_bytes: int, integrity: OutputIntegrity,
                     failed=None) -> dict:
    """The schema-2 manifest body every checkpoint write emits."""
    return {
        "schema": MANIFEST_SCHEMA,
        "done": sorted(done),
        "output_bytes": output_bytes,
        "sha256": integrity.hexdigest(),
        **({"failed": failed} if failed else {}),
    }
