"""Bounded retry with exponential backoff and deterministic jitter (the
port's copy of the JAX package's ``robustness/retry.py``).

One :class:`RetryPolicy` per run wraps the failure-prone lane steps: the
pack stage, the chunk dispatch, the QC cosine pass, and the write lane's
MGF append and manifest replace.  Only errors ``errors.is_transient``
calls transient are retried; malformed input and sticky CUDA errors go
straight to ``--on-error``.  The jitter is ``sha256(seed, site,
attempt)``, so a seeded run backs off the same way every time (and as the
JAX package's policy does for the same seed).  Thread-safe: the lanes
share one policy.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time

logger = logging.getLogger("specpride_tpu_torch")


class RetryPolicy:
    """``--retries N --retry-backoff BASE``: up to N retries per call,
    sleeping ``BASE * 2**attempt * (1 + jitter)`` before each, ``jitter``
    drawn deterministically in [0, 0.25)."""

    def __init__(self, retries: int = 0, backoff: float = 0.05,
                 seed: int = 0, journal=None):
        self.retries = max(int(retries), 0)
        self.journal = journal
        self.backoff = max(float(backoff), 0.0)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self.retry_count = 0
        self.retry_wait_s = 0.0
        self.retries_by_site: dict[str, int] = {}

    def _jitter(self, site: str, attempt: int) -> float:
        digest = hashlib.sha256(f"{self.seed}:{site}:{attempt}".encode()
                                ).digest()
        return 0.25 * int.from_bytes(digest[:8], "big") / float(1 << 64)

    def backoff_s(self, site: str, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (0-based)."""
        return self.backoff * (2 ** attempt) * (
            1.0 + self._jitter(site, attempt))

    def note_retry(self, site: str, attempt: int, error: BaseException,
                   wait_s: float) -> None:
        with self._lock:
            self.retry_count += 1
            self.retry_wait_s += wait_s
            self.retries_by_site[site] = self.retries_by_site.get(site, 0) + 1
        if self.journal is not None:
            self.journal.emit("retry", site=site, attempt=attempt,
                              backoff_s=round(wait_s, 4),
                              error=f"{type(error).__name__}: {error}")
        logger.warning("%s failed (%s); retry %d/%d in %.3fs", site, error,
                       attempt + 1, self.retries, wait_s)

    def call(self, site: str, fn, *, before_retry=None):
        """``fn()``, re-run after a transient error up to ``retries``
        times; ``before_retry`` runs before each re-run (the write lane
        truncates a partial append there, so a retry never duplicates
        bytes).  The last error, or any permanent one, propagates."""
        # here, not at the top: the serving client's backoff needs no torch
        from specpride_tpu_torch.robustness import errors

        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - classified below
                if attempt >= self.retries or not errors.is_transient(e):
                    raise
                wait = self.backoff_s(site, attempt)
                self.note_retry(site, attempt, e, wait)
                if before_retry is not None:
                    before_retry()
                if wait > 0:
                    time.sleep(wait)
                attempt += 1

    def summary(self) -> dict:
        with self._lock:
            return {
                "retries": self.retry_count,
                "retry_wait_s": round(self.retry_wait_s, 4),
                "retries_by_site": dict(sorted(self.retries_by_site.items())),
            }
