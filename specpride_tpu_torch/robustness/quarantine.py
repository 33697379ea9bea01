"""Malformed-record quarantine (the port's copy of the JAX package's
``robustness/quarantine.py``, without the journal).

Under ``--on-error skip`` the MGF parsers hand a truncated or
unparseable ``BEGIN IONS`` block to a :class:`Quarantine`, which appends
its raw text to ``<output>.quarantine.mgf`` and counts it, so the run goes
on and the dropped records can be recovered.  The file is created at the
first block (no damage, no file) and removed at construction (a resume
re-parses the whole input and would only add duplicates; a stale file
from another run would lie).  Each block logs a warning: the port has no
journal yet.  Thread-safe: pack workers parse streamed windows at once.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading

logger = logging.getLogger("specpride_tpu_torch")


class Quarantine:
    def __init__(self, path: str):
        self.path = str(path)
        self.count = 0
        self._lock = threading.Lock()
        self._fh = None
        with contextlib.suppress(OSError):
            os.remove(self.path)

    def add(self, raw: str, reason: str) -> None:
        """Append one malformed block: the ``malformed(raw, reason)``
        callback of ``io/mgf.py``'s parsers."""
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
            text = raw if raw.endswith("\n") else raw + "\n"
            self._fh.write(text)
            if not text.endswith("\n\n"):
                self._fh.write("\n")
            self._fh.flush()
            self.count += 1
        logger.warning("quarantined malformed MGF block (%s) -> %s", reason,
                       self.path)

    def rename(self, path: str) -> None:
        """Move the quarantine to ``path`` (a rank of a multi-host run
        keeps its own ``.part<id>`` file), before or after its first
        block."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if os.path.exists(self.path):
                os.replace(self.path, str(path))
            self.path = str(path)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
