"""Baseline / suppression semantics for the port's ``lint``.

The committed baseline (``lint-baseline.torch.json`` at the project
root; the JAX package's lint keeps ``lint-baseline.json``) holds legacy
findings that must not block CI, each with a mandatory ``reason`` — an
entry without one is itself a finding.  Matching is by fingerprint
``(check, path, symbol)``; line numbers are deliberately excluded so
edits above a legacy site don't churn the file.  The file format is the
JAX package's, so each package reads the other's.

Stale entries (no longer matching any finding) are reported so the
file shrinks as debt is paid; they don't fail the run on their own —
``--update-baseline`` rewrites the file from the current findings.
"""

from __future__ import annotations

import json
import os

from specpride_tpu_torch.analysis.core import Finding

BASELINE_NAME = "lint-baseline.torch.json"
BASELINE_VERSION = 1


class Baseline:
    def __init__(self, entries: list[dict], path: str | None = None):
        self.path = path
        self.entries = entries
        self._index: dict[tuple, dict] = {}
        for e in entries:
            key = (
                str(e.get("check", "")), str(e.get("path", "")),
                str(e.get("symbol", "")),
            )
            self._index[key] = e

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([], path=path)
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
        entries = payload.get("suppressions", [])
        if not isinstance(entries, list):
            raise ValueError(f"{path}: 'suppressions' must be a list")
        return cls(entries, path=path)

    def match(self, finding: Finding) -> dict | None:
        return self._index.get(finding.fingerprint)

    def split(self, findings: list[Finding],
              select: list[str] | None = None):
        """``(new, baselined, stale_entries, bad_entries)``.

        With ``select``, staleness and missing-reason checks cover only
        the selected checkers' entries — a one-checker run produces no
        findings for the others, and reporting their still-valid
        suppressions as 'stale, remove it' would talk a maintainer
        into deleting live debt records."""
        new: list[Finding] = []
        baselined: list[Finding] = []
        hit: set = set()
        for f in findings:
            entry = self.match(f)
            if entry is None:
                new.append(f)
            else:
                baselined.append(f)
                hit.add(f.fingerprint)

        def selected(e: dict) -> bool:
            return not select or str(e.get("check", "")) in select

        stale = [
            e for key, e in sorted(self._index.items())
            if key not in hit and selected(e)
        ]
        bad = [
            e for e in self.entries
            if not str(e.get("reason", "")).strip() and selected(e)
        ]
        return new, baselined, stale, bad

    @staticmethod
    def write(
        path: str, findings: list[Finding],
        existing: "Baseline | None" = None,
        select: list[str] | None = None,
    ) -> None:
        """Rewrite the baseline from current findings.

        New entries get an empty reason the committer must fill — CI
        treats a reason-less entry as a finding, so a thoughtless
        update cannot silently grandfather new debt.  ``existing``
        reasons carry forward on matching fingerprints, and with
        ``select`` the rewrite touches ONLY the selected checkers'
        entries — a one-checker refresh must not delete five other
        checkers' justified debt."""
        entries = []
        seen: set = set()
        if existing is not None and select:
            for e in existing.entries:
                if str(e.get("check", "")) not in select:
                    entries.append(e)
        old = existing._index if existing is not None else {}
        for f in sorted(findings, key=Finding.sort_key):
            if f.fingerprint in seen:
                continue
            seen.add(f.fingerprint)
            prior = old.get(f.fingerprint, {})
            entries.append({
                "check": f.check,
                "path": f.path,
                "symbol": f.symbol,
                "reason": str(prior.get("reason", "")),
                "message": f.message,
            })
        payload = {"version": BASELINE_VERSION, "suppressions": entries}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=1)
            fh.write("\n")
