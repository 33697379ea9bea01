"""Offline decision replay: re-run the policies over a recorded
journal and diff against what the controller actually decided (the JAX
package's ``autotune/replay.py``; it reads either package's journals).

Two independent checks per recorded ``autotune`` event:

* **decision** — rebuild the policy from the event's recorded
  ``params``, re-run the shared :func:`~.controller.evaluate` gating on
  the recorded ``signal`` snapshot, and require the same ``new`` value,
  the same ``reason`` string, and ``acted`` consistent with the
  recorded ``mode``.  This is the pure-function check: policies must be
  a function of (signal, current, params) and nothing else.

* **signal refold** — feed every preceding journal line through a fresh
  :class:`~.signals.SignalState` (the same fold the live tap ran, in
  the same order — the tap fires under the journal write lock, so file
  order IS fold order) and require the snapshot at the event's recorded
  ``clock`` to equal the recorded ``signal``.  Skipped for snapshots
  carrying a ``store`` section (the fleet supervisor's store-derived
  view is evidence, not journal-derivable).

Multi-file journals replay per process stream: rotated segments of one
journal chain into one fold, ``.part<rank>`` shards are independent
streams (each rank ran its own controller over its own journal).
"""

from __future__ import annotations

import json
import re

from specpride_tpu_torch.autotune.controller import evaluate
from specpride_tpu_torch.autotune.policy import policy_from_params
from specpride_tpu_torch.autotune.signals import SignalState
from specpride_tpu_torch.observability.journal import (
    expand_parts,
    read_events,
)

_PART_RE = re.compile(r"^(.*\.part\d+)(?:\.\d+)?$")


def _streams(path: str) -> tuple[dict[str, list[str]], list[str]]:
    """Group a journal path's files into per-process streams: rotated
    segments chain under their live file's key, rank shards split."""
    paths, warnings = expand_parts(path)
    streams: dict[str, list[str]] = {}
    for p in paths:
        m = _PART_RE.match(p)
        if m:
            key = m.group(1)
        elif re.fullmatch(r".*\.\d+", p) and p.rsplit(".", 1)[0]:
            key = p.rsplit(".", 1)[0]
        else:
            key = p
        streams.setdefault(key, []).append(p)
    return streams, warnings


def _same(a, b) -> bool:
    """Structural equality through one JSON round-trip, so a live
    payload that held numpy scalars compares equal to its file form."""
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(
        b, sort_keys=True, default=str
    )


def replay_journal(path: str) -> dict:
    """Replay every ``autotune`` decision under ``path``.  Returns::

        {"decisions": N, "reproduced": N_ok, "acted": ...,
         "mismatches": [...], "refold_mismatches": [...],
         "violations": [...], "warnings": [...], "streams": M}

    ``mismatches`` non-empty means the recorded controller and this
    code disagree — a policy changed since the journal was written, or
    a decision was not the pure function it claims to be."""
    streams, warnings = _streams(path)
    result: dict = {
        "decisions": 0, "reproduced": 0, "acted": 0,
        "mismatches": [], "refold_mismatches": [],
        "violations": [], "warnings": list(warnings),
        "streams": len(streams),
    }
    for key in sorted(streams):
        state: SignalState | None = None
        last: dict = {}
        pending: list[dict] = []  # events seen before window is known
        for p in streams[key]:
            events, violations = read_events(p)
            result["violations"].extend(violations)
            for rec in events:
                if rec.get("event") != "autotune":
                    if state is None:
                        pending.append(rec)
                    else:
                        state.observe(rec)
                    continue
                signal = rec.get("signal") or {}
                if state is None:
                    state = SignalState(
                        float(signal.get("window_s") or 30.0)
                    )
                    for early in pending:
                        state.observe(early)
                    pending = []
                result["decisions"] += 1
                if rec.get("acted"):
                    result["acted"] += 1
                where = f"{p}: {rec.get('knob')} @ {rec.get('clock')}"
                ok = _check_decision(rec, last, result, where)
                if ok:
                    result["reproduced"] += 1
                if "store" not in signal:
                    refold = state.snapshot(
                        float(rec.get("clock") or 0.0)
                    )
                    if not _same(refold, signal):
                        result["refold_mismatches"].append(
                            f"{where}: refolded signal differs from "
                            f"recorded (refold {refold!r})"
                        )
                last[rec.get("knob")] = rec.get("clock")
                state.observe(rec)
    result["ok"] = (
        not result["mismatches"] and not result["refold_mismatches"]
        and not result["violations"]
    )
    return result


def _check_decision(rec: dict, last: dict, result: dict,
                    where: str) -> bool:
    knob = rec.get("knob")
    try:
        policy = policy_from_params(knob, rec.get("params"))
    except ValueError as e:
        result["mismatches"].append(f"{where}: {e}")
        return False
    got = evaluate(
        policy, rec.get("signal") or {}, rec.get("old"), last.get(knob)
    )
    if got is None:
        result["mismatches"].append(
            f"{where}: replay produced NO decision where the journal "
            f"records new={rec.get('new')!r}"
        )
        return False
    new, reason = got
    ok = True
    if new != rec.get("new"):
        result["mismatches"].append(
            f"{where}: replay new={new!r} != recorded "
            f"{rec.get('new')!r}"
        )
        ok = False
    if reason != rec.get("reason"):
        result["mismatches"].append(
            f"{where}: replay reason {reason!r} != recorded "
            f"{rec.get('reason')!r}"
        )
        ok = False
    expect_acted = rec.get("mode") == "on"
    if bool(rec.get("acted")) != expect_acted:
        result["mismatches"].append(
            f"{where}: acted={rec.get('acted')!r} inconsistent with "
            f"mode={rec.get('mode')!r}"
        )
        ok = False
    return ok


def render_replay(result: dict, out) -> None:
    """Human summary for ``specpride autotune-replay``."""
    out.write(
        f"autotune-replay: {result['decisions']} decision(s) across "
        f"{result['streams']} stream(s), {result['acted']} acted\n"
    )
    out.write(
        f"  reproduced: {result['reproduced']}/{result['decisions']}\n"
    )
    for kind in ("mismatches", "refold_mismatches", "violations",
                 "warnings"):
        for line in result[kind]:
            out.write(f"  {kind[:-2] if kind.endswith('es') else kind}:"
                      f" {line}\n")
    out.write("ok\n" if result["ok"] else "FAILED\n")
