"""Flight recorder: always-on black-box capture and the incident plane
(the port's copy of the JAX package's ``observability/flightrec.py``).

An always-on, lock-cheap bounded ring of recent journal records per
process, plus the :mod:`~specpride_tpu_torch.observability.detect`
health detectors folding the same stream; when a detector fires, an
ATOMIC incident bundle is dumped under ``--incident-dir`` with what a
post-mortem needs and nothing unbounded: the ring, live thread stacks,
a ``/metrics`` exposition snapshot, the host's config digest, host
state (``extra_fn``) and the trailing journal window.  The bundle
layout is the JAX package's (``BUNDLE_SCHEMA``), so either package's
``incidents`` reads the other's bundles.  A host with an autotune
controller passes ``autotune_fn`` and its bundles carry
``autotune.json``; without one the bundle has none.

Wiring contract:

* ``off`` never constructs a recorder at all: the kill switch is the
  absence of this object, so an off run is byte-identical to a
  recorder-free build.
* ``observe`` journals every detector firing as an ``incident`` event
  (id, evidence, dedup accounting) without writing bundles.
* ``on`` also dumps the bundle, atomically: everything is written into
  a ``.tmp-<pid>`` staging directory and renamed into place, so a kill
  mid-dump leaves only debris the read side ignores, never a torn
  bundle.

The recorder attaches via ``Journal.attach_tap`` — catch-up first, so
ring + detector state equal ``fold(file)`` from line one — and does NO
journal emit from inside the tap (the tap runs under the journal's
write lock; emitting there would deadlock).  Firings queue to a
dedicated recorder thread that dumps bundles and journals the
``incident`` events; detectors ignore ``incident`` events, so the
recorder never feeds back on itself.

``incident-replay`` (:func:`replay_incidents`) refolds a finished
journal through the same :class:`~.detect.DetectorSet` and requires
every recorded firing (id, reason, clock, evidence, trace id, dedup
suppression count) to re-derive bit-exact from the stream alone.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import queue
import sys
import threading
import time
import traceback

from specpride_tpu_torch.autotune.replay import _same, _streams
from specpride_tpu_torch.observability.detect import DetectorSet
from specpride_tpu_torch.observability.journal import read_events

logger = logging.getLogger("specpride_tpu_torch")

# manifest schema for on-disk bundles (bumped on layout changes; the
# read side refuses manifests from the future)
BUNDLE_SCHEMA = 1

_TMP_MARKER = ".tmp-"


class RingBuffer:
    """Bounded ring of journal records.

    Appends happen under the journal write lock (the tap), snapshots
    from any thread: ``collections.deque`` with ``maxlen`` gives
    C-level, GIL-atomic append-with-overwrite, and :meth:`snapshot`
    retries the rare copy that catches a concurrent mutation — readers
    never block writers and never see a torn record."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1 ({capacity})")
        self.capacity = int(capacity)
        self._dq: collections.deque = collections.deque(maxlen=capacity)
        self.appended = 0

    def append(self, rec: dict) -> None:
        self._dq.append(rec)
        self.appended += 1

    def snapshot(self) -> list:
        """A point-in-time copy, oldest first."""
        while True:
            try:
                return list(self._dq)
            except RuntimeError:
                # the deque mutated mid-iteration (an append raced the
                # copy) — retry; the window is a few C instructions
                continue

    def __len__(self) -> int:
        return len(self._dq)


def _format_stacks() -> str:
    """Every live thread's Python stack via ``sys._current_frames`` —
    the 'what was everyone doing' page of the black box."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts: list[str] = []
    for tid, frame in sorted(sys._current_frames().items()):
        parts.append(f"--- thread {tid} ({names.get(tid, '?')}) ---\n")
        parts.append("".join(traceback.format_stack(frame)))
    return "".join(parts)


def _journal_tail(path: str | None, max_lines: int) -> list[str]:
    """The last ``max_lines`` complete lines of the live journal file
    (bounded read from the end — a days-long journal must not make a
    dump unbounded)."""
    if not path or max_lines <= 0:
        return []
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - 256 * 1024))
            chunk = fh.read().decode("utf-8", errors="replace")
    except OSError:
        return []
    lines = chunk.splitlines()
    if size > 256 * 1024 and lines:
        lines = lines[1:]  # drop the torn head of the window
    return lines[-max_lines:]


def config_digest(config: dict) -> str:
    """Stable digest of a host's boot-time config/flag view — lets an
    operator diff 'what exactly was this daemon running' across
    incidents without comparing whole dicts."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def check_mode(mode: str, incident_dir: str | None) -> None:
    """Raise ``ValueError`` (the JAX recorder's messages) unless ``mode``
    is ``observe``, or ``on`` with an ``incident_dir``; a host checks
    before it starts anything."""
    if mode not in ("observe", "on"):
        raise ValueError(
            f"flightrec mode {mode!r} must be observe or on"
        )
    if mode == "on" and not incident_dir:
        raise ValueError(
            "flightrec mode 'on' dumps bundles and therefore "
            "requires an --incident-dir"
        )


class FlightRecorder:
    """One process's black box: ring + detectors + bundle dumper.

    ``mode``: ``observe`` (journal firings, no bundles) or ``on``
    (also dump bundles under ``incident_dir``).  ``off`` never
    constructs a recorder.

    Capture hooks (all optional, all best-effort — a failing hook
    degrades that bundle section, never the host):

    * ``metrics_fn()`` -> Prometheus exposition text
      (``metrics.prom``)
    * ``autotune_fn()`` -> an autotune controller's knob/decision state
      (``autotune.json``; None without a controller)
    * ``config`` — the host's boot config dict (``config.json``, with
      its sha256 digest)
    * ``extra_fn()`` -> any further host state, e.g. the elastic
      coordinator's lease counters (``host.json``)
    """

    def __init__(
        self,
        journal,
        *,
        mode: str = "observe",
        incident_dir: str | None = None,
        ring: int = 512,
        journal_tail: int = 200,
        params: dict | None = None,
        metrics_fn=None,
        autotune_fn=None,
        config: dict | None = None,
        extra_fn=None,
        telemetry=None,
    ):
        check_mode(mode, incident_dir)
        self.journal = journal
        self.mode = mode
        self.incident_dir = incident_dir
        self.ring = RingBuffer(ring)
        self.detect = DetectorSet(params)
        self.journal_tail = int(journal_tail)
        self.metrics_fn = metrics_fn
        self.autotune_fn = autotune_fn
        self.config = dict(config or {})
        self.extra_fn = extra_fn
        self.telemetry = telemetry  # ServeTelemetry (or None)
        self.bundles = 0
        self.bundle_errors = 0
        self.dump_s = 0.0  # seconds spent writing bundles
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None
        self._stopped = False

    # -- the journal tap ------------------------------------------------

    def observe(self, rec) -> None:
        """Fold one record (runs UNDER the journal write lock — no
        emit, no I/O here beyond the ring append; firings queue to the
        recorder thread)."""
        if isinstance(rec, dict):
            self.ring.append(rec)
        for firing in self.detect.observe(rec):
            self._q.put(firing)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "FlightRecorder":
        """Attach to the journal WITH catch-up (ring + detector state
        equal ``fold(file)`` from line one — the replay invariant) and
        start the recorder thread."""
        if self.incident_dir:
            os.makedirs(self.incident_dir, exist_ok=True)
        self.journal.attach_tap(self.observe)
        self._thread = threading.Thread(
            target=self._run, name="flightrec", daemon=True,
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            firing = self._q.get()
            if firing is None:
                return
            try:
                self._process(firing)
            except Exception:  # noqa: BLE001 - the recorder must never
                logger.exception(  # take the host down
                    "flightrec: processing incident failed"
                )

    def stop(self) -> None:
        """Detach the tap, drain every queued firing (each is still
        journaled — a drain must not swallow evidence), stop the
        thread.  Called BEFORE the host closes its journal."""
        if self._stopped:
            return
        self._stopped = True
        self.journal.detach_tap(self.observe)
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    # -- incident processing (recorder thread) --------------------------

    def _process(self, firing: dict) -> None:
        if self.telemetry is not None:
            # counted before the bundle, so its metrics.prom holds the
            # incident it describes (the JAX recorder counts after the
            # journal line; the totals agree once the line is written)
            try:
                self.telemetry.incident(
                    detector=firing["detector"],
                    suppressed=int(firing["suppressed"]),
                )
            except Exception:  # noqa: BLE001 - metrics best effort
                pass
        bundled = False
        bundle_fields: dict = {}
        if self.mode == "on":
            t0 = time.perf_counter()
            try:
                bundle_dir = self._write_bundle(firing)
            except Exception as e:  # noqa: BLE001 - degrade to observe
                self.bundle_errors += 1
                bundle_fields["bundle_error"] = (
                    f"{type(e).__name__}: {e}"
                )
                logger.warning(
                    "flightrec: bundle dump for %s failed: %s",
                    firing["incident_id"], e,
                )
            else:
                bundled = True
                self.bundles += 1
                bundle_fields["bundle_dir"] = bundle_dir
            finally:
                self.dump_s += time.perf_counter() - t0
        self.journal.emit(
            "incident",
            detector=firing["detector"],
            incident_id=firing["incident_id"],
            reason=firing["reason"],
            clock=firing["clock"],
            evidence=firing["evidence"],
            suppressed=firing["suppressed"],
            trace_id=firing["trace_id"],
            mode=self.mode,
            bundled=bundled,
            **bundle_fields,
        )
        logger.warning(
            "incident %s: %s (%s%s)", firing["incident_id"],
            firing["reason"], self.mode,
            f", bundle {bundle_fields.get('bundle_dir')}"
            if bundled else "",
        )

    def _write_bundle(self, firing: dict) -> str:
        """Dump one atomic bundle; returns its final directory.  Stage
        into ``<final>.tmp-<pid>`` and rename: a SIGKILL mid-dump
        leaves only a ``.tmp-`` directory the read side skips."""
        name = f"{firing['incident_id']}-{firing['detector']}"
        final = os.path.join(self.incident_dir, name)
        if os.path.isdir(final):
            return final  # already dumped (a resumed catch-up refold)
        tmp = f"{final}{_TMP_MARKER}{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        files: list[str] = []

        def _put(fname: str, text: str) -> None:
            with open(os.path.join(tmp, fname), "w",
                      encoding="utf-8") as fh:
                fh.write(text)
            files.append(fname)

        ring = self.ring.snapshot()
        _put("ring.jsonl", "".join(
            json.dumps(r, default=str) + "\n" for r in ring
        ))
        _put("stacks.txt", _format_stacks())
        tail = _journal_tail(
            getattr(self.journal, "path", None), self.journal_tail
        )
        if tail:
            _put("journal_tail.jsonl", "\n".join(tail) + "\n")
        if self.metrics_fn is not None:
            try:
                _put("metrics.prom", self.metrics_fn())
            except Exception as e:  # noqa: BLE001 - section degrades
                _put("metrics.error.txt", f"{type(e).__name__}: {e}\n")
        if self.autotune_fn is not None:
            try:
                _put("autotune.json", json.dumps(
                    self.autotune_fn(), indent=2, sort_keys=True,
                    default=str,
                ) + "\n")
            except Exception as e:  # noqa: BLE001 - section degrades
                _put("autotune.error.txt", f"{type(e).__name__}: {e}\n")
        if self.extra_fn is not None:
            try:
                _put("host.json", json.dumps(
                    self.extra_fn(), indent=2, sort_keys=True,
                    default=str,
                ) + "\n")
            except Exception as e:  # noqa: BLE001 - section degrades
                _put("host.error.txt", f"{type(e).__name__}: {e}\n")
        _put("config.json", json.dumps(
            {"config": self.config,
             "digest": config_digest(self.config)},
            indent=2, sort_keys=True, default=str,
        ) + "\n")
        # the manifest is written LAST inside the staging dir, then the
        # whole dir renames into place — a bundle either exists with
        # its complete manifest or not at all
        manifest = {
            "schema": BUNDLE_SCHEMA,
            "incident": {**firing, "mode": self.mode},
            "ring_records": len(ring),
            "files": sorted(files),
            "journal": getattr(self.journal, "path", None),
            "pid": os.getpid(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=2, sort_keys=True,
                      default=str)
            fh.write("\n")
        os.rename(tmp, final)
        return final

    # -- live status ----------------------------------------------------

    def status(self) -> dict:
        return {
            "mode": self.mode,
            **self.detect.status(),
            "bundles": self.bundles,
            "bundle_errors": self.bundle_errors,
            "dump_s": round(self.dump_s, 6),
            "ring": len(self.ring),
            "ring_capacity": self.ring.capacity,
            **({"incident_dir": self.incident_dir}
               if self.incident_dir else {}),
        }


# -- read side: bundles on disk ------------------------------------------


def list_bundles(incident_dir: str) -> tuple[list[dict], list[str]]:
    """Scan an incident directory for complete bundles.  Returns
    ``(bundles, warnings)``: each bundle is its manifest plus a
    ``"dir"`` key; ``.tmp-`` staging debris (a kill mid-dump) is
    skipped silently — that is exactly the atomicity contract —
    while a directory MISSING its manifest is a warning."""
    bundles: list[dict] = []
    warnings: list[str] = []
    try:
        entries = sorted(os.listdir(incident_dir))
    except OSError as e:
        return [], [f"cannot read {incident_dir}: {e}"]
    for entry in entries:
        path = os.path.join(incident_dir, entry)
        if not os.path.isdir(path) or _TMP_MARKER in entry:
            continue
        mpath = os.path.join(path, "manifest.json")
        try:
            with open(mpath, encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as e:
            warnings.append(f"{path}: unreadable manifest ({e})")
            continue
        if manifest.get("schema", 0) > BUNDLE_SCHEMA:
            warnings.append(
                f"{path}: bundle schema {manifest.get('schema')} is "
                f"newer than this build ({BUNDLE_SCHEMA})"
            )
            continue
        manifest["dir"] = path
        bundles.append(manifest)
    bundles.sort(
        key=lambda m: float(m.get("incident", {}).get("clock") or 0.0)
    )
    return bundles, warnings


def find_bundle(incident_dir: str, incident_id: str) -> dict | None:
    """The one bundle whose incident id matches (prefix match accepted,
    like git — ids are content-derived hex)."""
    bundles, _ = list_bundles(incident_dir)
    hits = [
        b for b in bundles
        if str(b.get("incident", {}).get("incident_id", ""))
        .startswith(incident_id)
    ]
    return hits[0] if len(hits) == 1 else None


# -- offline replay audit ------------------------------------------------

def replay_incidents(path: str) -> dict:
    """Re-derive every ``incident`` event under ``path`` from the
    journal stream alone and diff against what the recorder journaled.

    Per-process streams replay independently (rotated segments chain,
    ``.part<rank>`` shards split).  Within one stream the recorder journals
    firings in trigger order, so the k-th recorded incident must match
    the k-th refolded firing on every stream-derivable field: detector,
    incident id, reason, trigger clock, evidence payload, trace id and
    the dedup ``suppressed`` count.  ``bundled`` must be consistent
    with the recorded ``mode``.  Firings the refold derives that never
    reached the file (a process killed before its recorder drained)
    are warnings, not failures — the stream holds MORE evidence than
    the dead recorder could write, never less."""
    streams, warnings = _streams(path)
    result: dict = {
        "incidents": 0, "reproduced": 0, "bundled": 0,
        "suppressed": 0, "by_detector": {},
        "mismatches": [], "unjournaled": [],
        "violations": [], "warnings": list(warnings),
        "streams": len(streams),
    }
    compare = ("detector", "incident_id", "reason", "clock",
               "evidence", "trace_id", "suppressed")
    for key in sorted(streams):
        detect = DetectorSet()
        derived: collections.deque = collections.deque()
        for p in streams[key]:
            events, violations = read_events(p)
            result["violations"].extend(violations)
            for rec in events:
                # fold first: DetectorSet ignores incident events, so
                # feeding every record keeps one code path with live
                for firing in detect.observe(rec):
                    derived.append(firing)
                if rec.get("event") != "incident":
                    continue
                result["incidents"] += 1
                det = rec.get("detector")
                result["by_detector"][det] = (
                    result["by_detector"].get(det, 0) + 1
                )
                if rec.get("bundled"):
                    result["bundled"] += 1
                result["suppressed"] += int(rec.get("suppressed") or 0)
                where = (
                    f"{p}: {det} @ {rec.get('clock')} "
                    f"({rec.get('incident_id')})"
                )
                if not derived:
                    result["mismatches"].append(
                        f"{where}: recorded incident has NO refolded "
                        "firing (detector changed since the journal "
                        "was written?)"
                    )
                    continue
                firing = derived.popleft()
                got = {k: firing.get(k) for k in compare}
                want = {
                    k: (int(rec.get(k) or 0) if k == "suppressed"
                        else rec.get(k))
                    for k in compare
                }
                ok = True
                if not _same(got, want):
                    for k in compare:
                        if not _same(got[k], want[k]):
                            result["mismatches"].append(
                                f"{where}: {k} refolded {got[k]!r} "
                                f"!= recorded {want[k]!r}"
                            )
                    ok = False
                mode = rec.get("mode")
                if mode not in ("observe", "on"):
                    result["mismatches"].append(
                        f"{where}: unknown mode {mode!r}"
                    )
                    ok = False
                elif mode == "observe" and rec.get("bundled"):
                    result["mismatches"].append(
                        f"{where}: bundled=true in observe mode"
                    )
                    ok = False
                elif (mode == "on" and not rec.get("bundled")
                        and "bundle_error" not in rec):
                    result["mismatches"].append(
                        f"{where}: mode on but bundled=false with no "
                        "bundle_error"
                    )
                    ok = False
                if ok:
                    result["reproduced"] += 1
        for firing in derived:
            result["unjournaled"].append(
                f"{key}: {firing['detector']} @ {firing['clock']} "
                f"({firing['incident_id']}) refolds but was never "
                "journaled (recorder died before draining?)"
            )
    result["ok"] = (
        not result["mismatches"] and not result["violations"]
    )
    return result


def render_incident_replay(result: dict, out) -> None:
    """Human summary for ``incident-replay``."""
    out.write(
        f"incident-replay: {result['incidents']} incident(s) across "
        f"{result['streams']} stream(s), {result['bundled']} bundled, "
        f"{result['suppressed']} suppressed by dedup\n"
    )
    out.write(
        f"  reproduced: {result['reproduced']}/{result['incidents']}\n"
    )
    for det in sorted(result["by_detector"]):
        out.write(f"  {det}: {result['by_detector'][det]}\n")
    for kind in ("mismatches", "unjournaled", "violations", "warnings"):
        label = kind.rstrip("es") if kind.endswith("es") else kind
        for line in result[kind]:
            out.write(f"  {label}: {line}\n")
    out.write("ok\n" if result["ok"] else "FAILED\n")
