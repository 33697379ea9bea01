"""Signal layer: fold the journal event stream into windowed estimates
(the JAX package's ``autotune/signals.py``, unchanged in behaviour).

A :class:`SignalState` is attached to the journal as an in-process tap
(``Journal.attach_tap``), so it observes every record under the journal's
write lock — its fold order is exactly the file's line order.  That
makes the fold REPLAYABLE: ``specpride autotune-replay`` feeds the same
journal lines through the same fold and must land on the same
snapshots, which is the property every downstream determinism claim
rests on.  Everything here is therefore a pure function of the event
stream plus the snapshot clock: no wall-clock reads, no randomness, no
dependence on anything outside the records.

Folded sources (all already emitted by the system):

========================  ============================================
event                     estimate
========================  ============================================
``job_queued``/``job_start``  live queue depth (queued-not-started)
``job_done``              job rate, wall/queue-wait means, busy
                          seconds, SLO burn (when the daemon has --slo)
``batch_dispatch``        dispatch rate, jobs/dispatch, occupancy,
                          window wait — the coalescing yield
``heartbeat``             per-rank EWMA chunk walls (v5 ``chunk_s``)
``lease_split``           steal pressure
``span``                  per-name duration attribution (critical-path
                          hops within the window)
========================  ============================================

Every section of a snapshot carries ``age_s`` — the staleness of its
newest datum — so a policy can refuse to move a knob on stale evidence.
"""

from __future__ import annotations

import collections


def _r(x) -> float:
    """One rounding rule for every float that lands in a snapshot: six
    decimals is beyond any signal's real precision and survives a JSON
    round-trip exactly, so live and replayed snapshots compare equal."""
    return round(float(x), 6)


class SignalState:
    """Windowed fold of one process's journal stream.

    Not internally locked: the journal calls :meth:`observe` under its
    own write lock, and the controller snapshots inside
    ``Journal.emit_atomic`` — under the same lock — so fold and
    snapshot are already serialized by the journal.  (Replay is
    single-threaded.)"""

    def __init__(self, window_s: float = 30.0):
        self.window_s = float(window_s)
        # queue depth is a counter fold, not a windowed series: admitted
        # jobs that have not started yet, whatever their age
        self.queued = 0
        self._jobs: collections.deque = collections.deque()
        self._dispatches: collections.deque = collections.deque()
        self._beats: dict = {}  # rank -> (mono, chunk_s|None)
        self._spans: collections.deque = collections.deque()
        self._splits: collections.deque = collections.deque()
        self._traces: collections.deque = collections.deque(maxlen=8)

    # -- the journal tap ------------------------------------------------

    def observe(self, rec) -> None:
        """Fold one journal record (the journal tap).
        Unknown events — including ``autotune`` itself — are ignored, so
        the fold never feeds back on the controller's own decisions."""
        if not isinstance(rec, dict):
            return
        event = rec.get("event")
        mono = rec.get("mono")
        if not isinstance(mono, (int, float)):
            return
        if event == "job_queued":
            self.queued += 1
        elif event == "job_start":
            if self.queued > 0:
                self.queued -= 1
        elif event == "job_done":
            slo_ok = rec.get("slo_ok")
            self._jobs.append((
                mono,
                float(rec.get("wall_s") or 0.0),
                float(rec.get("queue_wait_s") or 0.0),
                rec.get("status"),
                slo_ok if isinstance(slo_ok, bool) else None,
            ))
            tid = rec.get("trace_id")
            if tid:
                self._traces.append(tid)
        elif event == "batch_dispatch":
            occ = rec.get("bucket_occupancy_frac")
            self._dispatches.append((
                mono,
                int(rec.get("n_jobs") or 0),
                float(rec.get("window_wait_s") or 0.0),
                float(occ) if isinstance(occ, (int, float)) else None,
            ))
            for tid in rec.get("trace_ids") or ():
                if tid:
                    self._traces.append(tid)
        elif event == "heartbeat":
            chunk_s = rec.get("chunk_s")
            self._beats[rec.get("rank")] = (
                mono,
                float(chunk_s)
                if isinstance(chunk_s, (int, float)) else None,
            )
        elif event == "lease_split":
            self._splits.append(mono)
        elif event == "span":
            name = rec.get("name")
            dur = rec.get("dur_s")
            if isinstance(name, str) and isinstance(dur, (int, float)):
                self._spans.append((mono, name, float(dur)))

    def recent_traces(self, n: int = 4) -> list:
        """The newest ``n`` distinct trace ids the fold has seen — the
        exemplars an ``autotune`` event cites as evidence."""
        out: list = []
        for tid in reversed(self._traces):
            if tid not in out:
                out.append(tid)
            if len(out) >= n:
                break
        out.reverse()
        return out

    # -- snapshots ------------------------------------------------------

    def snapshot(self, now: float, extras: dict | None = None) -> dict:
        """The windowed estimate at monotonic time ``now`` — the
        ``signal`` payload an ``autotune`` event records verbatim.
        ``extras`` (the fleet supervisor's store-derived view) rides
        along under ``"store"``: it is recorded evidence like the rest,
        but not journal-derivable, so replay re-uses the recorded copy."""
        # round FIRST: every age_s below must derive from the exact
        # clock the record carries, or replay (which only has the
        # recorded 6-decimal "now") lands 1 µs off and the refold
        # audit flags a false mismatch
        now = _r(now)
        cut = now - self.window_s
        for dq in (self._jobs, self._dispatches, self._spans):
            while dq and dq[0][0] < cut:
                dq.popleft()
        while self._splits and self._splits[0] < cut:
            self._splits.popleft()

        snap: dict = {
            "now": _r(now),
            "window_s": _r(self.window_s),
            "queue_depth": int(self.queued),
        }

        if self._jobs:
            walls = [w for _, w, _, _, _ in self._jobs]
            waits = [q for _, _, q, _, _ in self._jobs]
            slo = [ok for _, _, _, _, ok in self._jobs if ok is not None]
            snap["jobs"] = {
                "n": len(self._jobs),
                "done": sum(
                    1 for _, _, _, s, _ in self._jobs if s == "done"
                ),
                "wall_mean_s": _r(sum(walls) / len(walls)),
                "wait_mean_s": _r(sum(waits) / len(waits)),
                "busy_s": _r(sum(walls)),
                "slo_jobs": len(slo),
                "slo_breaches": sum(1 for ok in slo if not ok),
                "age_s": _r(now - self._jobs[-1][0]),
            }
        if self._dispatches:
            njobs = [n for _, n, _, _ in self._dispatches]
            waits = [w for _, _, w, _ in self._dispatches]
            occs = [o for _, _, _, o in self._dispatches if o is not None]
            snap["batch"] = {
                "n": len(self._dispatches),
                "jobs_mean": _r(sum(njobs) / len(njobs)),
                "solo": sum(1 for n in njobs if n <= 1),
                "window_wait_mean_s": _r(sum(waits) / len(waits)),
                "age_s": _r(now - self._dispatches[-1][0]),
            }
            if occs:
                snap["batch"]["occupancy_mean"] = _r(
                    sum(occs) / len(occs)
                )
        if self._beats:
            fresh = [
                (mono, cs) for mono, cs in self._beats.values()
                if mono >= cut and cs is not None
            ]
            hb: dict = {
                "ranks": len(self._beats),
                "stale_ranks": sum(
                    1 for mono, _ in self._beats.values() if mono < cut
                ),
            }
            if fresh:
                walls = [cs for _, cs in fresh]
                hb["chunk_s_mean"] = _r(sum(walls) / len(walls))
                hb["chunk_s_max"] = _r(max(walls))
                hb["age_s"] = _r(now - max(mono for mono, _ in fresh))
            snap["heartbeats"] = hb
        if self._splits:
            snap["steal"] = {
                "splits": len(self._splits),
                "age_s": _r(now - self._splits[-1]),
            }
        if self._spans:
            totals: dict = {}
            for _, name, dur in self._spans:
                totals[name] = totals.get(name, 0.0) + dur
            top = sorted(
                totals.items(), key=lambda kv: (-kv[1], kv[0])
            )[:3]
            snap["spans"] = {
                "top": [[name, _r(total)] for name, total in top]
            }
        if extras:
            snap["store"] = dict(extras)
        return snap
