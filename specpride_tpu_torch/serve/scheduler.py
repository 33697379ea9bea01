"""Bounded admission queue with weighted-fair, quota-aware scheduling
(the port's copy of the JAX package's ``serve/scheduler.py``, standard
library only).

The queue feeds the daemon's worker lanes; on top of the capacity bound
admission applies three policies:

* **Weighted fairness** — each client carries a ``weight`` (``--quota
  client=weight[:max_inflight]``, default 1).  Scheduling is
  deficit-style (stride scheduling): every client keeps a virtual-time
  counter that advances by ``1/weight`` per served job, and ``pop``
  always serves the eligible client with the LEAST virtual time — i.e.
  the one with the largest accumulated service deficit relative to its
  weight.  Weight 3 gets three jobs per weight-1 job under contention;
  with no quotas every weight is 1 and the order degenerates to exactly
  the old FIFO-fair round-robin (one job per client per round, clients
  in first-submission order, FIFO within a client).  A client that goes
  idle re-enters at the current virtual-time frontier, so idling never
  banks credit and a burst can never starve incumbents.

* **Inflight quotas** — ``max_inflight`` caps a client's CONCURRENT
  execution lanes.  ``pop`` never selects a client at its cap (its jobs
  wait, other clients' jobs flow past), and ``offer`` refuses outright
  — :class:`QuotaExceeded`, which the daemon rejects retriable with the
  quota named — once the client already has ``max_inflight`` jobs in
  the system (queued + executing), so a capped tenant gets backpressure
  instead of unbounded queueing.

* **Output-path conflict guard** — two jobs writing the same output
  must not run concurrently (interleaved appends would tear the file;
  serialized, the second job simply rewrites the same bytes and served
  output stays byte-identical to one-shot CLI runs).  ``conflict_key``
  maps a job to its claimed path tokens; ``pop`` skips any client whose
  HEAD job touches a path some in-flight job holds (skipping only the
  head preserves per-client FIFO), and ``release`` frees the paths.

Thread contract: ``offer`` runs on connection reader threads, ``pop``
and ``release`` on the worker-pool threads, ``drain`` on whichever
thread initiates shutdown; everything synchronizes on one condition
variable.  ``release(job)`` MUST be called for every job ``pop``
returned once its lane is done with it — it frees the client's inflight
slot and the job's conflict paths and wakes blocked poppers.
"""

from __future__ import annotations

import collections
import itertools
import threading


class Quota:
    """One client's scheduling quota: relative ``weight`` (> 0) and an
    optional ``max_inflight`` concurrent-lane cap (>= 1, None = no cap)."""

    __slots__ = ("weight", "max_inflight")

    def __init__(self, weight: float = 1.0, max_inflight: int | None = None):
        self.weight = float(weight)
        self.max_inflight = max_inflight

    def __repr__(self) -> str:  # readable in rejection messages/tests
        cap = "" if self.max_inflight is None else f":{self.max_inflight}"
        return f"{self.weight:g}{cap}"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Quota)
            and self.weight == other.weight
            and self.max_inflight == other.max_inflight
        )


class QuotaExceeded(Exception):
    """A client at its ``max_inflight`` quota submitted another job.
    Retriable by contract: the tenant resubmits once a lane frees."""

    def __init__(self, client, max_inflight: int):
        self.client = client
        self.max_inflight = max_inflight
        super().__init__(
            f"quota client={client} max_inflight={max_inflight}: already "
            f"{max_inflight} job(s) queued or executing (retry after one "
            "completes)"
        )


def parse_quota_spec(spec: str | None) -> dict[str, Quota]:
    """``--quota client=weight[:max_inflight],...`` ->
    ``{client: Quota}``.  ``*`` is the default quota for clients not
    named explicitly.  Parsed at boot (the CLI turns ``ValueError`` into
    a usage error, never mid-serve) — same convention as ``--slo``."""
    out: dict[str, Quota] = {}
    if not spec:
        return out
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        client, sep, value = item.partition("=")
        client = client.strip()
        if not sep or not client:
            raise ValueError(
                f"--quota entry {item!r} is not client=weight[:max_inflight]"
            )
        weight_s, sep2, cap_s = value.partition(":")
        try:
            weight = float(weight_s)
        except ValueError:
            raise ValueError(
                f"--quota {client}: weight {weight_s!r} is not a number"
            ) from None
        if not weight > 0:
            raise ValueError(
                f"--quota {client}: weight must be > 0 (got {weight})"
            )
        cap: int | None = None
        if sep2:
            try:
                cap = int(cap_s)
            except ValueError:
                raise ValueError(
                    f"--quota {client}: max_inflight {cap_s!r} is not an "
                    "integer"
                ) from None
            if cap < 1:
                raise ValueError(
                    f"--quota {client}: max_inflight must be >= 1 "
                    f"(got {cap})"
                )
        out[client] = Quota(weight, cap)
    return out


_NO_QUOTA = Quota()


class _ClientState:
    """Persistent per-client scheduling state (survives empty queues so
    the deficit counter and inflight accounting stay correct)."""

    __slots__ = ("queue", "quota", "inflight", "vtime", "entry")

    def __init__(self, quota: Quota):
        self.queue: collections.deque = collections.deque()
        self.quota = quota
        self.inflight = 0  # jobs popped but not yet released
        self.vtime = 0.0  # deficit counter: advances 1/weight per job
        self.entry = 0  # rotation tie-break: when the client re-entered


class AdmissionQueue:
    def __init__(
        self,
        capacity: int,
        quotas: dict[str, Quota] | None = None,
        conflict_key=None,
    ):
        self.capacity = max(int(capacity), 1)
        self.quotas = dict(quotas or {})
        # job -> iterable of hashable path tokens it claims for the
        # duration of its execution (None = no conflict tracking)
        self._conflict_key = conflict_key
        self._cond = threading.Condition()
        self._states: dict[object, _ClientState] = {}
        self._total = 0
        self._closed = False
        self._vclock = 0.0  # virtual-time frontier (max served vtime)
        self._seq = itertools.count()
        self._held: set = set()  # path tokens claimed by in-flight jobs
        # id(job) -> (client, claimed tokens) for release()
        self._popped: dict[int, tuple[object, tuple]] = {}

    def _state(self, client) -> _ClientState:
        st = self._states.get(client)
        if st is None:
            quota = self.quotas.get(client) or self.quotas.get("*") \
                or _NO_QUOTA
            st = self._states[client] = _ClientState(quota)
        return st

    def set_quotas(self, quotas: dict[str, Quota] | None) -> None:
        """Replace the quota table LIVE, under the queue's one condition
        variable — the locked live-config path the autotune plane (and
        operators via future reload verbs) actuates through.  Every
        existing client state is re-resolved against the new table in
        the same critical section, so no pop/offer can ever observe a
        half-applied table (old map, new per-client quota, or vice
        versa); inflight counts and deficit clocks carry over untouched.
        Waiters are woken: a raised cap can make a parked client
        eligible right now."""
        with self._cond:
            self.quotas = dict(quotas or {})
            for client, st in self._states.items():
                st.quota = self.quotas.get(client) \
                    or self.quotas.get("*") or _NO_QUOTA
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return self._total

    def depths(self) -> dict:
        """Queued-job count per client — the live exporter's scrape-time
        view of queue pressure (who is waiting, and how much)."""
        with self._cond:
            return {
                client: len(st.queue)
                for client, st in self._states.items()
                if st.queue
            }

    def inflight_counts(self) -> dict:
        """Executing-job count per client (popped, not yet released)."""
        with self._cond:
            return {
                client: st.inflight
                for client, st in self._states.items()
                if st.inflight
            }

    def offer(self, client, job) -> bool:
        """Enqueue ``job`` for ``client``; ``False`` when the queue is at
        capacity or closed (the caller rejects with a retriable
        status).  Raises :class:`QuotaExceeded` when the client's
        ``max_inflight`` quota already covers its queued + executing
        jobs — also retriable, but with the quota named."""
        with self._cond:
            if self._closed or self._total >= self.capacity:
                return False
            st = self._state(client)
            cap = st.quota.max_inflight
            if cap is not None and st.inflight + len(st.queue) >= cap:
                raise QuotaExceeded(client, cap)
            if not st.queue:
                # (re-)entering the rotation: start at the virtual-time
                # frontier (idling banks no credit), behind incumbents
                # already at the frontier (entry order breaks ties)
                st.vtime = max(st.vtime, self._vclock)
                st.entry = next(self._seq)
            st.queue.append(job)
            self._total += 1
            self._cond.notify_all()
            return True

    # -- selection ------------------------------------------------------

    def _eligible(self, st: _ClientState) -> bool:
        if not st.queue:
            return False
        cap = st.quota.max_inflight
        if cap is not None and st.inflight >= cap:
            return False
        if self._conflict_key is not None and self._held:
            tokens = self._claim_tokens(st.queue[0])
            # only the HEAD job can run (per-client FIFO); a held path on
            # it parks the whole client until the holder releases
            if any(t in self._held for t in tokens):
                return False
        return True

    def _claim_tokens(self, job) -> tuple:
        if self._conflict_key is None:
            return ()
        return tuple(self._conflict_key(job))

    def _select_locked(self, ignore_limits: bool = False):
        """The next (client, state) in weighted-fair order, or None."""
        best = None
        for client, st in self._states.items():
            if ignore_limits:
                if not st.queue:
                    continue
            elif not self._eligible(st):
                continue
            rank = (st.vtime, st.entry)
            if best is None or rank < best[0]:
                best = (rank, client, st)
        if best is None:
            return None
        return best[1], best[2]

    def _pop_locked(self, client, st):
        """Dequeue ``client``'s head job with the full pop bookkeeping
        (deficit advance, inflight count, conflict-path claim).  Caller
        holds the lock and has already checked eligibility."""
        job = st.queue.popleft()
        self._total -= 1
        st.inflight += 1
        # deficit bookkeeping: serving one job costs 1/weight of
        # virtual time; the frontier follows
        st.vtime += 1.0 / st.quota.weight
        self._vclock = max(self._vclock, st.vtime)
        tokens = self._claim_tokens(job)
        self._held.update(tokens)
        self._popped[id(job)] = (client, tokens)
        return job

    def pop(self, timeout: float | None = None):
        """The next job in weighted-fair order; blocks while nothing is
        runnable (empty, every queued client at its inflight cap, or
        every head job path-conflicted with an in-flight job).  Returns
        ``None`` once the queue is closed and empty (worker shutdown),
        or on ``timeout``.  The caller MUST :meth:`release` the job when
        its lane is done with it."""
        with self._cond:
            while True:
                picked = self._select_locked() if self._total else None
                if picked is not None:
                    client, st = picked
                    return self._pop_locked(client, st)
                if self._closed and self._total == 0:
                    return None
                if not self._cond.wait(timeout=timeout):
                    return None

    def pop_compatible(self, match):
        """Non-blocking pop for the micro-batch collector: the next job
        in weighted-fair order whose client is ELIGIBLE (inflight cap,
        output-conflict guard — exactly :meth:`pop`'s criteria, so
        batching changes no scheduling policy) and whose HEAD job
        satisfies ``match(job)``.  Only heads are considered — per-
        client FIFO is preserved.  Returns None when no such job is
        queued right now; the caller MUST :meth:`release` any job
        returned, like a normal pop."""
        with self._cond:
            if self._total == 0:
                return None
            best = None
            for client, st in self._states.items():
                if not self._eligible(st) or not match(st.queue[0]):
                    continue
                rank = (st.vtime, st.entry)
                if best is None or rank < best[0]:
                    best = (rank, client, st)
            if best is None:
                return None
            return self._pop_locked(best[1], best[2])

    def release(self, job) -> None:
        """Mark a popped job's lane free: drop its client's inflight
        count and its claimed output paths, and wake blocked poppers.
        Idempotent for unknown jobs (drain-rejected jobs were never
        popped)."""
        with self._cond:
            client, tokens = self._popped.pop(id(job), (None, ()))
            if client is None:
                return
            self._held.difference_update(tokens)
            st = self._states.get(client)
            if st is not None:
                if st.inflight > 0:
                    st.inflight -= 1
                if not st.queue and st.inflight == 0:
                    # prune idle state: the vtime frontier (vclock)
                    # already equals a just-served client's vtime, so
                    # re-entry reconstructs the same schedule — and a
                    # long-lived daemon must not grow per-client state
                    # (and per-pop scan cost) with every tenant process
                    # it has ever served
                    del self._states[client]
            self._cond.notify_all()

    def close(self) -> None:
        """Stop admitting; ``pop`` drains what is queued then returns
        ``None``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self) -> list:
        """Close AND empty the queue, returning every still-queued job
        in the weighted-fair order they would have run (inflight caps
        and path conflicts ignored — these jobs are being rejected, not
        run) so the daemon can reject each with a retriable status."""
        with self._cond:
            self._closed = True
            out = []
            while self._total:
                client, st = self._select_locked(ignore_limits=True)
                out.append(st.queue.popleft())
                self._total -= 1
                st.vtime += 1.0 / st.quota.weight
                self._vclock = max(self._vclock, st.vtime)
            self._cond.notify_all()
            return out
