"""The elastic work coordinator (the port's copy of the JAX package's
``parallel/coordinator.py``): leases, exactly-once commits, fencing and
live work stealing over a :mod:`specpride_tpu_torch.parallel.store`.

Instead of ``--coordinator``'s fixed block per rank, ranks claim chunk
ranges of the clusters from a shared store (a directory or an object
store), in the JAX package's records:

* ``plan.json``: ``n_clusters`` in ranges of ``range_size``.  Every rank
  derives the plan from its own parse; the first writes it, later ones
  verify theirs matches.
* ``leases/range_<k>.json``: one rank works a range at a time.  A claim
  is a create-if-absent, renewed by ``touch`` from a heartbeat thread; a
  lease older than its TTL plus a grace is stolen by compare-and-delete,
  and only then are ``lease_expire`` and ``chunk_reassign`` journaled.
* ``done/range_<k>.json``: the commit marker, create-if-absent, so a
  range commits exactly once; it carries the part file's
  ``output_bytes`` and ``sha256``, which ``merge-parts --elastic``
  verifies.
* ``hb/rank_<r>.json``: each rank's heartbeat with its progress
  (clusters committed, the EWMA chunk wall), what a thief ranks its
  targets by.
* ``split/...`` and ``overlay/...``: the work-stealing handshake.  A
  rank with nothing to claim proposes a split of a live peer's range
  (``split/range_<k>.proposed.<nonce>.json``); the donor ratifies at its
  next chunk boundary, before dispatching that chunk, with a cut
  (``split/range_<k>.cut.<nonce>.json``) that names a new overlay range
  for the tail and journals ``lease_split``; the thief claims the tail
  and journals ``chunk_reassign via=lease_split``.  The cut falls on a
  chunk boundary of the donor, so the chunks on both sides are those of
  a single-process run.

Fencing: each claim carries a nonce.  Before every chunk commit the
executor calls :meth:`Coordinator.commit_fence`: a lost lease, a foreign
nonce or a chunk past a ratified cut raises ``LeaseExpiredError``
(permanent, never retried), so a stalled or zombie rank abandons instead
of racing the range's new owner.  The module holds no torch beyond what
the error taxonomy imports.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import uuid

from specpride_tpu_torch.observability.journal import emit_clock_anchor
from specpride_tpu_torch.parallel.store import (
    Store,
    is_remote_spec,
    store_from_spec,
)
from specpride_tpu_torch.robustness import faults
from specpride_tpu_torch.robustness.errors import LeaseExpiredError

logger = logging.getLogger("specpride_tpu_torch")

PLAN_SCHEMA = 1
DONE_SCHEMA = 1

# default lease time-to-live and the grace margin an observer adds on
# top before declaring a lease dead (absorbs clock skew between hosts
# sharing a filesystem; the object-store backend judges age with the
# SERVER's clock, where the same grace covers network latency instead)
DEFAULT_TTL_S = 10.0
DEFAULT_GRACE_FRAC = 0.5

# EWMA smoothing for the per-chunk wall the heartbeat publishes (the
# journal's chunk_done.elapsed_s is the same quantity, measured at the
# same commit; the heartbeat mirror exists because peers cannot read
# each other's journals without a shared filesystem)
_EWMA_ALPHA = 0.3


@dataclasses.dataclass(frozen=True)
class ChunkRange:
    """One unit of claimable work: a contiguous block of cluster
    indices.  Base ranges are fixed by the plan; **overlay** ranges
    (``parent`` set) are split-off tails registered by the stealing
    handshake — either way, every rank and every post-mortem resolves
    range ``k`` to the same clusters and the same ``.part<k>``
    output."""

    range_id: int
    start: int
    stop: int
    parent: int | None = None
    from_rank: int | None = None

    @property
    def n_clusters(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass
class Claim:
    """A held lease on one range."""

    range: ChunkRange
    nonce: str
    takeover: bool = False
    from_rank: int | None = None
    lost: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )


def plan_ranges(n_clusters: int, range_size: int) -> list[ChunkRange]:
    """The deterministic plan: ``n_clusters`` in blocks of
    ``range_size``.  An empty input still plans ONE empty range so the
    claimer writes an empty part and ``merge-parts`` finds something."""
    size = max(int(range_size), 1)
    if n_clusters <= 0:
        return [ChunkRange(0, 0, 0)]
    return [
        ChunkRange(k, start, min(start + size, n_clusters))
        for k, start in enumerate(range(0, n_clusters, size))
    ]


class Coordinator:
    """One rank's handle on the shared elastic work queue.

    Construction registers the plan (or verifies it against the one a
    peer already wrote) and starts the heartbeat thread; callers MUST
    pair with :meth:`stop` (the CLI does so in a ``finally``).

    ``root`` is the ``--elastic`` spec: a shared directory or an
    ``http(s)://`` object-store URL.  ``local_dir`` holds the per-range
    resume manifests (``ck/``) — they are ordinary checkpoint files the
    executor replaces atomically, so they stay on a filesystem even
    when coordination state lives in an object store (defaults to the
    store directory itself on the filesystem backend)."""

    def __init__(
        self,
        root: str,
        rank: int,
        n_clusters: int,
        range_size: int,
        ttl: float = DEFAULT_TTL_S,
        heartbeat_interval: float = 0.0,
        journal=None,
        local_dir: str | None = None,
        steal: bool = True,
        chunk_hint: int = 0,
        trace: str | None = None,
    ):
        self.root = root
        self.store: Store = store_from_spec(root)
        if local_dir is None:
            if is_remote_spec(root):
                raise ValueError(
                    "an object-store coordinator needs local_dir for its "
                    "per-range resume manifests"
                )
            local_dir = self.store.root  # type: ignore[attr-defined]
        self.local_dir = os.path.abspath(local_dir)
        self.rank = int(rank)
        self.ttl = max(float(ttl), 0.1)
        self.grace = self.ttl * DEFAULT_GRACE_FRAC
        self.heartbeat_interval = (
            float(heartbeat_interval)
            if heartbeat_interval and heartbeat_interval > 0
            else max(self.ttl / 4.0, 0.05)
        )
        self.journal = journal
        # the run's trace-context handoff ("trace_id:span_id"): the plan
        # creator registers it so LATE-JOINING ranks (spares spawned
        # without the SPECPRIDE_TRACE env) adopt the same trace instead
        # of minting their own — one elastic run, one causal timeline
        self.trace = trace
        self.steal_enabled = bool(steal)
        self.chunk_hint = max(int(chunk_hint), 1)
        self.n_clusters = int(n_clusters)
        self.range_size = max(int(range_size), 1)
        base = plan_ranges(n_clusters, range_size)
        self.n_base_ranges = len(base)
        self._by_id: dict[int, ChunkRange] = {
            r.range_id: r for r in base
        }
        # observed-recovery counters the liveness exporter mirrors
        self.lease_expires_observed = 0
        self.reassignments = 0
        self.ranges_run = 0
        self.lease_splits = 0  # splits this rank ratified as donor
        self.steals = 0  # overlay tails this rank claimed
        self.cas_conflicts = 0
        self._lock = threading.Lock()
        self._held: dict[int, Claim] = {}
        self._cuts: dict[int, int] = {}  # range -> ratified cut (global)
        # autotune's elastic_range actuator: caps a future cede (None is
        # steal-half)
        self._split_hint: int | None = None
        self._progress: dict[int, dict] = {}  # range -> {done, chunk_s}
        # the rank's EWMA chunk wall, the journal heartbeat's chunk_s: it
        # outlives any one range (the held-range view above empties at
        # every commit)
        self._chunk_s_ewma: float | None = None
        self._done_cache: set[int] = set()  # commit markers never vanish
        self._stop = threading.Event()
        os.makedirs(os.path.join(self.local_dir, "ck"), exist_ok=True)
        # register this identity even when --process-id pinned it, so a
        # later auto-assigning joiner (a fleet-spawned spare) can never
        # collide with an explicitly numbered rank's journals/heartbeats
        self.store.put_new(
            f"ranks/rank_{self.rank:05d}", {"pid": os.getpid()}
        )
        self._register_plan()
        # one immediate beat before the loop: every rank's journal holds
        # at least one heartbeat (the stats rank view keys off it) and
        # the exporter's age gauge starts near zero, even on runs that
        # finish inside the first interval
        self._beat()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop,
            name=f"specpride-heartbeat-r{self.rank}", daemon=True,
        )
        self._hb_thread.start()

    @property
    def ranges(self) -> list[ChunkRange]:
        """The live range table (base plan + discovered overlays, cuts
        applied), in id order."""
        with self._lock:
            return [self._by_id[k] for k in sorted(self._by_id)]

    # -- plan -----------------------------------------------------------

    def _plan_payload(self) -> dict:
        return {
            "schema": PLAN_SCHEMA,
            "n_clusters": self.n_clusters,
            "range_size": self.range_size,
            "n_ranges": self.n_base_ranges,
            **({"trace": self.trace} if self.trace else {}),
        }

    def _register_plan(self) -> None:
        payload = self._plan_payload()
        self.store.put_new("plan.json", payload)
        existing = self.store.get("plan.json")
        if existing is None:
            raise SystemExit(
                f"elastic plan under {self.store.describe()} is "
                "unreadable — another rank wrote a torn plan or the "
                "store is not shared between ranks"
            )
        for key in ("n_clusters", "range_size"):
            if existing[0].get(key) != payload[key]:
                raise SystemExit(
                    f"elastic plan mismatch ({self.store.describe()}): "
                    f"this rank derived {key}={payload[key]} but the "
                    f"registered plan says {existing[0].get(key)} — are "
                    "all ranks running the same input and "
                    "--elastic-range?"
                )

    @classmethod
    def read_plan(cls, root: str) -> dict | None:
        """The registered plan, for ``merge-parts --elastic`` and the
        stats/exporter consumers (None when absent/unreadable)."""
        got = store_from_spec(root).get("plan.json")
        return got[0] if got is not None else None

    # -- rank identity --------------------------------------------------

    @staticmethod
    def assign_rank(root: str, limit: int = 4096) -> int:
        """Auto-assign the lowest free rank id via create-if-absent
        marker records — used when ``--process-id`` is not given.  Ranks
        are identities, not a partition: any number may join or
        rejoin."""
        store = store_from_spec(root)
        for r in range(limit):
            if store.put_new(f"ranks/rank_{r:05d}", {"pid": os.getpid()}):
                return r
        raise SystemExit(f"no free rank id under {root}")

    # -- keys / paths ---------------------------------------------------

    def _lease_key(self, k: int) -> str:
        return f"leases/range_{k:05d}.json"

    def _done_key(self, k: int) -> str:
        return f"done/range_{k:05d}.json"

    def _proposal_key(self, k: int, nonce: str) -> str:
        return f"split/range_{k:05d}.proposed.{nonce}.json"

    def _cut_key(self, k: int, nonce: str) -> str:
        return f"split/range_{k:05d}.cut.{nonce}.json"

    def _overlay_key(self, k: int) -> str:
        return f"overlay/range_{k:05d}.json"

    def checkpoint_path(self, k: int) -> str:
        """The per-range resume manifest — coordinator-owned so elastic
        runs are ALWAYS checkpointed (reassignment needs the manifest to
        know which chunks the dead rank committed).  Always a local
        filesystem path: the executor replaces it atomically per
        chunk."""
        return os.path.join(self.local_dir, "ck", f"range_{k:05d}.json")

    # -- range table ----------------------------------------------------

    def _refresh_ranges(self) -> None:
        """Fold ratified cuts published by peers into the local range
        table.  The CUT record is the single atomic source of truth for
        a split — it names the overlay id and carries the tail's full
        extent — so a donor that dies between allocating an overlay id
        and publishing the cut leaves only invisible allocation debris:
        the parent stays whole, its takeover recomputes the full range,
        and no duplicate tail can ever be claimed.  Cut records are
        immutable once written, so this only ever adds entries or
        narrows stops."""
        for key in self.store.list_keys("split/"):
            if ".cut." not in key:
                continue
            got = self.store.get(key)
            if got is None:
                continue
            rec = got[0]
            try:
                parent = int(key.rsplit("/", 1)[1].split(".", 1)[0]
                             .replace("range_", ""))
            except ValueError:
                continue
            cut = rec.get("cut")
            if not isinstance(cut, int):
                continue
            rid = rec.get("new_range")
            if isinstance(rid, int):
                with self._lock:
                    if rid not in self._by_id:
                        self._by_id[rid] = ChunkRange(
                            rid, cut, int(rec.get("stop", cut)),
                            parent=parent,
                            from_rank=rec.get("donor_rank"),
                        )
            self._apply_cut(parent, cut)

    def _apply_cut(self, parent: int, cut: int) -> None:
        with self._lock:
            rng = self._by_id.get(parent)
            if rng is None or cut >= rng.stop:
                return
            self._by_id[parent] = dataclasses.replace(rng, stop=cut)
            prev = self._cuts.get(parent)
            self._cuts[parent] = cut if prev is None else min(prev, cut)

    def effective_range(self, k: int) -> ChunkRange:
        """Range ``k``'s current extent — narrowed by any ratified
        cut."""
        with self._lock:
            return self._by_id[k]

    # -- leases ---------------------------------------------------------

    def _is_done(self, k: int) -> bool:
        if k in self._done_cache:
            return True
        if self.store.get(self._done_key(k)) is not None:
            self._done_cache.add(k)
            return True
        return False

    def _lease_payload(self, nonce: str) -> dict:
        return {
            "rank": self.rank,
            "pid": os.getpid(),
            "nonce": nonce,
            "claimed": time.time(),
            "ttl": self.ttl,
        }

    def _lease_expired(
        self, k: int, lease: dict, age: float | None = None
    ) -> tuple[bool, float]:
        """(expired?, seconds past deadline) judged from the lease's
        store-side age — seconds since the holder's last renewal as the
        STORE's clock saw it — plus the holder's declared TTL and the
        clock-skew grace.  Callers that just read the lease pass the
        age from the same round trip."""
        if age is None:
            age = self.store.age_s(self._lease_key(k))
        if age is None:
            return False, 0.0  # mid-steal — look again next scan
        ttl = lease.get("ttl")
        if not isinstance(ttl, (int, float)) or ttl <= 0:
            ttl = self.ttl
        over = age - (ttl + self.grace)
        return over > 0, max(over, 0.0)

    def _remaining_clusters(self, rng: ChunkRange) -> int:
        """Clusters of ``rng`` NOT yet committed in its checkpoint
        manifest — the chunk_reassign payload's honest remainder."""
        try:
            with open(self.checkpoint_path(rng.range_id),
                      encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            return rng.n_clusters
        if not isinstance(manifest, dict):
            return rng.n_clusters
        done = manifest.get("done")
        n_done = len(done) if isinstance(done, list) else 0
        return max(rng.n_clusters - n_done, 0)

    def _cas_conflict(self, err: Exception) -> None:
        """An injected (or, with a real object store, genuine)
        compare-and-swap conflict: lose this attempt gracefully and let
        the claim loop re-scan.  Journaled as a ``retry`` at the
        ``cas`` site so the chaos audit pairs the fault with its
        recovery."""
        with self._lock:
            # the claim loop and the heartbeat lane's renewals can both
            # lose a CAS race; unguarded += would drop conflicts
            self.cas_conflicts += 1
        if self.journal is not None:
            self.journal.emit(
                "retry", site="cas", attempt=0, backoff_s=0.0,
                error=f"{type(err).__name__}: {err}",
            )
        logger.warning(
            "rank %d: coordinator CAS conflict (%s); re-scanning",
            self.rank, err,
        )

    def _try_claim(self, rng: ChunkRange) -> Claim | None:
        k = rng.range_id
        nonce = uuid.uuid4().hex
        try:
            faults.check("cas")
        except faults.InjectedCasConflict as e:
            self._cas_conflict(e)
            return None
        if self.store.put_new(self._lease_key(k), self._lease_payload(nonce)):
            claim = Claim(rng, nonce)
            if os.path.exists(self.checkpoint_path(k)):
                # a prior holder died after its lease was cleaned up (or
                # released without committing): partial state exists, so
                # this fresh-looking claim is still a takeover
                claim.takeover = True
            self._note_claim(claim)
            return claim
        got = self.store.get_with_age(self._lease_key(k))
        if got is None:
            return None  # torn or mid-steal — look again next scan
        lease, etag, age = got
        # (a dead previous incarnation of THIS rank id is handled like
        # any other dead rank: its lease simply ages out below)
        expired, over_s = self._lease_expired(k, lease, age)
        if not expired:
            return None  # live holder
        # expired: steal via compare-and-delete — only one racer wins
        if not self.store.delete_if(self._lease_key(k), etag):
            return None  # lost the steal race
        dead_rank = lease.get("rank", -1)
        if not self.store.put_new(
            self._lease_key(k), self._lease_payload(nonce)
        ):
            # another claimer slipped into the gap between our delete
            # and our create: ITS lease_claim covers the range, so emit
            # NOTHING here — a lease_expire with no paired
            # chunk_reassign would fail the audit over zero lost work
            return None
        with self._lock:
            self.lease_expires_observed += 1
            self.reassignments += 1
        if self.journal is not None:
            self.journal.emit(
                "lease_expire", rank=dead_rank, range=k,
                observed_by=self.rank, expired_for_s=round(over_s, 3),
            )
        logger.warning(
            "rank %d: lease on range %d held by rank %s expired; "
            "reassigning", self.rank, k, dead_rank,
        )
        claim = Claim(rng, nonce, takeover=True, from_rank=dead_rank)
        if self.journal is not None:
            self.journal.emit(
                "chunk_reassign", range=k, from_rank=dead_rank,
                to_rank=self.rank,
                n_clusters_remaining=self._remaining_clusters(rng),
            )
        self._note_claim(claim)
        return claim

    def _note_claim(self, claim: Claim) -> None:
        k = claim.range.range_id
        with self._lock:
            self._held[k] = claim
            self.ranges_run += 1
        if self.journal is not None:
            self.journal.emit(
                "lease_claim", rank=self.rank, range=k,
                takeover=claim.takeover,
                **(
                    {"from_rank": claim.from_rank}
                    if claim.from_rank is not None else {}
                ),
            )
        if claim.range.parent is not None and not claim.takeover:
            # first claim of a split-off tail: THIS is the reassignment
            # that pairs with the donor's lease_split in the audit —
            # whoever wins the claim (the proposing stealer usually,
            # any idle rank legitimately) emits it
            with self._lock:
                self.steals += 1
            if self.journal is not None:
                self.journal.emit(
                    "chunk_reassign", range=k,
                    from_rank=claim.range.from_rank
                    if claim.range.from_rank is not None else -1,
                    to_rank=self.rank,
                    n_clusters_remaining=claim.range.n_clusters,
                    via="lease_split",
                )

    def _holds(self, k: int) -> bool:
        with self._lock:
            return k in self._held

    def claim_next(self) -> Claim | None:
        """Claim the next available range, scanning from this rank's own
        offset (ranks start at different ranges, so a healthy fleet
        claims disjoint work without ever contending).  None = nothing
        claimable right now (all done, or every open range is leased by
        a live rank — try a steal, then poll again)."""
        self._refresh_ranges()
        ranges = self.ranges
        n = len(ranges)
        for i in range(n):
            rng = ranges[(self.rank + i) % n]
            if rng.n_clusters <= 0 and rng.parent is not None:
                continue  # voided overlay (cut == stop)
            if self._is_done(rng.range_id):
                continue
            if rng.from_rank == self.rank and rng.parent is not None:
                # our own split-off tail: the whole point of the split
                # was to move this work OFF this (slow) rank, and the
                # stealer that asked is microseconds behind us — defer
                # until the tail has gone unclaimed for a full expiry
                # window (the stealer died), then pick it up after all
                age = self.store.age_s(self._overlay_key(rng.range_id))
                if age is not None and age < self.ttl + self.grace:
                    continue
            claim = self._try_claim(rng)
            if claim is not None:
                return claim
        return None

    def all_committed(self) -> bool:
        self._refresh_ranges()
        return all(
            self._is_done(r.range_id)
            for r in self.ranges
            if r.n_clusters > 0 or r.parent is None
        )

    def done_count(self) -> int:
        return sum(self._is_done(r.range_id) for r in self.ranges)

    def counters(self) -> dict:
        """This rank's lease counters, the run summary's ``elastic``
        keys."""
        return {
            "ranges_run": self.ranges_run,
            "ranges_committed": self.done_count(),
            "lease_expires_observed": self.lease_expires_observed,
            "reassignments": self.reassignments,
            "lease_splits": self.lease_splits,
            "steals": self.steals,
            "cas_conflicts": self.cas_conflicts,
        }

    # -- work stealing --------------------------------------------------

    def _steal_candidates(self) -> list[tuple[float, ChunkRange, dict]]:
        """Open, live-leased ranges worth splitting, best target first.

        Score = estimated seconds of work left on the range, from the
        holder's heartbeat progress mirror (clusters committed + EWMA
        chunk wall — the same per-chunk timings the journal's
        ``chunk_done`` events carry).  Ranges without progress data
        score by remaining clusters alone."""
        progress_by_rank: dict[int, dict] = {}
        for key in self.store.list_keys("hb/"):
            got = self.store.get(key)
            if got is None:
                continue
            hb = got[0]
            if isinstance(hb.get("rank"), int):
                progress_by_rank[hb["rank"]] = hb.get("progress") or {}
        out: list[tuple[float, ChunkRange, dict]] = []
        for rng in self.ranges:
            k = rng.range_id
            if self._is_done(k) or self._holds(k):
                continue
            got = self.store.get_with_age(self._lease_key(k))
            if got is None:
                continue
            lease, _, age = got
            expired, _ = self._lease_expired(k, lease, age)
            if expired:
                continue  # the expiry path owns dead leases
            prog = progress_by_rank.get(lease.get("rank", -1), {}).get(
                str(k), {}
            )
            done = int(prog.get("done", 0) or 0)
            remaining = max(rng.n_clusters - done, 0)
            if remaining < 2 * max(self.chunk_hint, 1):
                continue  # too little left to be worth a handshake
            chunk_s = prog.get("chunk_s")
            per_cluster = (
                float(chunk_s) / max(self.chunk_hint, 1)
                if isinstance(chunk_s, (int, float)) and chunk_s > 0
                else 1.0
            )
            out.append((remaining * per_cluster, rng, lease))
        out.sort(key=lambda t: -t[0])
        return out

    def try_steal(self, poll_timeout: float | None = None) -> Claim | None:
        """Attempt one live steal: propose a split of the most-loaded
        live peer's range, wait for the donor to ratify a cut at its
        next chunk boundary, and claim the split-off tail.  None =
        nothing stealable (no live target with enough work, the donor
        finished first, or another rank won the tail)."""
        if not self.steal_enabled:
            return None
        self._refresh_ranges()
        candidates = self._steal_candidates()
        if not candidates:
            return None
        timeout = (
            float(poll_timeout) if poll_timeout is not None
            else min(2.0 * self.heartbeat_interval + 0.5, self.ttl)
        )
        for _, rng, lease in candidates[:2]:
            claim = self._steal_one(rng, lease, timeout)
            if claim is not None:
                return claim
        return None

    def _steal_one(
        self, rng: ChunkRange, lease: dict, timeout: float
    ) -> Claim | None:
        k = rng.range_id
        nonce = lease.get("nonce")
        if not isinstance(nonce, str):
            return None
        try:
            faults.check("cas")
        except faults.InjectedCasConflict as e:
            self._cas_conflict(e)
            return None
        # propose (idempotent: a racing proposer's record serves the
        # same purpose — we poll the cut either way)
        self.store.put_new(
            self._proposal_key(k, nonce),
            {"parent": k, "donor_rank": lease.get("rank", -1),
             "stealer_rank": self.rank, "donor_nonce": nonce},
        )
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline and not self._stop.is_set():
            got = self.store.get(self._cut_key(k, nonce))
            if got is not None:
                rec = got[0]
                new_id = rec.get("new_range")
                if not isinstance(new_id, int):
                    return None  # donor declined (nothing left to give)
                cut = int(rec.get("cut", rng.stop))
                self._apply_cut(k, cut)
                self._refresh_ranges()
                with self._lock:
                    tail = self._by_id.get(new_id)
                # a tail already committed (this proposal's cut was read
                # before, and the tail run) is no work: the JAX package
                # claims it again and redoes its resume and QC shard
                if (tail is None or tail.n_clusters <= 0
                        or self._is_done(new_id)):
                    return None
                return self._try_claim(tail)
            if self._is_done(k):
                return None  # donor finished the whole range first
            current = self.store.get(self._lease_key(k))
            if current is None or current[0].get("nonce") != nonce:
                return None  # donor died/released — the expiry path owns it
            self._stop.wait(min(0.05, timeout / 4.0))
        return None

    # -- donor side: ratify + clip + fence ------------------------------

    def _allocate_overlay(self, start: int, stop: int, parent: int) -> int:
        """Mint a fresh range id for the split-off tail (create-if-
        absent id allocation — two concurrent splits can never take the
        same id).  The overlay record is ONLY the allocation marker:
        peers learn the tail's existence and extent from the cut record
        that references it, so an id allocated by a donor that died
        before publishing its cut is harmless debris."""
        with self._lock:
            rid = max(
                [self.n_base_ranges] + [k + 1 for k in self._by_id]
            )
        while True:
            rec = {
                "range_id": rid, "start": start, "stop": stop,
                "parent": parent, "from_rank": self.rank,
            }
            if self.store.put_new(self._overlay_key(rid), rec):
                with self._lock:
                    self._by_id[rid] = ChunkRange(
                        rid, start, stop, parent=parent,
                        from_rank=self.rank,
                    )
                return rid
            rid += 1

    def clip_or_ratify(self, k: int, next_min_idx: int) -> int | None:
        """The donor's per-chunk dispatch-lane hook, called BEFORE
        submitting the chunk whose first local cluster index is
        ``next_min_idx``.  Returns the LOCAL clip index (stop before it)
        when this range has been split, else None.

        Ratification happens here — on the lane that knows the
        submission frontier — so the cut always lands at the boundary
        of a chunk that has NOT been handed to the ordered write lane:
        everything already in flight commits strictly below the cut and
        the commit fence never fires on the donor's own queued work."""
        with self._lock:
            claim = self._held.get(k)
            if claim is None or claim.lost.is_set():
                return None
            rng = self._by_id[k]
            cut = self._cuts.get(k)
            hint = self._split_hint
        if cut is not None:
            return max(cut - rng.start, 0)
        if not self.steal_enabled or next_min_idx <= 0:
            # the donor always keeps at least its first chunk: a zero
            # cut would leave an empty committed range behind
            return None
        if self.store.get(self._proposal_key(k, claim.nonce)) is None:
            return None
        # steal-half: the donor keeps the first half of its remaining
        # work (whole chunks, at least one) and cedes the rest.  Ceding
        # everything past the next boundary would leave a slow donor
        # idle one chunk later, stealing back from the stealer — the
        # classic halving policy converges geometrically instead.  The
        # cut can never land below the submission frontier: everything
        # up to ``next_min_idx`` is already in flight and commits below
        # it by construction.
        chunk = max(self.chunk_hint, 1)
        remaining = rng.stop - (rng.start + int(next_min_idx))
        keep = max((remaining // 2) // chunk, 1) * chunk
        if hint:
            # the autotune cap: cede at most ~hint clusters (whole chunks,
            # at least one), so split-off tails land near the tuned range
            # size.  It only grows ``keep``, and keeps it whole chunks: the
            # cut stays on the donor's chunk grid, where the card's f32
            # sums are the single run's (the JAX package keeps
            # ``remaining - cede``, off the grid when the range's last
            # chunk is short)
            cede = max(int(hint) // chunk, 1) * chunk
            keep = max(keep, -(-(remaining - cede) // chunk) * chunk)
        cut_global = rng.start + int(next_min_idx) + keep
        if cut_global >= rng.stop:
            # nothing left to give: publish a declined cut so the
            # stealer's poll terminates instead of timing out
            self.store.put_new(
                self._cut_key(k, claim.nonce),
                {"cut": rng.stop, "new_range": None},
            )
            with self._lock:
                self._cuts[k] = rng.stop
            return None
        new_id = self._allocate_overlay(cut_global, rng.stop, k)
        # the ONE atomic publication of the split: everything a peer
        # needs to claim the tail (id, extent, donor) rides the cut
        self.store.put_new(
            self._cut_key(k, claim.nonce),
            {"cut": cut_global, "new_range": new_id, "stop": rng.stop,
             "parent": k, "donor_rank": self.rank},
        )
        self._apply_cut(k, cut_global)
        with self._lock:
            self.lease_splits += 1
        if self.journal is not None:
            self.journal.emit(
                "lease_split", range=k, new_range=new_id,
                rank=self.rank, split_at=cut_global,
                n_clusters_split=rng.stop - cut_global,
            )
        logger.info(
            "rank %d: split range %d at cluster %d — tail of %d "
            "clusters is now range %d", self.rank, k, cut_global,
            rng.stop - cut_global, new_id,
        )
        return max(cut_global - rng.start, 0)

    @property
    def split_hint(self) -> int | None:
        with self._lock:
            return self._split_hint

    def set_split_hint(self, n: int | None) -> None:
        """Autotune's ``elastic_range`` actuator: later ratified splits
        cede at most ~``n`` clusters (whole chunks).  It applies only to
        ranges not yet cut, never resizes claimed work, so the bytes are
        untouched.  ``None`` restores steal-half."""
        with self._lock:
            self._split_hint = int(n) if n else None

    def check_lease(self, k: int) -> None:
        """The basic fence: raise :class:`LeaseExpiredError` when this
        rank no longer holds range ``k`` — the lease record is gone
        (stolen) or carries a foreign nonce (stolen and re-claimed)."""
        with self._lock:
            claim = self._held.get(k)
        if claim is None or claim.lost.is_set():
            raise LeaseExpiredError(
                f"rank {self.rank} lost its lease on range {k}"
            )
        got = self.store.get(self._lease_key(k))
        lease = got[0] if got is not None else None
        if lease is None or lease.get("nonce") != claim.nonce:
            claim.lost.set()
            raise LeaseExpiredError(
                f"rank {self.rank} lost its lease on range {k} "
                f"(held by rank {lease.get('rank') if lease else '?'} now)"
            )

    def commit_fence(self, k: int, max_idx: int | None = None,
                     n_clusters: int = 0,
                     chunk_t0: float | None = None) -> None:
        """The per-commit fence the executor calls before any bytes
        land: :meth:`check_lease` plus the split fence — a commit
        whose chunk reaches at or past a ratified cut raises
        :class:`LeaseExpiredError`, so a donor that somehow kept
        dispatching past its cut (a zombie that never ran the clip)
        abandons instead of racing the tail's new owner.  Also folds
        this chunk into the progress mirror the heartbeat publishes."""
        self.check_lease(k)
        with self._lock:
            rng = self._by_id[k]
            cut = self._cuts.get(k)
            if n_clusters > 0:
                prog = self._progress.setdefault(
                    k, {"done": 0, "chunk_s": None}
                )
                prog["done"] = int(prog["done"]) + int(n_clusters)
                if chunk_t0 is not None:
                    dt = max(time.perf_counter() - chunk_t0, 0.0)
                    prev = prog["chunk_s"]
                    prog["chunk_s"] = (
                        dt if prev is None
                        else _EWMA_ALPHA * dt + (1 - _EWMA_ALPHA) * prev
                    )
                    self._chunk_s_ewma = (
                        dt if self._chunk_s_ewma is None
                        else _EWMA_ALPHA * dt
                        + (1 - _EWMA_ALPHA) * self._chunk_s_ewma
                    )
        if (
            cut is not None and max_idx is not None
            and rng.start + int(max_idx) >= cut
        ):
            raise LeaseExpiredError(
                f"rank {self.rank}: range {k} was split at cluster "
                f"{cut}; the suffix belongs to the stealing rank now"
            )

    def release(self, k: int) -> None:
        """Drop a held lease (after commit, or on abandon)."""
        with self._lock:
            claim = self._held.pop(k, None)
        if claim is None or claim.lost.is_set():
            return
        got = self.store.get(self._lease_key(k))
        if got is not None and got[0].get("nonce") == claim.nonce:
            self.store.delete(self._lease_key(k))

    # -- commit ---------------------------------------------------------

    def commit(self, k: int, payload: dict) -> bool:
        """Exactly-once range commit: create-if-absent marker.  Returns
        False when another rank already committed ``k`` (the
        double-commit race — both produced byte-identical parts, only
        the first marker counts)."""
        body = {
            "schema": DONE_SCHEMA, "range": k, "rank": self.rank,
            "committed": time.time(), **payload,
        }
        ok = self.store.put_new(self._done_key(k), body)
        if ok:
            self._done_cache.add(k)
        return ok

    # -- heartbeats -----------------------------------------------------

    def _beat(self) -> None:
        with self._lock:
            held = sorted(self._held)
            claims = [self._held[k] for k in held]
            progress = {
                str(k): {
                    "done": int(p.get("done", 0)),
                    **(
                        {"chunk_s": round(p["chunk_s"], 4)}
                        if isinstance(p.get("chunk_s"), (int, float))
                        else {}
                    ),
                }
                for k, p in self._progress.items()
                if k in self._held
            }
            chunk_s_ewma = self._chunk_s_ewma
        for claim, k in zip(claims, held):
            # renewal = an atomic freshness bump (utime on the
            # filesystem, ETag-guarded rewrite on the object store).
            # Never a blind content rewrite: that could land AFTER a
            # stealer's fresh lease and shadow it with our stale nonce.
            got = self.store.get(self._lease_key(k))
            if got is None or got[0].get("nonce") != claim.nonce:
                claim.lost.set()
                continue
            if not self.store.touch(self._lease_key(k)):
                claim.lost.set()
        self.store.put(
            f"hb/rank_{self.rank:05d}.json",
            {
                "rank": self.rank, "pid": os.getpid(),
                "ts": time.time(), "holding": held,
                "ranges_done": len(self._done_cache),
                "reassignments": self.reassignments,
                "ttl": self.ttl,
                "progress": progress,
            },
        )
        if self.journal is not None:
            # chunk_s: the rank's EWMA chunk wall, not the held-range
            # view above, which empties at every commit
            self.journal.emit(
                "heartbeat", rank=self.rank, holding=held, ttl=self.ttl,
                chunk_s=(
                    round(chunk_s_ewma, 4)
                    if chunk_s_ewma is not None else None
                ),
            )
            # the clock anchor rides the heartbeat cadence: a long
            # elastic run's journal stays wall-alignable (bounded skew)
            # even across NTP slews mid-run
            emit_clock_anchor(self.journal)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self._beat()
            except OSError as e:  # a full/flaky share or a store outage
                logger.warning(  # must not kill the rank — the lease
                    "rank %d heartbeat failed: %s", self.rank, e,
                )  # just ages toward steal

    def rank_heartbeat_ages(self) -> dict[int, float]:
        """rank -> seconds since its last heartbeat write (store clock)
        — the live fleet view the metrics exporter samples per
        scrape."""
        return {
            rank: age
            for rank, (age, _stopped) in self.rank_heartbeat_states().items()
        }

    def rank_heartbeat_states(self) -> dict[int, tuple[float, bool]]:
        """rank -> (age_s, stopped): the ages plus the clean-shutdown
        marker ``stop()`` writes — consumers distinguishing "finished
        and left" (stale age is fine) from "went silent mid-run"
        (presumed dead) must read this, not the bare ages (the
        ``/healthz`` readiness probe does)."""
        out: dict[int, tuple[float, bool]] = {}
        for key in self.store.list_keys("hb/"):
            got = self.store.get_with_age(key)
            if got is None:
                continue
            rank, age = got[0].get("rank"), got[2]
            if isinstance(rank, int) and age is not None:
                out[rank] = (age, bool(got[0].get("stopped")))
        return out

    def wait_for_work(self, timeout: float | None = None) -> None:
        """Park between claim scans; wakes early on stop()."""
        self._stop.wait(
            timeout if timeout is not None
            else min(self.heartbeat_interval, 0.5)
        )

    def flush_progress(self) -> None:
        """Publish one heartbeat now (store record and journal event) with
        the current progress.  A rank that finishes inside one heartbeat
        interval never reaches a timed beat with its chunk walls folded
        in; the autotune drain tick asks for the final EWMA this way."""
        try:
            self._beat()
        except OSError as e:
            logger.warning("rank %d flush heartbeat failed: %s",
                           self.rank, e)

    def stop(self) -> None:
        self._stop.set()
        self._hb_thread.join(timeout=10)
        with self._lock:
            held = list(self._held)
        for k in held:
            self.release(k)
        try:
            # a final heartbeat marked `stopped`: the fleet supervisor
            # distinguishes "this rank finished and left" (stale age is
            # fine) from "this rank went silent mid-run" (presumed dead
            # — warm a spare).  A SIGKILLed rank never writes it.
            self.store.put(
                f"hb/rank_{self.rank:05d}.json",
                {
                    "rank": self.rank, "pid": os.getpid(),
                    "ts": time.time(), "holding": [],
                    "ranges_done": len(self._done_cache),
                    "reassignments": self.reassignments,
                    "ttl": self.ttl, "progress": {}, "stopped": True,
                },
            )
        except OSError:
            pass
        self.store.close()
