"""The warm-spare fleet supervisor behind ``fleet`` (the port's copy of
the JAX package's ``parallel/fleet.py``).

The coordinator makes a rank's death safe (lease expiry, reassignment)
and its slowness recoverable (work stealing); the supervisor manages the
rank processes themselves:

* it keeps ``--ranks N`` workers running while uncommitted ranges
  remain;
* **scale up**: it spawns up to ``--spares M`` more (bounded by
  ``--max-ranks``) when a heartbeat is older than the lease TTL plus the
  grace (a rank presumed dead or stalled) or the completion horizon
  (remaining ranges over the commit rate) passes ``--scale-horizon``;
* **scale down**: it sends SIGTERM to workers the store shows idle (no
  lease) once fewer ranges remain than workers;
* **replace**: a worker that exits abnormally is spawned again while
  work remains.

Each decision is journaled: ``rank_spawn`` (``reason`` ``boot``,
``replace_dead`` or ``scale_up``) and ``rank_retire`` (``reason``
``excess_capacity``).  The supervisor holds no lease and writes no
output.  A worker is ``python -m specpride_tpu_torch`` on the supervised
argv, a ``consensus`` or ``select`` command line with ``--elastic`` and
without ``--process-id`` (each worker takes a fresh rank).  With
``--flightrec observe|on`` a flight recorder taps the supervisor's
journal (its bundles carry the process counts).  With ``--autotune
observe|on`` a controller (``FleetSparesPolicy``) tunes the spare count
from the steal pressure the store shows, ticked from the poll loop.  The
module holds no torch (nor do the recorder and the controller): ``fleet``
and
``cas-server`` run here (``cmd_fleet``, ``cmd_cas_server``), routed by
``__main__`` before the CLI, and its torch, is imported.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time

from specpride_tpu_torch.observability import tracing
from specpride_tpu_torch.observability.flightrec import FlightRecorder
from specpride_tpu_torch.observability.incident_cli import add_flightrec_flags
from specpride_tpu_torch.observability.journal import (
    emit_clock_anchor,
    open_journal,
)
from specpride_tpu_torch.observability.tracing import TraceContext
from specpride_tpu_torch.parallel.store import (
    CasServer,
    Store,
    store_from_spec,
)

logger = logging.getLogger("specpride_tpu_torch")

# seconds of projected remaining work that justify warming a spare
DEFAULT_SCALE_HORIZON_S = 60.0

# the module every worker runs
WORKER_MODULE = "specpride_tpu_torch"


def extract_flag(argv: list[str], flag: str) -> str | None:
    """The value of ``--flag VALUE`` or ``--flag=VALUE`` in an argv (the
    last wins, as with argparse)."""
    value = None
    for i, tok in enumerate(argv):
        if tok == flag and i + 1 < len(argv):
            value = argv[i + 1]
        elif tok.startswith(flag + "="):
            value = tok.split("=", 1)[1]
    return value


class FleetSupervisor:
    """Drive one elastic run to completion with ``ranks`` workers and up
    to ``spares`` warm spares.  :meth:`run` blocks until every range is
    committed (0) or no worker can make progress (1).  ``env`` is the
    workers' environment (``fleet`` puts its trace context in it, so
    every rank journals under one trace)."""

    def __init__(self, job_argv: list[str], ranks: int, spares: int = 0,
                 max_ranks: int | None = None, journal=None,
                 poll_interval: float = 0.5,
                 scale_horizon: float = DEFAULT_SCALE_HORIZON_S,
                 env: dict | None = None, autotune: str = "off",
                 flightrec: str = "off", incident_dir: str | None = None):
        spec = extract_flag(job_argv, "--elastic")
        if not spec:
            raise ValueError(
                "fleet needs an --elastic DIR|URL in the supervised argv")
        if extract_flag(job_argv, "--process-id") is not None:
            raise ValueError(
                "drop --process-id from the supervised argv: every spawned "
                "worker must auto-assign a fresh rank")
        if autotune not in ("off", "observe", "on"):
            raise ValueError(f"fleet autotune {autotune!r} must be off, "
                             "observe or on")
        if autotune != "off" and not getattr(journal, "enabled", False):
            raise ValueError("fleet --autotune observe|on requires "
                             "--journal: every decision must be journaled "
                             "as evidence")
        if flightrec not in ("off", "observe", "on"):
            raise ValueError(f"fleet flightrec {flightrec!r} must be off, "
                             "observe or on")
        if flightrec != "off" and not getattr(journal, "enabled", False):
            raise ValueError("fleet --flightrec observe|on requires "
                             "--journal: the detectors fold the journal "
                             "stream")
        self.job_argv = list(job_argv)
        self.spec = spec
        self.ranks = max(int(ranks), 0)
        self.spares = max(int(spares), 0)
        self.max_ranks = (int(max_ranks) if max_ranks
                          else self.ranks + self.spares)
        self.journal = journal
        self.poll_interval = max(float(poll_interval), 0.05)
        self.scale_horizon = max(float(scale_horizon), 1.0)
        self.env = dict(env if env is not None else os.environ)
        ttl = extract_flag(job_argv, "--elastic-ttl")
        try:
            self.ttl = float(ttl) if ttl else 10.0
        except ValueError:
            self.ttl = 10.0
        self.grace = self.ttl * 0.5
        self.store: Store = store_from_spec(spec)
        # each worker's stderr goes to a file, never a pipe: an undrained
        # pipe blocks a chatty worker once the OS buffer fills
        self.scratch = tempfile.mkdtemp(prefix="specpride-fleet-")
        self.procs: list[subprocess.Popen] = []
        self.spawned = 0
        self.retired = 0
        self.replaced = 0
        self.failures: list[str] = []
        self._done_cache: set[str] = set()
        # off builds no controller: a controller-free supervisor
        self.autotune = autotune
        self.controller = None
        if autotune != "off":
            from specpride_tpu_torch.autotune import (
                Controller,
                FleetSparesPolicy,
            )

            ctl = Controller(journal, mode=autotune)
            ctl.register(
                FleetSparesPolicy(lo=0, hi=max(self.max_ranks - self.ranks,
                                               0)),
                get=lambda: self.spares,
                set=lambda n: setattr(self, "spares", max(int(n), 0)))
            self.controller = ctl
        # off builds no recorder: a recorder-free supervisor
        self.recorder = None
        if flightrec != "off":
            ctl = self.controller
            self.recorder = FlightRecorder(
                journal, mode=flightrec, incident_dir=incident_dir,
                autotune_fn=((lambda: {"status": ctl.status(),
                                       "knobs": ctl.knob_values()})
                             if ctl is not None else None),
                extra_fn=lambda: {
                    "procs_alive": sum(1 for p in self.procs
                                       if p.poll() is None),
                    "spawned": self.spawned, "retired": self.retired,
                    "replaced": self.replaced,
                    "failures": list(self.failures)},
                config={"host": "fleet", "elastic": self.spec,
                        "ranks": self.ranks, "spares": self.spares,
                        "max_ranks": self.max_ranks, "ttl_s": self.ttl,
                        "autotune": autotune, "flightrec": flightrec},
            ).start()

    # -- store views --------------------------------------------------------

    def _range_ids(self) -> set[int]:
        got = self.store.get("plan.json")
        if got is None:
            return set()
        ids = set(range(int(got[0].get("n_ranges", 0) or 0)))
        # stolen tails count from their cut records: an overlay id a donor
        # allocated before dying has no cut and is claimable by nobody
        for key in self.store.list_keys("split/"):
            if ".cut." not in key:
                continue
            cut = self.store.get(key)
            if cut is not None and isinstance(cut[0].get("new_range"), int):
                ids.add(cut[0]["new_range"])
        return ids

    def _done_ids(self) -> set[str]:
        self._done_cache.update(self.store.list_keys("done/"))
        return self._done_cache

    def _heartbeats(self) -> list[tuple[dict, float]]:
        out = []
        for key in self.store.list_keys("hb/"):
            got = self.store.get_with_age(key)
            if got is not None and got[2] is not None:
                out.append((got[0], got[2]))
        return out

    # -- processes ----------------------------------------------------------

    def worker_argv(self) -> list[str]:
        return [sys.executable, "-m", WORKER_MODULE, *self.job_argv]

    def _spawn(self, reason: str) -> None:
        err_path = os.path.join(self.scratch,
                                f"worker-{self.spawned:04d}.stderr")
        with open(err_path, "wb") as err_fh:
            proc = subprocess.Popen(self.worker_argv(), env=self.env,
                                    stdout=subprocess.DEVNULL,
                                    stderr=err_fh)
        proc.stderr_path = err_path  # type: ignore[attr-defined]
        self.procs.append(proc)
        self.spawned += 1
        if self.journal is not None:
            self.journal.emit("rank_spawn", pid=proc.pid, reason=reason)
        logger.info("fleet: spawned worker pid %d (%s)", proc.pid, reason)

    def _retire(self, proc: subprocess.Popen, reason: str) -> None:
        try:
            proc.send_signal(signal.SIGTERM)
        except OSError:
            return
        self.retired += 1
        if self.journal is not None:
            self.journal.emit("rank_retire", pid=proc.pid, reason=reason)
        logger.info("fleet: retiring worker pid %d (%s)", proc.pid, reason)

    def _reap(self, work_remains: bool) -> None:
        """Collect exited workers; replace an abnormal exit while work
        remains (an exit 0 saw every range committed)."""
        alive: list[subprocess.Popen] = []
        for proc in self.procs:
            rc = proc.poll()
            if rc is None:
                alive.append(proc)
                continue
            if rc in (0, -signal.SIGTERM):
                continue
            try:
                with open(proc.stderr_path, "rb") as fh:
                    tail = fh.read().decode(errors="replace")[-2000:]
            except OSError:
                tail = ""
            logger.warning("fleet: worker pid %d exited %s%s", proc.pid, rc,
                           f"\n{tail}" if tail.strip() else "")
            if work_remains:
                self.replaced += 1
                self._spawn("replace_dead")
            else:
                self.failures.append(
                    f"pid {proc.pid} exited {rc} with no work left")
        self.procs = alive

    # -- the policy loop ----------------------------------------------------

    def _stale(self) -> bool:
        """A rank silent past TTL + grace without the clean-exit marker:
        presumed dead or badly stalled."""
        return any(age > hb.get("ttl", self.ttl) + self.grace
                   for hb, age in self._heartbeats()
                   if not hb.get("stopped"))

    def _desired(self, remaining: int, rate: float) -> int:
        """How many workers to keep alive now."""
        if remaining <= 0:
            return 0
        target = self.ranks
        # the horizon needs an observed commit rate: before the first
        # commits, rate 0 means "unknown", not "infinitely behind"
        behind = rate > 0 and remaining / rate > self.scale_horizon
        if behind or self._stale():
            target = self.ranks + self.spares
        # never more workers than units of work; a pure-spare supervisor
        # (--ranks 0, watching ranks started elsewhere) floors at zero
        floor = 1 if self.ranks > 0 else 0
        return max(min(target, self.max_ranks, remaining), floor)

    def run(self, timeout: float | None = None) -> int:
        deadline = (time.perf_counter() + timeout if timeout is not None
                    else None)
        t0 = time.perf_counter()
        for _ in range(self.ranks):
            self._spawn("boot")
        rate_window: list[tuple[float, int]] = []  # (perf_counter, n_done)
        try:
            while True:
                if deadline is not None and time.perf_counter() > deadline:
                    self.failures.append("fleet timeout")
                    return 1
                ids = self._range_ids()
                done = self._done_ids()
                remaining = max(len(ids) - len(done), 0) if ids else None
                now = time.perf_counter()
                rate_window.append((now, len(done)))
                rate_window[:] = [(t, n) for t, n in rate_window
                                  if now - t <= 10.0]
                rate = 0.0
                if len(rate_window) >= 2:
                    dt = rate_window[-1][0] - rate_window[0][0]
                    dn = rate_window[-1][1] - rate_window[0][1]
                    rate = dn / dt if dt > 0 else 0.0
                self._reap(remaining is None or remaining > 0)
                if remaining == 0:
                    # every range committed: the workers see it and exit
                    for proc in self.procs:
                        try:
                            proc.wait(timeout=max(self.ttl * 4, 30.0))
                        except subprocess.TimeoutExpired:
                            proc.kill()
                            self.failures.append(
                                f"pid {proc.pid} hung after completion")
                    self._reap(work_remains=False)
                    self.procs = []
                    return 1 if self.failures else 0
                if remaining is not None:
                    desired = self._desired(remaining, rate)
                    while len(self.procs) < desired:
                        self._spawn("scale_up" if self.spawned >= self.ranks
                                    else "boot")
                    if (len(self.procs) > desired
                            and remaining < len(self.procs)):
                        self._scale_down(len(self.procs) - desired)
                elif not self.procs and time.perf_counter() - t0 > 60.0:
                    # no plan after a generous boot window and nobody alive
                    # to write one
                    self.failures.append(
                        "no worker alive and no plan registered")
                    return 1
                if self.controller is not None:
                    self._tick()
                time.sleep(self.poll_interval)
        finally:
            if self.controller is not None:
                self.controller.close()
            if self.recorder is not None:
                # journals the queued firings before the caller closes
                # the journal
                self.recorder.stop()
            for proc in self.procs:
                if proc.poll() is None:
                    proc.terminate()
            for proc in self.procs:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()

    def _tick(self) -> None:
        """One controller tick from the poll loop (no thread): the steal
        pressure the store shows (open split proposals, stale heartbeats)
        rides the decision as snapshot extras, recorded evidence that the
        journal alone cannot rebuild."""
        proposals = sum(1 for key in self.store.list_keys("split/")
                        if ".cut." not in key)
        stale = sum(1 for hb, age in self._heartbeats()
                    if not hb.get("stopped")
                    and age > hb.get("ttl", self.ttl) + self.grace)
        self.controller.tick({"steal_proposals": proposals,
                              "stale_ranks": stale})

    def _scale_down(self, n: int) -> None:
        """Retire up to ``n`` workers the store shows idle (no lease held),
        matched by the pid each rank's heartbeat carries."""
        idle_pids = {hb.get("pid") for hb, age in self._heartbeats()
                     if not hb.get("holding") and age <= self.ttl}
        for proc in list(self.procs):
            if n <= 0:
                break
            if proc.poll() is None and proc.pid in idle_pids:
                self._retire(proc, "excess_capacity")
                n -= 1

    def summary(self) -> dict:
        return {"spawned": self.spawned, "retired": self.retired,
                "replaced": self.replaced, "failures": list(self.failures),
                **({"autotune": {**self.controller.status(),
                                 "spares": self.spares}}
                   if self.controller is not None else {}),
                **({"flightrec": self.recorder.status()}
                   if self.recorder is not None else {})}


def add_fleet_parsers(sub) -> None:
    """The ``fleet`` and ``cas-server`` subcommands, with the JAX CLI's
    flags."""
    pf = sub.add_parser(
        "fleet",
        help="warm-spare supervisor of an elastic run: spawn N rank "
        "processes over the argv after --, replace dead ones, scale spares "
        "up and down from the heartbeat ages and the completion horizon "
        "(journals rank_spawn and rank_retire)",
    )
    pf.add_argument("--ranks", type=int, default=2, metavar="N",
                    help="workers to keep running while uncommitted ranges "
                    "remain (default 2; 0 = only spares, watching ranks "
                    "started elsewhere)")
    pf.add_argument("--spares", type=int, default=0, metavar="M",
                    help="extra workers spawned when a rank's heartbeat goes "
                    "stale or the completion horizon exceeds "
                    "--scale-horizon (default 0)")
    pf.add_argument("--max-ranks", type=int, default=None, metavar="N",
                    help="cap on concurrent workers (default ranks + spares)")
    pf.add_argument("--scale-horizon", type=float, default=60.0,
                    metavar="S",
                    help="projected seconds of remaining work (ranges left "
                    "over the commit rate) beyond which spares start "
                    "(default 60)")
    pf.add_argument("--poll", type=float, default=0.5, metavar="S",
                    help="supervision loop interval (default 0.5)")
    pf.add_argument("--timeout", type=float, default=None, metavar="S",
                    help="abort the fleet after S seconds (default: none)")
    pf.add_argument("--journal", metavar="FILE",
                    help="JSONL journal of the supervisor's rank_spawn and "
                    "rank_retire decisions (workers journal through their "
                    "own --journal)")
    pf.add_argument(
        "--autotune", choices=["off", "observe", "on"], default="off",
        help="closed-loop controller over the warm-spare count, driven by "
        "live steal pressure (split proposals, stale heartbeats): "
        "'observe' journals every would-be --spares decision without "
        "acting, 'on' also acts within [0, max-ranks - ranks].  Requires "
        "--journal; every decision is an `autotune` event (default off)")
    add_flightrec_flags(pf, "(over the supervisor's journal) ")
    pf.add_argument("job", nargs=argparse.REMAINDER,
                    help="the rank argv after --: consensus|select INPUT "
                    "OUTPUT --elastic DIR|URL [flags], without --process-id")
    pcs = sub.add_parser(
        "cas-server",
        help="the in-tree conditional-put/ETag object store (the --elastic "
        "URL backend's reference server; in memory)",
    )
    pcs.add_argument("--host", default="127.0.0.1", metavar="HOST",
                     help="bind address (default 127.0.0.1)")
    pcs.add_argument("--port", type=int, default=0, metavar="PORT",
                     help="bind port (default 0 = ephemeral; the URL is "
                     "printed on stdout)")
    pcs.add_argument("--url-file", metavar="FILE",
                     help="also write the server URL to FILE")


def cmd_fleet(args) -> int:
    """``fleet --ranks N -- consensus|select ... --elastic SPEC``: the
    supervisor (``parallel.fleet``) drives the run's workers until every
    range is committed (0; merge with ``merge-parts --elastic``).  Every
    worker journals under the supervisor's trace (``SPECPRIDE_TRACE``);
    the summary goes to stderr as one JSON line."""
    job = list(args.job)
    if job and job[0] == "--":
        job = job[1:]
    if not job:
        raise SystemExit(
            "fleet needs a supervised argv after --, e.g.: fleet --ranks 2 "
            "-- consensus in.mgf out.mgf --elastic /shared/coord")
    ctx = TraceContext.from_env() or TraceContext.mint()
    env = dict(os.environ, **{tracing.TRACE_ENV: ctx.to_env()})
    journal = open_journal(args.journal)
    journal.bind_trace(ctx.trace_id)
    if journal.enabled:
        emit_clock_anchor(journal)
    try:
        try:
            sup = FleetSupervisor(job, ranks=args.ranks, spares=args.spares,
                                  max_ranks=args.max_ranks, journal=journal,
                                  poll_interval=args.poll,
                                  scale_horizon=args.scale_horizon, env=env,
                                  autotune=args.autotune,
                                  flightrec=args.flightrec,
                                  incident_dir=args.incident_dir)
        except ValueError as e:
            raise SystemExit(str(e))
        rc = sup.run(timeout=args.timeout)
        summary = sup.summary()
        logger.info("fleet done: %d spawned, %d retired, %d replaced",
                    summary["spawned"], summary["retired"],
                    summary["replaced"])
        print(json.dumps(summary), file=sys.stderr)
        if rc != 0:
            for problem in summary["failures"]:
                logger.error("fleet: %s", problem)
        return rc
    finally:
        journal.close()


def cmd_cas_server(args) -> int:
    """``cas-server``: the in-tree object store behind ``--elastic URL``;
    prints its URL on stdout (and to ``--url-file``) and serves until
    SIGTERM or SIGINT."""
    # SIGTERM ends the loop like Ctrl-C, through the finally below; the
    # handler, then the URL file, then the printed line: a reader acting on
    # the line finds the file, and a SIGTERM sent on it exits 0
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    server = CasServer(host=args.host, port=args.port)
    try:
        if args.url_file:
            # whole or absent: a temporary name in the same directory,
            # then a rename
            tmp = f"{args.url_file}.tmp-{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(server.url + "\n")
            os.replace(tmp, args.url_file)
        print(server.url, flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


FLEET_COMMANDS = {"fleet": cmd_fleet, "cas-server": cmd_cas_server}


def main(argv: list[str] | None = None) -> int:
    """``python -m specpride_tpu_torch fleet|cas-server ...`` without the
    CLI: the same two subparsers, and no torch (the workers a fleet
    spawns import it)."""
    ap = argparse.ArgumentParser(prog="specpride_tpu_torch")
    add_fleet_parsers(ap.add_subparsers(dest="command", required=True))
    args = ap.parse_args(argv)
    return FLEET_COMMANDS[args.command](args)
