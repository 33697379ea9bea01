"""The serving daemon's client: ``submit`` and ``profile`` (the port's
copy of the JAX package's ``serve/client.py``, with the two commands'
parsers and entry).

This module imports no ``torch``: ``python -m specpride_tpu_torch submit``
and ``profile`` run :func:`main` before the CLI (and with it torch) is
imported, so a submitting process starts in a fraction of a second.  The
full CLI's parser adds the same two subcommands through
:func:`add_client_parsers`, so ``--help`` shows them.

``submit`` is a generator: the admission line ("accepted", with the
queue depth) arrives before the job ends.  Every submit mints (or
adopts) a trace context and sends it on the wire, so the daemon's spans
parent under this client's ``submit:wait`` span; with ``journal=`` the
client writes its own journal shard (a clock anchor and the ``submit``,
``submit:admit`` and ``submit:wait`` spans) for ``trace --job``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

from specpride_tpu_torch.observability.journal import (
    emit_clock_anchor,
    open_journal,
)
from specpride_tpu_torch.observability.tracing import (
    TraceContext,
    new_span_id,
)
from specpride_tpu_torch.serve import protocol


class ServeError(RuntimeError):
    """The daemon broke the protocol (a connection torn mid-job, a
    non-JSON line).  Transient for the client: the job may have finished,
    and resubmitting is safe because a served job is idempotent (the same
    argv writes the same bytes)."""


def _connect(socket_path: str | None, timeout: float | None):
    path = socket_path or protocol.default_socket_path()
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    try:
        sock.connect(path)
    except OSError:
        sock.close()
        raise
    return sock


def request(socket_path: str | None, payload: dict,
            timeout: float | None = 30.0) -> dict:
    """One-shot ops (``ping``, ``status``, ``profile``): send, read one
    reply."""
    sock = _connect(socket_path, timeout)
    try:
        fh = sock.makefile("rw", encoding="utf-8", newline="\n")
        protocol.write_msg(fh, **payload)
        msg = protocol.read_msg(fh)
        if msg is None:
            raise ServeError("daemon closed the connection without a reply")
        return msg
    finally:
        sock.close()


def _default_client_id() -> str:
    """One submitting process is one scheduling client, so a process
    bursting jobs interleaves with its neighbours in the fair queue."""
    return f"{os.getuid()}.{os.getpid()}"


def submit(socket_path: str | None, argv: list[str],
           timeout: float | None = 30.0, client: str | None = None,
           journal: str | None = None, trace: TraceContext | None = None):
    """Submit one job; yield every server message (admission line first,
    terminal line last).  ``timeout`` bounds the connect and the
    admission; once accepted the wait is unbounded (the job may queue).
    ``client`` overrides the per-process scheduling identity.  ``trace``
    overrides the minted context (a resubmit loop keeps one trace, each
    attempt a child submit span); ``journal`` writes the client's shard."""
    ctx = trace if trace is not None else TraceContext.mint()
    # a minted context makes the submit span the trace's root; a given one
    # makes this attempt its child
    submit_span = ctx.span_id if trace is None else new_span_id()
    submit_parent = None if trace is None else ctx.span_id
    # the daemon's spans parent under the wait span, minted now and
    # emitted at close: the daemon works while the client waits
    wait_span = new_span_id()
    jr = open_journal(journal)
    jr.bind_trace(ctx.trace_id)
    if jr.enabled:
        emit_clock_anchor(jr)
    t_start = time.perf_counter()
    t_admit = None

    def _span(name, t0, t1, span_id=None, parent=None, **labels):
        if not jr.enabled:
            return
        jr.emit("span", name=name, mono=t1, dur_s=round(t1 - t0, 6),
                depth=0 if parent is None else 1, tid=0,
                span_id=span_id or new_span_id(),
                **({"parent_span_id": parent} if parent else {}),
                **({"labels": labels} if labels else {}))

    sock = None
    last_status = "error"
    job_id = None
    try:
        sock = _connect(socket_path, timeout)
        fh = sock.makefile("rw", encoding="utf-8", newline="\n")
        protocol.write_msg(
            fh, op="submit", argv=list(argv),
            client=client or _default_client_id(),
            trace={"trace_id": ctx.trace_id, "parent_span_id": wait_span})
        while True:
            try:
                msg = protocol.read_msg(fh)
            except ValueError as e:  # json.JSONDecodeError included
                raise ServeError(f"bad protocol line from daemon: {e}")
            if msg is None:
                raise ServeError("connection closed before a terminal "
                                 "response (daemon killed mid-job?)")
            yield msg
            status = msg.get("status")
            job_id = msg.get("job_id", job_id)
            if status == "accepted":
                t_admit = time.perf_counter()
                _span("submit:admit", t_start, t_admit, parent=submit_span)
                sock.settimeout(None)  # the job may queue; wait it out
            if status in ("done", "error", "rejected"):
                last_status = status
                return
    finally:
        if sock is not None:
            sock.close()
        t_end = time.perf_counter()
        if t_admit is not None:
            _span("submit:wait", t_admit, t_end, span_id=wait_span,
                  parent=submit_span)
        _span("submit", t_start, t_end, span_id=submit_span,
              parent=submit_parent, status=last_status,
              **({"job_id": job_id} if job_id is not None else {}))
        jr.close()


def submit_wait(socket_path: str | None, argv: list[str],
                timeout: float | None = 30.0, client: str | None = None,
                journal: str | None = None,
                trace: TraceContext | None = None) -> dict:
    """Submit and return only the terminal message."""
    last: dict = {}
    for last in submit(socket_path, argv, timeout=timeout, client=client,
                       journal=journal, trace=trace):
        pass
    return last


def exit_code(msg: dict | None) -> int:
    """A terminal message as a shell exit code: done -> the job's rc; a
    retriable rejection or error -> 75 (resubmit later); a permanent
    rejection -> 2; a permanent error -> 1."""
    if not msg:
        return 1
    status = msg.get("status")
    if status == "done":
        return int(msg.get("rc", 0))
    if msg.get("retriable"):
        return protocol.EX_TEMPFAIL
    return 2 if status == "rejected" else 1


def profile(socket_path: str | None, seconds: float = 3.0,
            trace_dir: str | None = None, chrome_trace: str | None = None,
            timeout: float | None = 30.0) -> dict:
    """One bounded ``torch.profiler`` capture on a live daemon.  Blocks for
    about ``seconds``; ``timeout`` covers the connect and the margin past
    the window."""
    payload: dict = {"op": "profile", "seconds": float(seconds)}
    if trace_dir is not None:
        payload["trace_dir"] = trace_dir
    if chrome_trace is not None:
        payload["chrome_trace"] = chrome_trace
    return request(socket_path, payload,
                   timeout=None if timeout is None else
                   timeout + float(seconds))


def wait_for_socket(socket_path: str | None, timeout: float = 60.0,
                    interval: float = 0.1) -> bool:
    """Poll until the daemon answers a ``ping`` (boot imports torch and
    loads the kernels).  False on timeout."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            if request(socket_path, {"op": "ping"}, timeout=2.0).get("ok"):
                return True
        except (OSError, ServeError):
            pass
        time.sleep(interval)
    return False


# -- the two commands -------------------------------------------------------


def _error_line(e: BaseException) -> str:
    return json.dumps({"ok": False, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "retriable": True})


def cmd_submit(args) -> int:
    """``submit -- consensus IN OUT ...``: one job through a daemon, its
    status lines as JSON on stdout; exit 0 done, 75 retriable (queue full,
    quota, draining, no daemon: resubmit later), 2 permanently rejected,
    1 job error.  ``--retry N`` resubmits a retriable outcome up to N
    times with the robustness layer's backoff, under one trace."""
    from specpride_tpu_torch.robustness.retry import RetryPolicy

    job = list(args.job)
    if job and job[0] == "--":
        job = job[1:]
    if not job:
        raise SystemExit("submit needs a job argv after --, e.g.: "
                         "python -m specpride_tpu_torch submit -- consensus "
                         "in.mgf out.mgf --method bin-mean")
    retries = max(int(args.retry or 0), 0)
    policy = RetryPolicy(retries=retries, backoff=args.retry_backoff)
    ctx = TraceContext.from_env() or TraceContext.mint()

    def _attempt() -> int:
        last = None
        try:
            for msg in submit(args.socket, job, timeout=args.timeout,
                              client=args.client, journal=args.journal,
                              trace=ctx):
                print(json.dumps(msg), flush=True)
                last = msg
        except (OSError, ServeError) as e:
            print(_error_line(e), flush=True)
            return protocol.EX_TEMPFAIL
        return exit_code(last)

    attempt = 0
    while True:
        rc = _attempt()
        if rc != protocol.EX_TEMPFAIL or attempt >= retries:
            return rc
        wait = policy.backoff_s("submit", attempt)
        print(json.dumps({"status": "retrying", "attempt": attempt + 1,
                          "of": retries, "backoff_s": round(wait, 3)}),
              flush=True)
        time.sleep(wait)
        attempt += 1


def cmd_profile(args) -> int:
    """``profile``: one bounded ``torch.profiler`` capture (and the daemon
    journal's window) on a running daemon, its reply on stdout; exit 0
    captured, 75 retriable (another capture running), 2 rejected, 1
    error."""
    try:
        msg = profile(args.socket, seconds=args.seconds,
                      trace_dir=args.trace_dir,
                      chrome_trace=args.chrome_trace, timeout=args.timeout)
    except (OSError, ServeError) as e:
        print(_error_line(e), flush=True)
        return protocol.EX_TEMPFAIL
    print(json.dumps(msg), flush=True)
    if msg.get("status") == "profiled":
        return 0
    if msg.get("retriable"):
        return protocol.EX_TEMPFAIL
    return 2 if msg.get("status") == "rejected" else 1


CLIENT_COMMANDS = {"submit": cmd_submit, "profile": cmd_profile}

_SOCKET_HELP = ("daemon socket (default: $SPECPRIDE_SOCKET or "
                "~/.cache/specpride_tpu_torch/serve.sock)")


def add_client_parsers(sub) -> None:
    """The ``profile`` and ``submit`` subcommands, the JAX CLI's flags."""
    ppr = sub.add_parser(
        "profile",
        help="capture a torch.profiler trace of the card (plus the daemon "
        "journal's window) on a running serve daemon",
    )
    ppr.add_argument("--socket", metavar="PATH", default=None,
                     help=_SOCKET_HELP)
    ppr.add_argument("--seconds", type=float, default=3.0, metavar="S",
                     help="capture window (default 3; at most "
                     f"{protocol.PROFILE_MAX_SECONDS:g})")
    ppr.add_argument("--trace-dir", metavar="DIR", default=None,
                     help="where the daemon writes the trace (default: a "
                     "fresh temporary directory, named in the reply)")
    ppr.add_argument("--chrome-trace", metavar="FILE", default=None,
                     help="also copy the trace (Chrome JSON) to this path")
    ppr.add_argument("--timeout", type=float, default=30.0, metavar="S",
                     help="connect and reply margin past the window "
                     "(default 30)")
    psb = sub.add_parser(
        "submit",
        help="submit one consensus/select job to a serve daemon and print "
        "its status lines (exit 0 done, 75 retriable, 2 rejected, 1 error)",
    )
    psb.add_argument("--socket", metavar="PATH", default=None,
                     help=_SOCKET_HELP)
    psb.add_argument("--timeout", type=float, default=30.0, metavar="S",
                     help="connect and admission timeout; once accepted "
                     "the job waits unbounded (default 30)")
    psb.add_argument("--client", metavar="NAME", default=None,
                     help="scheduling identity for the fair queue and "
                     "--quota (default: one per submitting process)")
    psb.add_argument("--retry", type=int, default=0, metavar="N",
                     help="resubmit up to N times on a retriable outcome "
                     "(exit 75), with exponential backoff (default 0)")
    psb.add_argument("--retry-backoff", type=float, default=0.5,
                     metavar="S",
                     help="base backoff before the first resubmit, doubled "
                     "per attempt (default 0.5)")
    psb.add_argument("--journal", metavar="FILE",
                     help="write the client's journal shard: a clock "
                     "anchor and the submit spans under the job's trace")
    psb.add_argument("job", nargs=argparse.REMAINDER,
                     help="the one-shot CLI argv after --: consensus|select "
                     "INPUT OUTPUT [flags] (the daemon's own flags, such "
                     "as --device and --layout, are refused)")


def main(argv: list[str] | None = None) -> int:
    """``python -m specpride_tpu_torch submit|profile ...`` without the
    CLI: the same two subparsers, and no torch."""
    ap = argparse.ArgumentParser(prog="specpride_tpu_torch")
    add_client_parsers(ap.add_subparsers(dest="command", required=True))
    args = ap.parse_args(argv)
    return CLIENT_COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
