"""JSON-lines wire protocol of the serving daemon (the port's copy of the
JAX package's ``serve/protocol.py``; the same messages, so either
package's client talks to either daemon).

Transport: a local **unix-domain stream socket**, one connection per job.
Every message is one JSON object per line, newline-terminated, the same
framing as the run journal.

Client -> server (one request per connection)::

    {"op": "submit", "argv": ["consensus", IN, OUT, "--method", ...],
     "client": NAME, "trace": {"trace_id": HEX32, "parent_span_id": HEX16}}
    {"op": "ping"}
    {"op": "status"}
    {"op": "profile", "seconds": 3.0, "trace_dir": DIR,
     "chrome_trace": FILE}

``trace`` (optional) is the v4 causal envelope: the daemon adopts the
trace, parents its ``serve:queue`` / ``serve:job`` spans under
``parent_span_id`` and stamps the id on the job's journal events; absent,
the daemon mints one; malformed, the job is rejected permanently.

``profile`` captures a bounded ``torch.profiler`` trace of the running
daemon (the card's kernels and copies, as ``--trace-dir`` writes it) plus
the daemon journal's events inside the window
(``<trace_dir>/journal_window.jsonl``).  One capture at a time; a
concurrent request is rejected with ``retriable: true``.

Server -> client, for ``submit``: an admission line, then, unless the job
was rejected, one terminal line::

    {"ok": true,  "status": "accepted", "job_id": 3, "queue_depth": 1}
    {"ok": true,  "status": "done", "job_id": 3, "rc": 0, "wall_s": 1.23,
     "queue_wait_s": 0.0, "stats": {...}, "worker": 1}
    {"ok": false, "status": "rejected", "reason": "queue_full",
     "retriable": true}
    {"ok": false, "status": "error", "job_id": 3,
     "error": "ValueError: ...", "retriable": false}

Admission rejections for capacity (``queue_full``, ``draining``, a
``quota ...``) are retriable; an execution error is retriable only when
``robustness.errors`` calls it transient, and a sticky CUDA error never
is.  ``submit`` exits 75 (BSD ``EX_TEMPFAIL``) on a retriable
non-success.

A job's ``argv`` is the one-shot CLI argv (``consensus`` or ``select``),
parsed by the CLI's own parser.  The flags in ``JOB_REFUSED_FLAGS`` set up
the daemon's resident lanes at boot and are refused on a job: a per-job
``--device`` or ``--layout`` could not apply to a lane already built.
"""

from __future__ import annotations

import json
import os

PROTOCOL_VERSION = 1

# commands a job may run
SERVABLE_COMMANDS = ("consensus", "select")

# flags the daemon owns: the JAX package's list, as far as the port's
# parser has them, plus --device.  A job carrying one is rejected, never
# silently run otherwise.  --metrics-out: the lanes' registries are
# resident and shared across jobs (scrape /metrics, or read the drain
# snapshot); --elastic*, --metrics-port: a job is one tenant of the
# daemon, not a rank (it would lease ranges and bind ports inside the
# daemon); --trace-dir: one profiler session per process (profile the
# daemon instead); --autotune: the controller is the daemon's
# (``serve --autotune``), one per process; --result-cache, --result-store:
# the tiers are the daemon's, shared by every lane; --device: a job may
# not move a resident lane to the CPU or to another card.
JOB_REFUSED_FLAGS = (
    "--layout",
    "--precision",
    "--mesh",
    "--coordinator",
    "--num-processes",
    "--process-id",
    "--metrics-out",
    "--elastic",
    "--elastic-steal",
    "--elastic-local",
    "--metrics-port",
    "--trace-dir",
    "--autotune",
    "--result-cache",
    "--result-store",
    "--device",
)

# `submit` exit code for a retriable non-success (sysexits' EX_TEMPFAIL)
EX_TEMPFAIL = 75

# ceiling on one `profile` capture window: a profiler session buffers the
# card's events in memory
PROFILE_MAX_SECONDS = 300.0


def default_socket_path() -> str:
    """Where daemon and client meet when ``--socket`` is not given:
    ``SPECPRIDE_SOCKET``, else a per-user path under ``~/.cache``."""
    env = os.environ.get("SPECPRIDE_SOCKET")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "specpride_tpu_torch", "serve.sock")


def write_msg(fh, **payload) -> None:
    """One protocol message as one flushed JSON line."""
    fh.write(json.dumps(payload) + "\n")
    fh.flush()


def read_msg(fh) -> dict | None:
    """The next message, ``None`` at EOF.  Raises ``ValueError`` on a line
    that is not a JSON object."""
    line = fh.readline()
    if not line:
        return None
    msg = json.loads(line)
    if not isinstance(msg, dict):
        raise ValueError(f"protocol message is not an object: {msg!r}")
    return msg


def forbidden_flags(argv: list[str]) -> list[str]:
    """The refused flags in a job argv (``--flag`` and ``--flag=value``
    both count)."""
    return sorted({tok.split("=", 1)[0] for tok in argv
                   if tok.split("=", 1)[0] in JOB_REFUSED_FLAGS})


# parser dests of the refused flags: a parsed job whose value differs from
# the parser's default was set by the argv, whatever spelling reached the
# parser (argparse takes unambiguous prefixes like --layou, which the
# token scan above cannot see)
_JOB_REFUSED_DESTS = tuple(f[2:].replace("-", "_") for f in JOB_REFUSED_FLAGS)

_refused_defaults: dict | None = None


def _owned_defaults() -> dict:
    """The port parser's own defaults of the refused dests, read once
    from a bare parse, never a hard-coded copy."""
    global _refused_defaults
    if _refused_defaults is None:
        from specpride_tpu_torch.cli import build_parser

        base = build_parser().parse_args(["consensus", "", ""])
        _refused_defaults = {dest: getattr(base, dest)
                             for dest in _JOB_REFUSED_DESTS}
    return _refused_defaults


def overridden_daemon_flags(args) -> list[str]:
    """The refused flags a parsed job overrides from their defaults: the
    prefix-proof check behind :func:`forbidden_flags`."""
    return sorted("--" + dest.replace("_", "-")
                  for dest, default in _owned_defaults().items()
                  if getattr(args, dest, default) != default)
