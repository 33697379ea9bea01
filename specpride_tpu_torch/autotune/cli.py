"""``autotune-replay``: the controller's determinism audit, with the JAX
CLI's flags, output and exit codes.  It rebuilds each recorded policy
from its journaled params, re-runs it on the journaled signal snapshot,
refolds the snapshots from the event stream, and exits 0 only when every
decision reproduces (``replay.replay_journal``).  The module holds no
torch: ``__main__`` routes the command here before the CLI is imported.
"""

from __future__ import annotations

import argparse
import json
import sys

from specpride_tpu_torch.autotune.replay import render_replay, replay_journal


def add_replay_parser(sub) -> None:
    """The ``autotune-replay`` subcommand."""
    par = sub.add_parser(
        "autotune-replay",
        help="re-run the autotune policies over a recorded journal and "
        "verify every decision reproduces exactly (same new value, same "
        "reason, refolded signal snapshots)",
    )
    par.add_argument(
        "journal",
        help="journal file from an --autotune observe|on run (base path; "
        "rotated segments and .part<rank> shards replay as independent "
        "per-process streams)",
    )
    par.add_argument("--json", metavar="FILE",
                     help="also write the machine-readable replay result "
                     "here")


def cmd_autotune_replay(args) -> int:
    result = replay_journal(args.journal)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(result, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
    render_replay(result, sys.stdout)
    return 0 if result["ok"] else 1


AUTOTUNE_COMMANDS = {"autotune-replay": cmd_autotune_replay}


def main(argv: list[str] | None = None) -> int:
    """``python -m specpride_tpu_torch autotune-replay ...`` without the
    CLI, and without torch."""
    ap = argparse.ArgumentParser(prog="specpride_tpu_torch")
    add_replay_parser(ap.add_subparsers(dest="command", required=True))
    args = ap.parse_args(argv)
    return AUTOTUNE_COMMANDS[args.command](args)
