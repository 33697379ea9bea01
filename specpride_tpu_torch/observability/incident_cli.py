"""``incident-replay`` and ``incidents``: the read side of the flight
recorder (``observability/flightrec.py``), with the JAX CLI's flags,
messages and exit codes; and the hosts' ``--flightrec`` flags.

* ``incident-replay JOURNAL`` refolds a journal through the detector set
  and exits 0 only when every journaled ``incident`` re-derives
  bit-exact (``--json`` also writes the result);
* ``incidents list|show|export INCIDENT_DIR [INCIDENT_ID]`` reads the
  bundles a ``--flightrec on`` host dumped: one line per bundle, one
  bundle's manifest (``--files`` adds its evidence files), or one bundle
  as ``incident-<id>.tar.gz`` (``--output``).

The module holds no torch: ``__main__`` routes both commands here before
the CLI, and its torch, is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from specpride_tpu_torch.observability.flightrec import (
    find_bundle,
    list_bundles,
    render_incident_replay,
    replay_incidents,
)


def add_flightrec_flags(p: argparse.ArgumentParser, scope: str = "") -> None:
    """``--flightrec`` and ``--incident-dir`` on a host's parser
    (``serve``, ``fleet``, and ``consensus``/``select``, where only an
    elastic rank builds a recorder, as in the JAX CLI); ``scope``
    prefixes the help."""
    p.add_argument(
        "--flightrec", choices=["off", "observe", "on"], default="off",
        help=f"{scope}flight recorder: an always-on ring of recent journal "
        "records plus health detectors (SLO-breach streaks, latency spikes "
        "against the EWMA, queue saturation, watchdog stalls, retry "
        "exhaustion, fallback_solo bursts, lease churn).  'observe' "
        "journals each firing as an `incident` event; 'on' also dumps an "
        "atomic diagnostic bundle under --incident-dir; 'off' constructs "
        "no recorder at all.  Requires --journal; audit with "
        "`incident-replay` (default off)",
    )
    p.add_argument(
        "--incident-dir", metavar="DIR",
        help="directory for --flightrec on incident bundles (ring dump, "
        "thread stacks, /metrics snapshot, config digest, host state, "
        "journal tail; read with `incidents`)",
    )


def add_incident_parsers(sub) -> None:
    """The ``incident-replay`` and ``incidents`` subcommands."""
    pir = sub.add_parser(
        "incident-replay",
        help="refold a recorded journal through the flight recorder's "
        "detector set and verify every journaled incident re-derives "
        "bit-exact (same id, reason, clock, evidence, dedup)",
    )
    pir.add_argument(
        "journal",
        help="journal file from a --flightrec observe|on run (base path; "
        "rotated segments and .part<rank> shards replay as independent "
        "per-process streams)",
    )
    pir.add_argument("--json", metavar="FILE",
                     help="also write the machine-readable replay result "
                     "here")
    pin = sub.add_parser(
        "incidents",
        help="read the atomic diagnostic bundles a --flightrec on host "
        "dumped under its --incident-dir",
    )
    pin.add_argument(
        "action", choices=["list", "show", "export"],
        help="list = one line per bundle; show = print one bundle's "
        "manifest (+ evidence files with --files); export = tar one bundle",
    )
    pin.add_argument("incident_dir", metavar="INCIDENT_DIR",
                     help="the --incident-dir a --flightrec on host wrote "
                     "into")
    pin.add_argument(
        "incident_id", nargs="?", default=None, metavar="INCIDENT_ID",
        help="(show/export) the bundle's incident id: any unique prefix, "
        "as printed by `incidents list`",
    )
    pin.add_argument("--files", action="store_true",
                     help="(show) also print every evidence file in the "
                     "bundle")
    pin.add_argument("--output", metavar="FILE",
                     help="(export) tarball path (default "
                     "incident-<incident_id>.tar.gz in the current "
                     "directory)")


def cmd_incident_replay(args) -> int:
    """``incident-replay JOURNAL``: 0 only when every recorded incident
    reproduces (``flightrec.replay_incidents``)."""
    result = replay_incidents(args.journal)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(result, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
    render_incident_replay(result, sys.stdout)
    return 0 if result["ok"] else 1


def cmd_incidents(args) -> int:
    """``incidents list|show|export``: the bundles under
    ``INCIDENT_DIR``; a warning on stderr for each directory that is not
    a readable bundle."""
    bundles, warnings = list_bundles(args.incident_dir)
    for w in warnings:
        print(f"warning: {w}", file=sys.stderr)
    if args.action == "list":
        if not bundles:
            print(f"no incident bundles under {args.incident_dir}")
            return 0
        for b in bundles:
            inc = b.get("incident", {})
            print(f"{inc.get('incident_id', '?'):<18} "
                  f"{inc.get('detector', '?'):<16} "
                  f"clock={inc.get('clock', '?')} "
                  f"mode={inc.get('mode', '?')} "
                  f"suppressed={inc.get('suppressed', 0)}  "
                  f"{inc.get('reason', '')}")
        return 0
    if not args.incident_id:
        raise SystemExit(f"incidents {args.action} needs an INCIDENT_ID")
    bundle = find_bundle(args.incident_dir, args.incident_id)
    if bundle is None:
        raise SystemExit(
            f"no unique bundle matches {args.incident_id!r} under "
            f"{args.incident_dir} (try `incidents list`)")
    if args.action == "show":
        print(json.dumps(bundle, indent=2, sort_keys=True, default=str))
        if args.files:
            for fname in sorted(f for f in os.listdir(bundle["dir"])
                                if f != "manifest.json"):
                print(f"\n===== {fname} =====")
                with open(os.path.join(bundle["dir"], fname),
                          encoding="utf-8", errors="replace") as fh:
                    sys.stdout.write(fh.read())
        return 0
    import tarfile

    inc = bundle.get("incident", {})
    out = args.output or (
        f"incident-{inc.get('incident_id', 'unknown')}.tar.gz")
    with tarfile.open(out, "w:gz") as tar:
        tar.add(bundle["dir"], arcname=os.path.basename(bundle["dir"]))
    print(out)
    return 0


INCIDENT_COMMANDS = {"incident-replay": cmd_incident_replay,
                     "incidents": cmd_incidents}


def main(argv: list[str] | None = None) -> int:
    """``python -m specpride_tpu_torch incident-replay|incidents ...``
    without the CLI: the same two subparsers, and no torch."""
    ap = argparse.ArgumentParser(prog="specpride_tpu_torch")
    add_incident_parsers(ap.add_subparsers(dest="command", required=True))
    args = ap.parse_args(argv)
    return INCIDENT_COMMANDS[args.command](args)
