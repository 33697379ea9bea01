"""Checker registry + the port's ``lint`` driver.

``run_checks`` is the library entry (tests drive fixtures through it);
``main`` implements the CLI verb: per-check selection, ``--list``,
``--json`` reports, inline-suppression filtering, and the committed
baseline gate (exit 1 only on NEW, unbaselined findings).  The exit
codes, the report (``REPORT_VERSION``) and the baseline format are the
JAX package's, so each package reads the other's reports and baselines.

``python -m specpride_tpu_torch lint`` reaches ``main`` without
importing the CLI (``__main__.py``), so it runs without torch; the
CLI's ``lint`` subparser (``cli.py``) takes the same arguments.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from specpride_tpu_torch.analysis import (
    cli_flags,
    fault_sites,
    journal_schema,
    kernel_hygiene,
    lane_safety,
    metrics_conformance,
)
from specpride_tpu_torch.analysis.baseline import BASELINE_NAME, Baseline
from specpride_tpu_torch.analysis.core import Finding, Project

REPORT_VERSION = 1

# id -> (one-line description, run fn).  Order is render order.
CHECKERS: dict[str, tuple] = {
    lane_safety.CHECK: (
        "attributes mutated from >= 2 lanes must sit in a "
        "lock-protected region (call-graph lane inference)",
        lane_safety.run,
    ),
    kernel_hygiene.CHECK: (
        "no kernel build or import at module load, every wrapper with "
        "its plain version and launch counter, no fallback, every "
        "dispatched kernel warmable, no host sync in a launching wrapper",
        kernel_hygiene.run,
    ),
    journal_schema.CHECK: (
        "EVENT_SCHEMA vs emit sites vs the docs event table vs "
        "renderer literals, in both directions",
        journal_schema.run,
    ),
    metrics_conformance.CHECK: (
        "metric names vs the strict exposition grammar, the docs "
        "catalog, and the zero-at-start contract",
        metrics_conformance.run,
    ),
    cli_flags.CHECK: (
        "JOB_REFUSED_FLAGS vs the parser and its dest mirror; every "
        "flag documented under docs/",
        cli_flags.run,
    ),
    fault_sites.CHECK: (
        "SITES vs actual check() visit sites, in both directions",
        fault_sites.run,
    ),
}


def checker_ids() -> list[str]:
    return list(CHECKERS)


def run_checks(
    root: str, select: list[str] | None = None,
    project: Project | None = None,
) -> list[Finding]:
    """All (selected) checkers over ``root``, inline suppressions
    applied, sorted for stable output."""
    project = project or Project(root)
    findings: list[Finding] = []
    for check_id, (_desc, fn) in CHECKERS.items():
        if select and check_id not in select:
            continue
        findings.extend(fn(project))
    by_rel = {m.rel: m for m in project.modules}
    kept = []
    for f in findings:
        mod = by_rel.get(f.path)
        if mod is not None and f.line and (
            f.check in mod.suppressed_at(f.line)
            or "*" in mod.suppressed_at(f.line)
        ):
            continue
        kept.append(f)
    kept.sort(key=Finding.sort_key)
    return kept


def _report(
    root: str, select, findings: list[Finding], baseline: Baseline,
    new, baselined, stale, bad,
) -> dict:
    return {
        "version": REPORT_VERSION,
        "root": os.path.abspath(root),
        "checks": [
            {"id": cid, "description": desc}
            for cid, (desc, _fn) in CHECKERS.items()
            if not select or cid in select
        ],
        "findings": [f.to_json() for f in new],
        "baselined": [f.to_json() for f in baselined],
        "baseline": {
            "path": baseline.path,
            "entries": len(baseline.entries),
            "stale": stale,
            "missing_reason": bad,
        },
        "summary": {
            "total": len(findings),
            "new": len(new),
            "baselined": len(baselined),
            "stale_baseline_entries": len(stale),
            "baseline_entries_missing_reason": len(bad),
        },
    }


def main(args) -> int:
    if args.list:
        for cid, (desc, _fn) in CHECKERS.items():
            print(f"{cid:22s} {desc}")
        return 0
    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
        unknown = sorted(set(select) - set(CHECKERS))
        if unknown:
            print(
                f"lint: unknown checker(s) {unknown}; known: "
                f"{', '.join(CHECKERS)}", file=sys.stderr,
            )
            return 2
    root = os.path.abspath(args.root)
    project = Project(root)
    for err in project.errors:
        print(f"lint: {err}", file=sys.stderr)
    findings = run_checks(root, select=select, project=project)

    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    if args.update_baseline:
        Baseline.write(
            baseline_path, findings,
            existing=Baseline.load(baseline_path), select=select,
        )
        print(
            f"lint: wrote {len(findings)} suppression(s) to "
            f"{baseline_path} — fill in every empty 'reason' before "
            f"committing"
        )
        return 0
    baseline = (
        Baseline([], path=None) if args.no_baseline
        else Baseline.load(baseline_path)
    )
    new, baselined, stale, bad = baseline.split(findings, select=select)

    report = _report(
        root, select, findings, baseline, new, baselined, stale, bad
    )
    if args.json:
        payload = json.dumps(report, indent=1) + "\n"
        if args.json == "-":
            sys.stdout.write(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as fh:
                fh.write(payload)
    else:
        for f in new:
            loc = f"{f.path}:{f.line}" if f.line else f.path
            print(f"{loc}: [{f.check}] {f.message}")
        if baselined:
            print(f"lint: {len(baselined)} baselined finding(s)")
        for e in stale:
            print(
                f"lint: stale baseline entry {e.get('check')}:"
                f"{e.get('path')}:{e.get('symbol')} — remove it"
            )
    for e in bad:
        print(
            f"lint: baseline entry {e.get('check')}:{e.get('path')}:"
            f"{e.get('symbol')} has no justification 'reason'",
            file=sys.stderr,
        )
    if project.errors:
        return 2
    if new or bad:
        if new and not args.json:
            print(
                f"lint: {len(new)} new finding(s) — fix, suppress "
                f"inline (`# lint: ok[<check>] why`), or baseline "
                f"with --update-baseline + a written reason"
            )
        return 1
    if not args.json:
        print(
            f"lint OK: {len(CHECKERS) if not select else len(select)} "
            f"checker(s), 0 new finding(s), "
            f"{len(baselined)} baselined"
        )
    return 0


def add_lint_parser(sub) -> None:
    """The ``lint`` subcommand: the JAX CLI's positional and flags."""
    par = sub.add_parser(
        "lint",
        help="project-invariant static analysis of the port: lane-safety, "
        "kernel-hygiene, journal/metrics/flag/fault-site conformance; "
        "exits non-zero on any finding not in the committed baseline",
    )
    par.add_argument(
        "root", nargs="?", default=".",
        help="project root to analyze (default: current directory); the "
        "JAX package and bench.py under it are not scanned",
    )
    par.add_argument(
        "--select", metavar="ID[,ID...]",
        help="run only these checkers (see --list for ids)",
    )
    par.add_argument(
        "--list", action="store_true",
        help="enumerate checkers with one-line descriptions and exit",
    )
    par.add_argument(
        "--json", metavar="FILE",
        help="write the machine-readable report here ('-' = stdout)",
    )
    par.add_argument(
        "--baseline", metavar="FILE",
        help=f"baseline/suppression file (default: <root>/{BASELINE_NAME}"
        "); findings matching an entry don't fail the run",
    )
    par.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline file: report every finding as new",
    )
    par.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline from the current findings (every entry "
        "then needs a written 'reason' before the run passes)",
    )


def lint_main(argv: list[str] | None = None) -> int:
    """``python -m specpride_tpu_torch lint ...`` without the CLI, and
    without torch."""
    ap = argparse.ArgumentParser(prog="specpride_tpu_torch")
    add_lint_parser(ap.add_subparsers(dest="command", required=True))
    return main(ap.parse_args(argv))
