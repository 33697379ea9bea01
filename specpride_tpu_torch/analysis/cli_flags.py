"""``cli-flags``: the parser, the job-refused tables, and the docs must
agree on every flag.

Anchors: all ``add_argument("--flag", ...)`` calls (the parser), the
``JOB_REFUSED_FLAGS`` tuple and its ``_JOB_REFUSED_DESTS`` mirror
(``serve/protocol.py``), and the ``docs/``/README markdown.

Rules:

1. every ``JOB_REFUSED_FLAGS`` entry is a real parser flag — a stale
   entry silently stops protecting the daemon boot config;
2. ``JOB_REFUSED_FLAGS`` and ``_JOB_REFUSED_DESTS`` are exact mirrors
   under argparse dest derivation (the prefix-spelling scan and the
   parsed-namespace scan must cover the same set).  The mirror is either
   a literal copy or derived from ``JOB_REFUSED_FLAGS`` by one
   comprehension over it whose element is built from the flag by
   slicing, ``lstrip``/``strip`` and ``replace`` with literal arguments:
   that expression is evaluated on every flag, so a derivation that is
   not the dest rule still shows as missing or stale dests.  A mirror of
   any other form reads as empty, and every dest is missing;
3. every long flag the parser defines appears literally (as
   ``--flag``) somewhere in ``docs/*.md`` or ``README.md``;
4. no flag is defined twice with the same spelling on one subparser
   (argparse raises at runtime — catch it at lint time).
"""

from __future__ import annotations

import ast
import re

from specpride_tpu_torch.analysis.core import (
    Finding,
    Project,
    flag_to_dest,
    str_const,
    str_seq_resolved,
)

CHECK = "cli-flags"

_STR_METHODS = frozenset({"lstrip", "rstrip", "strip", "replace"})


def _apply(expr, var: str, value: str) -> str | None:
    """``expr`` evaluated with ``var`` bound to ``value``, where it is
    built only from that name, constant slices and the literal-argument
    string methods in ``_STR_METHODS``; None for any other form."""
    if isinstance(expr, ast.Name):
        return value if expr.id == var else None
    if isinstance(expr, ast.Subscript) and isinstance(expr.slice, ast.Slice):
        base = _apply(expr.value, var, value)
        bounds = []
        for b in (expr.slice.lower, expr.slice.upper, expr.slice.step):
            if b is None:
                bounds.append(None)
            elif isinstance(b, ast.Constant) and type(b.value) is int:
                bounds.append(b.value)
            else:
                return None
        return None if base is None else base[slice(*bounds)]
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in _STR_METHODS
        and not expr.keywords
    ):
        base = _apply(expr.func.value, var, value)
        args = [str_const(a) for a in expr.args]
        if base is None or None in args:
            return None
        return getattr(base, expr.func.attr)(*args)
    return None


def _derived(node, source: str, flags: list[str]) -> list[str] | None:
    """The dests of a mirror derived from ``source`` by one comprehension
    (optionally wrapped in ``tuple``/``frozenset``/...), or None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and (
        node.func.id in ("tuple", "frozenset", "set", "list", "sorted")
    ) and len(node.args) == 1 and not node.keywords:
        node = node.args[0]
    if not isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
        return None
    if len(node.generators) != 1:
        return None
    gen = node.generators[0]
    if gen.ifs or gen.is_async or not isinstance(gen.target, ast.Name):
        return None
    if not (isinstance(gen.iter, ast.Name) and gen.iter.id == source):
        return None
    out = [_apply(node.elt, gen.target.id, f) for f in flags]
    return None if None in out else out


def _parser_flags(project: Project):
    """Every literal ``--flag`` passed to an ``add_argument`` call:
    flag -> (module, first line)."""
    flags: dict[str, tuple] = {}
    per_parser: dict[tuple, list] = {}
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
            ):
                continue
            receiver = ast.unparse(node.func.value)
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ) and arg.value.startswith("--"):
                    flags.setdefault(arg.value, (mod, node.lineno))
                    per_parser.setdefault(
                        (mod.name, receiver, arg.value), []
                    ).append((mod, node.lineno))
    return flags, per_parser


def run(project: Project) -> list[Finding]:
    flags, per_parser = _parser_flags(project)
    if not flags:
        return []
    findings: list[Finding] = []
    for (mod_name, receiver, flag), sites in sorted(per_parser.items()):
        if len(sites) > 1:
            mod, line = sites[1]
            findings.append(Finding(
                check=CHECK, path=mod.rel, line=line,
                symbol=f"{flag}:duplicate",
                message=(
                    f"`{flag}` is added twice to parser `{receiver}` "
                    f"— argparse raises at runtime"
                ),
            ))

    daemon_hit = project.one_constant("JOB_REFUSED_FLAGS")
    dests_hit = project.one_constant("_JOB_REFUSED_DESTS")
    if daemon_hit is not None:
        dmod, dnode, dline = daemon_hit
        daemon_flags = str_seq_resolved(dnode, {}) or []
        for flag in daemon_flags:
            if flag not in flags:
                findings.append(Finding(
                    check=CHECK, path=dmod.rel, line=dline,
                    symbol=f"{flag}:unknown",
                    message=(
                        f"JOB_REFUSED_FLAGS lists `{flag}` but no "
                        f"parser defines it — stale protection"
                    ),
                ))
        if dests_hit is not None:
            omod, onode, oline = dests_hit
            dests = set(
                str_seq_resolved(onode, {})
                or _derived(onode, "JOB_REFUSED_FLAGS", daemon_flags)
                or []
            )
            want = {flag_to_dest(f) for f in daemon_flags}
            for dest in sorted(want - dests):
                findings.append(Finding(
                    check=CHECK, path=omod.rel, line=oline,
                    symbol=f"{dest}:dest-missing",
                    message=(
                        f"_JOB_REFUSED_DESTS is missing `{dest}` "
                        f"(from JOB_REFUSED_FLAGS) — prefix spellings "
                        f"like `--layou` would slip past the scan"
                    ),
                ))
            for dest in sorted(dests - want):
                findings.append(Finding(
                    check=CHECK, path=omod.rel, line=oline,
                    symbol=f"{dest}:dest-stale",
                    message=(
                        f"_JOB_REFUSED_DESTS lists `{dest}` with no "
                        f"matching JOB_REFUSED_FLAGS entry"
                    ),
                ))

    # docs coverage: every long flag documented somewhere.  Token
    # match, not substring — docs naming only `--poll-interval` must
    # not count as documenting a `--poll` flag.
    if project.docs:
        corpus = "\n".join(text for _rel, text in project.docs)
        documented = set(re.findall(r"--[a-zA-Z][\w-]*", corpus))
        for flag, (mod, line) in sorted(flags.items()):
            if flag not in documented:
                findings.append(Finding(
                    check=CHECK, path=mod.rel, line=line,
                    symbol=f"{flag}:undocumented",
                    message=(
                        f"flag `{flag}` is not documented anywhere "
                        f"under docs/ or README.md"
                    ),
                ))
    return findings
