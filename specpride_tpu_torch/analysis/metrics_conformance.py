"""``metrics-conformance``: metric names vs the strict exposition
grammar, the docs catalog, and the pre-register-at-0 rule.

Collected from code:

* **registrations** — ``<registry>.counter/gauge/histogram("name", ...)``
  calls with a literal name (kind rules apply here);
* the **name universe** — every non-docstring string constant matching
  the project metric shape (``specpride_*``, excluding the package-name
  prefix ``specpride_tpu``), plus f-string registrations as
  prefix/suffix patterns — what the docs direction matches against.

Rules:

1. names match the Prometheus grammar and carry the project prefix;
2. counters end ``_total``; gauges/histograms do not; no name uses the
   reserved histogram suffixes ``_bucket``/``_sum``/``_count``;
3. one name, one kind (conflicting re-registration is schema drift the
   registry would reject at runtime — catch it at lint time);
4. every registered name is documented in ``docs/`` and every
   ``specpride_*`` metric token in the docs catalog resolves to a name
   (or f-string pattern) the code can actually register;
5. zero-at-start: counters/gauges named by the exporter's
   ``ZERO_AT_START_FAMILIES`` contract must be zero-initialized in
   the telemetry ``__init__`` — a drain snapshot must render 0-valued
   series, not absent ones.  The flight recorder's incident families
   (``specpride_incidents_*``, one series per detector in the v6
   catalog) ride this contract: "this detector never fired" must be
   an auditable 0, not an absent series.

A registration whose name is the loop variable of a ``for`` over a
module-level literal table of tuples (the exporter's
``_RESULT_CACHE_SERIES``) counts once for each name in the table, for
every rule above.
"""

from __future__ import annotations

import ast
import fnmatch
import re

from specpride_tpu_torch.analysis.core import (
    Finding,
    Project,
    str_const,
    str_seq_resolved,
    walk_no_docstrings,
)

CHECK = "metrics-conformance"

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_UNIVERSE_RE = re.compile(r"specpride_[a-z0-9_]+")
_RESERVED_SUFFIXES = ("_bucket", "_sum", "_count")
_KINDS = ("counter", "gauge", "histogram")

# every series this project exports carries the project prefix so a
# dashboard/alert namespace can never collide with another exporter's
METRIC_PREFIX = "specpride_"


class _Reg:
    def __init__(self, module, kind, name, line):
        self.module = module
        self.kind = kind
        self.name = name
        self.line = line


def _table_bound(tree) -> dict[int, list]:
    """``id(Name node) -> [str, ...]`` for every load of a ``for`` loop
    variable that iterates a module-level literal tuple or list of
    tuples of constants: the strings the name takes over the loop."""
    tables: dict[str, list] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
            isinstance(node.targets[0], ast.Name)
        ) and isinstance(node.value, (ast.Tuple, ast.List)):
            rows = []
            for elt in node.value.elts:
                if not isinstance(elt, ast.Tuple) or not all(
                    isinstance(e, ast.Constant) for e in elt.elts
                ):
                    break
                rows.append([e.value for e in elt.elts])
            else:
                tables[node.targets[0].id] = rows
    out: dict[int, list] = {}
    for loop in ast.walk(tree):
        if not (
            isinstance(loop, ast.For)
            and isinstance(loop.iter, ast.Name)
            and loop.iter.id in tables
        ):
            continue
        rows = tables[loop.iter.id]
        if isinstance(loop.target, ast.Name):
            slots = {loop.target.id: None}
        elif isinstance(loop.target, ast.Tuple) and all(
            isinstance(e, ast.Name) for e in loop.target.elts
        ):
            slots = {e.id: i for i, e in enumerate(loop.target.elts)}
        else:
            continue
        for var, i in slots.items():
            if i is None:
                continue  # the whole row, not a name
            values = [
                row[i] for row in rows
                if i < len(row) and isinstance(row[i], str)
            ]
            if len(values) != len(rows):
                continue
            for stmt in loop.body:
                for n in ast.walk(stmt):
                    if isinstance(n, ast.Name) and n.id == var and (
                        isinstance(n.ctx, ast.Load)
                    ):
                        out[id(n)] = values
    return out


def _names_of(node, bound: dict) -> list[str]:
    """The metric names a registration's first argument gives: a literal
    name, or each name a table-bound loop variable takes."""
    name = str_const(node)
    if name is not None:
        return [name]
    return bound.get(id(node), []) if isinstance(node, ast.Name) else []


def _registrations(project: Project):
    regs: list[_Reg] = []
    patterns: list[tuple] = []  # (prefix, suffix) from f-strings
    for mod in project.modules:
        bound = _table_bound(mod.tree)
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _KINDS
                and node.args
            ):
                continue
            names = _names_of(node.args[0], bound)
            if names:
                # ALL literal registrations collected — an unprefixed
                # name is exactly the drift the prefix rule must see
                regs.extend(
                    _Reg(mod, node.func.attr, name, node.lineno)
                    for name in names
                )
                continue
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                parts = arg.values
                prefix = (
                    parts[0].value
                    if parts and isinstance(parts[0], ast.Constant)
                    else ""
                )
                suffix = (
                    parts[-1].value
                    if len(parts) > 1
                    and isinstance(parts[-1], ast.Constant)
                    else ""
                )
                if str(prefix).startswith("specpride_"):
                    patterns.append((str(prefix), str(suffix)))
    return regs, patterns


def _universe(project: Project) -> set:
    names: set = set()
    for mod in project.modules:
        for node in walk_no_docstrings(mod.tree):
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                for m in _UNIVERSE_RE.finditer(node.value):
                    tok = m.group(0)
                    if not tok.startswith("specpride_tpu"):
                        names.add(tok)
    return names


def _doc_metric_tokens(project: Project):
    """``specpride_*`` metric tokens in the docs catalog, with their
    file/line.  Label suffixes (``name{kernel}``) strip; templated
    mentions (``specpride_run_<counter>_total``, brace alternation) and
    filesystem paths (``~/.cache/specpride_jax``) are skipped."""
    for rel, text in project.docs:
        for lineno, line in enumerate(text.splitlines(), 1):
            for m in re.finditer(r"specpride_[a-zA-Z0-9_<>]*", line):
                tok = m.group(0)
                if tok.startswith("specpride_tpu"):
                    continue
                if "<" in tok or ">" in tok:
                    continue  # templated family mention
                if m.start() > 0 and line[m.start() - 1] in "/.~$":
                    continue  # path or env-var tail, not a metric
                if tok.endswith("_") and line[m.end(): m.end() + 1] in (
                    "{", "*"
                ):
                    continue  # brace-alternation / glob family mention
                yield rel, lineno, tok


def _pre_register_check(project: Project) -> list[Finding]:
    hit = project.one_constant("ZERO_AT_START_FAMILIES")
    if hit is None:
        return []
    mod, node, line = hit
    families = str_seq_resolved(node, {}) or []
    bound = _table_bound(mod.tree)
    findings: list[Finding] = []
    # zero-inits live in __init__ bodies of this module's classes:
    # `<reg>.counter("name", ...).inc(0)` chains, or `self.x = r.counter
    # ("name", ...)` followed by `self.x.inc(0)` / `.set(0...)`
    zeroed: set = set()
    named_attrs: dict[str, str] = {}  # self attr -> metric name
    inits = [
        n for n in ast.walk(mod.tree)
        if isinstance(n, ast.FunctionDef) and n.name == "__init__"
    ]
    registered: dict[str, tuple] = {}  # name -> (line, kind)
    for init in inits:
        for node in ast.walk(init):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _KINDS
            ) and node.args:
                for name in _names_of(node.args[0], bound):
                    registered.setdefault(
                        name, (node.lineno, node.func.attr)
                    )
            # chained: r.counter("x", ...).inc(0) / .set(0)
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "inc", "set"
            ):
                inner = node.func.value
                zero_arg = (
                    node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value in (0, 0.0)
                )
                if not zero_arg:
                    # NB: a bare .inc() increments by 1 — that is the
                    # phantom-event miscount, not a zero-init
                    continue
                if isinstance(inner, ast.Call) and isinstance(
                    inner.func, ast.Attribute
                ) and inner.func.attr in _KINDS and inner.args:
                    zeroed.update(_names_of(inner.args[0], bound))
                elif isinstance(inner, ast.Attribute) and isinstance(
                    inner.value, ast.Name
                ) and inner.value.id == "self":
                    name = named_attrs.get(inner.attr)
                    if name:
                        zeroed.add(name)
        for stmt in ast.walk(init):
            if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call
            ) and isinstance(stmt.value.func, ast.Attribute) and (
                stmt.value.func.attr in _KINDS
            ) and stmt.value.args:
                name = str_const(stmt.value.args[0])
                for tgt in stmt.targets:
                    if name and isinstance(
                        tgt, ast.Attribute
                    ) and isinstance(tgt.value, ast.Name) and (
                        tgt.value.id == "self"
                    ):
                        named_attrs[tgt.attr] = name
        # second pass so attr zero-inits after the binding resolve
        for node in ast.walk(init):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in ("inc", "set"):
                zero_arg = (
                    node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value in (0, 0.0)
                )
                inner = node.func.value
                if zero_arg and isinstance(
                    inner, ast.Attribute
                ) and isinstance(inner.value, ast.Name) and (
                    inner.value.id == "self"
                ):
                    name = named_attrs.get(inner.attr)
                    if name:
                        zeroed.add(name)
    for name, (reg_line, kind) in sorted(registered.items()):
        if kind == "histogram":
            continue  # histograms appear with the first observe
        if any(
            fnmatch.fnmatchcase(name, fam) for fam in families
        ) and name not in zeroed:
            findings.append(Finding(
                check=CHECK, path=mod.rel, line=reg_line,
                symbol=f"{name}:pre-register",
                message=(
                    f"`{name}` matches ZERO_AT_START_FAMILIES but is "
                    f"never zero-initialized in __init__ — drain "
                    f"snapshots would omit the series instead of "
                    f"rendering 0"
                ),
            ))
    for fam in families:
        if not any(
            fnmatch.fnmatchcase(name, fam) for name in registered
        ):
            findings.append(Finding(
                check=CHECK, path=mod.rel, line=line,
                symbol=f"{fam}:family",
                message=(
                    f"ZERO_AT_START_FAMILIES pattern `{fam}` matches "
                    f"no registration in this module — stale contract"
                ),
            ))
    return findings


def run(project: Project) -> list[Finding]:
    regs, patterns = _registrations(project)
    if not regs:
        return []
    findings: list[Finding] = []
    kinds_by_name: dict[str, set] = {}
    for r in regs:
        kinds_by_name.setdefault(r.name, set()).add(r.kind)
        if not r.name.startswith(METRIC_PREFIX):
            findings.append(Finding(
                check=CHECK, path=r.module.rel, line=r.line,
                symbol=f"{r.name}:prefix",
                message=(
                    f"metric `{r.name}` lacks the project prefix "
                    f"`{METRIC_PREFIX}` — its series would collide "
                    f"with other exporters' namespaces"
                ),
            ))
        if not _NAME_RE.fullmatch(r.name):
            findings.append(Finding(
                check=CHECK, path=r.module.rel, line=r.line,
                symbol=f"{r.name}:grammar",
                message=(
                    f"metric name `{r.name}` violates the Prometheus "
                    f"name grammar"
                ),
            ))
        if r.kind == "counter" and not r.name.endswith("_total"):
            findings.append(Finding(
                check=CHECK, path=r.module.rel, line=r.line,
                symbol=f"{r.name}:suffix",
                message=(
                    f"counter `{r.name}` must end in `_total` "
                    f"(Prometheus counter convention)"
                ),
            ))
        if r.kind in ("gauge", "histogram") and r.name.endswith(
            "_total"
        ):
            findings.append(Finding(
                check=CHECK, path=r.module.rel, line=r.line,
                symbol=f"{r.name}:suffix",
                message=(
                    f"{r.kind} `{r.name}` must not end in `_total` — "
                    f"that suffix marks counters"
                ),
            ))
        if any(r.name.endswith(s) for s in _RESERVED_SUFFIXES):
            findings.append(Finding(
                check=CHECK, path=r.module.rel, line=r.line,
                symbol=f"{r.name}:reserved",
                message=(
                    f"metric `{r.name}` uses a reserved histogram "
                    f"suffix — scrapers will misparse the exposition"
                ),
            ))
    for name, kinds in sorted(kinds_by_name.items()):
        if len(kinds) > 1:
            first = next(r for r in regs if r.name == name)
            findings.append(Finding(
                check=CHECK, path=first.module.rel, line=first.line,
                symbol=f"{name}:kind-conflict",
                message=(
                    f"`{name}` is registered as {sorted(kinds)} in "
                    f"different places — the registry would raise at "
                    f"runtime"
                ),
            ))

    # docs coverage, both directions (only when a docs catalog exists)
    doc_tokens = list(_doc_metric_tokens(project))
    if doc_tokens:
        documented = {tok for _rel, _ln, tok in doc_tokens}

        def doc_has(name: str) -> bool:
            if name in documented:
                return True
            # histogram series are documented by their base name
            for s in _RESERVED_SUFFIXES:
                if name.endswith(s) and name[: -len(s)] in documented:
                    return True
            return False

        for r in regs:
            if not doc_has(r.name):
                findings.append(Finding(
                    check=CHECK, path=r.module.rel, line=r.line,
                    symbol=f"{r.name}:undocumented",
                    message=(
                        f"metric `{r.name}` is registered but appears "
                        f"nowhere in docs/ — add it to the catalog in "
                        f"docs/observability.md"
                    ),
                ))
        universe = _universe(project)
        for rel, lineno, tok in doc_tokens:
            base = tok
            for s in _RESERVED_SUFFIXES:
                if tok.endswith(s):
                    base = tok[: -len(s)]
            known = base in universe or any(
                base.startswith(p) and base.endswith(s)
                for p, s in patterns
            )
            if not known:
                findings.append(Finding(
                    check=CHECK, path=rel, line=lineno,
                    symbol=f"{tok}:stale-doc",
                    message=(
                        f"docs mention metric `{tok}` but no code "
                        f"registers or references that name"
                    ),
                ))
    findings += _pre_register_check(project)
    return findings
