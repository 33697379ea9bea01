"""``fault-sites``: the declared fault-site tables vs the visit sites
actually compiled into the lanes.

Anchors: the module declaring ``SITES`` (and the executor subset
``EXECUTOR_SITES``; ``robustness/faults.py``), plus every
``<faults>.check("site")`` call whose receiver resolves to an import of
that module (or a bare ``check`` imported from it).

Rules, both directions:

1. every declared site has at least one literal visit call site — a
   site nobody visits makes ``--inject-faults site:...`` silently inert
   and the chaos CI matrix vacuous;
2. every literal site passed to a faults check is declared — a typo'd
   site would never fire.
"""

from __future__ import annotations

import ast

from specpride_tpu_torch.analysis.core import (
    Finding,
    Project,
    str_const,
    str_seq_resolved,
)

CHECK = "fault-sites"


def _declared(project: Project):
    hit = project.one_constant("SITES")
    if hit is None:
        return None
    mod, node, line = hit
    env = {}
    for name in ("EXECUTOR_SITES",):
        sub = project.one_constant(name)
        if sub is not None:
            _m, sub_node, _l = sub
            seq = str_seq_resolved(sub_node, {})
            if seq is not None:
                env[name] = seq
    sites = str_seq_resolved(node, env)
    if sites is None:
        return None
    return mod, list(sites), line


def _faults_aliases(project: Project, faults_mod_name: str):
    """Per-module local names bound to the faults module (import
    aliases) and to its ``check`` function (from-imports)."""
    mod_aliases: dict[str, set] = {}
    fn_aliases: dict[str, set] = {}
    for mod in project.modules:
        mods: set = set()
        fns: set = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == faults_mod_name:
                        mods.add(a.asname or a.name.split(".")[-1])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    if full == faults_mod_name:
                        mods.add(a.asname or a.name)
                    elif node.module == faults_mod_name and (
                        a.name == "check"
                    ):
                        fns.add(a.asname or a.name)
        mod_aliases[mod.name] = mods
        fn_aliases[mod.name] = fns
    return mod_aliases, fn_aliases


def run(project: Project) -> list[Finding]:
    decl = _declared(project)
    if decl is None:
        return []
    faults_mod, sites, decl_line = decl
    mod_aliases, fn_aliases = _faults_aliases(project, faults_mod.name)

    visited: dict[str, list] = {}
    findings: list[Finding] = []
    for mod in project.modules:
        if mod.name == faults_mod.name:
            continue  # the plan's own internals are not visit sites
        aliases = mod_aliases.get(mod.name, set())
        fns = fn_aliases.get(mod.name, set())
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            is_visit = (
                isinstance(f, ast.Attribute)
                and f.attr == "check"
                and isinstance(f.value, ast.Name)
                and f.value.id in aliases
            ) or (isinstance(f, ast.Name) and f.id in fns)
            if not is_visit:
                continue
            site = str_const(node.args[0])
            if site is None:
                continue
            visited.setdefault(site, []).append((mod, node.lineno))
            if site not in sites:
                findings.append(Finding(
                    check=CHECK, path=mod.rel, line=node.lineno,
                    symbol=f"{site}:undeclared",
                    message=(
                        f"fault visit site `{site}` is not declared "
                        f"in SITES — an injected fault there "
                        f"could never be armed"
                    ),
                ))
    for site in sites:
        if site not in visited:
            findings.append(Finding(
                check=CHECK, path=faults_mod.rel, line=decl_line,
                symbol=f"{site}:unvisited",
                message=(
                    f"SITES declares `{site}` but no lane ever "
                    f"visits it (`check(\"{site}\")`) — injection "
                    f"specs naming it are silently inert"
                ),
            ))
    return findings
