"""``lane-safety``: attributes mutated from >= 2 lanes need a lock.

Builds the lane-annotated call graph (:mod:`analysis.callgraph`) from
the project's thread entry points — pack workers, the dedicated packer,
the H2D stager, the committer, serve worker/reader lanes, heartbeat and
fleet threads, HTTP handler threads, the implicit ``main`` dispatch
lane — then groups every ``self.attr`` / module-global mutation by its
owner and flags groups written from two or more distinct lanes where at
least one write sits outside a lock-protected ``with`` region.

Known limits (``docs/static-analysis.md`` describes the JAX package's
copy of this checker; the port's is the same): writes through local
aliases and closure cells (``busy[0] += ...``) are invisible;
happens-before edges other than locks (``Thread.join``, queue handoff)
are not modeled — annotate those sites with
``# lint: ok[lane-safety] <why>`` where the safety argument is real.
"""

from __future__ import annotations

import re

from specpride_tpu_torch.analysis.callgraph import CallGraph
from specpride_tpu_torch.analysis.core import Finding, Project

CHECK = "lane-safety"

_LOCK_ATTR_RE = re.compile(r"(?i)(lock|cond|mutex|sem|event)")

# writes in these methods happen before the object escapes to another
# lane (construction) or after every lane joined (teardown by
# convention is NOT exempt — joins are invisible to the analysis, so
# teardown writes need the inline annotation instead)
_INIT_METHODS = frozenset({"__init__", "__new__", "__post_init__"})


def run(project: Project) -> list[Finding]:
    graph = CallGraph(project)
    # A class is "synchronized" when it owns a lock: some method takes a
    # lock-ish `with`, or some write is already lock-guarded, or an
    # attribute is lock-named.  Only synchronized classes are eligible —
    # a class with no lock at all is taken as lane-confined by design
    # (per-run/per-job instances never escape their lane), which the
    # analysis cannot distinguish from a missing lock; the docs name
    # this as the checker's main known limit.  Module globals are
    # process-shared by construction and always eligible.
    sync_classes: set[str] = set()
    for fi in graph.functions.values():
        if fi.cls and fi.uses_lock:
            sync_classes.add(f"{fi.module.name}:{fi.cls}")
        for w in fi.writes:
            if w.owner and (
                w.guarded
                or _LOCK_ATTR_RE.search(w.attr.rsplit(".", 1)[-1])
            ):
                sync_classes.add(w.owner)

    # group mutations: (owner, attr) -> [WriteSite]
    groups: dict[tuple, list] = {}
    for fi in graph.functions.values():
        for w in fi.writes:
            if _LOCK_ATTR_RE.search(w.attr.rsplit(".", 1)[-1]):
                continue  # the lock objects themselves
            if w.owner and w.owner not in sync_classes:
                continue
            groups.setdefault((w.owner, w.attr), []).append(w)

    findings: list[Finding] = []
    for (owner, attr), writes in sorted(groups.items()):
        lanes: set[str] = set()
        for w in writes:
            if w.fn.node.name in _INIT_METHODS:
                continue
            lanes.update(w.fn.lanes)
        if len(lanes) < 2:
            continue
        unguarded = [
            w for w in writes
            if not w.guarded and w.fn.node.name not in _INIT_METHODS
            # `_foo_locked` names the caller-holds-the-lock convention:
            # the lock region is real, just not lexical here
            and not w.fn.node.name.endswith("_locked")
        ]
        if not unguarded:
            continue
        target = f"{owner}.{attr}" if owner else attr
        lane_list = ", ".join(sorted(lanes))
        for w in unguarded:
            findings.append(Finding(
                check=CHECK, path=w.module.rel, line=w.line,
                symbol=target.split(":")[-1],
                message=(
                    f"`{target.split(':')[-1]}` is mutated from lanes "
                    f"[{lane_list}] but this write is outside any "
                    f"lock-protected region"
                ),
            ))
    return findings
