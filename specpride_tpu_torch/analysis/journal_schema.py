"""``journal-schema``: the journal event schema, its emit sites, the
docs event table, and every renderer literal must agree.

Anchors (convention-discovered):

* ``EVENT_SCHEMA`` — the authoritative ``{event: frozenset(required)}``
  module-level table (``observability/journal.py``).
* emit sites — every ``<journal>.emit(...)`` call whose first argument
  is a literal event name.
* the docs event table — the markdown table in
  ``docs/observability.md`` whose header's first cell is ``event``
  (payload cell: required fields before a ``plus`` marker).
* renderer literals — any comparison of ``x["event"]`` /
  ``x.get("event")`` against string constants anywhere in the project
  (``stats_cli``, audits, exporters).

Checked, in both directions: emitted events exist in the schema and
carry every required field (when the kwargs are statically visible and
no ``**`` passthrough hides them); schema events are documented with
exactly the schema's required payload; documented events exist in the
schema; renderer literals name real events.

The version-gated tables (``GATED``) get the same treatment on top:
``TRACE_EVENT_SCHEMA`` (v4, the causal trace envelope: ``trace_id`` on
the serving job events, ``trace_ids`` on ``batch_dispatch``),
``V5_EVENT_SCHEMA`` (``chunk_s`` on ``heartbeat``, which the autotune
signal fold reads) and ``V6_EVENT_SCHEMA`` (``incident_id`` and
``evidence`` on ``incident``, which ``incident-replay`` re-derives
firings from).  Every statically visible emit site must pass their
fields, and the docs row must at least mention each one (required or
behind the ``plus`` marker).  Gated tables keep old journals valid while
no new emit site can drop a field.
"""

from __future__ import annotations

import ast

from specpride_tpu_torch.analysis.core import (
    Finding,
    Project,
    dict_of_str_sets,
    has_starstar,
    parse_event_table,
    str_const,
)

CHECK = "journal-schema"

_DOC = "docs/observability.md"

# (anchor, symbol tag, what the fields are, why an emit needs them)
GATED = (
    ("TRACE_EVENT_SCHEMA", "trace", "v4 trace-envelope fields",
     "an untraceable serving event breaks the cross-process causal "
     "join"),
    ("V5_EVENT_SCHEMA", "v5", "v5 fields",
     "the autotune signal fold depends on them"),
    ("V6_EVENT_SCHEMA", "v6", "v6 fields",
     "incident-replay re-derives firings from them"),
)


def _table(project: Project, name: str):
    """``(module, {event: fields}, line)`` of the unique module-level
    ``name`` table, or None when the project declares none (or two)."""
    hit = project.one_constant(name)
    if hit is None:
        return None
    mod, node, line = hit
    table = dict_of_str_sets(node)
    if table is None:
        return None
    return mod, {k: v for k, v in table.items() if v is not None}, line


def _emit_sites(project: Project):
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit"
                and node.args
            ):
                continue
            event = str_const(node.args[0])
            if event is None:
                continue
            kwargs = {kw.arg for kw in node.keywords if kw.arg}
            yield mod, node, event, kwargs, has_starstar(node)


def _event_literal_comparisons(project: Project):
    """String constants compared against ``x["event"]`` /
    ``x.get("event")`` anywhere in the project."""

    def is_event_access(n) -> bool:
        if isinstance(n, ast.Subscript):
            return str_const(n.slice) == "event"
        if isinstance(n, ast.Call) and isinstance(
            n.func, ast.Attribute
        ) and n.func.attr == "get" and n.args:
            return str_const(n.args[0]) == "event"
        return False

    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left] + list(node.comparators)
            if not any(is_event_access(s) for s in sides):
                continue
            for s in sides:
                lit = str_const(s)
                if lit is not None:
                    yield mod, node.lineno, lit
                for elt in getattr(s, "elts", []):
                    lit = str_const(elt)
                    if lit is not None:
                        yield mod, node.lineno, lit


def run(project: Project) -> list[Finding]:
    anchor = _table(project, "EVENT_SCHEMA")
    if anchor is None:
        return []
    _schema_mod, schema, _schema_line = anchor
    gated = []
    for name, tag, what, why in GATED:
        hit = _table(project, name)
        if hit is not None:
            gated.append((name, tag, what, why, hit[1]))
    findings: list[Finding] = []

    # 1. emit sites vs schema (and the gated tables)
    for mod, node, event, kwargs, passthrough in _emit_sites(project):
        if event not in schema:
            findings.append(Finding(
                check=CHECK, path=mod.rel, line=node.lineno,
                symbol=f"emit:{event}",
                message=(
                    f"emitted event `{event}` is not in EVENT_SCHEMA"
                ),
            ))
            continue
        if passthrough:
            continue  # **fields forwarding: kwargs not statically visible
        missing = sorted(schema[event] - kwargs)
        if missing:
            findings.append(Finding(
                check=CHECK, path=mod.rel, line=node.lineno,
                symbol=f"emit:{event}:fields",
                message=(
                    f"emit of `{event}` is missing required fields "
                    f"{missing} (EVENT_SCHEMA)"
                ),
            ))
        for name, tag, what, why, table in gated:
            absent = sorted(table.get(event, set()) - kwargs)
            if absent:
                findings.append(Finding(
                    check=CHECK, path=mod.rel, line=node.lineno,
                    symbol=f"emit:{event}:{tag}",
                    message=(
                        f"emit of `{event}` is missing the {what} "
                        f"{absent} ({name}) — {why}"
                    ),
                ))

    # 2. docs table vs schema, both directions + payload equality
    doc_text = project.doc(_DOC)
    table = parse_event_table(doc_text) if doc_text is not None else {}
    if table:
        for event, fields in sorted(schema.items()):
            row = table.get(event)
            if row is None:
                findings.append(Finding(
                    check=CHECK, path=_DOC, line=0,
                    symbol=f"doc:{event}",
                    message=(
                        f"event `{event}` is in EVENT_SCHEMA but has no "
                        f"row in the {_DOC} event table"
                    ),
                ))
                continue
            if row["required"] != fields:
                missing = sorted(fields - row["required"])
                extra = sorted(row["required"] - fields)
                detail = []
                if missing:
                    detail.append(f"missing {missing}")
                if extra:
                    detail.append(
                        f"lists non-required {extra} (move behind a "
                        f"`plus` marker if optional)"
                    )
                findings.append(Finding(
                    check=CHECK, path=_DOC, line=row["line"],
                    symbol=f"doc:{event}:fields",
                    message=(
                        f"{_DOC} row for `{event}` disagrees with "
                        f"EVENT_SCHEMA: {'; '.join(detail)}"
                    ),
                ))
        for event, row in sorted(table.items()):
            if event not in schema:
                findings.append(Finding(
                    check=CHECK, path=_DOC, line=row["line"],
                    symbol=f"doc:{event}:unknown",
                    message=(
                        f"{_DOC} documents event `{event}` which is not "
                        f"in EVENT_SCHEMA"
                    ),
                ))
        # gated fields: the documented row must at least MENTION each
        # (required, or optional behind the `plus` marker — they are
        # version-gated, so either placement is legitimate; silence is
        # not)
        for name, tag, what, _why, gated_table in gated:
            for event, fields in sorted(gated_table.items()):
                row = table.get(event)
                if row is None:
                    continue  # the missing-row finding above covers it
                absent = sorted(fields - row.get("mentioned", set()))
                if absent:
                    findings.append(Finding(
                        check=CHECK, path=_DOC, line=row["line"],
                        symbol=f"doc:{event}:{tag}",
                        message=(
                            f"{_DOC} row for `{event}` does not mention "
                            f"the {what} {absent} ({name})"
                        ),
                    ))

    # 3. renderer literals vs schema
    for mod, line, lit in _event_literal_comparisons(project):
        if lit not in schema:
            findings.append(Finding(
                check=CHECK, path=mod.rel, line=line,
                symbol=f"render:{lit}",
                message=(
                    f"event literal `{lit}` compared against "
                    f"x[\"event\"] is not in EVENT_SCHEMA — stale "
                    f"renderer or typo"
                ),
            ))
    return findings
