"""The port's ``lint`` (``specpride_tpu_torch.analysis``) against the JAX
package's (``specpride_tpu.analysis``).

Every fixture tree of ``tests/test_lint.py`` is written here once, with
``@NAME@`` placeholders for the lint anchors, and rendered twice: with
the JAX anchor names for the JAX ``run_checks`` and with the port's for
the port's.  The shared checkers must give the same findings by
``(check, path, symbol)``; ``jit-hygiene`` is the JAX package's alone and
``kernel-hygiene`` the port's, which has a tripping fixture and a clean
twin per rule.  The baseline and report semantics run through both
packages, and the real tree lints clean against
``lint-baseline.torch.json``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from specpride_tpu import cli as jcli
from specpride_tpu.analysis import checker_ids as jax_checker_ids
from specpride_tpu.analysis import run_checks as jax_run_checks
from specpride_tpu.analysis.baseline import Baseline as JaxBaseline
from specpride_tpu.analysis.core import Finding as JaxFinding
from specpride_tpu_torch.analysis import checker_ids, run_checks
from specpride_tpu_torch.analysis import kernel_hygiene
from specpride_tpu_torch.analysis.baseline import BASELINE_NAME, Baseline
from specpride_tpu_torch.analysis.core import Finding, Project
from specpride_tpu_torch.analysis.runner import lint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX anchor -> the port's (the port's file in ANCHOR_FILES)
PORT_NAMES = {
    "EVENT_FIELDS": "EVENT_SCHEMA",
    "TRACE_EVENT_FIELDS": "TRACE_EVENT_SCHEMA",
    "V5_EVENT_FIELDS": "V5_EVENT_SCHEMA",
    "V6_EVENT_FIELDS": "V6_EVENT_SCHEMA",
    "FAULT_SITES": "SITES",
    "EXECUTOR_FAULT_SITES": "EXECUTOR_SITES",
    "DAEMON_ONLY_FLAGS": "JOB_REFUSED_FLAGS",
    "_DAEMON_OWNED_DESTS": "_JOB_REFUSED_DESTS",
    "_BUILDERS": "_WARM_BUILDERS",
    "PRE_REGISTERED_FAMILIES": "ZERO_AT_START_FAMILIES",
}
JAX_NAMES = {name: name for name in PORT_NAMES}
ANCHOR_FILES = {
    "EVENT_SCHEMA": "observability/journal.py",
    "TRACE_EVENT_SCHEMA": "observability/journal.py",
    "V5_EVENT_SCHEMA": "observability/journal.py",
    "V6_EVENT_SCHEMA": "observability/journal.py",
    "SITES": "robustness/faults.py",
    "EXECUTOR_SITES": "robustness/faults.py",
    "JOB_REFUSED_FLAGS": "serve/protocol.py",
    "_JOB_REFUSED_DESTS": "serve/protocol.py",
    "_WARM_BUILDERS": "warmstart/registry.py",
    "ZERO_AT_START_FAMILIES": "observability/exporter.py",
}
# the checkers both packages have
SHARED = ["lane-safety", "journal-schema", "metrics-conformance",
          "cli-flags", "fault-sites"]


def render(text: str, names: dict) -> str:
    return re.sub(r"@(\w+)@", lambda m: names[m.group(1)], text)


def write_tree(root, files: dict, names: dict) -> str:
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(render(textwrap.dedent(text), names))
    return str(root)


def keys(findings) -> set:
    return {(f.check, f.path, f.symbol) for f in findings}


# -- fixture sources (tests/test_lint.py's, anchors as placeholders) -----

LANE_BAD = """
    import threading

    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self.hits = 0
            self._t = threading.Thread(
                target=self._run, name="fix-worker", daemon=True
            )

        def _run(self):
            while True:
                self.hits += 1  # unguarded, also written from main

        def bump(self):
            self.hits += 1

    def cmd_main():
        c = Counter()
        c.bump()
"""

LANE_GOOD = LANE_BAD.replace(
    """\
        def _run(self):
            while True:
                self.hits += 1  # unguarded, also written from main

        def bump(self):
            self.hits += 1
""",
    """\
        def _run(self):
            while True:
                with self._lock:
                    self.hits += 1

        def bump(self):
            with self._lock:
                self.hits += 1
""",
)

JIT_OPS = """
    from fix.ops.jit_util import jit_pair

    def _kernel(x, *, cap, impl):
        return x

    kernel_packed, kernel_packed_donated = jit_pair(
        _kernel, static_argnames=("cap", "impl"), donate_argnums=(0,)
    )
"""

JIT_UTIL = """
    import jax

    def jit_pair(fn, static_argnames, donate_argnums):
        plain = jax.jit(fn, static_argnames=static_argnames)
        donated = jax.jit(
            fn, static_argnames=static_argnames,
            donate_argnums=donate_argnums,
        )
        return plain, donated
"""

JIT_REGISTRY_BAD = """
    from fix.ops import kernels

    def _kernel_packed(entry, donate):
        avals = ()
        statics = dict(cap=entry.shape_key[0])
        fn = (
            kernels.kernel_packed_donated if donate
            else kernels.kernel_packed
        )
        return fn, avals, statics

    @_BUILDERS@ = {
        "kernel_packed": _kernel_packed,
    }
"""

JIT_REGISTRY_GOOD = JIT_REGISTRY_BAD.replace(
    "statics = dict(cap=entry.shape_key[0])",
    "statics = dict(cap=entry.shape_key[0], impl='scan')",
)

JOURNAL_MOD = """
    @EVENT_FIELDS@ = {
        "run_start": frozenset({"command"}),
        "run_end": frozenset({"elapsed_s"}),
    }

    class Journal:
        def emit(self, event, **fields):
            return {}
"""

JOURNAL_EMIT_BAD = """
    def go(journal):
        journal.emit("run_start", command="x")
        journal.emit("run_stop")  # unknown event
        journal.emit("run_end")   # missing elapsed_s
"""

JOURNAL_EMIT_GOOD = """
    def go(journal):
        journal.emit("run_start", command="x")
        journal.emit("run_end", elapsed_s=1.0)

    def render(events):
        return [e for e in events if e["event"] == "run_end"]
"""

DOC_EVENTS_GOOD = """
    # Events

    | event | payload (required) | meaning |
    |---|---|---|
    | `run_start` | `command` | run began |
    | `run_end` | `elapsed_s` (plus `counters`) | run finished |
"""

DOC_EVENTS_BAD = """
    # Events

    | event | payload (required) | meaning |
    |---|---|---|
    | `run_start` | `command`, `n_clusters` | run began |
    | `run_finish` | `elapsed_s` | stale row |
"""

METRICS_BAD = """
    def build(r):
        r.counter("specpride_fix_jobs", "no _total suffix")
        r.gauge("specpride_fix_depth_total", "gauge with _total")
"""

METRICS_GOOD = """
    def build(r):
        r.counter("specpride_fix_jobs_total", "jobs")
        r.gauge("specpride_fix_depth", "depth")
"""

DOC_METRICS_GOOD = """
    # Metrics

    - `specpride_fix_jobs_total` — jobs
    - `specpride_fix_depth` — queue depth
"""

FLAGS_MOD_BAD = """
    @DAEMON_ONLY_FLAGS@ = ("--layout", "--vanished")
    @_DAEMON_OWNED_DESTS@ = ("layout", "stale_dest")
"""

FLAGS_MOD_GOOD = """
    @DAEMON_ONLY_FLAGS@ = ("--layout",)
    @_DAEMON_OWNED_DESTS@ = ("layout",)
"""

FLAGS_PARSER = """
    import argparse

    def build():
        ap = argparse.ArgumentParser()
        ap.add_argument("--layout", choices=["auto", "flat"])
        return ap
"""

DOC_FLAGS = """
    # Flags

    - `--layout` — device layout
"""

FAULTS_MOD = """
    @EXECUTOR_FAULT_SITES@ = ("parse", "write")
    @FAULT_SITES@ = @EXECUTOR_FAULT_SITES@ + ("cas",)

    def check(site):
        pass
"""

FAULTS_VISITS_BAD = """
    from fix.robustness import faults

    def run():
        faults.check("parse")
        faults.check("wrong_site")
        # "write" and "cas" never visited
"""

FAULTS_VISITS_GOOD = """
    from fix.robustness import faults

    def run():
        faults.check("parse")
        faults.check("write")
        faults.check("cas")
"""


def base_fixture(good: bool) -> dict:
    """A miniature project exercising every checker's anchors; ``good``
    selects the violation-free variant of each artifact."""
    return {
        "fix/__init__.py": "",
        "fix/lanes.py": LANE_GOOD if good else LANE_BAD,
        "fix/ops/__init__.py": "",
        "fix/ops/jit_util.py": JIT_UTIL,
        "fix/ops/kernels.py": JIT_OPS,
        "fix/registry.py": (
            JIT_REGISTRY_GOOD if good else JIT_REGISTRY_BAD
        ),
        "fix/journal.py": JOURNAL_MOD,
        "fix/emitter.py": (
            JOURNAL_EMIT_GOOD if good else JOURNAL_EMIT_BAD
        ),
        "fix/metrics.py": METRICS_GOOD if good else METRICS_BAD,
        "fix/protocol.py": FLAGS_MOD_GOOD if good else FLAGS_MOD_BAD,
        "fix/parser.py": FLAGS_PARSER,
        "fix/robustness/__init__.py": "",
        "fix/robustness/faults.py": FAULTS_MOD,
        "fix/visits.py": (
            FAULTS_VISITS_GOOD if good else FAULTS_VISITS_BAD
        ),
        "docs/observability.md": (
            DOC_EVENTS_GOOD if good else DOC_EVENTS_BAD
        ) + DOC_METRICS_GOOD,
        "docs/cli.md": DOC_FLAGS,
    }


def _gated(anchor: str, event: str, required: str, field: str,
           fixed: bool) -> dict:
    """The v4 / v5 / v6 journal cases: an emit of ``event`` and its docs
    row, missing ``field`` of the gated table ``anchor``, or (``fixed``)
    carrying it and mentioning it behind ``plus``."""
    files = base_fixture(good=True)
    files["fix/journal.py"] = f"""
        @EVENT_FIELDS@ = {{
            "run_start": frozenset({{"command"}}),
            "run_end": frozenset({{"elapsed_s"}}),
            "{event}": frozenset({{"{required}"}}),
        }}

        @{anchor}@ = {{
            "{event}": frozenset({{"{field}"}}),
        }}

        class Journal:
            def emit(self, event, **fields):
                return {{}}
    """
    extra = f", {field}=v" if fixed else ""
    files["fix/emitter.py"] = f"""
        def go(journal, v):
            journal.emit("run_start", command="x")
            journal.emit("run_end", elapsed_s=1.0)
            journal.emit("{event}", {required}=1{extra})
    """
    cell = (f"`{required}` (plus `{field}`)" if fixed
            else f"`{required}`")
    files["docs/observability.md"] = f"""
        # Events

        | event | payload (required) | meaning |
        |---|---|---|
        | `run_start` | `command` | run began |
        | `run_end` | `elapsed_s` (plus `counters`) | run finished |
        | `{event}` | {cell} | gated |
    """ + DOC_METRICS_GOOD
    return files


def _stale_renderer():
    files = base_fixture(good=True)
    files["fix/emitter.py"] = textwrap.dedent(JOURNAL_EMIT_GOOD) + (
        textwrap.dedent("""
        def render_stale(events):
            return [e for e in events if e.get("event") == "gone"]
        """))
    return files


EXPORTER = """
    @PRE_REGISTERED_FAMILIES@ = ("specpride_fix_batch_*",)

    class Telemetry:
        def __init__(self, r):
            self.batch = r.counter(
                "specpride_fix_batch_total", "batched work"
            )
            {zero}

        def sync_singletons(self):
            pass
"""


def _exporter(zero: str):
    files = base_fixture(good=True)
    files["fix/exporter.py"] = EXPORTER.replace("{zero}", zero)
    files["docs/observability.md"] += (
        "\n- `specpride_fix_batch_total` — batch counter\n"
    )
    return files


def _parser_with(flag_line: str, doc_extra: str = ""):
    files = base_fixture(good=True)
    files["fix/parser.py"] = FLAGS_PARSER.replace(
        'ap.add_argument("--layout", choices=["auto", "flat"])',
        'ap.add_argument("--layout", choices=["auto", "flat"])\n'
        f'        {flag_line}',
    )
    files["docs/cli.md"] = DOC_FLAGS + doc_extra
    return files


def _inline_suppression():
    files = base_fixture(good=False)
    files["fix/lanes.py"] = LANE_BAD.replace(
        "self.hits += 1  # unguarded, also written from main",
        "self.hits += 1  # lint: ok[lane-safety] fixture proves "
        "suppression",
    ).replace(
        "            self.hits += 1\n\n    def cmd_main",
        "            self.hits += 1  # lint: ok[lane-safety] fixture\n"
        "\n    def cmd_main",
    )
    return files


def _nested_threads():
    files = base_fixture(good=True)
    files["fix/lanes.py"] = """
        import threading

        class Shared:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                self.count += 1

        def cmd_pipeline(shared):
            def _worker():
                while True:
                    shared.bump()

            t = threading.Thread(
                target=_worker, name="fix-nested-worker", daemon=True
            )
            t.start()
            shared.bump()
    """
    return files


def _metrics_prefix():
    files = base_fixture(good=True)
    files["fix/metrics.py"] = METRICS_GOOD.replace(
        'r.gauge("specpride_fix_depth", "depth")',
        'r.gauge("specpride_fix_depth", "depth")\n'
        '    r.counter("h2d_bytes_total", "missing project prefix")',
    )
    return files


def _jit_orphan():
    files = base_fixture(good=True)
    files["fix/ops/kernels.py"] = textwrap.dedent(JIT_OPS) + (
        textwrap.dedent("""
        import numpy as np
        from fix.ops.jit_util import jit_pair

        def _orphan(x, *, cap):
            return float(np.asarray(x).sum())

        orphan_kernel, orphan_kernel_donated = jit_pair(
            _orphan, static_argnames=("cap",), donate_argnums=(0,)
        )
        """))
    return files


# id -> (files, checkers run, symbols both must find, symbols the JAX
# jit-hygiene must find, whether the checkers run must find nothing)
CASES = {
    "seeded": (
        lambda: base_fixture(good=False), SHARED,
        {"emit:run_stop", "emit:run_end:fields", "doc:run_start:fields",
         "doc:run_finish:unknown", "doc:run_end",
         "specpride_fix_jobs:suffix", "specpride_fix_depth_total:suffix",
         "--vanished:unknown", "stale_dest:dest-stale",
         "vanished:dest-missing", "wrong_site:undeclared",
         "write:unvisited", "cas:unvisited", "Counter.hits"},
        {"kernel_packed:statics"}, False,
    ),
    "clean": (lambda: base_fixture(good=True), None, set(), set(), True),
    "trace-missing": (
        lambda: _gated("TRACE_EVENT_FIELDS", "job_done", "job_id",
                       "trace_id", False),
        ["journal-schema"], {"emit:job_done:trace", "doc:job_done:trace"},
        set(), False,
    ),
    "trace-fixed": (
        lambda: _gated("TRACE_EVENT_FIELDS", "job_done", "job_id",
                       "trace_id", True),
        ["journal-schema"], set(), set(), True,
    ),
    "v5-missing": (
        lambda: _gated("V5_EVENT_FIELDS", "heartbeat", "rank", "chunk_s",
                       False),
        ["journal-schema"], {"emit:heartbeat:v5", "doc:heartbeat:v5"},
        set(), False,
    ),
    "v5-fixed": (
        lambda: _gated("V5_EVENT_FIELDS", "heartbeat", "rank", "chunk_s",
                       True),
        ["journal-schema"], set(), set(), True,
    ),
    "v6-missing": (
        lambda: _gated("V6_EVENT_FIELDS", "incident", "detector",
                       "incident_id", False),
        ["journal-schema"], {"emit:incident:v6", "doc:incident:v6"},
        set(), False,
    ),
    "v6-fixed": (
        lambda: _gated("V6_EVENT_FIELDS", "incident", "detector",
                       "incident_id", True),
        ["journal-schema"], set(), set(), True,
    ),
    "no-gated-tables": (
        lambda: base_fixture(good=True), ["journal-schema"], set(), set(),
        True,
    ),
    "stale-renderer": (
        _stale_renderer, ["journal-schema"], {"render:gone"}, set(),
        False,
    ),
    "pre-register-missing": (
        lambda: _exporter("pass"), ["metrics-conformance"],
        {"specpride_fix_batch_total:pre-register"}, set(), False,
    ),
    "pre-register-zeroed": (
        lambda: _exporter("self.batch.inc(0)"), ["metrics-conformance"],
        set(), set(), True,
    ),
    "pre-register-bare-inc": (
        lambda: _exporter("self.batch.inc()"), ["metrics-conformance"],
        {"specpride_fix_batch_total:pre-register"}, set(), False,
    ),
    "undocumented-flag": (
        lambda: _parser_with('ap.add_argument("--mystery", type=int)'),
        ["cli-flags"], {"--mystery:undocumented"}, set(), False,
    ),
    "flag-docs-token-match": (
        lambda: _parser_with(
            'ap.add_argument("--poll", type=float)',
            "\n- `--poll-interval` — a LONGER flag must not count\n"),
        ["cli-flags"], {"--poll:undocumented"}, set(), False,
    ),
    "inline-suppression": (
        _inline_suppression, ["lane-safety"], set(), set(), True,
    ),
    "nested-thread-bodies": (
        _nested_threads, ["lane-safety"], {"Shared.count"}, set(), False,
    ),
    "metrics-prefix": (
        _metrics_prefix, ["metrics-conformance"],
        {"h2d_bytes_total:prefix"}, set(), False,
    ),
    "jit-orphan-and-host-sync": (
        _jit_orphan, SHARED, set(),
        {"orphan_kernel:registry", "_orphan:host-sync"}, True,
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_findings_match_the_jax_lint(case, tmp_path):
    make, select, want, want_jit, empty = CASES[case]
    files = make()
    jax_root = write_tree(tmp_path / "jax", files, JAX_NAMES)
    port_root = write_tree(tmp_path / "port", files, PORT_NAMES)
    shared = select or SHARED
    jax = keys(jax_run_checks(jax_root, select=shared))
    port = keys(run_checks(port_root, select=shared))
    assert port == jax
    symbols = {s for _c, _p, s in port}
    assert want <= symbols, (want - symbols, port)
    if empty:
        assert port == set(), port
    # the checkers of one package only: jit-hygiene on the JAX side,
    # kernel-hygiene (whose anchors no such fixture has) on the port's
    jit = {f.symbol for f in jax_run_checks(jax_root,
                                            select=["jit-hygiene"])}
    assert want_jit <= jit, jit
    if case == "clean":
        assert jit == set()
    assert run_checks(port_root, select=["kernel-hygiene"]) == []


# -- the cli-flags mirror rule for a derived mirror ------------------------


@pytest.mark.parametrize("mirror, want", [
    ('tuple(f[2:].replace("-", "_") for f in @DAEMON_ONLY_FLAGS@)', set()),
    ('frozenset({f.lstrip("-").replace("-", "_") '
     'for f in @DAEMON_ONLY_FLAGS@})', set()),
    # a derivation that is not the dest rule drifts like a bad copy
    ('tuple(f[1:] for f in @DAEMON_ONLY_FLAGS@)',
     {"layout:dest-missing", "mesh_shape:dest-missing",
      "-layout:dest-stale", "-mesh-shape:dest-stale"}),
    # an unreadable mirror is every dest missing
    ('tuple(_dest(f) for f in @DAEMON_ONLY_FLAGS@)',
     {"layout:dest-missing", "mesh_shape:dest-missing"}),
    ('tuple(f[2:] for f in OTHER)',
     {"layout:dest-missing", "mesh_shape:dest-missing"}),
])
def test_cli_flags_reads_a_derived_dest_mirror(mirror, want, tmp_path):
    files = base_fixture(good=True)
    files["fix/protocol.py"] = f"""
        OTHER = ("--layout", "--mesh-shape")
        @DAEMON_ONLY_FLAGS@ = ("--layout", "--mesh-shape")
        @_DAEMON_OWNED_DESTS@ = {mirror}
    """
    files["fix/parser.py"] = FLAGS_PARSER.replace(
        'ap.add_argument("--layout", choices=["auto", "flat"])',
        'ap.add_argument("--layout", choices=["auto", "flat"])\n'
        '        ap.add_argument("--mesh-shape")',
    )
    files["docs/cli.md"] = DOC_FLAGS + "- `--mesh-shape` — mesh\n"
    root = write_tree(tmp_path, files, PORT_NAMES)
    got = {f.symbol for f in run_checks(root, select=["cli-flags"])}
    assert got == want


# -- metrics registered from a literal table -------------------------------

TABLE_EXPORTER = """
    @PRE_REGISTERED_FAMILIES@ = ("specpride_fix_cache_*",)

    _SERIES = (
        ("specpride_fix_cache_hits_total", "hits"),
        ("specpride_fix_cache_misses_total", "misses"),
    )

    class Telemetry:
        def __init__(self, r):
            for name, help_ in _SERIES:
                r.counter(name, help_){zero}
"""


@pytest.mark.parametrize("zero, documented, want", [
    (".inc(0)", True, set()),
    ("", True, {"specpride_fix_cache_hits_total:pre-register",
                "specpride_fix_cache_misses_total:pre-register"}),
    (".inc(0)", False, {"specpride_fix_cache_hits_total:undocumented",
                        "specpride_fix_cache_misses_total:undocumented"}),
])
def test_metrics_see_table_registrations(zero, documented, want, tmp_path):
    files = base_fixture(good=True)
    files["fix/exporter.py"] = TABLE_EXPORTER.replace("{zero}", zero)
    if documented:
        files["docs/observability.md"] += (
            "\n- `specpride_fix_cache_hits_total`, "
            "`specpride_fix_cache_misses_total`\n")
    root = write_tree(tmp_path, files, PORT_NAMES)
    got = {f.symbol for f in run_checks(root,
                                        select=["metrics-conformance"])}
    assert got == want


# -- baseline / report semantics, through both packages --------------------


def _jax_cli(argv):
    return jcli.main(argv)


def _port_cli(argv):
    from specpride_tpu_torch import cli

    return cli.main(argv)


PACKAGES = {
    "jax": dict(run=jax_run_checks, ids=jax_checker_ids, cli=_jax_cli,
                Baseline=JaxBaseline, Finding=JaxFinding, names=JAX_NAMES),
    "torch": dict(run=run_checks, ids=checker_ids, cli=_port_cli,
                  Baseline=Baseline, Finding=Finding, names=PORT_NAMES),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture
def seeded(pkg, tmp_path):
    return write_tree(tmp_path / "tree", base_fixture(good=False),
                      pkg["names"])


def _justify(path, reason="seeded fixture violation"):
    payload = json.loads(open(path).read())
    for e in payload["suppressions"]:
        e["reason"] = reason
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return payload


def test_json_report_round_trip(pkg, seeded, tmp_path):
    out = tmp_path / "report.json"
    assert pkg["cli"](["lint", seeded, "--json", str(out)]) == 1
    report = json.loads(out.read_text())
    assert report["version"] == 1
    assert {c["id"] for c in report["checks"]} == set(pkg["ids"]())
    assert report["summary"]["new"] == len(report["findings"]) > 0
    for rec in report["findings"]:
        f = pkg["Finding"].from_json(rec)
        assert f.to_json() == rec
        assert f.check in set(pkg["ids"]())


def test_baseline_suppresses_and_reports_stale(pkg, seeded, tmp_path):
    findings = pkg["run"](seeded)
    assert findings
    bl_path = str(tmp_path / "baseline.json")
    pkg["Baseline"].write(bl_path, findings)
    payload = json.loads(open(bl_path).read())
    bl = pkg["Baseline"].load(bl_path)
    new, baselined, stale, bad = bl.split(findings)
    assert new == [] and len(baselined) == len(findings)
    assert len(bad) == len(payload["suppressions"])  # reasons empty
    _justify(bl_path)
    new, baselined, stale, bad = pkg["Baseline"].load(bl_path).split(
        findings)
    assert new == [] and bad == [] and stale == []
    new, _b, stale, _bad = pkg["Baseline"].load(bl_path).split(
        findings[1:])
    assert new == [] and len(stale) == 1


def test_baseline_cli_gate(pkg, seeded, tmp_path):
    bl = str(tmp_path / "bl.json")
    assert pkg["cli"](["lint", seeded, "--update-baseline",
                       "--baseline", bl]) == 0
    _justify(bl)
    assert pkg["cli"](["lint", seeded, "--baseline", bl]) == 0
    assert pkg["cli"](["lint", seeded, "--baseline", bl,
                       "--no-baseline"]) == 1


def test_select_unknown_checker_is_an_error(pkg, seeded):
    assert pkg["cli"](["lint", seeded, "--select", "no-such-check"]) == 2


def test_list_enumerates_all_checkers(pkg, capsys):
    assert pkg["cli"](["lint", "--list"]) == 0
    out = capsys.readouterr().out
    for cid in pkg["ids"]():
        assert cid in out
    assert len(pkg["ids"]()) == 6


def test_update_baseline_with_select_preserves_other_checkers(
    pkg, seeded, tmp_path
):
    findings = pkg["run"](seeded)
    lane = [f for f in findings if f.check == "lane-safety"]
    assert lane and len(lane) < len(findings)
    bl_path = str(tmp_path / "bl.json")
    pkg["Baseline"].write(bl_path, findings)
    _justify(bl_path, "justified")
    pkg["Baseline"].write(bl_path, lane,
                          existing=pkg["Baseline"].load(bl_path),
                          select=["lane-safety"])
    bl = pkg["Baseline"].load(bl_path)
    assert len(bl.entries) == len({f.fingerprint for f in findings})
    assert all(e["reason"] == "justified" for e in bl.entries)
    new, _b, stale, bad = bl.split(findings)
    assert new == [] and stale == [] and bad == []


def test_select_does_not_report_other_checkers_entries_stale(
    pkg, seeded, tmp_path
):
    findings = pkg["run"](seeded)
    bl_path = str(tmp_path / "bl.json")
    pkg["Baseline"].write(bl_path, findings)
    _justify(bl_path, "justified")
    lane_only = pkg["run"](seeded, select=["lane-safety"])
    bl = pkg["Baseline"].load(bl_path)
    new, _b, stale, bad = bl.split(lane_only, select=["lane-safety"])
    assert new == [] and stale == [] and bad == []
    _n, _b2, stale_full, _bad2 = bl.split(lane_only)
    assert stale_full


@pytest.mark.parametrize("writer, reader", [("jax", "torch"),
                                            ("torch", "jax")])
def test_each_package_reads_the_others_baseline_and_report(
    writer, reader, tmp_path
):
    """The same seeded tree: one package writes its baseline and JSON
    report, the other's ``Baseline.load`` and ``Finding.from_json`` read
    them to the same entries and findings."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    w_root = write_tree(tmp_path / "w", base_fixture(good=False),
                        w["names"])
    r_root = write_tree(tmp_path / "r", base_fixture(good=False),
                        r["names"])
    bl = str(tmp_path / "bl.json")
    assert w["cli"](["lint", w_root, "--select", ",".join(SHARED),
                     "--update-baseline", "--baseline", bl]) == 0
    _justify(bl)
    loaded = r["Baseline"].load(bl)
    assert loaded.entries == w["Baseline"].load(bl).entries
    new, baselined, stale, bad = loaded.split(
        r["run"](r_root, select=SHARED), select=SHARED)
    assert new == [] and stale == [] and bad == [] and baselined
    report = tmp_path / "report.json"
    assert w["cli"](["lint", w_root, "--select", ",".join(SHARED),
                     "--json", str(report)]) == 1
    payload = json.loads(report.read_text())
    got = [r["Finding"].from_json(rec) for rec in payload["findings"]]
    assert [f.to_json() for f in got] == payload["findings"]
    assert keys(got) == keys(r["run"](r_root, select=SHARED))


# -- kernel-hygiene: a tripping fixture and its clean twin per rule --------

KH_BUILD = """
    def load():
        return None

    def load_host():
        return None
"""

KH_KERNELS = """
    import torch

    from kx.ops import _build

    launches = {"seg_mean": 0}


    def _launch(name, entry, lib, runs, ins, outs, count):
        rc = entry(runs.data_ptr())
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: {rc}")
        launches[name] += 1


    def seg_mean_plain(x):
        return torch.cumsum(x, 0)


    def seg_mean(x):
        if x.device.type == "cpu":
            return seg_mean_plain(x)
        lib = _build.load()
        out = torch.empty_like(x)
        _launch("seg_mean", lib.seg_mean_f32, lib, x, (x,), (out,), 1)
        return out
"""

KH_REGISTRY = """
    def _flat(entry):
        return (), {}

    def _packed(entry):
        return (), {}

    _WARM_BUILDERS = {
        "k_flat_f32": _flat,
        "k_flat_q": _flat,
        "k_packed": _packed,
    }
"""

KH_BACKEND = """
    class Backend:
        def _note_dispatch(self, kernel, shape_key, dispatch):
            self.last = kernel

        def run_flat(self, q):
            self._note_dispatch("k_flat_q" if q else "k_flat_f32", (), ())

        def _count(self, kernel, n):
            self._note_dispatch(kernel, (n,), ())

        def run_packed(self):
            self._count("k_packed", 4)
"""


def kh_tree(**edits) -> dict:
    files = {
        "kx/__init__.py": "",
        "kx/ops/__init__.py": "",
        "kx/ops/_build.py": KH_BUILD,
        "kx/ops/kernels.py": KH_KERNELS,
        "kx/registry.py": KH_REGISTRY,
        "kx/backend.py": KH_BACKEND,
    }
    for rel, (old, new) in edits.items():
        rel = rel.replace("__", "/") + ".py"
        text = files.get(rel, "")
        assert old in text, (rel, old)
        files[rel] = text.replace(old, new, 1)
    return files


IMPORT_TIME = """
    from kx.ops import _build
    from kx.ops._build import load_host
    import triton
    from torch.utils.cpp_extension import load_inline

    LIB = _build.load()
    HOST = load_host()
"""
IMPORT_TIME_FIXED = """
    from kx.ops import _build


    def lib():
        import triton
        from torch.utils.cpp_extension import load_inline

        from kx.ops._build import load_host

        load_host()
        return _build.load(), triton, load_inline
"""

KH_CASES = {
    # a. no build or load at import
    "a-import-time": (
        {"kx__user": ("", IMPORT_TIME)},
        {"load:import-time", "load_host:import-time", "triton:import-time",
         "cpp_extension:import-time"},
    ),
    "a-import-time-fixed": ({"kx__user": ("", IMPORT_TIME_FIXED)}, set()),
    # b. wrapper, plain version, counter
    "b-no-plain": (
        {"kx__ops__kernels": ("def seg_mean_plain(x):",
                              "def seg_mean_ref(x):")},
        {"seg_mean:plain"},
    ),
    "b-no-counter": (
        {"kx__ops__kernels": ('launches = {"seg_mean": 0}',
                              'launches = {"seg_sum": 0}')},
        {"seg_mean:counter", "seg_sum:wrapper"},
    ),
    "b-counted-elsewhere": (
        {"kx__ops__kernels": ('_launch("seg_mean", lib.seg_mean_f32',
                              '_launch("seg_scan", lib.seg_mean_f32')},
        {"seg_mean:counter-name"},
    ),
    # c. no fallback
    "c-fallback-plain": (
        {"kx__ops__kernels": (
            '        _launch("seg_mean", lib.seg_mean_f32, lib, x, (x,), '
            '(out,), 1)\n',
            '        try:\n'
            '            _launch("seg_mean", lib.seg_mean_f32, lib, x, '
            '(x,), (out,), 1)\n'
            '        except RuntimeError:\n'
            '            return seg_mean_plain(x)\n')},
        {"seg_mean:fallback"},
    ),
    "c-fallback-cpu": (
        {"kx__ops__kernels": (
            '        _launch("seg_mean", lib.seg_mean_f32, lib, x, (x,), '
            '(out,), 1)\n',
            '        try:\n'
            '            lib.seg_mean_check(x.data_ptr())\n'
            '        except OSError:\n'
            '            return torch.cumsum(x.to("cpu"), 0)\n'
            '        _launch("seg_mean", lib.seg_mean_f32, lib, x, (x,), '
            '(out,), 1)\n')},
        {"seg_mean:fallback"},
    ),
    "c-reraise": (
        {"kx__ops__kernels": (
            '        _launch("seg_mean", lib.seg_mean_f32, lib, x, (x,), '
            '(out,), 1)\n',
            '        try:\n'
            '            _launch("seg_mean", lib.seg_mean_f32, lib, x, '
            '(x,), (out,), 1)\n'
            '        except RuntimeError as e:\n'
            '            raise RuntimeError(f"seg_mean on {x.device}") '
            'from e\n')},
        set(),
    ),
    # d. every dispatched kernel can be warmed, and back
    "d-unwarmed-literal": (
        {"kx__registry": ('        "k_flat_q": _flat,\n', "")},
        {"k_flat_q:unwarmed"},
    ),
    "d-unwarmed-parameter": (
        {"kx__backend": ('self._count("k_packed", 4)',
                         'self._count("k_packed", 4)\n'
                         '            self._count(kernel="k_new", n=2)')},
        {"k_new:unwarmed"},
    ),
    "d-undispatched": (
        {"kx__registry": ('        "k_packed": _packed,\n',
                          '        "k_packed": _packed,\n'
                          '        "k_stale": _packed,\n')},
        {"k_stale:undispatched"},
    ),
    "d-local-binding": (
        {"kx__backend": (
            '            self._note_dispatch("k_flat_q" if q else '
            '"k_flat_f32", (), ())',
            '            kernel = "k_flat_q" if q else "k_flat_f32"\n'
            '            self._note_dispatch(kernel, (), ())')},
        set(),
    ),
    # e. no host sync inside a launching wrapper
    "e-item": (
        {"kx__ops__kernels": ("        out = torch.empty_like(x)\n",
                              "        n = int(x.sum().item())\n"
                              "        out = torch.empty_like(x)\n")},
        {"seg_mean:host-sync"},
    ),
    "e-synchronize": (
        {"kx__ops__kernels": ("        return out\n",
                              "        torch.cuda.synchronize()\n"
                              "        return out\n")},
        {"seg_mean:host-sync"},
    ),
    "e-sync-outside-wrapper": (
        {"kx__ops__kernels": ("def seg_mean_plain(x):\n",
                              "def total(x):\n"
                              "    return x.sum().item()\n\n\n"
                              "def seg_mean_plain(x):\n")},
        set(),
    ),
    "clean": ({}, set()),
}


@pytest.mark.parametrize("case", sorted(KH_CASES))
def test_kernel_hygiene_rule(case, tmp_path):
    edits, want = KH_CASES[case]
    root = write_tree(tmp_path, kh_tree(**edits), PORT_NAMES)
    got = {f.symbol for f in run_checks(root, select=["kernel-hygiene"])}
    assert got == want


# -- the real tree ---------------------------------------------------------


@pytest.fixture(scope="module")
def repo_lint():
    project = Project(REPO)
    return project, run_checks(REPO, project=project)


def test_port_lints_clean_against_its_baseline(repo_lint):
    project, findings = repo_lint
    assert project.errors == []
    bl = Baseline.load(os.path.join(REPO, BASELINE_NAME))
    new, baselined, stale, bad = bl.split(findings)
    assert new == [], [f.to_json() for f in new]
    assert bad == [] and stale == []
    assert all(str(e.get("reason", "")).strip() for e in bl.entries)
    # without the baseline: only the JAX-only series the frozen docs name
    assert keys(findings) == keys(baselined)
    assert {(f.check, f.symbol.split(":")[-1]) for f in findings} == {
        ("metrics-conformance", "stale-doc")}


def test_port_scan_prunes_the_jax_package(repo_lint):
    project, _ = repo_lint
    rels = {m.rel for m in project.modules}
    assert "chip_smoke.py" in rels
    assert "specpride_tpu_torch/data/packed.py" in rels
    assert "specpride_tpu_torch/analysis/kernel_hygiene.py" in rels
    assert not any(r.startswith(("specpride_tpu/", "tests/")) for r in rels)
    assert "bench.py" not in rels


@pytest.mark.parametrize("name", sorted(ANCHOR_FILES))
def test_port_anchor_resolves(name, repo_lint):
    project, _ = repo_lint
    hit = project.one_constant(name)
    assert hit is not None, name
    assert hit[0].rel == f"specpride_tpu_torch/{ANCHOR_FILES[name]}"


@pytest.mark.parametrize("name", sorted(PORT_NAMES))
def test_port_assigns_no_jax_anchor_name(name, repo_lint):
    project, _ = repo_lint
    assert list(project.module_constants(name)) == []


def test_kernel_hygiene_reads_the_real_kernels(repo_lint):
    """The rules' anchors resolve on the real tree: the three wrappers
    and every dispatched kernel name, which are exactly the warm-start
    table's keys."""
    project, _ = repo_lint
    (mod,) = [m for m in project.modules
              if m.rel == "specpride_tpu_torch/ops/kernels.py"]
    wrappers = {q for q, fn in kernel_hygiene._functions(mod.tree)
                if kernel_hygiene._calls_launch(fn)}
    assert wrappers == {"seg_mean", "seg_mean_heads", "seg_scan"}
    import ast

    dispatched = set()
    (backend,) = [m for m in project.modules if m.rel.endswith(
        "backends/torch_backend.py")]
    for _q, fn in kernel_hygiene._functions(backend.tree):
        for call in kernel_hygiene._own_nodes(fn):
            if isinstance(call, ast.Call) and getattr(
                call.func, "attr", None
            ) == "_note_dispatch":
                names = kernel_hygiene._dispatched_names(
                    backend.tree, fn, call.args[0])
                assert names, ast.unparse(call)
                dispatched |= names
    from specpride_tpu_torch.warmstart.registry import known_kernels

    assert dispatched == set(known_kernels())


def test_deleting_a_warm_builder_is_a_finding(tmp_path):
    dst = tmp_path / "specpride_tpu_torch"
    shutil.copytree(os.path.join(REPO, "specpride_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    reg = dst / "warmstart" / "registry.py"
    text = reg.read_text()
    assert '    "cosine_flat": _cosine_flat,\n' in text
    reg.write_text(text.replace('    "cosine_flat": _cosine_flat,\n', ""))
    got = run_checks(str(tmp_path), select=["kernel-hygiene"])
    assert keys(got) == {("kernel-hygiene",
                          "specpride_tpu_torch/backends/torch_backend.py",
                          "cosine_flat:unwarmed")}


def test_lint_subprocess_runs_without_torch(tmp_path):
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['specpride_tpu_torch', 'lint', {REPO!r}, "
        "'--json', '-']\n"
        "rc = 0\n"
        "try:\n"
        "    runpy.run_module('specpride_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print('CHILD', rc, 'torch' in sys.modules, file=sys.stderr)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert "CHILD 0 False" in proc.stderr, proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert report["summary"]["new"] == 0
    assert len(report["checks"]) == 6
    assert report["baseline"]["path"] == os.path.join(REPO, BASELINE_NAME)


def test_lint_main_prints_the_ok_line(capsys):
    assert lint_main(["lint", REPO, "--select",
                      "kernel-hygiene,fault-sites"]) == 0
    assert capsys.readouterr().out.strip().endswith(
        "lint OK: 2 checker(s), 0 new finding(s), 0 baselined")
