"""Project-invariant static analysis of the port (``python -m
specpride_tpu_torch lint``), the counterpart of the JAX package's
``specpride_tpu/analysis``: an AST + cross-artifact analyzer with one
checker per invariant family, a committed baseline of its own
(``lint-baseline.torch.json``), and exit 1 on any new finding.  It is
stdlib ``ast`` work and imports no torch.

It scans the port's tree alone: at the root it prunes the JAX package
and ``bench.py`` (``core.Project``).  Its anchors are the port's names:

=============================  =====================================
anchor                         where
=============================  =====================================
``EVENT_SCHEMA``               ``observability/journal.py``
``TRACE_EVENT_SCHEMA``,        ``observability/journal.py``
``V5_EVENT_SCHEMA``,
``V6_EVENT_SCHEMA``
``SITES``, ``EXECUTOR_SITES``  ``robustness/faults.py``
``JOB_REFUSED_FLAGS``,         ``serve/protocol.py``
``_JOB_REFUSED_DESTS``
``_WARM_BUILDERS``             ``warmstart/registry.py``
``ZERO_AT_START_FAMILIES``     ``observability/exporter.py``
``launches``, ``_launch``      ``ops/kernels.py``
``_note_dispatch``             ``backends/torch_backend.py``
=============================  =====================================

Checkers (``lint --list``):

* ``lane-safety`` — call-graph lane inference from the thread entry
  points; flags attributes mutated from >= 2 lanes without a lock.
* ``kernel-hygiene`` — the stand-in for the JAX ``jit-hygiene``: no
  kernel build or ``triton`` import at module load, every wrapper with
  its ``_plain`` version and ``launches`` key, no fallback to the plain
  version, every dispatched kernel in ``_WARM_BUILDERS`` and back, no
  host sync in a launching wrapper.
* ``journal-schema`` — ``EVENT_SCHEMA`` vs emit sites vs the
  ``docs/observability.md`` event table vs renderer literals.
* ``metrics-conformance`` — registered metric names vs the strict
  exposition grammar, the docs catalog, and zero-at-start.
* ``cli-flags`` — ``JOB_REFUSED_FLAGS`` vs the parser and its dest
  mirror, and every flag documented under ``docs/`` or the README.
* ``fault-sites`` — ``SITES`` vs actual harness visit sites.
"""

from specpride_tpu_torch.analysis.core import Finding, Project
from specpride_tpu_torch.analysis.runner import (
    CHECKERS,
    checker_ids,
    run_checks,
)

__all__ = [
    "CHECKERS",
    "Finding",
    "Project",
    "checker_ids",
    "run_checks",
]
