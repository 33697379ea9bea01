"""Warm start of the port (the JAX package's ``warmstart/``, less its XLA
compile cache and routing table, which the port has not got).

* ``manifest`` — the shape manifest: every (kernel, shape class) a run
  dispatched, in the JAX package's format (version 1);
* ``registry`` — for each kernel name the port's backend dispatches, the
  smallest inputs that take the same path;
* ``warmup`` — ``warm_entries``: each entry dispatched once on the
  caller's device and stream before the first chunk (``warmup``,
  ``--warmup``, ``serve --warmup``), journaled as ``warmup`` events.
"""

from specpride_tpu_torch.warmstart.manifest import (  # noqa: F401
    ShapeEntry,
    entries_from_seen,
    load_manifest,
    merge_manifest,
)
from specpride_tpu_torch.warmstart.warmup import (  # noqa: F401
    check_jobs,
    warm_entries,
)
