"""Closed-loop autotune of the port (the JAX package's ``autotune/``).

A :class:`~.signals.SignalState` folds a process's journal into windowed
estimates (queue depth, batch yield, SLO burn, rank chunk walls, span
attribution); pure :mod:`~.policy` objects map a snapshot to a proposed
knob value; a :class:`~.controller.Controller` journals every decision as
an ``autotune`` event before it acts through the host's live knob (the
daemon's batch window and active lanes, the coordinator's split hint,
the fleet's spare count).  ``--autotune off|observe|on``: ``off`` builds
no controller at all, ``observe`` journals would-be decisions, ``on``
acts on them.  ``autotune-replay`` re-runs the policies over a recorded
journal (:mod:`~.replay`).  The package imports no torch, so the fleet
supervisor and the replay command start without it; its journals and
decisions are the JAX package's, field for field.
"""

from specpride_tpu_torch.autotune.controller import (  # noqa: F401
    Controller,
    ControllerThread,
    evaluate,
)
from specpride_tpu_torch.autotune.policy import (  # noqa: F401
    MODES,
    BatchWindowPolicy,
    ElasticRangePolicy,
    FleetSparesPolicy,
    WorkerPolicy,
    parse_clamp,
    policy_from_params,
)
from specpride_tpu_torch.autotune.signals import SignalState  # noqa: F401
