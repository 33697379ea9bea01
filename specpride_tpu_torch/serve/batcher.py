"""The configuration digest of a consensus or select run: the port's copy
of ``config_digest`` from the JAX package's ``serve/batcher.py``, the
part of the micro-batcher the result cache keys by.  The batcher itself
(sharing one dispatch across jobs) is not ported; ``config_digest`` lives
where its counterpart does so that it grows into it.
"""

from __future__ import annotations

import hashlib


def config_digest(args, command: str) -> str | None:
    """Digest of the constructed method (and QC cosine) config: the part
    of a run's argv that must be identical for two runs to give the same
    representative of the same cluster.  Hashing the built config
    objects, not the argv, makes the key immune to flag spelling and
    order.  None when the config does not build (the run itself reports
    the usage error)."""
    from specpride_tpu_torch import cli

    try:
        cfg = cli.method_config(args)
    except (ValueError, SystemExit):
        return None
    parts = [command, args.method, repr(cfg)]
    if getattr(args, "qc_report", None):
        parts.append(repr(cli._cosine_config(args)))
    else:
        parts.append("noqc")
    h = hashlib.blake2b("\x00".join(parts).encode(), digest_size=8)
    return h.hexdigest()
