"""``import_s``: seconds from before ``import torch`` to the port's
kernels and host library loaded from the compile cache (the harness's
clock; a process's start, paid by every run's set-up)."""


def read(run: dict):
    return run.get("import_s")
