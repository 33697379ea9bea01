"""``device_idle_share``: the share of the traced window in which no
kernel, copy or set ran on the card (``torch.profiler``)."""


def read(run: dict):
    dev = run.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 1.0 - dev["busy_s"] / dev["window_s"]
