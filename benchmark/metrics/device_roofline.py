"""``device_roofline``: the least time the window's device work needs
over the card's busy time in the profiler, in percent.  The work is the
configuration's work model (``benchmark/work/<config>.py``) on the
job's problem sizes, whatever kernels implement it; its least time is
the larger of its bytes over the HBM rate and its operations over the
data sheet's rate for the configuration's precision.  The card's busy
time is the union of its kernels, copies and sets in the traced window."""

from benchmark import peaks


def read(run: dict):
    dev, work = run.get("device"), run.get("work")
    if not dev or not work or dev["busy_s"] <= 0:
        return None
    least = max(work["bytes"] / peaks.HBM_BYTES_PER_S,
                work["flops"] / peaks.FLOPS_PER_S[run["config"]["precision"]])
    return 100.0 * least * len(run["jobs"]) / dev["busy_s"]
