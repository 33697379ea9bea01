"""Work model of ``pxd004732-gap``: the least bytes and operations the
card must spend on a job, from the job's problem sizes (the reference's
``sizes``), whatever kernels implement it.  Each input byte is read once
and each output byte written once: each member peak brings its intensity
and one byte marking where its group starts (the host's sort knows the
groups); each group's mean goes out as float32 with one byte saying
whether it is kept; one addition per peak, and per group a division and
a comparison with its cluster's floor.
"""

from benchmark.peaks import VALUE_BYTES


def work(sizes: dict, precision: str) -> dict:
    v = VALUE_BYTES[precision]
    return {"bytes": sizes["peaks"] * (v + 1) + sizes["groups"] * 5,
            "flops": sizes["peaks"] + 2 * sizes["groups"]}
