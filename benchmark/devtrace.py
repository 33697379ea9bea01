"""The device side of a traced window, from ``torch.profiler``'s Chrome
trace: the card's busy intervals (kernels, copies and sets, merged), the
idle gaps between them, each labelled by the port's host spans open at
the time (from the jobs' ``--journal`` span events), and the device
operations by total time.

The profiler's clock is tied to ``time.perf_counter`` (the clock of the
port's spans and of the harness) by the harness's ``benchmark.job``
ranges, whose host start it records on both clocks."""

from __future__ import annotations

import bisect
import json

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB_RANGE = "benchmark.job"
TOP = 10
SHORT_GAP_S = 1e-3  # gaps shorter than this are summed under one label
SHORT_LABEL = "(gaps under 1 ms)"


def load(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def clock_offset(events: list[dict], job_starts: list[float]) -> float | None:
    """Seconds to add to a ``perf_counter`` time to get the trace's
    clock: the median over the jobs' ranges, paired in order."""
    ranges = sorted(float(e["ts"]) / 1e6 for e in events
                    if e.get("name") == JOB_RANGE
                    and e.get("cat") == "user_annotation")
    n = min(len(ranges), len(job_starts))
    if n == 0:
        return None
    return float(np.median(np.asarray(ranges[:n])
                           - np.asarray(job_starts[:n])))


def device_intervals(events: list[dict], lo: float, hi: float):
    """Merged busy intervals of the card inside [lo, hi] (trace clock,
    seconds), and the device operations' total seconds by name."""
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = float(e["ts"]) / 1e6
        b = a + float(e["dur"]) / 1e6
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    spans.sort()
    merged: list[list[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged, by_name


def idle_gaps(merged: list, lo: float, hi: float) -> list[tuple[float,
                                                                float]]:
    """The window's stretches with nothing on the card."""
    gaps, at = [], lo
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


class SpanIndex:
    """The port's host spans (journal ``span`` events, ``perf_counter``
    seconds), to ask which were open at an instant."""

    def __init__(self, spans: list[dict]):
        rows = []
        for s in spans:
            end = float(s["mono"])
            rows.append((end - float(s["dur_s"]), end, int(s.get("depth", 0)),
                         s.get("tid", 0), s["name"]))
        rows.sort()
        self.rows = rows
        self.starts = [r[0] for r in rows]
        self.longest = max((r[1] - r[0] for r in rows), default=0.0)

    def label(self, t: float) -> str:
        """The deepest span open at ``t`` on each lane, joined by ``+``;
        ``(no span)`` when none is."""
        hi = bisect.bisect_right(self.starts, t)
        lo = bisect.bisect_left(self.starts, t - self.longest)
        deepest = {}
        for start, end, depth, tid, name in self.rows[lo:hi]:
            if start <= t <= end and depth >= deepest.get(tid, (-1, ""))[0]:
                deepest[tid] = (depth, name)
        names = sorted({name for _, name in deepest.values()})
        return "+".join(names) if names else "(no span)"


def journal_spans(paths: list[str]) -> list[dict]:
    spans = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if e.get("event") == "span" and "mono" in e:
                    spans.append(e)
    return spans


def summarize(trace_path: str, journals: list[str], job_starts: list[float],
              t0: float, t1: float) -> dict | None:
    """``busy_s``, ``window_s`` and the breakdown of the traced window
    [t0, t1] (``perf_counter`` seconds); None when the trace cannot be
    tied to the window or holds no device operation."""
    events = load(trace_path)
    off = clock_offset(events, job_starts)
    if off is None:
        return None
    lo, hi = t0 + off, t1 + off
    merged, by_name = device_intervals(events, lo, hi)
    if not merged:
        return None
    busy = sum(b - a for a, b in merged)
    index = SpanIndex(journal_spans(journals))
    idle: dict[str, float] = {}
    for a, b in idle_gaps(merged, lo, hi):
        key = (SHORT_LABEL if b - a < SHORT_GAP_S
               else index.label((a + b) / 2.0 - off))
        idle[key] = idle.get(key, 0.0) + (b - a)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy, "window_s": hi - lo,
        "breakdown": {"device_ops": [[k, v] for k, v in top_ops],
                      "idle_gaps": [[k, v] for k, v in top_idle]},
    }
