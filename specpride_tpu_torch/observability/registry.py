"""Metrics registry: named counters, gauges and histograms with labels
(the port's copy of the JAX package's ``observability/registry.py``),
rendered in the Prometheus text format (``--metrics-out FILE``, for
node_exporter's textfile collector, and the serving daemon's live
``/metrics``) and as a plain JSON dict (``to_json``).  Counters are
cumulative over the registry's life (Prometheus semantics): a serving
daemon keeps each lane's registry resident, and a job's ``run_end``
diffs a ``device_counters_snapshot`` instead of resetting it.  Every
mutator and every view locks per metric, so the dispatch lane, the pack
and write lanes and a scrape can share one registry.  The metric names
are the JAX package's and are documented in ``docs/observability.md``;
the port registers no name the JAX package lacks.
"""

from __future__ import annotations

import math
import os
import threading

# seconds buckets of the dispatch latency (the JAX package's): sub-ms
# calls up to multi-second ones
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    def __init__(self, kind: str, name: str, help: str, label_names: tuple):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        # label values -> value (a histogram's: its _HistState)
        self.samples: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: got labels {sorted(labels)}, "
                             f"declared {sorted(self.label_names)}")
        return tuple(str(labels[n]) for n in self.label_names)

    def clear(self) -> None:
        """Drop every labeled sample (the exporter resets ephemeral label
        sets, the per-client queue depths, at each scrape)."""
        with self._lock:
            self.samples.clear()


class Counter(_Metric):
    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (got {n})")
        key = self._key(labels)
        with self._lock:
            self.samples[key] = self.samples.get(key, 0.0) + n

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self.samples.get(key, 0.0))


class Gauge(_Metric):
    def set(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self.samples[key] = float(v)

    def zero_all(self) -> None:
        """Every existing labeled sample set to 0: the series stay, so a
        scraper sees the in-flight count drop to 0, not disappear."""
        with self._lock:
            for key in self.samples:
                self.samples[key] = 0.0

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self.samples.get(key, 0.0))


class _HistState:
    __slots__ = ("counts", "total", "n", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per bucket, not cumulative
        self.total = 0.0
        self.n = 0
        # bucket index (len(buckets) is +Inf) -> (labels, value): the last
        # exemplar observed into each bucket
        self.exemplars: dict[int, tuple[dict, float]] = {}


class Histogram(_Metric):
    def __init__(self, kind, name, help, label_names, buckets):
        super().__init__(kind, name, help, label_names)
        self.buckets = tuple(sorted(buckets))

    def observe(self, v: float, exemplar: dict | None = None,
                **labels) -> None:
        """Fold one observation in.  ``exemplar`` (``{"trace_id": ...}``)
        attaches to the bucket the value lands in, last writer wins: the
        OpenMetrics link from a latency outlier to its trace."""
        key = self._key(labels)
        with self._lock:
            st = self.samples.get(key)
            if st is None:
                st = self.samples[key] = _HistState(len(self.buckets))
            bucket = len(self.buckets)  # +Inf
            for i, le in enumerate(self.buckets):
                if v <= le:
                    st.counts[i] += 1
                    bucket = i
                    break
            st.total += v
            st.n += 1
            if exemplar:
                st.exemplars[bucket] = (dict(exemplar), float(v))


def _fmt_exemplar(ex: "tuple[dict, float] | None") -> str:
    """The OpenMetrics exemplar suffix of a ``_bucket`` line, empty when
    the bucket has none."""
    if not ex:
        return ""
    labels, value = ex
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return f" # {{{inner}}} {_fmt(value)}"


def _sample_lines(m: _Metric, extra: tuple = ()) -> list[str]:
    """One metric's sample lines (no HELP or TYPE) from a snapshot taken
    under its lock.  ``extra`` is ``(label, value)`` pairs put first on
    every sample: ``render_labeled`` names each lane's series with it."""
    with m._lock:
        samples = {
            key: ((tuple(st.counts), st.total, st.n, dict(st.exemplars))
                  if isinstance(m, Histogram) else st)
            for key, st in m.samples.items()
        }
    prefix = ",".join(f'{ln}="{_escape_label(lv)}"' for ln, lv in extra)
    lines: list[str] = []
    for key in sorted(samples):
        labelstr = ",".join(filter(None, [prefix] + [
            f'{ln}="{_escape_label(lv)}"'
            for ln, lv in zip(m.label_names, key)]))
        base = f"{{{labelstr}}}" if labelstr else ""
        if not isinstance(m, Histogram):
            lines.append(f"{m.name}{base} {_fmt(samples[key])}")
            continue
        counts, total, n, exemplars = samples[key]
        cum = 0
        for i, (le, c) in enumerate(zip(m.buckets, counts)):
            cum += c
            blabel = ",".join(filter(None, [labelstr, f'le="{_fmt(le)}"']))
            lines.append(f"{m.name}_bucket{{{blabel}}} {cum}"
                         f"{_fmt_exemplar(exemplars.get(i))}")
        blabel = ",".join(filter(None, [labelstr, 'le="+Inf"']))
        lines.append(f"{m.name}_bucket{{{blabel}}} {n}"
                     f"{_fmt_exemplar(exemplars.get(len(m.buckets)))}")
        lines.append(f"{m.name}_sum{base} {_fmt(total)}")
        lines.append(f"{m.name}_count{base} {n}")
    return lines


def render_labeled(registries: "dict[str, MetricsRegistry]",
                   label: str = "worker") -> str:
    """One exposition over several registries that carry the same metric
    names (the serving daemon's per-lane backend registries): one HELP
    and TYPE line per metric, and ``label="<registry key>"`` on every
    sample.  Registries that disagree on a metric's kind or labels
    raise."""
    by_name: dict[str, list] = {}
    for key in sorted(registries):
        for m in registries[key]._sorted_metrics():
            by_name.setdefault(m.name, []).append((key, m))
    lines: list[str] = []
    for name in sorted(by_name):
        group = by_name[name]
        kind, label_names = group[0][1].kind, group[0][1].label_names
        for _, m in group[1:]:
            if m.kind != kind or m.label_names != label_names:
                raise ValueError(
                    f"metric {name} disagrees across registries: "
                    f"{m.kind}{m.label_names} vs {kind}{label_names}")
        sample_lines: list[str] = []
        for key, m in group:
            sample_lines.extend(_sample_lines(m, extra=((label, key),)))
        if not sample_lines:
            continue
        help_ = next((m.help for _, m in group if m.help), "")
        if help_:
            lines.append(f"# HELP {name} {_escape_help(help_)}")
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(sample_lines)
    return "\n".join(lines) + ("\n" if lines else "")


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._index_lock = threading.Lock()

    def _register(self, cls, kind, name, help, labels, **kw) -> _Metric:
        with self._index_lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name} re-registered as {kind}"
                        f"{tuple(labels)} (was {m.kind}{m.label_names})")
                return m
            m = self._metrics[name] = cls(kind, name, help, tuple(labels),
                                          **kw)
            return m

    def _sorted_metrics(self) -> list:
        with self._index_lock:
            return [self._metrics[name] for name in sorted(self._metrics)]

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._register(Counter, "counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._register(Gauge, "gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, "histogram", name, help, labels,
                              buckets=buckets)

    def to_prometheus_text(self) -> str:
        lines: list[str] = []
        for m in self._sorted_metrics():
            sample_lines = _sample_lines(m)
            if not sample_lines:
                continue  # registered, never touched
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(sample_lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def write_textfile(self, path: str) -> None:
        """Atomic rewrite (temporary file, then rename): a scraper never
        reads a torn file."""
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(self.to_prometheus_text())
        os.replace(tmp, path)

    def to_json(self) -> dict:
        """``{name: {"label|values": value}}``; a histogram's value is
        ``{"sum", "count"}``."""
        out: dict = {}
        for m in self._sorted_metrics():
            with m._lock:
                if isinstance(m, Histogram):
                    out[m.name] = {"|".join(key): {"sum": st.total,
                                                   "count": st.n}
                                   for key, st in m.samples.items()}
                else:
                    out[m.name] = {"|".join(key): v
                                   for key, v in m.samples.items()}
        return out

    def sum_counter(self, name: str) -> float:
        """Total over all label values (0.0 when never registered or a
        histogram)."""
        with self._index_lock:
            m = self._metrics.get(name)
        if m is None or isinstance(m, Histogram):
            return 0.0
        with m._lock:
            return float(sum(m.samples.values()))


_DEVICE_KEYS = (
    "compiles", "dispatches", "bytes_h2d", "bytes_d2h",
    "pack_real_elements", "pack_padded_elements", "padding_waste_frac",
    "rows_real", "rows_padded", "bucket_occupancy_frac",
    "device_peak_bytes_in_use",
)


# the counters device_summary folds: a registry that outlives one run (a
# serving lane's) is snapshot before the run and diffed after it
_DEVICE_COUNTERS = (
    "specpride_compiles_total", "specpride_dispatches_total",
    "specpride_bytes_h2d_total", "specpride_bytes_d2h_total",
    "specpride_pack_real_elements_total",
    "specpride_pack_padded_elements_total",
    "specpride_rows_real_total", "specpride_rows_padded_total",
)


def device_counters_snapshot(registry: MetricsRegistry | None) -> dict:
    """The device counters' totals now, for ``device_summary(since=)``."""
    if registry is None:
        return {}
    return {name: registry.sum_counter(name) for name in _DEVICE_COUNTERS}


def device_summary(registry: MetricsRegistry | None,
                   since: dict | None = None) -> dict:
    """The journal's ``run_end.device``: the JAX package's fixed key set
    from the device counters, zeros for a registry nothing touched.
    ``since`` (a ``device_counters_snapshot``) reports only the traffic
    after it: a served job's own, on its lane's resident registry.  The
    peak-memory gauge is a watermark and reports its value either way."""
    out = {k: 0 for k in _DEVICE_KEYS}
    if registry is None:
        return out
    since = since or {}

    def total(name: str) -> float:
        return registry.sum_counter(name) - float(since.get(name, 0))

    out["compiles"] = int(total("specpride_compiles_total"))
    out["dispatches"] = int(total("specpride_dispatches_total"))
    out["bytes_h2d"] = int(total("specpride_bytes_h2d_total"))
    out["bytes_d2h"] = int(total("specpride_bytes_d2h_total"))
    real = total("specpride_pack_real_elements_total")
    padded = total("specpride_pack_padded_elements_total")
    out["pack_real_elements"] = int(real)
    out["pack_padded_elements"] = int(padded)
    out["padding_waste_frac"] = (round(1.0 - real / padded, 4)
                                 if padded > 0 else 0.0)
    rows_r = total("specpride_rows_real_total")
    rows_p = total("specpride_rows_padded_total")
    out["rows_real"] = int(rows_r)
    out["rows_padded"] = int(rows_p)
    out["bucket_occupancy_frac"] = (round(rows_r / rows_p, 4)
                                    if rows_p > 0 else 0.0)
    with registry._index_lock:  # a read: must not register the gauge
        peak = registry._metrics.get("specpride_device_peak_bytes_in_use")
    if peak is not None:
        with peak._lock:
            values = list(peak.samples.values())
        out["device_peak_bytes_in_use"] = int(max(values, default=0))
    return out


def export_run_metrics(registry: MetricsRegistry, stats, device: dict
                       ) -> None:
    """Fold one run's ``RunStats`` and device summary into ``registry``
    for the textfile: run counters and phase seconds as counters, the
    padding and occupancy fractions and the wall as gauges."""
    for name, n in stats.counters.items():
        registry.counter(
            f"specpride_run_{name}_total",
            f"run counter '{name}' accumulated across runs",
        ).inc(n)
    for phase, secs in stats.phases.items():
        registry.counter(
            "specpride_phase_seconds_total",
            "per-phase wall seconds accumulated across runs",
            labels=("phase",),
        ).inc(secs, phase=phase)
    registry.gauge(
        "specpride_padding_waste_frac",
        "fraction of packed device elements that were padding (last run)",
    ).set(device["padding_waste_frac"])
    registry.gauge(
        "specpride_bucket_occupancy_frac",
        "real rows / padded rows across device dispatches (last run)",
    ).set(device["bucket_occupancy_frac"])
    registry.gauge(
        "specpride_run_elapsed_seconds", "wall time of the last run"
    ).set(stats.elapsed)
