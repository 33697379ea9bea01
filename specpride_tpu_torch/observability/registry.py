"""Metrics registry: named counters and gauges with labels (the port's
trimmed copy of the JAX package's ``observability/registry.py``),
rendered in the Prometheus textfile format (``--metrics-out FILE``, for
node_exporter's textfile collector).  Counters are cumulative over the
registry's life (Prometheus semantics).  Every mutator and the render
lock per metric, so the dispatch lane and the pack and write lanes can
update one registry while another thread renders it.  The metric names
are the JAX package's and are documented in ``docs/observability.md``;
the port registers no name the JAX package lacks.  Left out until a
port metric needs them: histograms (the JAX package's dispatch latency
comes with the span tracer) and the JSON view.
"""

from __future__ import annotations

import math
import os
import threading


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
        self.samples: dict[tuple, float] = {}  # label values -> value
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: got labels {sorted(labels)}, "
                             f"declared {sorted(self.label_names)}")
        return tuple(str(labels[n]) for n in self.label_names)


class Counter(_Metric):
    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (got {n})")
        key = self._key(labels)
        with self._lock:
            self.samples[key] = self.samples.get(key, 0.0) + n


class Gauge(_Metric):
    def set(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self.samples[key] = float(v)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self.samples.get(key, 0.0))


def _sample_lines(m: _Metric) -> list[str]:
    """One metric's sample lines from a snapshot taken under its lock."""
    with m._lock:
        samples = dict(m.samples)
    lines: list[str] = []
    for key in sorted(samples):
        labelstr = ",".join(f'{ln}="{_escape_label(lv)}"'
                            for ln, lv in zip(m.label_names, key))
        base = f"{{{labelstr}}}" if labelstr else ""
        lines.append(f"{m.name}{base} {_fmt(samples[key])}")
    return lines


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._index_lock = threading.Lock()

    def _register(self, cls, kind, name, help, labels) -> _Metric:
        with self._index_lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name} re-registered as {kind}"
                        f"{tuple(labels)} (was {m.kind}{m.label_names})")
                return m
            m = self._metrics[name] = cls(kind, name, help, tuple(labels))
            return m

    def _sorted_metrics(self) -> list:
        with self._index_lock:
            return [self._metrics[name] for name in sorted(self._metrics)]

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._register(Counter, "counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._register(Gauge, "gauge", name, help, labels)

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

    def sum_counter(self, name: str) -> float:
        """Total over all label values (0.0 when never registered)."""
        with self._index_lock:
            m = self._metrics.get(name)
        if m is None:
            return 0.0
        with m._lock:
            return float(sum(m.samples.values()))


_DEVICE_KEYS = (
    "compiles", "dispatches", "bytes_h2d", "bytes_d2h",
    "pack_real_elements", "pack_padded_elements", "padding_waste_frac",
    "rows_real", "rows_padded", "bucket_occupancy_frac",
    "device_peak_bytes_in_use",
)


def device_summary(registry: MetricsRegistry | None) -> dict:
    """The journal's ``run_end.device``: the JAX package's fixed key set
    from the device counters, zeros for a registry nothing touched."""
    out = {k: 0 for k in _DEVICE_KEYS}
    if registry is None:
        return out
    total = registry.sum_counter
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
