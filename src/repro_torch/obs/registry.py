"""Minimal metrics registry: named counters, gauges and histograms.

The trace is the ground truth; the registry is the roll-up — a flat,
JSON-ready bag of metrics that reports, benches and CI gates read without
re-walking the event stream.  ``MetricsRegistry.from_events`` builds the
standard set from a trace (event counts per kind, a histogram per span
phase, final-state gauges from ``run_end``); callers can also register
their own series by hand (``counter`` / ``gauge`` / ``histogram``).

Deliberately tiny — no labels, no time windows, no export protocol beyond
``to_dict``.  If this ever needs Prometheus semantics, replace it, don't
grow it.
"""
from __future__ import annotations

import numpy as np


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, by: int = 1) -> None:
        self.value += by


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value: float | None = None

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Append-only sample list with summary statistics on demand."""
    __slots__ = ("samples",)

    def __init__(self):
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        a = np.asarray(self.samples, np.float64)
        return {"count": int(a.size), "sum": float(a.sum()),
                "mean": float(a.mean()), "p50": float(np.median(a)),
                "p95": float(np.percentile(a, 95)), "max": float(a.max())}


class MetricsRegistry:
    """Namespace of metrics; creation is idempotent per (kind, name)."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def to_dict(self) -> dict:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }

    @classmethod
    def from_events(cls, events) -> "MetricsRegistry":
        """The standard trace roll-up: ``events.<kind>`` counters, a
        ``span_s.<phase>`` histogram per span phase, and one gauge per
        numeric field of the final ``run_end`` event."""
        reg = cls()
        for e in events:
            kind = e.kind if hasattr(e, "kind") else e.get("kind")
            data = e.data if hasattr(e, "data") else {
                k: v for k, v in e.items()
                if k not in ("kind", "t_sim", "t_wall")}
            reg.counter(f"events.{kind}").inc()
            if kind == "span":
                reg.histogram(
                    f"span_s.{data.get('phase', '?')}").observe(
                    float(data.get("dur_s", 0.0)))
            elif kind == "run_end":
                for k, v in data.items():
                    if isinstance(v, (int, float)):
                        reg.gauge(f"final.{k}").set(float(v))
        return reg
