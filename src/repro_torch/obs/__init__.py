"""Observability plane for the online estimator loop.

Four layers over one substrate — the structured event trace:

* ``trace`` — the ``Tracer`` protocol (``NULL_TRACER`` when disabled),
  the append-only typed ``EventLog``, JSONL + Chrome ``trace_event``
  export (a tick timeline opens directly in Perfetto);
* ``calibration`` — empirical coverage, PIT histogram, sharpness and
  coverage/MPE timelines of the predictive intervals, computed from the
  trace's ``observe`` events (plus ``RunningMedian``, the O(log n)
  streaming median);
* ``profiling`` — per-phase wall-clock breakdown of the tick with the
  first-call (set-up) cost split from steady state;
* ``registry`` / ``report`` — the flat metrics roll-up and the
  human-readable report (``scripts/report_trace_torch.py`` is the CLI).
"""
from .calibration import (RunningMedian, calibration_summary,
                          coverage_timeline, empirical_coverage,
                          observe_records, pit_histogram, pit_uniformity,
                          running_median, sharpness)
from .profiling import (phase_breakdown, slowest_spans,
                        tick_latency_summary)
from .registry import MetricsRegistry
from .report import render_report, report_dict
from .trace import (EVENT_KINDS, TRACE_FORMAT_VERSION, Event, EventLog,
                    NULL_TRACER, NullTracer, Tracer, chrome_trace_events,
                    load_jsonl)

__all__ = [
    "EVENT_KINDS", "TRACE_FORMAT_VERSION", "Event", "EventLog",
    "NULL_TRACER", "NullTracer", "Tracer", "chrome_trace_events",
    "load_jsonl",
    "RunningMedian", "calibration_summary", "coverage_timeline",
    "empirical_coverage", "observe_records", "pit_histogram",
    "pit_uniformity", "running_median", "sharpness",
    "phase_breakdown", "slowest_spans", "tick_latency_summary",
    "MetricsRegistry", "render_report", "report_dict",
]
