"""Latency profiling over the span events of a trace.

The online tick's wall-clock cost hides three very different phases — the
``predict_matrix`` dispatch, the conjugate update stream, and the
``heft_schedule_array`` re-plan — and each pays a one-off cost on its
first call (library and CUDA context set-up, lazy loading of kernels).
Averaging that into steady state makes every latency number a lie, so the
breakdown here splits them: per phase, the first span is reported as
``first_s`` (set-up + execute) and the rest as steady-state statistics.
"""
from __future__ import annotations

import numpy as np


def _span_payloads(events, phase: str | None = None) -> list[dict]:
    out = []
    for e in events:
        kind = e.kind if hasattr(e, "kind") else e.get("kind")
        if kind != "span":
            continue
        d = dict(e.data) if hasattr(e, "data") else dict(e)
        if phase is None or d.get("phase") == phase:
            if hasattr(e, "t_sim"):
                d.setdefault("t_sim", e.t_sim)
                d.setdefault("t_wall", e.t_wall)
            out.append(d)
    return out


def phase_breakdown(events) -> dict[str, dict]:
    """Per-phase wall-time statistics with the first call split out.

    Returns ``{phase: {count, first_s, steady_mean_s, steady_p50_s,
    steady_max_s, steady_total_s, total_s}}``.  ``first_s`` is the
    phase's first span (set-up + execute);
    the ``steady_*`` statistics cover every later span — NaN when the
    phase ran only once.  Spans are grouped in stream order, which is
    wall-clock order for a single-threaded loop.
    """
    by_phase: dict[str, list[float]] = {}
    for d in _span_payloads(events):
        by_phase.setdefault(str(d.get("phase", "?")), []).append(
            float(d.get("dur_s", 0.0)))
    out: dict[str, dict] = {}
    for phase, durs in by_phase.items():
        steady = np.array(durs[1:], np.float64)
        out[phase] = {
            "count": len(durs),
            "first_s": durs[0],
            "steady_mean_s": float(steady.mean()) if steady.size else
            float("nan"),
            "steady_p50_s": float(np.median(steady)) if steady.size else
            float("nan"),
            "steady_max_s": float(steady.max()) if steady.size else
            float("nan"),
            "steady_total_s": float(steady.sum()),
            "total_s": float(sum(durs)),
        }
    return out


def slowest_spans(events, n: int = 5) -> list[dict]:
    """The ``n`` slowest spans of the trace (phase, dur_s, t_sim, extra
    payload), slowest first — the "which tick hurt" view."""
    spans = _span_payloads(events)
    spans.sort(key=lambda d: -float(d.get("dur_s", 0.0)))
    return spans[:n]


def tick_latency_summary(events) -> dict:
    """One roll-up for benchmarks: the per-phase breakdown plus the
    total traced wall time, the first-call share (``compile_*``: the
    JAX package's key names, kept so both packages' reports compare),
    and the steady-state per-tick cost (sum of every phase's steady mean
    — the cost of one fully-instrumented observe → re-predict → re-plan
    tick once every first call is paid)."""
    phases = phase_breakdown(events)
    total = sum(p["total_s"] for p in phases.values())
    first = sum(p["first_s"] for p in phases.values())
    steady_tick = sum(p["steady_mean_s"] for p in phases.values()
                     if np.isfinite(p["steady_mean_s"]))
    return {
        "phases": phases,
        "traced_total_s": total,
        "compile_total_s": first,
        "compile_frac": first / total if total > 0 else float("nan"),
        "steady_tick_s": steady_tick,
    }
