"""Human-readable rendering of a saved trace.

``render_report`` turns an event stream (live ``EventLog`` or events
loaded from a JSONL trace) into the summary a person actually wants when
a run looks wrong: what happened (counters), whether the uncertainty can
be trusted (calibration table + PIT histogram), where the wall time went
(per-phase latency, compile vs steady state, slowest ticks), and the
chronological fault/retry narrative.  ``scripts/report_trace_torch.py``
is the CLI wrapper; ``report_dict`` is the machine-readable twin CI
archives next to the trace.  (The report's labels keep the JAX package's
"compile" wording, so the two packages render the same text.)
"""
from __future__ import annotations

import math

from .calibration import calibration_summary
from .profiling import phase_breakdown, slowest_spans, tick_latency_summary
from .registry import MetricsRegistry


def _fmt(v, unit: str = "", prec: int = 3) -> str:
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "-"
    if isinstance(v, float):
        return f"{v:.{prec}g}{unit}"
    return f"{v}{unit}"


def _fmt_s(v) -> str:
    """Engineering-format seconds (ms/us below 1s)."""
    if v is None or not math.isfinite(v):
        return "-"
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.0f}us"


def _pit_bar(counts: list[int], width: int = 30) -> list[str]:
    total = sum(counts) or 1
    peak = max(counts) or 1
    return [f"{'#' * max(1, round(width * c / peak)) if c else '':<{width}}"
            f" {c:4d} ({c / total:5.1%})" for c in counts]


def report_dict(events, min_obs: int = 20) -> dict:
    """Machine-readable report: metrics roll-up, calibration summary,
    latency breakdown, slowest spans, fault narrative."""
    narrative = []
    for e in events:
        kind = e.kind if hasattr(e, "kind") else e.get("kind")
        if kind in ("fault", "retry", "node_down", "node_up", "stranded"):
            d = dict(e.data) if hasattr(e, "data") else dict(e)
            d.pop("t_wall", None)
            narrative.append({"t_sim": getattr(e, "t_sim", d.pop("t_sim", 0.0)),
                              "kind": kind, **d})
    return {
        "metrics": MetricsRegistry.from_events(events).to_dict(),
        "calibration": calibration_summary(events, min_obs=min_obs),
        "latency": tick_latency_summary(events),
        "slowest_spans": slowest_spans(events),
        "fault_narrative": narrative,
    }


def render_report(events, min_obs: int = 20) -> str:
    """The human-readable report (one plain-text block)."""
    events = list(events)
    lines: list[str] = []
    reg = MetricsRegistry.from_events(events).to_dict()

    # ---- header: run configuration ---------------------------------------
    start = next((e for e in events
                  if (e.kind if hasattr(e, "kind") else e.get("kind"))
                  == "run_start"), None)
    lines.append("=" * 64)
    lines.append("TRACE REPORT")
    lines.append("=" * 64)
    if start is not None:
        d = start.data if hasattr(start, "data") else start
        cfg = ", ".join(f"{k}={v}" for k, v in sorted(d.items()))
        lines.append(f"run config: {cfg}")
    final = reg["gauges"]
    if final:
        lines.append("final state: " + ", ".join(
            f"{k.removeprefix('final.')}={_fmt(v)}"
            for k, v in final.items()))
    lines.append("")

    # ---- counters ----------------------------------------------------------
    lines.append("-- event counters " + "-" * 46)
    counters = {k.removeprefix("events."): v
                for k, v in reg["counters"].items()}
    for k in sorted(counters):
        lines.append(f"  {k:<14s} {counters[k]:6d}")
    lines.append("")

    # ---- calibration -------------------------------------------------------
    cal = calibration_summary(events, min_obs=min_obs)
    lines.append("-- calibration (predictive intervals) " + "-" * 26)
    if cal["n_obs"] == 0:
        lines.append("  no observe events in this trace")
    else:
        lines.append(
            f"  observations: {cal['n_obs']} "
            f"({cal['n_post_warmup']} after the {cal['min_obs']}-obs "
            "warm-up)")
        lines.append(
            f"  coverage      post-warmup {_fmt(cal['coverage'], prec=4)}"
            f"   all {_fmt(cal['coverage_all'], prec=4)}")
        lines.append(
            f"  sharpness     post-warmup {_fmt(cal['sharpness'])}s"
            f"   relative {_fmt(cal['sharpness_rel'])}")
        lines.append(
            f"  PIT dist-from-uniform (TV): {_fmt(cal['pit_tv'])}")
        cov0, cov1 = cal["coverage_timeline_first_last"]
        mpe0, mpe1 = cal["mpe_timeline_first_last"]
        lines.append(f"  coverage timeline {_fmt(cov0, prec=4)} -> "
                     f"{_fmt(cov1, prec=4)}   cumulative MPE "
                     f"{_fmt(mpe0)} -> {_fmt(mpe1)}")
        if cal["n_post_warmup"]:
            lines.append("  PIT histogram (post-warm-up, 10 bins over "
                         "[0, 1]):")
            for i, bar in enumerate(_pit_bar(cal["pit_hist"])):
                lo, hi = cal["pit_edges"][i], cal["pit_edges"][i + 1]
                lines.append(f"    [{lo:.1f},{hi:.1f}) {bar}")
    lines.append("")

    # ---- latency -----------------------------------------------------------
    lines.append("-- latency (wall clock, compile vs steady state) "
                 + "-" * 15)
    phases = phase_breakdown(events)
    if not phases:
        lines.append("  no span events in this trace")
    else:
        lines.append(f"  {'phase':<16s} {'count':>5s} {'first':>9s} "
                     f"{'steady p50':>10s} {'steady max':>10s} "
                     f"{'total':>9s}")
        for phase in sorted(phases, key=lambda p: -phases[p]["total_s"]):
            p = phases[phase]
            lines.append(
                f"  {phase:<16s} {p['count']:>5d} {_fmt_s(p['first_s']):>9s} "
                f"{_fmt_s(p['steady_p50_s']):>10s} "
                f"{_fmt_s(p['steady_max_s']):>10s} "
                f"{_fmt_s(p['total_s']):>9s}")
        summ = tick_latency_summary(events)
        lines.append(
            f"  compile share {_fmt(summ['compile_frac'], prec=3)} of "
            f"{_fmt_s(summ['traced_total_s'])} traced; steady-state tick "
            f"~{_fmt_s(summ['steady_tick_s'])}")
        slow = slowest_spans(events, 5)
        if slow:
            lines.append("  slowest spans:")
            for s in slow:
                extra = {k: v for k, v in s.items()
                         if k not in ("phase", "dur_s", "t_sim", "t_wall")}
                extra_s = f"  {extra}" if extra else ""
                lines.append(
                    f"    {_fmt_s(s['dur_s']):>9s}  {s['phase']:<16s}"
                    f"t_sim={_fmt(s.get('t_sim', 0.0), prec=5)}{extra_s}")
    lines.append("")

    # ---- fault narrative ---------------------------------------------------
    churn = [e for e in events
             if (e.kind if hasattr(e, "kind") else e.get("kind"))
             in ("fault", "retry", "node_down", "node_up", "stranded")]
    lines.append("-- fault / retry narrative " + "-" * 37)
    if not churn:
        lines.append("  clean run: no faults, retries or node churn")
    else:
        for e in churn:
            kind = e.kind if hasattr(e, "kind") else e.get("kind")
            d = dict(e.data) if hasattr(e, "data") else dict(e)
            t = getattr(e, "t_sim", d.pop("t_sim", 0.0))
            detail = ", ".join(f"{k}={_fmt(v, prec=4)}"
                               for k, v in sorted(d.items()))
            lines.append(f"  t={t:10.2f}  {kind:<10s} {detail}")
    lines.append("=" * 64)
    return "\n".join(lines)
