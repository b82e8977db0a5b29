"""Calibration diagnostics for the online predictive distribution.

The paper's headline is not only low point error but *robust uncertainty
estimates as an input for advanced scheduling* — yet a σ nobody checks is
a σ nobody should price risk with: miscalibrated intervals silently
corrupt ``risk_k`` pricing and tail-mass speculation admission.  This
module turns the ``observe`` events of a trace (each carries the realised
runtime, the dispatch-time predictive mean/std, the ``confidence``-level
interval and its coverage flag, and the PIT value) into the standard
diagnostics:

* **empirical coverage** — the fraction of realised runtimes that landed
  inside their predictive interval, overall and after a warm-up (the
  first observations stream in against near-prior posteriors, so the gate
  excludes them);
* **PIT histogram** — probability-integral-transform values
  ``F(runtime)`` under the predictive CDF; a calibrated predictor's PITs
  are uniform on [0, 1] (∪-shape ⇒ overconfident, ∩-shape ⇒
  underconfident);
* **sharpness** — mean predictive-interval width (absolute and relative
  to the realised runtime): calibration alone is cheap (predict ±∞), the
  pair (coverage ≈ nominal, width small) is the actual target;
* **timelines** — running coverage and running-median prediction error
  per observation index, the trajectories ROADMAP item 4's regret
  feedback will consume.

Also home to ``RunningMedian``, the O(log n)-per-push two-heap running
median that replaced the O(n²) prefix re-median in
``ExecutionTrace.cumulative_mpe``.
"""
from __future__ import annotations

import heapq
from typing import Iterable, Sequence

import numpy as np


class RunningMedian:
    """Streaming median via the classic two-heap construction: a
    max-heap of the lower half, a min-heap of the upper half, rebalanced
    so their sizes never differ by more than one.  ``push`` is
    O(log n); ``median`` is O(1) and matches ``np.median`` of the pushed
    prefix exactly (odd count → the middle element; even count → the
    mean of the two middles, the same ``(a + b) / 2`` float arithmetic).
    """
    __slots__ = ("_lo", "_hi")

    def __init__(self):
        self._lo: list[float] = []   # max-heap (negated) — lower half
        self._hi: list[float] = []   # min-heap — upper half

    def __len__(self) -> int:
        return len(self._lo) + len(self._hi)

    def push(self, x: float) -> None:
        x = float(x)
        if self._lo and x > -self._lo[0]:
            heapq.heappush(self._hi, x)
        else:
            heapq.heappush(self._lo, -x)
        # rebalance: |lo| - |hi| must stay in {0, 1}
        if len(self._lo) > len(self._hi) + 1:
            heapq.heappush(self._hi, -heapq.heappop(self._lo))
        elif len(self._hi) > len(self._lo):
            heapq.heappush(self._lo, -heapq.heappop(self._hi))

    def median(self) -> float:
        if not self._lo:
            raise ValueError("median of an empty stream")
        if len(self._lo) > len(self._hi):
            return -self._lo[0]
        return (-self._lo[0] + self._hi[0]) / 2.0


def running_median(values: Iterable[float]) -> np.ndarray:
    """Median of each prefix of ``values`` — O(n log n) total, equal to
    ``[np.median(v[:k+1]) for k in range(n)]``."""
    rm = RunningMedian()
    out = []
    for v in values:
        rm.push(v)
        out.append(rm.median())
    return np.array(out)


def empirical_coverage(covered: Sequence[bool]) -> float:
    """Fraction of observations whose realised runtime fell inside its
    predictive interval (NaN on an empty sequence)."""
    c = np.asarray(covered, bool)
    return float(c.mean()) if c.size else float("nan")


def coverage_timeline(covered: Sequence[bool]) -> np.ndarray:
    """Running empirical coverage after each observation."""
    c = np.asarray(covered, np.float64)
    if c.size == 0:
        return c
    return np.cumsum(c) / np.arange(1, c.size + 1)


def pit_histogram(pits: Sequence[float], bins: int = 10
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Histogram of PIT values over [0, 1] (counts, bin edges)."""
    p = np.asarray(pits, np.float64)
    return np.histogram(p, bins=bins, range=(0.0, 1.0))


def pit_uniformity(pits: Sequence[float], bins: int = 10) -> float:
    """Total-variation distance of the PIT histogram from uniform, in
    [0, 1): 0 is perfectly calibrated, larger is worse.  A coarse single
    number for gates and tables — eyeball the histogram for the shape."""
    p = np.asarray(pits, np.float64)
    if p.size == 0:
        return float("nan")
    counts, _ = pit_histogram(p, bins)
    freq = counts / p.size
    return float(0.5 * np.abs(freq - 1.0 / bins).sum())


def sharpness(widths: Sequence[float]) -> float:
    """Mean predictive-interval width — the sharpness half of the
    calibration/sharpness trade-off (NaN on empty input)."""
    w = np.asarray(widths, np.float64)
    return float(w.mean()) if w.size else float("nan")


def observe_records(events) -> list[dict]:
    """The ``observe`` events of a trace as plain payload dicts, in
    stream order (accepts ``Event`` objects or raw dicts)."""
    out = []
    for e in events:
        kind = e.kind if hasattr(e, "kind") else e.get("kind")
        if kind != "observe":
            continue
        out.append(dict(e.data) if hasattr(e, "data") else dict(e))
    return out


def calibration_summary(events, min_obs: int = 20,
                        bins: int = 10) -> dict:
    """All calibration diagnostics of one trace in a JSON-ready dict.

    ``min_obs`` is the warm-up: ``coverage`` / ``sharpness_rel`` /
    ``pit_tv`` are computed over observations from index ``min_obs`` on
    (the stream's early intervals reflect the near-prior posterior, not
    the online estimator the gate is judging); the ``*_all`` twins cover
    the full stream.  Returns NaNs (and ``n_post_warmup = 0``) when the
    stream is shorter than the warm-up.
    """
    recs = observe_records(events)
    covered = np.array([bool(r["covered"]) for r in recs], bool)
    pits = np.array([float(r["pit"]) for r in recs
                     if r.get("pit") is not None], np.float64)
    widths = np.array([float(r["hi"]) - float(r["lo"]) for r in recs],
                      np.float64)
    rts = np.array([float(r["runtime"]) for r in recs], np.float64)
    rel_w = widths / np.maximum(rts, 1e-12)
    errs = np.array([abs(float(r["pred_mean"]) - float(r["runtime"]))
                     / max(float(r["runtime"]), 1e-12) for r in recs])
    post = slice(min_obs, None)
    n_post = max(len(recs) - min_obs, 0)
    counts, edges = pit_histogram(pits[post] if n_post else [], bins)
    return {
        "n_obs": len(recs),
        "min_obs": int(min_obs),
        "n_post_warmup": n_post,
        "coverage": empirical_coverage(covered[post]),
        "coverage_all": empirical_coverage(covered),
        "sharpness": sharpness(widths[post]),
        "sharpness_all": sharpness(widths),
        "sharpness_rel": sharpness(rel_w[post]),
        "pit_tv": pit_uniformity(pits[post] if n_post else [], bins),
        "pit_hist": counts.tolist(),
        "pit_edges": edges.tolist(),
        "coverage_timeline_first_last": (
            [float(coverage_timeline(covered)[0]),
             float(coverage_timeline(covered)[-1])]
            if len(recs) else [float("nan")] * 2),
        "mpe_timeline_first_last": (
            [float(running_median(errs)[0]), float(running_median(errs)[-1])]
            if len(recs) else [float("nan")] * 2),
    }
