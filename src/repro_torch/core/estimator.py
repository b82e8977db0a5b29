"""LotaruEstimator — the paper's four phases, end to end, in PyTorch.

``LotaruEstimator`` is the faithful reproduction (genomics plane): profile
-> downsample + dual local runs (normal / CPU-throttled) -> per-task BLR
with Pearson gating -> per-node factor adjustment, with Bayesian
uncertainty propagated to every (task x node) prediction.

Port of ``repro.core.estimator``'s genomics plane.  The fitted posteriors
and the factor-scaled (task x node) matrix are computed on the estimator's
device (``device=None`` is the CUDA card) in its dtype (float64 unless the
caller passes ``dtype=torch.float32``); the matrix crosses to the host once
per ``predict_matrix`` into the numpy cache that ``observe_batch`` dirties
and the bias fold reads.  The bias and reliability posteriors are numpy on
the host, as in the JAX package.  ``save``/``load`` read and write the JAX
package's schema v6 files.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from scipy import stats as _scipy_stats

from repro_torch import resolve_device
from repro_torch.obs.trace import NULL_TRACER

from .adjust import cpu_weight, deviation, runtime_factor, stack_benches
from .blr import (POSTERIOR_FIELDS, BatchedTaskModel, BiasModel,
                  BLRPosterior, OnlineStats, ReliabilityModel, SampleLog,
                  TaskModel, _default_dtype, _np, _slice_rows, _to_device,
                  fit_task, fit_task_batch, predict_cdf, predict_interval,
                  predict_task_batch, unstack_task_models,
                  update_task_batch_stream)
from .downsample import partition_sizes
from .profiler import BenchResult

SCHEMA_VERSION = 6   # LotaruEstimator.save/load on-disk format
# v1: raw samples only (refit on load)     v2: + fitted posteriors
# v3: + per-(task, node) bias state        v4: + bias hyperparameters
# v5: + per-node reliability posterior          (decay, empirical_bayes)
#      (Beta-Binomial attempt-success state)
# Every version still loads; see docs/architecture.md for the field map.


def _fold_bias_matrix(bias: BiasModel, bias_col: dict[str, int],
                      nodes: list[str], mean: np.ndarray, std: np.ndarray,
                      with_std: bool = True):
    """Fold a learned (row × node) bias into a bias-free estimate matrix:
    mean scaled by the posterior point estimate, std widened by the
    posterior uncertainty.  Unobserved pairs and nodes outside the bias
    universe pass through untouched (bitwise), so dirty-row caches stay
    valid.  ``with_std=False`` skips the (comparatively costly) widening
    and returns ``(mean, None)`` for mean-only consumers."""
    known = [k for k, n in enumerate(nodes) if n in bias_col]
    if not known:
        return mean.copy(), (std.copy() if with_std else None)
    cols = [bias_col[nodes[k]] for k in known]
    out_mean = mean.copy()
    out_std = None
    if with_std:
        out_std = std.copy()
        out_std[:, known] = bias.widen_std(mean[:, known], std[:, known],
                                           cols)
    out_mean[:, known] = mean[:, known] * bias.matrix(cols)
    return out_mean, out_std


def _as_obs_tuple(o) -> tuple[str, str, float, float]:
    """Accept (task, node, size, runtime) tuples or Observation-likes."""
    if isinstance(o, (tuple, list)):
        task, node, size, runtime = o
        return str(task), str(node), float(size), float(runtime)
    return str(o.task), str(o.node), float(o.size), float(o.runtime)


class _BiasLayer:
    """Per-(row, node) bias plumbing of the estimator.

    The concrete class exposes its ordered row registry via
    ``_bias_rows()`` (``tasks`` for the genomics plane); everything else —
    node-column universe, lazy state creation, matrix/scalar folding, row
    lookup — lives here once (the JAX package shares it with its ML-plane
    estimator, which is not ported yet)."""

    def _bias_setup(self, bias_correction: bool, *, decay: float = 1.0,
                    sigma_r: float = 0.25,
                    empirical_bayes: bool = False) -> None:
        """``decay`` / ``sigma_r`` / ``empirical_bayes`` are forwarded to
        the lazily-created ``BiasModel`` (see its docstring); the defaults
        are bit-exact with the hyperparameter-free layer."""
        self.bias_correction = bias_correction
        self.bias: BiasModel | None = None
        # observability: spans around the matrix dispatch and the
        # update/bias scatters go through this tracer (NULL_TRACER = the
        # zero-cost disabled path; set_tracer attaches a live EventLog)
        self._tracer = NULL_TRACER
        # per-node attempt-reliability posterior (lazily created on the
        # first recorded attempt, like the bias state): keyed by node
        # *instance* name, since availability is a property of the
        # machine, not its hardware type
        self.reliability: ReliabilityModel | None = None
        self._bias_opts = {"decay": float(decay), "sigma_r": float(sigma_r),
                           "empirical_bayes": bool(empirical_bayes)}
        self.bias_nodes = ([self.local_bench.node]
                           + list(self.target_benches))
        self._bias_col = {n: j for j, n in enumerate(self.bias_nodes)}
        self._row_map: dict[str, int] | None = None

    def _bias_rows(self) -> dict:
        raise NotImplementedError

    def set_tracer(self, tracer) -> None:
        """Attach a tracer (``repro_torch.obs.trace.Tracer``): the
        estimator's ``predict_matrix`` dispatches and its update/bias
        scatters emit
        wall-clock spans through it.  Tracing is read-only — it never
        changes a prediction (``None`` restores the no-op tracer)."""
        self._tracer = tracer if tracer is not None else NULL_TRACER

    def _row_of(self, name: str) -> int:
        """Row index of a task/cell — cached: the executor hits this per
        completion and per running task, and a linear scan per call would
        make every tick O(T²)."""
        rows = self._bias_rows()
        if self._row_map is None or len(self._row_map) != len(rows):
            self._row_map = {n: i for i, n in enumerate(rows)}
        return self._row_map[name]

    def _ensure_bias(self) -> BiasModel:
        """Bias state sized to the current row set (rows grow with it).
        The node universe snapshots ``target_benches`` the moment the
        first state is created — until then a swapped-out bench dict is
        picked up; after, columns are pinned so accumulated pair stats
        never silently misalign."""
        if self.bias is None:
            self.bias_nodes = ([self.local_bench.node]
                               + list(self.target_benches))
            self._bias_col = {n: j for j, n in enumerate(self.bias_nodes)}
            self.bias = BiasModel(len(self._bias_rows()),
                                  len(self.bias_nodes), **self._bias_opts)
        else:
            self.bias.expand_rows(len(self._bias_rows()))
        return self.bias

    def _bias_fold(self, nodes: list[str], mean: np.ndarray,
                   std: np.ndarray, with_std: bool = True):
        if not self.bias_correction:
            return mean.copy(), (std.copy() if with_std else None)
        return _fold_bias_matrix(self._ensure_bias(), self._bias_col,
                                 nodes, mean, std, with_std)

    def _bias_fold_scalar(self, name: str, node: str, mean: float,
                          std: float) -> tuple[float, float]:
        if self.bias_correction:
            bias = self._ensure_bias()
            j = self._bias_col.get(node)
            if j is not None:
                return bias.fold_scalar(self._row_of(name), j, mean, std)
        return mean, std

    def bias_point(self, name: str, node: str) -> float:
        """Current multiplicative bias point estimate for the
        (task/cell, node) pair — 1.0 when the pair is unobserved or bias
        correction is off.  The straggler coupling reads this: a pair
        whose bias has drifted high is systematically slower than its
        prediction admits."""
        if not self.bias_correction or self.bias is None:
            return 1.0
        j = self._bias_col.get(node)
        if j is None:
            return 1.0
        return self.bias.point(self._row_of(name), j)

    def bias_tail_mass(self, name: str, node: str,
                       threshold: float) -> float:
        """Posterior probability that the (task/cell, node) bias exceeds
        ``threshold`` — the admission statistic for risk-aware
        speculative copies (``OnlineExecutor(spec_tail=...)``).  Unlike
        ``bias_point`` (a point estimate that crosses a threshold the
        moment the posterior mean does), this demands the posterior
        *mass* to sit above the drift line, so barely-observed pairs
        with wide posteriors do not trigger copies.  Returns 0.0 when
        the pair is unobserved, the node is outside the bias universe,
        or bias correction is off."""
        if not self.bias_correction or self.bias is None:
            return 0.0
        j = self._bias_col.get(node)
        if j is None:
            return 0.0
        return self.bias.tail_mass(self._row_of(name), j, threshold)

    # ---- per-node attempt reliability (availability plane) ----------------
    def record_attempt(self, node: str, success: bool) -> None:
        """Feed one attempt outcome on ``node`` into the Beta–Binomial
        reliability posterior (created lazily on first use).  Crashed
        or failed attempts count as failures; scheduler-ordered kills
        (a lost speculative race) must NOT be recorded — the node did
        nothing wrong."""
        if self.reliability is None:
            self.reliability = ReliabilityModel()
        self.reliability.record(node, success)

    def reliability_factor(self, node: str, k: float = 1.0) -> float:
        """Expected time-to-success multiplier for ``node`` —
        ``1 / (E[p_success] - k·sd)``, floored; 1.0 while no attempt has
        ever been recorded (the layer is inert until evidence exists,
        like the bias posterior)."""
        if self.reliability is None:
            return 1.0
        return self.reliability.factor(node, k)

    def reliability_factors(self, nodes, k: float = 1.0) -> np.ndarray:
        """(N,) reliability factors in ``nodes`` order (all-ones while
        the reliability state is empty)."""
        if self.reliability is None:
            return np.ones(len(nodes), np.float64)
        return self.reliability.factors(nodes, k)


def _scaled_matrix_core(model: BatchedTaskModel, factors, size):
    """Batched Student-t predictive x (T, N) factors, on the model's
    device."""
    mean_t, std_t = predict_task_batch(model, size)
    return mean_t[:, None] * factors, std_t[:, None] * factors


@dataclass
class FittedTask:
    model: TaskModel
    w: float                      # CPU-vs-IO weight (paper eq. 5)
    sizes: np.ndarray
    runtimes: np.ndarray


class LotaruEstimator(_BiasLayer):
    """Paper-faithful estimator over black-box tasks.

    ``device`` (``None``: the CUDA card, raising without one) and ``dtype``
    (``None``: float64) hold the fitted posteriors and the factor-scaled
    matrix; everything else is host state, as in the JAX package."""

    def __init__(self, local_bench: BenchResult,
                 target_benches: dict[str, BenchResult],
                 freq_reduction: float = 0.2, bias_correction: bool = True,
                 bias_decay: float = 1.0, bias_sigma_r: float = 0.25,
                 bias_empirical_bayes: bool = False, *, device=None,
                 dtype=None):
        self.device = resolve_device(device)
        self.dtype = _default_dtype(dtype)
        self.local_bench = local_bench
        self.target_benches = target_benches
        self.freq_reduction = freq_reduction
        self.tasks: dict[str, FittedTask] = {}
        self._batch_cache: tuple | None = None
        self._mat_cache: dict | None = None    # last (T, N) estimate matrix
        self._dirty_rows: set[int] = set()     # rows invalidated by observe()
        # online heterogeneity correction: per-(task, node) multiplicative
        # bias posterior fed by observe(); bias_correction=False keeps the
        # pure factor-scaled path (the paper-faithful ablation).
        # bias_decay < 1 forgets old residuals exponentially (hardware
        # drift); bias_empirical_bayes pools sigma_r from the observed
        # residual spread.  The defaults are bit-exact with the layer
        # without either.
        self._bias_setup(bias_correction, decay=bias_decay,
                         sigma_r=bias_sigma_r,
                         empirical_bayes=bias_empirical_bayes)

    def _bias_rows(self) -> dict:
        return self.tasks

    # ---- phases 2+3: local downsampled runs + model fit -------------------
    def fit_tasks(self, task_names: list[str], input_size: float,
                  run_local: Callable[[str, float, float], float],
                  n_partitions: int = 10, slow_partitions: int = 3) -> None:
        """run_local(task_name, size, cpu_factor) -> measured runtime.

        Collects every (task × partition) measurement first, then fits all
        T tasks in one batched ``fit_task_batch`` solve; the per-task
        scalar models are posterior-exact slices of that batch, and the
        batched cache is primed with the same fit (no second solve)."""
        sizes = np.array(partition_sizes(input_size, n_partitions))
        slow_factor = 1.0 - self.freq_reduction          # 20% CPU reduction
        runs, ws = [], []
        for name in task_names:
            normal = np.array([run_local(name, s, 1.0) for s in sizes])
            # second execution with reduced CPU speed on a few partitions
            sub = sizes[:slow_partitions]
            slow = np.array([run_local(name, s, slow_factor) for s in sub])
            devs = [deviation(t_new, t_old)
                    for t_new, t_old in zip(slow, normal[:slow_partitions])]
            ws.append(cpu_weight(float(np.median(devs)), 1.0, slow_factor))
            runs.append(normal)
        batch = fit_task_batch([sizes] * len(task_names), runs,
                               device=self.device, dtype=self.dtype)
        for name, model, w, normal in zip(task_names,
                                          unstack_task_models(batch),
                                          ws, runs):
            self.tasks[name] = FittedTask(model=model, w=w, sizes=sizes,
                                          runtimes=normal)
        self._batch_cache = None
        self._mat_cache = None
        self._dirty_rows.clear()
        self._row_map = None
        names = list(self.tasks)
        if names == list(task_names):    # batch covers the whole task set
            fts = [self.tasks[n] for n in names]
            self._batch_cache = (names, fts, batch,
                                 np.array(ws, np.float64))

    # ---- phase 4: adjusted prediction --------------------------------------
    def factor(self, task_name: str, node: str) -> float:
        if node == self.local_bench.node:
            return 1.0
        ft = self.tasks[task_name]
        return runtime_factor(ft.w, self.local_bench,
                              self.target_benches[node])

    def predict(self, task_name: str, node: str, size: float):
        """(mean, std) for task on node at input size.

        The factor-scaled Student-t prediction, with the learned
        per-(task, node) bias folded in when the pair has been observed
        (scalar oracle of ``predict_matrix`` — test-enforced)."""
        ft = self.tasks[task_name]
        mean, std = ft.model.predict(size)
        f = self.factor(task_name, node)
        mean, std = float(mean) * f, float(std) * f
        return self._bias_fold_scalar(task_name, node, mean, std)

    def predict_local(self, task_name: str, size: float):
        ft = self.tasks[task_name]
        mean, std = ft.model.predict(size)
        return float(mean), float(std)

    # ---- batched (task × node) matrix API ----------------------------------
    def _batched(self) -> tuple[list[str], BatchedTaskModel, np.ndarray]:
        """All T task models stacked into one batched fit.

        Cached; invalidated when the task set OR any ``FittedTask`` object
        changes (identity check, so replacing ``est.tasks[name]`` in place
        is picked up — the cache holds the refs, keeping ids stable)."""
        names = list(self.tasks)
        fts = [self.tasks[n] for n in names]
        c = self._batch_cache
        if (c is None or c[0] != names
                or any(a is not b for a, b in zip(c[1], fts))):
            model = fit_task_batch([ft.sizes for ft in fts],
                                   [ft.runtimes for ft in fts],
                                   device=self.device, dtype=self.dtype)
            w = np.array([ft.w for ft in fts], np.float64)
            self._batch_cache = (names, fts, model, w)
        return (self._batch_cache[0], self._batch_cache[2],
                self._batch_cache[3])

    def task_names(self) -> list[str]:
        """Row order of ``predict_matrix`` / ``factor_matrix``."""
        return list(self.tasks)

    def factor_matrix(self, nodes: list[str]) -> np.ndarray:
        """(T, N) adjustment factors, rows in ``task_names()`` order."""
        names, _, w = self._batched()
        F = np.ones((len(names), len(nodes)))
        targets = [n for n in nodes if n != self.local_bench.node]
        if targets:
            Ft = runtime_factor(w, self.local_bench,
                                stack_benches([self.target_benches[n]
                                               for n in targets]))
            k = 0
            for j, n in enumerate(nodes):
                if n != self.local_bench.node:
                    F[:, j] = Ft[:, k]
                    k += 1
        return F

    def predict_matrix(self, nodes: list[str], size, with_std: bool = True):
        """Full (task × node) estimate matrix, computed on the device and
        brought to the host in one transfer.

        ``size`` is a scalar (shared input size) or a (T,) per-task array.
        Returns (mean, std) arrays of shape (T, N): rows follow
        ``task_names()``, columns follow ``nodes`` (the local node gets
        factor 1, matching ``predict_local``).  With ``with_std=False``
        the std slot is ``None`` and the bias widening is skipped — for
        mean-only consumers (e.g. a risk-neutral HEFT rank) that don't
        want to pay for the delta-method fold.  ``with_std=True`` is the
        risk-aware path: the returned std already carries the bias
        posterior's own uncertainty, which is exactly the sigma a
        ``risk_k``-weighted scheduler should consume.

        The matrix is cached per (nodes, size); ``observe`` invalidates
        only the observed task's row, so an online re-predict recomputes
        the dirty rows instead of the whole matrix.  The cache holds the
        bias-free factor-scaled matrix; the (cheap, host-side) bias fold
        is applied on the way out so bias updates never force a device
        recompute of clean rows; a dirty-row refresh gathers, computes and
        brings back only the dirty rows."""
        _, model, _ = self._batched()
        dev, dt = self.device, self.dtype
        key = (tuple(nodes), np.asarray(size, np.float64).tobytes())
        c = self._mat_cache
        if c is not None and c["key"] == key and c["model"] is model:
            rows = sorted(self._dirty_rows)
            if rows:
                idx = np.asarray(rows)
                sub = model.rows(idx)
                sz = size if np.ndim(size) == 0 else np.asarray(size)[idx]
                with self._tracer.span("predict_matrix", rows=len(rows),
                                       mode="dirty"):
                    ms = _np(torch.stack(_scaled_matrix_core(
                        sub, _to_device(c["F"][idx], dev, dt),
                        _to_device(np.asarray(sz, np.float64), dev, dt))))
                    c["mean"][idx] = ms[0]
                    c["std"][idx] = ms[1]
                self._dirty_rows.clear()
            return self._bias_fold(nodes, c["mean"], c["std"], with_std)
        F = self.factor_matrix(nodes)
        with self._tracer.span("predict_matrix", rows=len(self.tasks),
                               mode="full"):
            ms = _np(torch.stack(_scaled_matrix_core(
                model, _to_device(F, dev, dt),
                _to_device(np.asarray(size, np.float64), dev, dt))))
            # copies: the cache is patched row by row
            mean, std = ms[0].copy(), ms[1].copy()
        self._mat_cache = {"key": key, "model": model, "F": F,
                           "mean": mean, "std": std}
        self._dirty_rows.clear()
        return self._bias_fold(nodes, self._mat_cache["mean"],
                               self._mat_cache["std"], with_std)

    # ---- phase 5 (beyond paper): online estimation ------------------------
    def observe(self, task_name: str, node: str, size: float,
                runtime: float) -> float:
        """Feed one realised (size, runtime) from ``node`` back in.

        Single-observation convenience over ``observe_batch`` — returns
        the de-adjusted local-equivalent runtime that entered the model."""
        return self.observe_batch([(task_name, node, size, runtime)])[0]

    def observe_batch(self, observations) -> list[float]:
        """Absorb a whole tick's completions in one update stream.

        ``observations``: iterable of ``(task, node, size, runtime)``
        tuples or ``Observation``-likes (``.task/.node/.size/.runtime``) —
        e.g. everything that finished at the same simulation time.  Per
        observation:

        * the measured runtime is de-adjusted by factor × tick-start bias
          to the local-machine scale and queued for the model update;
        * after ONE ``update_task_batch_stream`` call absorbs the queued
          stream (identical math to sequential ``update_task_batch``
          calls), each observation's
          residual against the POST-update factor-scaled prediction feeds
          the conjugate per-(task, node) bias posterior — what the
          refreshed model still cannot explain is the pair-specific part.

        Only the affected rows of any cached estimate matrix are
        invalidated.  Tick semantics: all residuals in the batch are
        evaluated against the post-tick posterior, so two same-task
        observations in one tick see the same model mean — sequential
        ``observe`` calls refresh it in between (batches over distinct
        tasks are exactly equivalent to sequential calls).  Returns the
        de-adjusted local runtimes in input order."""
        obs = [_as_obs_tuple(o) for o in observations]
        if not obs:
            return []
        names, model, _ = self._batched()
        row = {n: k for k, n in enumerate(names)}
        bias = self._ensure_bias() if self.bias_correction else None
        idx = np.empty(len(obs), np.int64)
        xs = np.empty(len(obs), np.float64)
        ys = np.empty(len(obs), np.float64)
        factors = np.empty(len(obs), np.float64)
        for k, (task, node, size, runtime) in enumerate(obs):
            i = row[task]
            f = max(float(self.factor(task, node)), 1e-12)
            b = 1.0
            if bias is not None and node in self._bias_col:
                b = bias.point(i, self._bias_col[node])
            idx[k] = i
            xs[k] = size
            ys[k] = runtime / (f * max(b, 1e-12))
            factors[k] = f
        with self._tracer.span("update_stream", n=len(obs)):
            new_model = update_task_batch_stream(model, idx, xs, ys)
        affected = []
        for k, (task, _, _, _) in enumerate(obs):
            ft = self.tasks[task]
            # keep the raw history on the FittedTask (same object, so the
            # batched cache's identity check stays valid) — a later full
            # refit over these arrays reproduces the incremental state
            ft.sizes = np.append(ft.sizes, xs[k])
            ft.runtimes = np.append(ft.runtimes, ys[k])
            affected.append(int(idx[k]))
        hit = sorted(set(affected))
        for i, tm in zip(hit, _slice_rows(new_model, hit)):
            self.tasks[names[i]].model = tm
        if bias is not None:
            # bias residuals against the POST-update factor-scaled means:
            # the model has already absorbed everything it can explain
            # from this tick (the task-common part), so what is left is
            # the pair-specific residual — charging the PRE-update means
            # instead would double-count the model's own transient misfit
            # into whichever pair happened to report first.  The whole
            # tick goes through ONE BiasModel.update scatter: one update
            # is one forgetting step, so the decay clock ticks per
            # simulation tick, not per completion within it
            rows, cols, lrs = [], [], []
            for k, (task, node, size, runtime) in enumerate(obs):
                if node not in self._bias_col:
                    continue
                m_post, _ = self.tasks[task].model.predict(size)
                scaled = factors[k] * float(m_post)
                if runtime > 0.0 and scaled > 1e-12:
                    rows.append(int(idx[k]))
                    cols.append(self._bias_col[node])
                    lrs.append(np.log(runtime / scaled))
            if rows:
                with self._tracer.span("bias_update", n=len(rows)):
                    bias.update(rows, cols, lrs)
        c = self._batch_cache
        self._batch_cache = (c[0], c[1], new_model, c[3])
        if self._mat_cache is not None and self._mat_cache["model"] is model:
            self._mat_cache["model"] = new_model
            self._dirty_rows.update(affected)
        else:
            self._mat_cache = None
        return [float(y) for y in ys]

    def predict_interval_node(self, task_name: str, node: str, size: float,
                              confidence: float = 0.9) -> tuple[float, float]:
        """Equal-tailed predictive interval for the task on ``node``.

        Student-t interval (factor-scaled) for correlated tasks; a normal
        median ± z·spread envelope for the median fallback.  When the
        (task, node) bias pair has been observed, the interval is shifted
        by the bias point estimate and WIDENED by the bias posterior's
        own uncertainty (± z posterior sds of the log-bias), so a pair
        whose bias is still unsettled admits a broader range before the
        surprise gate fires."""
        ft = self.tasks[task_name]
        f = self.factor(task_name, node)
        z = float(_scipy_stats.norm.ppf(0.5 + confidence / 2.0))
        if ft.model.correlated:
            lo, hi = predict_interval(ft.model.post, size, confidence)
            lo, hi = float(lo), float(hi)
        else:
            lo = ft.model.median - z * ft.model.spread
            hi = ft.model.median + z * ft.model.spread
        s_lo = s_hi = 1.0
        if self.bias_correction:
            bias = self._ensure_bias()
            j = self._bias_col.get(node)
            if j is not None:
                s_lo, s_hi = bias.interval_scale(self._row_of(task_name),
                                                 j, z)
        return max(lo * f * s_lo, 0.0), hi * f * s_hi

    def predict_pit_node(self, task_name: str, node: str, size: float,
                         runtime: float) -> float:
        """Probability integral transform of a realised runtime under the
        predictive distribution on ``node``: ``F(runtime)`` with the same
        location/scale/dof family as ``predict_interval_node`` — the
        Student-t predictive for correlated tasks, the normal
        median/spread envelope for the fallback, shifted by the factor
        and the bias *point* estimate (the bias posterior's own widening
        is deliberately not folded in: PIT judges the core predictive
        σ the scheduler prices with).  A calibrated stream of PITs is
        uniform on [0, 1]; ``repro.obs.calibration`` histograms them.
        Read-only: never creates bias state or touches any cache the
        predictions depend on."""
        ft = self.tasks[task_name]
        f = max(float(self.factor(task_name, node)), 1e-12)
        b = 1.0
        if self.bias_correction and self.bias is not None:
            j = self._bias_col.get(node)
            if j is not None:
                b = self.bias.point(self._row_of(task_name), j)
        y_local = float(runtime) / (f * max(b, 1e-12))
        if ft.model.correlated:
            return predict_cdf(ft.model.post, size, y_local)
        z = (y_local - ft.model.median) / max(ft.model.spread, 1e-300)
        return float(_scipy_stats.norm.cdf(z))

    # ---- offline reuse (paper §1: "allows for offline scenarios where the
    # learned models are reused for future executions") -----------------
    def save(self, path) -> None:
        """Schema v6: persists the fitted posteriors themselves (v2), the
        online per-(task, node) bias state (v3), the bias
        hyperparameters — forgetting factor ``decay`` and the
        ``empirical_bayes`` noise pooling (v4) — the per-node
        Beta–Binomial reliability posterior (v5), and the consolidated
        batched state (v6: the streamed (T, 8) moment matrix plus the
        stacked posterior, the exact arrays the JAX package's
        ``EstimatorState`` carries), so a save → load round trip
        reproduces predictions AND
        availability pricing bit-exactly, including everything learned
        from streamed observations and attempt outcomes — and a loaded
        estimator resumes the fused tick MOMENT-exact, not refit-close
        (re-deriving moments from raw samples sums in a different order).
        Earlier files still load: missing v4/v5 fields default to the
        inert (bit-exact) values, missing v6 state falls back to the
        refit path."""
        import json
        from pathlib import Path
        state = None
        if self.tasks:
            names, model, _w = self._batched()
            if model.stats is not None:
                state = {
                    "tasks": list(names),
                    "moments": _np(model.stats.moments).tolist(),
                    "correlated": model.correlated.cpu().numpy()
                    .astype(bool).tolist(),
                    "median": _np(model.median).tolist(),
                    "spread": _np(model.spread).tolist(),
                    "post": {f: _np(getattr(model.post, f)).tolist()
                             for f in POSTERIOR_FIELDS}}
        out = {"version": SCHEMA_VERSION,
               "state": state,
               "freq_reduction": self.freq_reduction,
               "bias_correction": self.bias_correction,
               "bias_opts": dict(self._bias_opts),
               "bias": None if self.bias is None else {
                   "nodes": list(self.bias_nodes),
                   "state": self.bias.to_dict()},
               "reliability": (None if self.reliability is None
                               else self.reliability.to_dict()),
               "local_bench": self.local_bench.to_dict(),
               "target_benches": {k: v.to_dict()
                                  for k, v in self.target_benches.items()},
               "tasks": {}}
        for name, ft in self.tasks.items():
            m = ft.model
            post = None
            if m.post is not None:
                post = {"mu": _np(m.post.mu).tolist(),
                        "V": _np(m.post.V).tolist(),
                        "a": float(m.post.a), "b": float(m.post.b),
                        "x_scale": float(m.post.x_scale),
                        "y_scale": float(m.post.y_scale)}
            out["tasks"][name] = {
                "w": ft.w,
                "sizes": list(map(float, ft.sizes)),
                "runtimes": list(map(float, ft.runtimes)),
                "model": {"correlated": bool(m.correlated),
                          "median": float(m.median),
                          "spread": float(m.spread),
                          "post": post},
            }
        Path(path).write_text(json.dumps(out))

    @classmethod
    def load(cls, path, *, device=None, dtype=None) -> "LotaruEstimator":
        """Read a file of any schema version, written by either package,
        onto ``device`` in ``dtype``."""
        import json
        from pathlib import Path
        d = json.loads(Path(path).read_text())
        version = d.get("version", 1)
        local = BenchResult(**d["local_bench"])
        targets = {k: BenchResult(**v) for k, v in d["target_benches"].items()}
        opts = d.get("bias_opts", {})       # v4; absent in v1-v3 files
        est = cls(local, targets,
                  freq_reduction=d.get("freq_reduction", 0.2),
                  bias_correction=d.get("bias_correction", True),
                  bias_decay=opts.get("decay", 1.0),
                  bias_sigma_r=opts.get("sigma_r", 0.25),
                  bias_empirical_bayes=opts.get("empirical_bayes", False),
                  device=device, dtype=dtype)
        if version >= 3 and d.get("bias") is not None:
            est.bias_nodes = list(d["bias"]["nodes"])
            est._bias_col = {n: j for j, n in enumerate(est.bias_nodes)}
            est.bias = BiasModel.from_dict(d["bias"]["state"])
        if version >= 5 and d.get("reliability") is not None:
            est.reliability = ReliabilityModel.from_dict(d["reliability"])
        for name, rec in d["tasks"].items():
            sizes = np.asarray(rec["sizes"])
            runtimes = np.asarray(rec["runtimes"])
            if version >= 2:
                md = rec["model"]
                post = None
                if md["post"] is not None:
                    p = md["post"]
                    post = est._posterior(p["mu"], p["V"], p["a"], p["b"],
                                          p["x_scale"], p["y_scale"])
                model = TaskModel(correlated=md["correlated"], post=post,
                                  median=md["median"], spread=md["spread"])
            else:              # v1 files carried only the raw samples
                model = fit_task(sizes, runtimes, device=est.device,
                                 dtype=est.dtype)
            est.tasks[name] = FittedTask(model=model,
                                         w=rec["w"], sizes=sizes,
                                         runtimes=runtimes)
        if version >= 6 and d.get("state") is not None:
            st = d["state"]
            est._prime_batch_cache(st, st["moments"])
        return est

    def _posterior(self, *fields) -> BLRPosterior:
        """A posterior from its six JSON fields (``POSTERIOR_FIELDS``
        order), on the estimator's device."""
        return BLRPosterior(*(_to_device(np.asarray(v, np.float64),
                                         self.device, self.dtype)
                              for v in fields))

    def _prime_batch_cache(self, st: dict, moments) -> None:
        """v6 fast path: rebuild the batched model from the persisted
        moment matrix and stacked posterior — bit-exact to the saved
        in-memory state — instead of refitting from raw samples (whose
        different summation order perturbs the last ulp of the moments).
        The raw-sample ``SampleLog`` (median-fallback history) is
        reconstructed from the per-task arrays, which carry every
        streamed observation."""
        names = list(st["tasks"])
        if names != list(self.tasks):
            return                       # stale block: fall back to refit
        fts = [self.tasks[n] for n in names]
        p = st["post"]
        post = self._posterior(p["mu"], p["V"], p["a"], p["b"],
                               p["x_scale"], p["y_scale"])
        dev, dt = self.device, self.dtype
        count = np.array([len(ft.sizes) for ft in fts], np.int64)
        cap = max(1, int(count.max(initial=1)))
        X = np.zeros((len(fts), cap), np.float64)
        Y = np.zeros_like(X)
        for i, ft in enumerate(fts):
            X[i, :count[i]] = np.asarray(ft.sizes, np.float64)
            Y[i, :count[i]] = np.asarray(ft.runtimes, np.float64)
        stats = OnlineStats(moments=_to_device(np.asarray(moments,
                                                          np.float64),
                                               dev, dt),
                            log=SampleLog(X, Y, count))
        model = BatchedTaskModel(
            correlated=_to_device(np.asarray(st["correlated"], bool), dev,
                                  torch.bool),
            post=post,
            median=_to_device(np.asarray(st["median"], np.float64), dev, dt),
            spread=_to_device(np.asarray(st["spread"], np.float64), dev, dt),
            stats=stats)
        w = np.array([ft.w for ft in fts], np.float64)
        self._batch_cache = (names, fts, model, w)
