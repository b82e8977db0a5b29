"""LotaruEstimator — the paper's four phases, end to end, in PyTorch.

``LotaruEstimator`` is the faithful reproduction (genomics plane): profile
-> downsample + dual local runs (normal / CPU-throttled) -> per-task BLR
with Pearson gating -> per-node factor adjustment, with Bayesian
uncertainty propagated to every (task x node) prediction.

``LotaruML`` is the accelerator-plane integration: workload cells from the
multi-pod dry-run are the tasks, token count is the input size, the local
runs execute on the developer CPU node, and the adjustment uses the
three-term (FLOPs/HBM/link) factor with weights from the cell's own
compiled roofline decomposition.  Its predictions (mean and uncertainty)
feed the HEFT scheduler, straggler thresholds, and Young/Daly checkpoint
intervals.

Port of ``repro.core.estimator``.  The fitted posteriors and the
(task x node) and (cell x node) matrices are computed on the estimator's
device (``device=None`` is the CUDA card) in its dtype (float64 unless the
caller passes ``dtype=torch.float32``); a matrix crosses to the host once
per ``predict_matrix`` into the numpy cache that ``observe_batch`` dirties
and the bias fold reads.  The bias and reliability posteriors are numpy on
the host, as in the JAX package.  ``LotaruEstimator.save``/``load`` read
and write the JAX package's schema v6 files.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from scipy import stats as _scipy_stats

from repro_torch import resolve_device
from repro_torch.obs.trace import NULL_TRACER

from .adjust import (cpu_weight, deviation, roofline_weights, runtime_factor,
                     runtime_factor3, stack_benches)
from .blr import (POSTERIOR_FIELDS, BatchedTaskModel, BiasModel,
                  BLRPosterior, OnlineStats, ReliabilityModel, SampleLog,
                  TaskModel, _default_dtype, _np, _slice_rows, _to_device,
                  fit_task, fit_task_batch, predict_cdf, predict_interval,
                  predict_task_batch, stack_task_models,
                  unstack_task_models, update_task_batch_stream)
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
    """Shared per-(row, node) bias plumbing of the two estimators.

    The concrete class exposes its ordered row registry via
    ``_bias_rows()`` (``tasks`` for the genomics plane, ``cells`` for the
    ML plane); everything else — node-column universe, lazy state
    creation, matrix/scalar folding, row lookup — lives here once, so the
    two planes cannot drift apart."""

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


def _ml_transfer(mean, std, w_c, has_w, flops, bytes_, coll, l_mat, l_mem,
                 l_link, t_mat, t_mem, t_link, is_local, mix):
    """The decomposed transfer of local predictive (mean, std) to target
    benches, elementwise over broadcast shapes: the cell arrays (``mean``,
    ``std``, ``w_c``, ``has_w``, ``flops``, ``bytes_``, ``coll``) against
    the target bench arrays (``t_*``, ``is_local``), with the local
    bench's scalars ``l_*``.  (T, 1) cells against (N,) benches give the
    (cell x node) matrix; (B,) against (B,) one prediction per pair.

    The dual-run per-resource transfer where a compute share is available
    (``has_w``), the whole-time roofline-ratio transfer elsewhere,
    identity on the local node; the link rate falls back to ``mem / 10``
    where a bench has none.  ``LotaruML._predict_base`` is its scalar
    oracle: the same operations in the same order."""
    l_link_f = torch.where(l_link > 0, l_link, l_mem / 10)
    t_link_f = torch.where(t_link > 0, t_link, t_mem / 10)
    lc = torch.stack(torch.broadcast_tensors(
        flops / (l_mat * 1e9), bytes_ / (l_mem * 1e9),
        coll / (l_link_f * 1e9)), -1)
    # dual-run decomposition: measured compute share splits the local time
    t_c = w_c * mean
    rest = (1.0 - w_c) * mean
    mn = lc[..., 1] + lc[..., 2]
    t_m = rest * torch.where(mn > 0, lc[..., 1] / torch.where(mn > 0, mn, 1.0),
                             1.0)
    t_n = rest - t_m
    parts = torch.stack(torch.broadcast_tensors(
        t_c * l_mat / torch.clamp_min(t_mat, 1e-9),
        t_m * l_mem / torch.clamp_min(t_mem, 1e-9),
        t_n * l_link_f / torch.clamp_min(t_link_f, 1e-9)), -1)
    pred_dual = parts.amax(-1) + mix * parts.amin(-1)
    std_dual = pred_dual * (std / torch.clamp_min(mean, 1e-12))
    # whole-time roofline-ratio transfer (no throttle probe)
    tt = torch.stack(torch.broadcast_tensors(
        flops / (t_mat * 1e9), bytes_ / (t_mem * 1e9),
        coll / (t_link_f * 1e9)), -1)
    comb_t = tt.amax(-1) + mix * tt.amin(-1)
    comb_l = lc.amax(-1) + mix * lc.amin(-1)
    ratio = comb_t / torch.clamp_min(comb_l, 1e-12)
    mean_m = torch.where(has_w, pred_dual, mean * ratio)
    std_m = torch.where(has_w, std_dual, std * ratio)
    return (torch.where(is_local, mean, mean_m),
            torch.where(is_local, std, std_m))


def _ml_matrix_core(model: BatchedTaskModel, tokens, w_c, has_w,
                    flops, bytes_, coll, l_mat, l_mem, l_link,
                    t_mat, t_mem, t_link, is_local, mix):
    """(cell × node) estimate matrix of the decomposed predictor, on the
    model's device: the batched Student-t predictive of every cell at its
    tokens, then ``_ml_transfer`` of the (T,) cell arrays against the (N,)
    target bench arrays (``l_*`` are the local bench's 0-d tensors).

    ``LotaruML.predict`` is the scalar oracle for this function — keep the
    two in lock-step (equivalence is test-enforced)."""
    mean, std = predict_task_batch(model, tokens)              # (T,)
    return _ml_transfer(mean[:, None], std[:, None], w_c[:, None],
                        has_w[:, None], flops[:, None], bytes_[:, None],
                        coll[:, None], l_mat, l_mem, l_link, t_mat, t_mem,
                        t_link, is_local, mix)


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


# ---------------------------------------------------------------------------
# Accelerator-plane estimator
# ---------------------------------------------------------------------------
@dataclass
class FittedCell:
    model: TaskModel
    weights: tuple[float, float, float]
    full_tokens: int
    flops: float = 0.0            # per device, from the compiled artifact
    bytes_: float = 0.0
    coll: float = 0.0
    w_compute: float | None = None  # measured compute share (dual-run probe)
    tokens: np.ndarray | None = None     # raw local samples (batched refit)
    runtimes: np.ndarray | None = None


#: the per-cell arrays ``LotaruML._batched`` keeps, in the order they are
#: packed for one host->device transfer
_CELL_FIELDS = ("w_c", "has_w", "flops", "bytes_", "coll")


class LotaruML(_BiasLayer):
    """Lotaru over (arch x shape) workload cells (beyond-paper integration).

    The CPU-frequency probe does not transfer to accelerators; instead the
    cell's compiled artifact supplies per-device (FLOPs, bytes, collective
    bytes) and the *decomposed* predictor scales each resource term by its
    own microbenchmark ratio, recombining with the roofline max — this
    handles the bottleneck *switching* between the local CPU
    (compute-bound) and accelerator targets (often memory-bound).
    ``predict_scalar`` keeps the paper's single-factor form as an
    ablation.

    ``device`` (``None``: the CUDA card, raising without one) and ``dtype``
    (``None``: float64) hold the fitted posteriors and the (cell x node)
    matrix; the bias and reliability posteriors are host state, as in the
    JAX package."""

    _MIX = 0.35   # secondary-term overlap coefficient of the roofline model

    def __init__(self, local_bench: BenchResult,
                 target_benches: dict[str, BenchResult],
                 bias_correction: bool = True, bias_decay: float = 1.0,
                 bias_sigma_r: float = 0.25,
                 bias_empirical_bayes: bool = False, *, device=None,
                 dtype=None):
        self.device = resolve_device(device)
        self.dtype = _default_dtype(dtype)
        self.local_bench = local_bench
        self.target_benches = target_benches
        self.cells: dict[str, FittedCell] = {}
        self._batch_cache: tuple | None = None
        self._mat_cache: dict | None = None
        self._dirty_rows: set[int] = set()
        #: device-to-host copies made by ``observe_batch`` (two a tick)
        self.fetches = 0
        # same online heterogeneity correction as LotaruEstimator: the
        # decomposed transfer linearises real cells imperfectly, and the
        # per-(cell, node) residual of that transfer is itself systematic
        # (decay / empirical-Bayes knobs as in LotaruEstimator)
        self._bias_setup(bias_correction, decay=bias_decay,
                         sigma_r=bias_sigma_r,
                         empirical_bayes=bias_empirical_bayes)

    def _bias_rows(self) -> dict:
        return self.cells

    def fit_cell(self, cell: dict,
                 run_local: Callable[[dict, float], float],
                 n_partitions: int = 6,
                 run_local_throttled: Callable[[dict, float], float] | None = None,
                 freq_reduction: float = 0.2,
                 slow_partitions: int = 3) -> None:
        """run_local(cell, token_fraction) -> measured local runtime.

        ``run_local_throttled`` is the paper's second execution at reduced
        compute speed (phase 2): the deviation separates the compute share
        w (paper eq. 5), which the decomposed predictor then transfers
        per-resource."""
        r = cell["roofline"]
        name = f"{cell['arch']}__{cell['shape']}"
        fracs = np.array(partition_sizes(1.0, n_partitions))
        runtimes = np.array([run_local(cell, f) for f in fracs])
        tokens = fracs * r["step_tokens"]
        model = fit_task(tokens, runtimes, device=self.device,
                         dtype=self.dtype)
        weights = roofline_weights(r["compute_s"], r["memory_s"],
                                   r["collective_s"])
        w_compute = None
        if run_local_throttled is not None:
            devs = []
            for f, t_old in zip(fracs[:slow_partitions],
                                runtimes[:slow_partitions]):
                t_new = run_local_throttled(cell, f)
                devs.append(deviation(t_new, t_old))
            w_compute = cpu_weight(float(np.median(devs)), 1.0,
                                   1.0 - freq_reduction)
        self.cells[name] = FittedCell(
            model=model, weights=weights, full_tokens=int(r["step_tokens"]),
            flops=r["flops_per_device"], bytes_=r["bytes_per_device"],
            coll=r["coll_bytes_per_device"], w_compute=w_compute,
            tokens=tokens, runtimes=runtimes)
        self._batch_cache = None
        self._row_map = None

    # ---- helpers -----------------------------------------------------------
    def _terms(self, fc: FittedCell, bench: BenchResult) -> tuple:
        link = bench.link_gbps if bench.link_gbps > 0 else bench.mem_gbps / 10
        return (fc.flops / (bench.matmul_gflops * 1e9),
                fc.bytes_ / (bench.mem_gbps * 1e9),
                fc.coll / (link * 1e9))

    def _combine(self, terms) -> float:
        return max(terms) + self._MIX * min(terms)

    # ---- predictors ---------------------------------------------------------
    def predict(self, cell_name: str, node: str, tokens: float | None = None):
        """Decomposed (per-resource) prediction with the learned
        per-(cell, node) bias folded in (scalar oracle of
        ``predict_matrix`` — test-enforced)."""
        mean, std = self._predict_base(cell_name, node, tokens)
        return self._bias_fold_scalar(cell_name, node, mean, std)

    def _predict_base(self, cell_name: str, node: str,
                      tokens: float | None = None):
        """Bias-free decomposed prediction: the local measurement
        calibrates an efficiency alpha; each term re-scales by its own
        benchmark ratio.

        This scalar path is the equivalence oracle for the vectorised
        ``_ml_transfer`` (tests assert they agree): any change to the
        dual-run split, the link fallback or ``_MIX`` must be mirrored
        there."""
        fc = self.cells[cell_name]
        tokens = fc.full_tokens if tokens is None else tokens
        mean, std = fc.model.predict(tokens)
        if node == self.local_bench.node:
            return float(mean), float(std)
        tb = self.target_benches[node]
        if fc.w_compute is not None:
            # Dual-run decomposition (paper phase 2, per-resource transfer):
            # the measured compute share w splits the *measured* local time
            # into a compute part and a rest part; the rest splits between
            # memory and interconnect by the artifact's raw term ratio.
            # Each part scales by its own microbenchmark ratio.
            lc = self._terms(fc, self.local_bench)
            t_c = fc.w_compute * float(mean)
            rest = (1.0 - fc.w_compute) * float(mean)
            mn = lc[1] + lc[2]
            t_m = rest * (lc[1] / mn if mn > 0 else 1.0)
            t_n = rest - t_m
            link_l = (self.local_bench.link_gbps or
                      self.local_bench.mem_gbps / 10)
            link_t = tb.link_gbps or tb.mem_gbps / 10
            parts = (
                t_c * self.local_bench.matmul_gflops / max(tb.matmul_gflops, 1e-9),
                t_m * self.local_bench.mem_gbps / max(tb.mem_gbps, 1e-9),
                t_n * link_l / max(link_t, 1e-9),
            )
            pred = max(parts) + self._MIX * min(parts)
            rel = float(std) / max(float(mean), 1e-12)
            return pred, pred * rel
        # no throttle probe available: whole-time ratio transfer
        ratio = (self._combine(self._terms(fc, tb))
                 / max(self._combine(self._terms(fc, self.local_bench)), 1e-12))
        return float(mean) * ratio, float(std) * ratio

    def predict_scalar(self, cell_name: str, node: str,
                       tokens: float | None = None):
        """Paper-form single scalar factor (ablation)."""
        fc = self.cells[cell_name]
        tokens = fc.full_tokens if tokens is None else tokens
        mean, std = fc.model.predict(tokens)
        if node == self.local_bench.node:
            return float(mean), float(std)
        f = runtime_factor3(fc.weights, self.local_bench,
                            self.target_benches[node])
        return float(mean) * f, float(std) * f

    # ---- batched (cell × node) matrix API ----------------------------------
    def _batched(self):
        """Stack all cells for the batched path.

        Cached; invalidated when the cell set OR any ``FittedCell`` object
        changes (identity check, like ``LotaruEstimator._batched``).  Cells
        fitted via ``fit_cell`` carry raw local samples and are refitted in
        one batched solve; cells constructed by hand fall back to
        posterior-exact stacking of their scalar models."""
        names = list(self.cells)
        cells = [self.cells[n] for n in names]
        c = self._batch_cache
        if (c is None or c[0] != names
                or any(a is not b for a, b in zip(c[1], cells))):
            if all(c.tokens is not None and c.runtimes is not None
                   for c in cells):
                model = fit_task_batch([c.tokens for c in cells],
                                       [c.runtimes for c in cells],
                                       device=self.device, dtype=self.dtype)
            else:
                model = stack_task_models([c.model for c in cells],
                                          device=self.device,
                                          dtype=self.dtype)
            arrays = {
                "full_tokens": np.array([c.full_tokens for c in cells],
                                        np.float64),
                "flops": np.array([c.flops for c in cells], np.float64),
                "bytes_": np.array([c.bytes_ for c in cells], np.float64),
                "coll": np.array([c.coll for c in cells], np.float64),
                "w_c": np.array([c.w_compute if c.w_compute is not None
                                 else 0.0 for c in cells], np.float64),
                "has_w": np.array([c.w_compute is not None for c in cells]),
                "weights": np.array([c.weights for c in cells], np.float64),
            }
            self._batch_cache = (names, cells, model, arrays)
        return (self._batch_cache[0], self._batch_cache[2],
                self._batch_cache[3])

    def cell_names(self) -> list[str]:
        """Row order of ``predict_matrix`` / ``predict_matrix_scalar``."""
        return list(self.cells)

    def _node_arrays(self, nodes: list[str]):
        benches = [self.local_bench if n == self.local_bench.node
                   else self.target_benches[n] for n in nodes]
        ba = stack_benches(benches)
        is_local = np.array([n == self.local_bench.node for n in nodes])
        return ba, is_local

    def _transfer_inputs(self, cells: np.ndarray, toks: np.ndarray,
                         benches, extra=()):
        """The transfer's inputs on the device, from ONE host->device copy:
        the (5, R) cell arrays and the (R,) tokens, the target ``benches``
        (a ``BenchArrays`` of the R pairs' or the N columns' nodes, with
        its ``is_local`` mask), the local bench's three rates, and any
        ``extra`` 1-D host arrays (returned as float64 tensors)."""
        ba, is_local = benches
        lb = self.local_bench
        parts = ([np.asarray(toks, np.float64)]
                 + [np.asarray(a, np.float64) for a in cells]
                 + [ba.matmul_gflops, ba.mem_gbps, ba.link_gbps,
                    is_local.astype(np.float64),
                    np.array([lb.matmul_gflops, lb.mem_gbps, lb.link_gbps],
                             np.float64)]
                 + [np.asarray(a, np.float64) for a in extra])
        flat = _to_device(np.concatenate(parts), self.device, torch.float64)
        out = list(torch.split(flat, [len(a) for a in parts]))
        dt = self.dtype
        toks_t, w_c, has_w, flops, bytes_, coll = out[:6]
        t_mat, t_mem, t_link, is_loc, local = out[6:11]
        return ({"tokens": toks_t.to(dt), "w_c": w_c.to(dt),
                 "has_w": has_w > 0, "flops": flops.to(dt),
                 "bytes_": bytes_.to(dt), "coll": coll.to(dt),
                 "l_mat": local[0].to(dt), "l_mem": local[1].to(dt),
                 "l_link": local[2].to(dt), "t_mat": t_mat.to(dt),
                 "t_mem": t_mem.to(dt), "t_link": t_link.to(dt),
                 "is_local": is_loc > 0}, out[11:])

    def _matrix_rows(self, model, arr, toks, nodes, row_idx=None):
        """(mean, std) of ``_ml_matrix_core`` for all rows, or a subset
        when ``row_idx`` is given (online partial refresh): one copy of
        the inputs to the device, one copy of the result back."""
        sel = (lambda a: a) if row_idx is None else (lambda a: a[row_idx])
        if row_idx is not None:
            model = model.rows(row_idx)
        x, _ = self._transfer_inputs([sel(arr[k]) for k in _CELL_FIELDS],
                                     sel(toks), self._node_arrays(nodes))
        ms = _np(torch.stack(_ml_matrix_core(
            model, x["tokens"], x["w_c"], x["has_w"], x["flops"],
            x["bytes_"], x["coll"], x["l_mat"], x["l_mem"], x["l_link"],
            x["t_mat"], x["t_mem"], x["t_link"], x["is_local"], self._MIX)))
        # copies: the row cache patches these in place
        return ms[0].copy(), ms[1].copy()

    def predict_matrix(self, nodes: list[str], tokens=None,
                       with_std: bool = True):
        """Full (cell × node) decomposed estimate matrix, computed on the
        device and brought to the host in one transfer.

        ``tokens``: None (each cell's full step tokens), a scalar, or a
        (T,) per-cell array.  Returns (mean, std) of shape (T, N); rows in
        ``cell_names()`` order, columns in ``nodes`` order; with
        ``with_std=False`` the std slot is ``None`` and the bias widening
        is skipped (mean-only fast path — see
        ``LotaruEstimator.predict_matrix``).  Cached per (nodes, tokens)
        bias-free; the bias fold happens on the way out; ``observe``
        dirties only the affected row."""
        _, model, arr = self._batched()
        toks = arr["full_tokens"] if tokens is None else np.broadcast_to(
            np.asarray(tokens, np.float64), arr["full_tokens"].shape)
        key = (tuple(nodes), toks.tobytes())
        c = self._mat_cache
        if c is not None and c["key"] == key and c["model"] is model:
            rows = sorted(self._dirty_rows)
            if rows:
                idx = np.asarray(rows)
                with self._tracer.span("predict_matrix", rows=len(rows),
                                       mode="dirty"):
                    mean_r, std_r = self._matrix_rows(model, arr, toks,
                                                      nodes, row_idx=idx)
                    c["mean"][idx] = mean_r
                    c["std"][idx] = std_r
                self._dirty_rows.clear()
            return self._bias_fold(nodes, c["mean"], c["std"], with_std)
        with self._tracer.span("predict_matrix", rows=len(self.cells),
                               mode="full"):
            mean, std = self._matrix_rows(model, arr, toks, nodes)
        self._mat_cache = {"key": key, "model": model,
                           "mean": mean, "std": std}
        self._dirty_rows.clear()
        return self._bias_fold(nodes, mean, std, with_std)

    def observe(self, cell_name: str, node: str, tokens: float,
                runtime: float) -> float:
        """Feed one realised (tokens, runtime) from ``node`` back in
        (single-observation convenience over ``observe_batch``)."""
        return self.observe_batch([(cell_name, node, tokens, runtime)])[0]

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One of ``observe_batch``'s two device-to-host copies."""
        self.fetches += 1
        return _np(t)

    def _pair_means(self, model, x, rows):
        """(local mean, bias-free on-node mean) of each observed pair: one
        batched predictive of the cells ``rows`` at their tokens, then
        ``_ml_transfer`` pair by pair — ``_predict_base``'s numbers for
        all B pairs at once, on the device."""
        mean, std = predict_task_batch(model.rows(rows), x["tokens"])
        m_node, _ = _ml_transfer(
            mean, std, *(x[k] for k in _CELL_FIELDS), x["l_mat"], x["l_mem"],
            x["l_link"], x["t_mat"], x["t_mem"], x["t_link"], x["is_local"],
            self._MIX)
        return mean, m_node

    def observe_batch(self, observations) -> list[float]:
        """Absorb a tick's realised (tokens, runtime) completions at once.

        The decomposed transfer is nonlinear in the local mean, so each
        measured runtime is de-adjusted by the *implied* factor at the
        tick-start posterior mean (bias-free prediction-on-node /
        local-mean) — exact for the ratio path, a linearisation for the
        dual-run path — times the current bias estimate; the residual
        against the implied prediction feeds the per-(cell, node) bias
        posterior, and one ``update_task_batch_stream`` absorbs the whole
        de-adjusted stream (see ``LotaruEstimator.observe_batch`` for the
        tick semantics).

        The tick-start means of all B pairs come from one batched
        predictive, and the post-update means with the refreshed rows'
        gates, medians and spreads from one more: two device-to-host
        copies a tick (``fetches``), whatever B is."""
        obs = [_as_obs_tuple(o) for o in observations]
        if not obs:
            return []
        names, model, arr = self._batched()
        row = {n: k for k, n in enumerate(names)}
        bias = self._ensure_bias() if self.bias_correction else None
        B = len(obs)
        idx = np.array([row[o[0]] for o in obs], np.int64)
        xs = np.array([o[2] for o in obs], np.float64)
        pair_nodes = [o[1] for o in obs]
        hit = np.unique(idx)
        x, (rows_t, hit_t) = self._transfer_inputs(
            [arr[k][idx] for k in _CELL_FIELDS], xs,
            self._node_arrays(pair_nodes), extra=(idx, hit))
        rows_t, hit_t = rows_t.long(), hit_t.long()
        m_local, m_node = self._fetch(torch.stack(
            self._pair_means(model, x, rows_t)))
        ys = np.empty(B, np.float64)
        for k, (cell_name, node, tokens, runtime) in enumerate(obs):
            fc = self.cells[cell_name]
            if fc.tokens is None or fc.runtimes is None:
                raise ValueError(f"cell {cell_name!r} carries no raw local "
                                 "samples; online updates need "
                                 "fit_cell-built cells")
            if float(m_local[k]) <= 1e-9:
                # the clamped-at-zero mean makes the transfer
                # un-invertible; absorbing runtime/f with f ~ 1e12 would
                # drag the posterior to zero — reject instead of silently
                # corrupting it
                raise ValueError(
                    f"cell {cell_name!r}: local predictive mean is ~0 at "
                    f"tokens={tokens}; cannot de-adjust the observation")
            f = max(float(m_node[k]) / float(m_local[k]), 1e-12)
            b = 1.0
            if bias is not None and node in self._bias_col:
                b = bias.point(int(idx[k]), self._bias_col[node])
            ys[k] = runtime / (f * max(b, 1e-12))
        with self._tracer.span("update_stream", n=B):
            new_model = update_task_batch_stream(model, idx, xs, ys)
        # the raw history, in input order, one concatenation a cell
        order = np.argsort(idx, kind="stable")
        for r, k in zip(hit, np.split(order, np.cumsum(
                np.bincount(idx)[hit])[:-1])):
            fc = self.cells[names[r]]
            fc.tokens = np.concatenate([fc.tokens, xs[k]])
            fc.runtimes = np.concatenate([fc.runtimes, ys[k]])
        # the refreshed rows' gates, medians and spreads, and the
        # post-update means, in one copy
        parts = [new_model.correlated.to(self.dtype).index_select(0, hit_t),
                 new_model.median.index_select(0, hit_t),
                 new_model.spread.index_select(0, hit_t)]
        if bias is not None:
            parts.append(self._pair_means(new_model, x, rows_t)[1])
        host = self._fetch(torch.cat(parts))
        R = len(hit)
        p = new_model.post
        for k, i in enumerate(hit):
            i = int(i)
            self.cells[names[i]].model = TaskModel(
                correlated=bool(host[k]),
                post=BLRPosterior(mu=p.mu[i], V=p.V[i], a=p.a[i], b=p.b[i],
                                  x_scale=p.x_scale[i],
                                  y_scale=p.y_scale[i]),
                median=float(host[R + k]), spread=float(host[2 * R + k]))
        if bias is not None:
            # bias residuals against the POST-update implied predictions —
            # same invariant as LotaruEstimator.observe_batch: the pair
            # term only absorbs what the refreshed cell model still
            # cannot explain.  One BiasModel.update per tick so the
            # forgetting factor decays per tick, not per completion
            m_post = host[3 * R:]
            rows, cols, lrs = [], [], []
            for k, (_, node, _, runtime) in enumerate(obs):
                if node not in self._bias_col:
                    continue
                if runtime > 0.0 and float(m_post[k]) > 1e-12:
                    rows.append(int(idx[k]))
                    cols.append(self._bias_col[node])
                    lrs.append(np.log(runtime / float(m_post[k])))
            if rows:
                with self._tracer.span("bias_update", n=len(rows)):
                    bias.update(rows, cols, lrs)
        c = self._batch_cache
        self._batch_cache = (c[0], c[1], new_model, c[3])
        if self._mat_cache is not None and self._mat_cache["model"] is model:
            self._mat_cache["model"] = new_model
            self._dirty_rows.update(int(i) for i in hit)
        else:
            self._mat_cache = None
        return ys.tolist()

    def predict_matrix_scalar(self, nodes: list[str], tokens=None):
        """Paper-form single-factor (cell × node) matrix (ablation): the
        vectorised ``runtime_factor3`` over stacked bench arrays."""
        _, model, arr = self._batched()
        toks = arr["full_tokens"] if tokens is None else np.broadcast_to(
            np.asarray(tokens, np.float64), arr["full_tokens"].shape)
        ms = _np(torch.stack(predict_task_batch(
            model, _to_device(toks, self.device, self.dtype))))
        ba, is_local = self._node_arrays(nodes)
        F = runtime_factor3(arr["weights"], self.local_bench, ba)  # (T, N)
        F = np.where(is_local[None, :], 1.0, F)
        return ms[0][:, None] * F, ms[1][:, None] * F

    def straggler_threshold(self, cell_name: str, node: str,
                            k: float = 3.0) -> float:
        """mean + k*sigma: tasks exceeding this are treated as stragglers."""
        mean, std = self.predict(cell_name, node)
        return mean + k * std


def young_daly_interval(step_time_s: float, mtbf_s: float,
                        checkpoint_cost_s: float) -> float:
    """Young/Daly optimal checkpoint interval, from predicted step time."""
    opt = float(np.sqrt(2.0 * checkpoint_cost_s * mtbf_s))
    return max(opt, step_time_s)
