"""The estimator state the fused tick updates, as one record of tensors.

Port of ``repro.core.state``.  Everything the online loop changes per tick
— the NIG ``(T, 8)`` streamed moments and batched posterior (``blr``), the
per-(task, node) bias sufficient statistics (``BiasModel``), the per-node
reliability counts (``ReliabilityModel``) and the static ``(T, N)``
runtime-factor matrix — sits in one ``EstimatorState`` of tensors on one
device, so observe → update → bias scatter → re-predict runs as one
device-side function (``repro_torch.core.tick.tick_step``).

Design split, as in the JAX package:

* tensor leaves — on the estimator's device, in its dtype (``node_cols``
  is an int64 index tensor);
* ``StateMeta`` — the frozen, hashable hyperparameter record (bias prior
  scales, decay, NIG priors...).  Python branches on it pick the tick's
  code (``decay == 1.0`` skips the forgetting multiply entirely, exactly
  like ``BiasModel.update``);
* ``StateNames`` — host-side row/column labels (task order, prediction
  node order, bias-column universe); strings never reach the device.

A state owns its leaves: ``build_state`` copies the estimator's tensors,
because the tick updates a state's leaves in place (the port's
counterpart of the JAX package's buffer donation).  The raw-sample
``SampleLog`` is shared, not copied: it stays the live host-side history.
``bias_view`` / ``reliability_view`` rebuild bit-exact ``BiasModel`` /
``ReliabilityModel`` objects from the leaves, and ``write_back`` returns a
state into a live ``LotaruEstimator``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .blr import (POSTERIOR_FIELDS, BatchedTaskModel, BiasModel,
                  BLRPosterior, OnlineStats, ReliabilityModel, _np,
                  _slice_rows, _to_device)


@dataclass(frozen=True)
class StateMeta:
    """Static hyperparameters of one estimator (hashable)."""
    bias_correction: bool
    tau0: float
    sigma_r: float
    decay: float
    empirical_bayes: bool
    prior_scale: float = 10.0
    a0: float = 1.0
    b0: float = 1.0
    threshold: float = 0.8
    rel_a0: float = 8.0
    rel_b0: float = 1.0


@dataclass(frozen=True)
class StateNames:
    """Host-side label universe of an ``EstimatorState``."""
    tasks: tuple[str, ...]          # row order (estimator task_names())
    nodes: tuple[str, ...]          # prediction-column order (N axis)
    bias_nodes: tuple[str, ...]     # bias-column universe (Nb axis)
    rel_nodes: tuple[str, ...]      # reliability slot order (R axis)


@dataclass(frozen=True)
class EstimatorState:
    """All per-tick mutable estimator state, as tensors on one device.

    Leaves (T tasks, N prediction nodes, Nb bias columns, R rel slots):

    * ``model``      — ``BatchedTaskModel`` (moments, posterior, Pearson
      gate, median/spread);
    * ``factors``    — (T, N) static runtime-factor matrix;
    * ``node_cols``  — (N,) int64 bias column of each prediction node,
      ``-1`` outside the bias universe;
    * ``bias_counts`` / ``bias_log_sum`` / ``bias_log_sq`` — (T, Nb)
      ``BiasModel`` sufficient statistics;
    * ``rel_succ`` / ``rel_fail`` — (R,) Beta-Binomial attempt counts.
    """
    model: BatchedTaskModel
    factors: torch.Tensor
    node_cols: torch.Tensor
    bias_counts: torch.Tensor
    bias_log_sum: torch.Tensor
    bias_log_sq: torch.Tensor
    rel_succ: torch.Tensor
    rel_fail: torch.Tensor
    meta: StateMeta

    @property
    def device(self) -> torch.device:
        return self.factors.device


def clone_model(model: BatchedTaskModel) -> BatchedTaskModel:
    """A copy of a batched model's tensors (the ``SampleLog`` is shared)."""
    p = model.post
    return BatchedTaskModel(
        correlated=model.correlated.clone(),
        post=BLRPosterior(*(getattr(p, f).clone()
                            for f in POSTERIOR_FIELDS)),
        median=model.median.clone(), spread=model.spread.clone(),
        stats=OnlineStats(moments=model.stats.moments.clone(),
                          log=model.stats.log))


def clone_state(state: EstimatorState) -> EstimatorState:
    """A copy of every leaf of ``state`` (the ``SampleLog`` is shared)."""
    return EstimatorState(
        model=clone_model(state.model), factors=state.factors.clone(),
        node_cols=state.node_cols.clone(),
        bias_counts=state.bias_counts.clone(),
        bias_log_sum=state.bias_log_sum.clone(),
        bias_log_sq=state.bias_log_sq.clone(),
        rel_succ=state.rel_succ.clone(), rel_fail=state.rel_fail.clone(),
        meta=state.meta)


def build_state(est, nodes, rel_nodes=()) -> tuple[EstimatorState,
                                                   StateNames]:
    """Snapshot a fitted ``LotaruEstimator`` into an ``EstimatorState`` on
    the estimator's device, in its dtype.

    ``nodes`` fixes the prediction-column order (the executor's node
    *type* universe) and must not repeat a node; ``rel_nodes`` the
    reliability slots (node *instances* — availability is a machine
    property).  The leaves are copies of the estimator's tensors; the
    ``SampleLog`` is shared and stays the live raw-sample history.
    """
    names, model, _w = est._batched()
    dev, dt = est.device, est.dtype
    nodes = tuple(nodes)
    rel_nodes = tuple(rel_nodes)
    if len(set(nodes)) != len(nodes):
        # the tick's order-exact bias scatter keys a pair by its
        # prediction column: two columns of one node would share a slot
        raise ValueError(f"nodes repeat a node: {list(nodes)}")
    factors = _to_device(est.factor_matrix(list(nodes)), dev, dt)
    if est.bias_correction:
        bias = est._ensure_bias()
        tau0, sigma_r = bias.tau0, bias.sigma_r
        decay, eb = bias.decay, bias.empirical_bayes
        stats = np.stack([bias.counts, bias.log_sum, bias.log_sq])
    else:
        opts = est._bias_opts
        tau0, sigma_r = 0.5, opts["sigma_r"]
        decay, eb = opts["decay"], opts["empirical_bayes"]
        stats = np.zeros((3, len(names), len(est.bias_nodes)))
    bias_t = _to_device(stats, dev, dt)
    node_cols = _to_device([est._bias_col.get(n, -1) for n in nodes], dev,
                           torch.int64)
    rel = est.reliability
    rel_a0 = rel.a0 if rel is not None else 8.0
    rel_b0 = rel.b0 if rel is not None else 1.0
    rel_counts = np.zeros((2, len(rel_nodes)), np.float64)
    if rel is not None:
        for k, n in enumerate(rel_nodes):
            rel_counts[:, k] = rel.counts(n)
    rel_t = _to_device(rel_counts, dev, dt)
    meta = StateMeta(bias_correction=bool(est.bias_correction),
                     tau0=float(tau0), sigma_r=float(sigma_r),
                     decay=float(decay), empirical_bayes=bool(eb),
                     rel_a0=float(rel_a0), rel_b0=float(rel_b0))
    state = EstimatorState(
        model=clone_model(model), factors=factors, node_cols=node_cols,
        bias_counts=bias_t[0], bias_log_sum=bias_t[1], bias_log_sq=bias_t[2],
        rel_succ=rel_t[0], rel_fail=rel_t[1], meta=meta)
    return state, StateNames(tasks=tuple(names), nodes=nodes,
                             bias_nodes=tuple(est.bias_nodes),
                             rel_nodes=rel_nodes)


def bias_view(state: EstimatorState) -> BiasModel:
    """Rebuild the host ``BiasModel`` view of the state's bias leaves —
    bit-exact: the sufficient statistics are copied at float64 (one
    transfer) and the hyperparameters come from ``StateMeta``."""
    m = state.meta
    counts, log_sum, log_sq = _np(torch.stack(
        [state.bias_counts, state.bias_log_sum, state.bias_log_sq]))
    return BiasModel(counts.shape[0], counts.shape[1], tau0=m.tau0,
                     sigma_r=m.sigma_r, decay=m.decay,
                     empirical_bayes=m.empirical_bayes, counts=counts,
                     log_sum=log_sum, log_sq=log_sq)


def reliability_view(state: EstimatorState,
                     names: StateNames) -> ReliabilityModel | None:
    """Rebuild the host ``ReliabilityModel`` view (``None`` while no
    attempt was ever recorded, matching the estimator's lazy layer)."""
    succ, fail = _np(torch.stack([state.rel_succ, state.rel_fail]))
    if not np.any(succ + fail > 0):
        return None
    seen = {n: [float(succ[k]), float(fail[k])]
            for k, n in enumerate(names.rel_nodes) if succ[k] + fail[k] > 0}
    return ReliabilityModel(a0=state.meta.rel_a0, b0=state.meta.rel_b0,
                            state=seen)


def write_back(state: EstimatorState, names: StateNames, est,
               rows=None) -> None:
    """Fold a state back into a live ``LotaruEstimator`` so the OO surface
    (scalar predicts, save/load, further ``observe_batch`` calls)
    continues from exactly where the fused tick left off.  ``rows`` limits
    the per-task scalar-model writeback to the rows the tick touched (the
    batch cache itself is always swapped whole).  The estimator gets a
    copy of the model's tensors, so later ticks on ``state`` leave it as
    it is."""
    model = clone_model(state.model)
    fts = [est.tasks[n] for n in names.tasks]
    w = np.array([ft.w for ft in fts], np.float64)
    est._batch_cache = (list(names.tasks), fts, model, w)
    touched = range(len(names.tasks)) if rows is None else sorted(rows)
    for i, tm in zip(touched, _slice_rows(model, touched)):
        est.tasks[names.tasks[i]].model = tm
    est._mat_cache = None
    est._dirty_rows.clear()
    if est.bias_correction:
        view = bias_view(state)
        bias = est._ensure_bias()
        bias.counts = view.counts
        bias.log_sum = view.log_sum
        bias.log_sq = view.log_sq
        bias._sigma_r_cache = None
    rel = reliability_view(state, names)
    if rel is not None:
        est.reliability = rel
