"""The fused tick: observe → update → bias scatter → re-predict as one
device-side function over ``EstimatorState``.

Port of ``repro.core.tick``.  The legacy online path is four separate
steps per simulation tick (the update stream, per-row scalar-model
writebacks, a host-side ``BiasModel.update`` scatter and a dirty-row
``predict_matrix`` re-predict), stitched together by Python in
``LotaruEstimator.observe_batch``.  ``tick_step`` runs the whole sequence
on the state's device and updates the state's leaves in place.  The core
(``_stacked_tick_core``) is written over W states stacked on a leading
axis — the multi-workflow fleet (``repro_torch.online.fleet``) — and the
single-workflow tick is its W = 1 case.

Observation batches are packed as a ``(B, 8)`` array::

    [row, col, x, y_raw, y_local, med, spr, valid]

* ``row``/``col`` — task row and prediction-node column (``state``'s
  ``factors`` axes); ``x`` the input size; ``y_raw`` the measured
  runtime on the node;
* ``y_local`` — the host-de-adjusted local-equivalent runtime.  With
  ``host_deadjust=True`` (the ``TickEngine`` executor path) it is used
  verbatim, keeping the engine bit-compatible with ``observe_batch``'s
  host float64 de-adjust; with ``False`` it is recomputed on the device
  from ``y_raw`` and the tick-start bias, and the packed value is ignored;
* ``med``/``spr`` — the row's refreshed median/MAD (order statistics
  live host-side in the ``SampleLog``, exactly as in the legacy path); the
  last valid observation of a row sets them;
* ``valid`` — padding mask (0 rows are no-ops), so a ragged tick can be
  padded to a fixed batch (the CUDA graph of ``TickEngine`` does).

Rows flagged invalid leave every leaf bitwise untouched: they are routed
to a scratch slot past the end of every scatter, never blended with 0.

Order.  The JAX package folds a tick's observations into the moments with
a sequential scan and scatters the bias residuals with a sequential
``.at[].add``; a row hit twice is summed in input order.  A CUDA scatter
with duplicate indices sums in no fixed order, so here both sums go in
*waves*: wave ``w`` adds the ``w``-th occurrence of every row (or
(row, column) pair) in one ``index_add_``, whose indices are then
distinct (``blr.fold_moments``, shared with the estimator's update
stream, and the bias scatter below).  Each slot thus receives its terms
one at a time, in input order, and the result is the same bit for bit
from run to run and on every device.  The occurrence ranks are computed
on the host from the packed rows (``pack_waves``), so the number of
waves is a host integer.  The posteriors of the touched rows are then
recomputed once from their final moments — the state the scan leaves,
since a posterior is a function of its row's moments alone.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import stats as _scipy_stats

from repro_torch.obs.trace import NULL_TRACER

from .blr import (POSTERIOR_FIELDS, BatchedTaskModel, BiasModel,
                  BLRPosterior, OnlineStats, _gate,
                  _posterior_from_stats, _predict_core, _to_device,
                  fold_moments, occurrence_ranks, predict_cdf,
                  predict_interval, predict_task_batch, slice_task_model)
from .state import (EstimatorState, bias_view, build_state, clone_state,
                    write_back)

def _wave_ranks(keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """rank[k] = the number of earlier valid observations with key
    ``keys[k]`` (-1 where ``valid`` is false)."""
    rank = np.full(len(keys), -1, np.int64)
    idx = np.flatnonzero(valid)
    rank[idx] = occurrence_ranks(keys[idx])
    return rank


def pack_waves(obs, n_cols: int, n_rows: int = 0
               ) -> tuple[np.ndarray, int, int]:
    """The observation rows — (B, 8), or (W, B, 8) for W stacked
    workflows of ``n_rows`` task rows each — with two columns appended:
    the occurrence rank of each observation's row, and of its (row,
    column) pair, among the batch's valid observations (-1 for invalid
    ones), workflow w's rows keyed as ``w * n_rows + row`` so that two
    workflows never share a key.  Returns them as one float64 host array
    of shape (..., B, 10), and the wave counts of the moment fold and of
    the bias scatter."""
    obs = np.asarray(obs, np.float64)
    shape = obs.shape[:2] if obs.ndim == 3 else (1, obs.size // 8)
    flat = obs.reshape(shape[0] * shape[1], 8)
    valid = flat[:, 7] > 0
    rows = (flat[:, 0].astype(np.int64)
            + np.repeat(np.arange(shape[0]), shape[1]) * n_rows)
    rank_m = _wave_ranks(rows, valid)
    rank_b = _wave_ranks(rows * n_cols + flat[:, 1].astype(np.int64), valid)
    packed = np.concatenate([flat, rank_m[:, None], rank_b[:, None]], 1)
    if obs.ndim == 3:
        packed = packed.reshape(shape + (10,))
    return (packed, int(rank_m.max(initial=-1)) + 1,
            int(rank_b.max(initial=-1)) + 1)


def _sigma_r(meta, counts, log_sum, log_sq):
    """Device twin of ``BiasModel.effective_sigma_r`` over W stacked
    (W, T, Nb) bias grids — the fixed ``sigma_r``, or, per workflow as a
    (W, 1, 1) tensor, the pooled empirical spread of that workflow's
    observed log-residuals (floored) once any of its pairs has two
    observations.  Each workflow pools its own grid only, so one
    workflow's residuals never move another's posterior."""
    if not meta.empirical_bayes:
        return meta.sigma_r
    mask = counts >= 2
    safe_n = torch.where(mask, counts, 1.0)
    ss = torch.where(mask, log_sq - log_sum ** 2 / safe_n, 0.0).sum(
        (1, 2), keepdim=True)
    dof = torch.where(mask, counts - 1.0, 0.0).sum((1, 2), keepdim=True)
    s = torch.sqrt(torch.clamp_min(ss, 0.0) / torch.clamp_min(dof, 1.0))
    pooled = torch.clamp_min(s, BiasModel.SIGMA_R_FLOOR)
    seen = mask.flatten(1).any(1).reshape(-1, 1, 1)
    return torch.where(seen, pooled, meta.sigma_r)


def _flat_model(model: BatchedTaskModel) -> BatchedTaskModel:
    """A stacked (W, T, ...) batched model as one of W * T rows (views
    where the leaves allow; the moments are left out)."""
    def flat(t):
        return t.reshape((-1,) + tuple(t.shape[2:]))
    p = model.post
    return BatchedTaskModel(
        correlated=flat(model.correlated),
        post=BLRPosterior(*(flat(getattr(p, f)) for f in POSTERIOR_FIELDS)),
        median=flat(model.median), spread=flat(model.spread))


def _lift(state: EstimatorState) -> EstimatorState:
    """One state as a stack of one: every leaf a (1, ...) view, so that
    updating the stack in place updates ``state``."""
    m = state.model
    stats = (None if m.stats is None else
             OnlineStats(moments=m.stats.moments[None], log=m.stats.log))
    model = BatchedTaskModel(
        correlated=m.correlated[None],
        post=BLRPosterior(*(getattr(m.post, f)[None]
                            for f in POSTERIOR_FIELDS)),
        median=m.median[None], spread=m.spread[None], stats=stats)
    return EstimatorState(
        model=model, factors=state.factors[None],
        node_cols=state.node_cols[None], bias_counts=state.bias_counts[None],
        bias_log_sum=state.bias_log_sum[None],
        bias_log_sq=state.bias_log_sq[None], rel_succ=state.rel_succ[None],
        rel_fail=state.rel_fail[None], meta=state.meta)


def _fold_predict(model, state, counts, log_sum, log_sq, size):
    """Full (W, T, N) factor-scaled predictive of W stacked states, each
    at its own input size (``size`` is (W,)), with the bias posterior
    folded in — device twin of ``_scaled_matrix_core`` +
    ``_fold_bias_matrix`` (point-scale the mean, delta-method-widen the
    std, inert where unobserved or outside the bias universe)."""
    meta = state.meta
    W, T, N = state.factors.shape
    mean_t, std_t = predict_task_batch(
        _flat_model(model), size.reshape(W, 1).expand(W, T).reshape(-1))
    mean = mean_t.reshape(W, T, 1) * state.factors
    std = std_t.reshape(W, T, 1) * state.factors
    if not meta.bias_correction:
        return mean, std
    sr = _sigma_r(meta, counts, log_sum, log_sq)
    lam = 1.0 / meta.tau0 ** 2 + counts / sr ** 2
    mu = log_sum / (sr ** 2 * lam)
    v = 1.0 / lam
    cols = torch.clamp_min(state.node_cols, 0)[:, None, :].expand(W, T, N)
    mu_g = mu.gather(2, cols)
    v_g = v.gather(2, cols)
    n_g = counts.gather(2, cols)
    active = (state.node_cols >= 0)[:, None, :] & (n_g > 0)
    point = torch.exp(mu_g)
    out_mean = torch.where(active, mean * point, mean)
    widened = point * torch.sqrt(std ** 2 + mean ** 2 * torch.expm1(v_g))
    out_std = torch.where(active, widened, std)
    return out_mean, out_std


def _stacked_tick_core(state: EstimatorState, obs, size,
                       host_deadjust: bool, waves: tuple[int, int]):
    """One fused tick of W stacked workflows on device tensors.  Every
    leaf of ``state`` carries a leading (W,) axis; ``obs`` is the (W, B,
    10) batch of ``pack_waves`` (float64, on the state's device), ``size``
    the (W,) input sizes of the predictions, ``waves`` the host wave
    counts of ``pack_waves``.

    The W workflows run as one batched pass: a task row is keyed ``w * T
    + row`` in the moment fold and a bias pair ``(w * T + row) * Nb +
    col`` in the bias scatter, so each wave is one ``index_add_`` for the
    whole fleet and stays order-exact; the two reductions over a
    workflow's whole state — the empirical-Bayes ``sigma_r`` and the
    decay trigger — are taken per workflow.  Updates the leaves in place
    and returns ``(state, mean, std, y_local)``: the refreshed (W, T, N)
    estimate matrices and the (W, B) local-equivalent runtimes that
    entered the model (input order).  Every shape depends on (W, B, T,
    N, Nb) and ``waves`` alone, and nothing is read back, so the function
    can be captured into a CUDA graph."""
    meta = state.meta
    model = state.model
    dt = state.factors.dtype
    dev = state.factors.device
    W, T, N = state.factors.shape
    n_bias = state.bias_counts.shape[2]
    B = obs.shape[1]
    obs = obs.reshape(W * B, obs.shape[2])
    wid = torch.arange(W * B, device=dev) // B
    rows = obs[:, 0].long()
    cols = obs[:, 1].long()
    grow = wid * T + rows                      # row in the (W * T) rows
    x, y_raw, y_host, med, spr = obs[:, 2:7].to(dt).unbind(1)
    valid = obs[:, 7] > 0
    rank_m, rank_b = obs[:, 8].long(), obs[:, 9].long()
    bcol = state.node_cols[wid, cols]
    safe_b = torch.clamp_min(bcol, 0)
    f = torch.clamp_min(state.factors[wid, rows, cols], 1e-12)
    counts = state.bias_counts
    log_sum = state.bias_log_sum
    log_sq = state.bias_log_sq
    if host_deadjust:
        y = y_host
    elif meta.bias_correction:
        # tick-START bias point estimates (the same values the legacy
        # path reads via ``BiasModel.point`` before updating anything)
        sr0 = _sigma_r(meta, counts, log_sum, log_sq)
        if isinstance(sr0, torch.Tensor):
            sr0 = sr0.reshape(W)[wid]
        n0 = counts[wid, rows, safe_b]
        lam0 = 1.0 / meta.tau0 ** 2 + n0 / sr0 ** 2
        mu0 = log_sum[wid, rows, safe_b] / (sr0 ** 2 * lam0)
        b_pt = torch.where((bcol >= 0) & (n0 > 0), torch.exp(mu0), 1.0)
        y = y_raw / (f * torch.clamp_min(b_pt, 1e-12))
    else:
        y = y_raw / f

    # --- streamed NIG moments, in input order (one wave per occurrence) --
    moments = model.stats.moments
    WT = W * T
    target = torch.where(valid, grow, WT)      # invalid -> scratch row
    new_m = fold_moments(moments.reshape(WT, 8), target, x, y, rank_m,
                         waves[0])
    # the last valid observation of each row: its med/spr win
    last = torch.full((WT + 1,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, target, torch.arange(W * B, device=dev), "amax")
    last = last[:WT]
    touched = last >= 0
    pick = torch.clamp_min(last, 0)
    fields = _posterior_from_stats(new_m, meta.prior_scale, meta.a0,
                                   meta.b0)
    old = _flat_model(model)
    post = BLRPosterior(*(
        torch.where(touched.reshape((WT,) + (1,) * (new.dim() - 1)), new,
                    getattr(old.post, name))
        for name, new in zip(POSTERIOR_FIELDS, fields)))
    new_model = BatchedTaskModel(
        correlated=torch.where(touched, _gate(new_m, meta.threshold),
                               old.correlated),
        post=post,
        median=torch.where(touched, med.index_select(0, pick), old.median),
        spread=torch.where(touched, spr.index_select(0, pick), old.spread))

    if meta.bias_correction:
        # --- bias residuals vs the POST-update means (one batched
        # predict), scattered in input order, one wave per occurrence ----
        pr = BLRPosterior(*(getattr(post, name).index_select(0, grow)
                            for name in POSTERIOR_FIELDS))
        mean_b, _ = _predict_core(pr.mu, pr.V, pr.a, pr.b, pr.x_scale,
                                  pr.y_scale, x[:, None])
        m_post = torch.where(new_model.correlated.index_select(0, grow),
                             torch.clamp_min(mean_b[:, 0], 0.0),
                             new_model.median.index_select(0, grow))
        scaled = f * m_post
        resid_ok = valid & (bcol >= 0) & (y_raw > 0.0) & (scaled > 1e-12)
        ratio = torch.where(resid_ok,
                            y_raw / torch.where(resid_ok, scaled, 1.0), 1.0)
        lr = torch.log(ratio)
        stats = torch.stack([counts, log_sum, log_sq]).reshape(3, W, -1)
        if meta.decay != 1.0:
            # one update is one forgetting step: decay fires iff the tick
            # contributes any residual to the workflow, exactly like
            # ``BiasModel.update``
            fire = resid_ok.reshape(W, B).any(1).reshape(1, W, 1)
            stats = torch.where(fire, stats * meta.decay, stats)
        slot = WT * n_bias                     # the scratch slot
        ws = torch.zeros((3, slot + 1), dtype=dt, device=dev)
        ws[:, :slot] = stats.reshape(3, slot)
        flat = torch.where(resid_ok, grow * n_bias + safe_b, slot)
        contrib = torch.stack([torch.ones_like(lr), lr, lr * lr])
        for w in range(waves[1]):
            ws.index_add_(1, torch.where(rank_b == w, flat, slot), contrib)
        new_bias = ws[:, :slot].reshape(3, W, T, n_bias)
        for dst, src in zip((counts, log_sum, log_sq), new_bias.unbind(0)):
            dst.copy_(src)

    # --- in place: the state's leaves take the new values -------------
    moments.copy_(new_m.reshape(moments.shape))
    p = model.post
    for name in POSTERIOR_FIELDS:
        dst = getattr(p, name)
        dst.copy_(getattr(post, name).reshape(dst.shape))
    for name in ("correlated", "median", "spread"):
        dst = getattr(model, name)
        dst.copy_(getattr(new_model, name).reshape(dst.shape))
    mean, std = _fold_predict(model, state, counts, log_sum, log_sq, size)
    return state, mean, std, y.reshape(W, B)


def _tick_core(state: EstimatorState, obs, size, host_deadjust: bool,
               waves: tuple[int, int]):
    """One fused tick of one workflow: ``_stacked_tick_core`` on the
    state lifted to a stack of one.  ``obs`` is the (B, 10) batch of
    ``pack_waves``, ``size`` a 0-d tensor on the state's device.  Updates
    the state's leaves in place and returns ``(state, mean, std,
    y_local)`` with a (T, N) matrix and (B,) runtimes."""
    _, mean, std, y = _stacked_tick_core(_lift(state), obs[None],
                                         size.reshape(1), host_deadjust,
                                         waves)
    return state, mean[0], std[0], y[0]


def _size_tensor(size, like: torch.Tensor) -> torch.Tensor:
    if isinstance(size, torch.Tensor):
        return size.to(device=like.device, dtype=like.dtype)
    return _to_device(np.float64(size), like.device, like.dtype)


def _host_obs(obs) -> np.ndarray:
    if isinstance(obs, torch.Tensor):
        obs = obs.detach().cpu().numpy()
    return np.asarray(obs, np.float64).reshape(-1, 8)


def tick_step(state: EstimatorState, obs, size, host_deadjust: bool):
    """One fused tick.  ``obs`` is the (B, 8) packed batch (host data: a
    numpy array, or a tensor, which is read back first), ``size`` the
    input size of the predictions.  Returns ``(state', mean, std,
    y_local)``.

    The state's leaves are updated in place — the port's counterpart of
    the JAX package's ``donate_argnums=(0,)``: the input state is
    consumed, and ``state'`` holds the same tensors."""
    packed, wm, wb = pack_waves(_host_obs(obs), state.factors.shape[1])
    return _tick_core(state, _to_device(packed, state.device, torch.float64),
                      _size_tensor(size, state.factors), host_deadjust,
                      (wm, wb))


def predict_state(state: EstimatorState, size):
    """Estimate matrix of a state without absorbing anything — the
    tick-zero twin of ``tick_step``'s (mean, std) outputs."""
    s = _lift(state)
    mean, std = _fold_predict(s.model, s, s.bias_counts, s.bias_log_sum,
                              s.bias_log_sq,
                              _size_tensor(size, state.factors).reshape(1))
    return mean[0], std[0]


def _bucket(n: int) -> int:
    """The padded batch of a CUDA-graph tick: a power of two, at least 8."""
    return max(8, 1 << (n - 1).bit_length())


def _bucket_waves(n: int) -> int:
    """The wave count of a CUDA-graph tick: ``n`` rounded up to a power
    of two.  A wave past the last rank holds no observation and sends
    every index to the scratch slot, so the padding waves change no leaf
    and the number of graphs grows with log2 of the waves, not with them."""
    return 1 << max(n - 1, 0).bit_length()


class TickEngine:
    """Executor-facing driver of the fused tick.

    Owns an ``EstimatorState`` snapshot of a fitted estimator and
    replaces the estimator's per-tick surface (``observe_batch`` +
    ``predict_matrix`` + the scalar interval/PIT/bias consumers) with
    ``tick_step`` outputs, while keeping the host-side pieces the legacy
    path keeps host-side: the raw-sample ``SampleLog`` (order
    statistics), the de-adjust of measured runtimes (bit-compatible
    float64, ``host_deadjust=True``) and the Beta-Binomial reliability
    plane (consumed by the scheduler, not the tick).

    Each tick ends in ONE device-to-host copy: the (T, N) mean and std,
    the bias statistics and the model's per-row fields.  The scalar
    consumers and the next tick's de-adjust read that host view, so
    between ticks nothing waits on the device.

    ``cuda_graph`` (the default on a CUDA state; ``False`` runs the tick
    eagerly): replay the tick core from a CUDA graph captured per (padded
    batch, wave counts) key; a ragged tick is padded to a power of two
    with ``valid = 0`` rows, and each wave count is rounded up to a power
    of two (``_bucket_waves``).  Its outputs equal eager's bit for bit
    (``chip_smoke.py`` phase 9b and the ``gpu`` tests check it).  A new
    key pays one eager warm-up tick on a copy of the state and the
    capture; a replay saves the host's launch of every kernel.

    The wrapped estimator is NOT updated per tick — call ``finalize()``
    when the run ends to write the final state back through the thin
    views, after which the estimator continues (scalar predicts,
    save/load, further ``observe_batch`` ticks) from exactly where the
    engine left off.
    """

    def __init__(self, est, nodes, *, size: float, tracer=None,
                 cuda_graph: bool | None = None):
        self.est = est
        self.size = float(size)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.state, self.names = build_state(est, nodes)
        on_card = self.state.device.type == "cuda"
        if cuda_graph and not on_card:
            raise ValueError("cuda_graph needs a state on a CUDA device, "
                             f"got {self.state.device}")
        self.cuda_graph = on_card if cuda_graph is None else bool(cuda_graph)
        self._graphs: dict = {}
        self._size_t = _size_tensor(self.size, self.state.factors)
        self._rowmap = {n: i for i, n in enumerate(self.names.tasks)}
        self._colmap = {n: j for j, n in enumerate(self.names.nodes)}
        #: host copy of the factors: entry (i, j) is ``est.factor`` of
        #: task i on node j, bit for bit (the same elementwise formula)
        self._F = est.factor_matrix(list(self.names.nodes))
        self._log = self.state.model.stats.log
        self._bias = bias_view(self.state) if est.bias_correction else None
        self._bias_col = dict(est._bias_col)
        self._touched: set[int] = set()
        self._rel_dirty = False
        #: device-to-host copies made by ``observe_batch`` (one a tick)
        self.fetches = 0
        mean, std = predict_state(self.state, self._size_t)
        self._take(self._fetch(self._pack_out(mean, std)))

    # ---- estimator-compatible per-tick surface ------------------------
    def predict_matrix(self, nodes, size, with_std: bool = True):
        if list(nodes) != self.names_nodes or float(size) != self.size:
            raise ValueError(
                "TickEngine serves one (nodes, size) configuration; got "
                f"{list(nodes)}/{size}, engine holds "
                f"{self.names_nodes}/{self.size}")
        return self._mean, (self._std if with_std else None)

    @property
    def names_nodes(self) -> list[str]:
        return list(self.names.nodes)

    def observe_batch(self, observations) -> list[float]:
        """One fused tick: de-adjust host-side (bitwise the legacy
        float64 math), append the raw history, then dispatch ONE tick
        that absorbs the stream, scatters the bias residuals and
        re-predicts the full (T, N) matrix, and copy its outputs back.

        Host work per observation is the reference's de-adjust: the
        factor (read from the engine's copy of ``factor_matrix``, the
        same numbers as ``est.factor``) and the tick-start bias point.
        The samples enter the ``SampleLog`` in input order in one
        scatter (``SampleLog.extend``), and a row's median/MAD is
        computed once a tick, after its last append, for all touched
        rows in one sort (``median_spread_rows``, bit for bit
        ``median_spread``): only the last valid observation of a row
        sets them (the tick's ``med``/``spr`` columns), so the values the
        JAX package computes for a row's earlier observations are never
        read, and every observation of the row carries the final ones.
        The per-task raw arrays grow by one concatenation a task."""
        obs = list(observations)
        if not obs:
            return []
        B = len(obs)
        rows = np.empty(B, np.int64)
        cols = np.empty(B, np.int64)
        xs = np.empty(B, np.float64)
        rts = np.empty(B, np.float64)
        ys = np.empty(B, np.float64)
        F, log, bias, bias_col = self._F, self._log, self._bias, \
            self._bias_col
        for k, o in enumerate(obs):
            task, node, size, runtime = (o if isinstance(o, (tuple, list))
                                         else (o.task, o.node, o.size,
                                               o.runtime))
            size, runtime = float(size), float(runtime)
            i = self._rowmap[str(task)]
            j = self._colmap[str(node)]
            f = max(float(F[i, j]), 1e-12)
            b = 1.0
            if bias is not None and node in bias_col:
                b = bias.point(i, bias_col[node])
            y = runtime / (f * max(b, 1e-12))
            rows[k], cols[k], xs[k], rts[k], ys[k] = i, j, size, runtime, y
        log.extend(rows, xs, ys)
        touched, inverse = np.unique(rows, return_inverse=True)
        med, spr = log.median_spread_rows(touched)
        packed = np.column_stack([rows, cols, xs, rts, ys, med[inverse],
                                  spr[inverse], np.ones(B)])
        names = self.names.tasks
        for r, k in zip(touched, np.split(np.argsort(rows, kind="stable"),
                                          np.cumsum(np.bincount(rows)[
                                              touched])[:-1])):
            ft = self.est.tasks[names[r]]
            ft.sizes = np.concatenate([ft.sizes, xs[k]])
            ft.runtimes = np.concatenate([ft.runtimes, ys[k]])
        self._touched.update(int(i) for i in touched)
        if self._rel_dirty:
            self._sync_reliability()
        with self.tracer.span("tick_step", n=B):
            out = (self._graph_tick(packed) if self.cuda_graph
                   else self._eager_tick(packed))
            self._take(self._fetch(out))
        return ys.tolist()

    def _eager_tick(self, obs: np.ndarray) -> torch.Tensor:
        packed, wm, wb = pack_waves(obs, len(self.names.nodes))
        _, mean, std, _y = _tick_core(
            self.state, _to_device(packed, self.state.device, torch.float64),
            self._size_t, True, (wm, wb))
        return self._pack_out(mean, std)

    def _graph_tick(self, obs: np.ndarray) -> torch.Tensor:
        """The tick core replayed from a CUDA graph: the batch is padded
        with ``valid = 0`` rows to ``_bucket(B)``, the wave counts to
        ``_bucket_waves``, and the rows are copied into the graph's input
        buffer; the graph updates the state's leaves in place and writes
        the packed outputs to its output buffer."""
        B = len(obs)
        pad = np.zeros((_bucket(B), 8), np.float64)
        pad[:B] = obs
        packed, wm, wb = pack_waves(pad, len(self.names.nodes))
        waves = (_bucket_waves(wm), _bucket_waves(wb))
        key = (len(pad),) + waves
        dev = self.state.device
        src = _to_device(packed, dev, torch.float64)
        if key not in self._graphs:
            self._graphs[key] = self._capture(src, waves)
        graph, inp, out = self._graphs[key]
        inp.copy_(src)
        graph.replay()
        return out

    def _capture(self, src: torch.Tensor, waves):
        """Capture the tick core for one (padded batch, waves) key.  The
        warm-up run that precedes a capture (library handles, lazy
        kernels) works on a copy of the state, so the live leaves change
        only when the graph is replayed."""
        inp = torch.empty_like(src)
        inp.copy_(src)
        side = torch.cuda.Stream(device=inp.device)
        side.wait_stream(torch.cuda.current_stream(inp.device))
        with torch.cuda.stream(side):
            _tick_core(clone_state(self.state), inp, self._size_t, True,
                       waves)
        torch.cuda.current_stream(inp.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, mean, std, _y = _tick_core(self.state, inp, self._size_t,
                                          True, waves)
            out = self._pack_out(mean, std)
        return graph, inp, out

    def _pack_out(self, mean, std) -> torch.Tensor:
        """What a tick sends back, as one flat tensor: mean, std, the bias
        statistics and the model's per-row fields."""
        s, m = self.state, self.state.model
        p = m.post
        parts = [mean, std]
        if self._bias is not None:
            parts += [s.bias_counts, s.bias_log_sum, s.bias_log_sq]
        parts += [m.correlated.to(mean.dtype), m.median, m.spread]
        parts += [getattr(p, f) for f in POSTERIOR_FIELDS]
        return torch.cat([t.reshape(-1) for t in parts])

    def _fetch(self, out: torch.Tensor) -> np.ndarray:
        """The tick's one device-to-host copy."""
        self.fetches += 1
        return np.asarray(out.cpu().numpy(), np.float64)

    def _take(self, flat: np.ndarray) -> None:
        """Refresh the host views from a fetched ``_pack_out``."""
        T, N = self.state.factors.shape
        nb = self.state.bias_counts.shape[1]
        k = 0

        def take(*shape):
            nonlocal k
            n = int(np.prod(shape))
            a = flat[k:k + n].reshape(shape)
            k += n
            return a

        self._mean, self._std = take(T, N).copy(), take(T, N).copy()
        if self._bias is not None:
            self._bias.counts = take(T, nb).copy()
            self._bias.log_sum = take(T, nb).copy()
            self._bias.log_sq = take(T, nb).copy()
            self._bias._sigma_r_cache = None
        dt = self.state.factors.dtype

        def host(a):
            return torch.from_numpy(a.copy()).to(dt)

        corr, med, spr = take(T) > 0, take(T), take(T)
        post = {f: host(take(*getattr(self.state.model.post, f).shape))
                for f in POSTERIOR_FIELDS}
        self._host_model = BatchedTaskModel(
            correlated=torch.from_numpy(corr), post=BLRPosterior(**post),
            median=host(med), spread=host(spr))

    # ---- scalar consumers (tick-start belief, from the host view) -----
    def predict_interval_node(self, task_name: str, node: str, size: float,
                              confidence: float = 0.9):
        i = self._rowmap[task_name]
        tm = slice_task_model(self._host_model, i)
        f = self.est.factor(task_name, node)
        z = float(_scipy_stats.norm.ppf(0.5 + confidence / 2.0))
        if tm.correlated:
            lo, hi = predict_interval(tm.post, size, confidence)
            lo, hi = float(lo), float(hi)
        else:
            lo = tm.median - z * tm.spread
            hi = tm.median + z * tm.spread
        s_lo = s_hi = 1.0
        if self._bias is not None:
            j = self._bias_col.get(node)
            if j is not None:
                s_lo, s_hi = self._bias.interval_scale(i, j, z)
        return max(lo * f * s_lo, 0.0), hi * f * s_hi

    def predict_pit_node(self, task_name: str, node: str, size: float,
                         runtime: float) -> float:
        i = self._rowmap[task_name]
        tm = slice_task_model(self._host_model, i)
        f = max(float(self.est.factor(task_name, node)), 1e-12)
        b = 1.0
        if self._bias is not None:
            j = self._bias_col.get(node)
            if j is not None:
                b = self._bias.point(i, j)
        y_local = float(runtime) / (f * max(b, 1e-12))
        if tm.correlated:
            return predict_cdf(tm.post, size, y_local)
        z = (y_local - tm.median) / max(tm.spread, 1e-300)
        return float(_scipy_stats.norm.cdf(z))

    def bias_point(self, name: str, node: str) -> float:
        if self._bias is None:
            return 1.0
        j = self._bias_col.get(node)
        if j is None:
            return 1.0
        return self._bias.point(self._rowmap[name], j)

    def bias_tail_mass(self, name: str, node: str,
                       threshold: float) -> float:
        if self._bias is None:
            return 0.0
        j = self._bias_col.get(node)
        if j is None:
            return 0.0
        return self._bias.tail_mass(self._rowmap[name], j, threshold)

    # ---- reliability plane (host, scheduler-consumed) -----------------
    def record_attempt(self, node: str, success: bool) -> None:
        self.est.record_attempt(node, success)
        self._rel_dirty = True

    def reliability_factors(self, nodes, k: float = 1.0):
        return self.est.reliability_factors(nodes, k)

    def _sync_reliability(self) -> None:
        """Mirror the host reliability counts into the state leaves (in
        place) so the state stays authoritative for save consumers (the
        tick itself never reads them)."""
        rel = self.est.reliability
        names = self.names
        if rel is None or not names.rel_nodes:
            self._rel_dirty = False
            return
        counts = np.array([rel.counts(n) for n in names.rel_nodes],
                          np.float64).T
        src = _to_device(counts, self.state.device, self.state.rel_succ.dtype)
        self.state.rel_succ.copy_(src[0])
        self.state.rel_fail.copy_(src[1])
        self._rel_dirty = False

    # ---- writeback ----------------------------------------------------
    def finalize(self) -> None:
        """Fold the final state back into the wrapped estimator (batch
        cache, touched scalar models, bias posterior) — after this the
        legacy OO surface continues bit-compatibly."""
        if self._rel_dirty:
            self._sync_reliability()
        write_back(self.state, self.names, self.est, rows=self._touched)
        self._touched.clear()
