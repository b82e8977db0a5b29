"""Multi-workflow fleet: a leading ``(W,)`` axis over ``EstimatorState``.

Port of ``repro.online.fleet``.  The fused tick (``repro_torch.core.tick``)
runs one estimator's whole observe → update → bias scatter → re-predict
sequence on the device over an ``EstimatorState``.  This module lifts
that to a fleet of W concurrent workflows: per-workflow states are padded
to a common ``(T, N)`` envelope, stacked leaf-wise into one
``FleetState`` whose every tensor leaf carries a leading workflow axis,
and advanced by ``fleet_tick_step`` — the SAME tick core the
single-workflow ``tick_step`` runs (``tick._stacked_tick_core``, of which
``tick_step`` is the W = 1 case), so the fleet semantics are the
per-workflow semantics by construction (held to per-workflow
``tick_step`` loops and to the JAX package in
``tests/test_torch_fleet.py``).  All W workflows go in one batched pass:
row keys are flattened to ``w * T + row``, so the order-exact wave
scatters take one launch a wave for the whole fleet, and the sums over a
workflow's whole state (the empirical-Bayes ``sigma_r``, the decay
trigger) are taken per workflow.

Placement: ``repro_torch.launch.mesh.make_fleet_mesh`` builds a ``("wf",
"task")`` mesh and ``shard_fleet`` places the stacked leaves on it.  One
card is the (1, 1) mesh: every leaf goes whole to that device, bit for
bit the unsharded fleet.  A mesh of more than one device is not ported
(``shard_fleet`` raises ``NotImplementedError``).

Padding values are chosen inert, not just ignored: padded observation
rows carry ``valid = 0`` (the tick sends them to a scratch slot, so every
leaf stays bitwise unchanged), padded task rows get an identity posterior
whose fold output is finite, and padded node columns sit outside the bias
universe (``node_cols = -1``).  Consumers slice real cells back out with
``fleet_slice``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.blr import (POSTERIOR_FIELDS, BatchedTaskModel,
                                  BLRPosterior, OnlineStats, _to_device)
from repro_torch.core.state import EstimatorState
from repro_torch.core.tick import (_fold_predict, _host_obs, _size_tensor,
                                   _stacked_tick_core, pack_waves)

#: columns of one packed observation row (see ``core.tick``)
OBS_WIDTH = 8


@dataclass(frozen=True)
class FleetState:
    """W stacked estimator states plus their real (unpadded) extents.

    ``state``'s tensor leaves all carry a leading ``(W,)`` axis;
    ``t_count`` / ``n_count`` record how many task rows / node columns of
    each workflow's padded envelope are real.
    """
    state: EstimatorState
    t_count: torch.Tensor    # (W,) int32 real task rows per workflow
    n_count: torch.Tensor    # (W,) int32 real node columns per workflow


def _map_leaves(fn, *states: EstimatorState) -> EstimatorState:
    """An ``EstimatorState`` whose every tensor leaf is ``fn`` of the same
    leaf of each of ``states`` (the ``SampleLog`` is left out)."""
    s0, models = states[0], [s.model for s in states]

    def leaf(get):
        return fn(*(get(x) for x in states))

    def mleaf(get):
        return fn(*(get(m) for m in models))

    stats = (None if s0.model.stats is None else
             OnlineStats(moments=mleaf(lambda m: m.stats.moments), log=None))
    model = BatchedTaskModel(
        correlated=mleaf(lambda m: m.correlated),
        post=BLRPosterior(*(mleaf(lambda m, f=f: getattr(m.post, f))
                            for f in POSTERIOR_FIELDS)),
        median=mleaf(lambda m: m.median), spread=mleaf(lambda m: m.spread),
        stats=stats)
    return EstimatorState(
        model=model, factors=leaf(lambda s: s.factors),
        node_cols=leaf(lambda s: s.node_cols),
        bias_counts=leaf(lambda s: s.bias_counts),
        bias_log_sum=leaf(lambda s: s.bias_log_sum),
        bias_log_sq=leaf(lambda s: s.bias_log_sq),
        rel_succ=leaf(lambda s: s.rel_succ),
        rel_fail=leaf(lambda s: s.rel_fail), meta=s0.meta)


def pad_state(state: EstimatorState, t_pad: int, n_pad: int,
              nb_pad: int | None = None) -> EstimatorState:
    """Grow a state's envelope to ``(t_pad, n_pad)`` task/node extents
    (and ``nb_pad`` bias columns, default ``n_pad``) with inert filler:
    padded rows are uncorrelated identity posteriors with zero
    median/moments, padded factors are 1, padded node columns map to no
    bias column.  Real cells are byte-identical to the input; the result
    owns its leaves and carries no ``SampleLog``."""
    model = state.model
    t0 = int(model.median.shape[-1])
    n0 = int(state.factors.shape[-1])
    nb0 = int(state.bias_counts.shape[-1])
    nb_pad = n_pad if nb_pad is None else nb_pad
    if t_pad < t0 or n_pad < n0 or nb_pad < nb0:
        raise ValueError(
            f"pad_state cannot shrink: have (T={t0}, N={n0}, Nb={nb0}), "
            f"asked for (T={t_pad}, N={n_pad}, Nb={nb_pad})")
    te = t_pad - t0

    def row_pad(x, value=0.0):
        """Pad the leading task axis of a (T, ...) leaf with ``value``."""
        fill = torch.full((te,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, fill])

    def block_pad(x, shape, value):
        """``x`` in the top-left corner of a ``shape`` leaf of ``value``."""
        out = torch.full(shape, value, dtype=x.dtype, device=x.device)
        out[tuple(slice(0, k) for k in x.shape)] = x
        return out

    p = model.post
    eye = torch.eye(2, dtype=p.V.dtype, device=p.V.device)
    post = BLRPosterior(
        mu=row_pad(p.mu), V=torch.cat([p.V, eye.expand(te, 2, 2)]),
        a=row_pad(p.a, 1.5), b=row_pad(p.b, 1.0),
        x_scale=row_pad(p.x_scale, 1.0), y_scale=row_pad(p.y_scale, 1.0))
    stats = (None if model.stats is None else
             OnlineStats(moments=row_pad(model.stats.moments), log=None))
    padded_model = BatchedTaskModel(
        correlated=row_pad(model.correlated, False), post=post,
        median=row_pad(model.median), spread=row_pad(model.spread),
        stats=stats)
    grid = (t_pad, nb_pad)
    return EstimatorState(
        model=padded_model,
        factors=block_pad(state.factors, (t_pad, n_pad), 1.0),
        node_cols=block_pad(state.node_cols, (n_pad,), -1),
        bias_counts=block_pad(state.bias_counts, grid, 0.0),
        bias_log_sum=block_pad(state.bias_log_sum, grid, 0.0),
        bias_log_sq=block_pad(state.bias_log_sq, grid, 0.0),
        rel_succ=state.rel_succ.clone(), rel_fail=state.rel_fail.clone(),
        meta=state.meta)


def stack_states(states) -> FleetState:
    """Pad each workflow's state to the common envelope and stack every
    tensor leaf along a new leading ``(W,)`` axis, on the first state's
    device.

    All states must share one ``StateMeta`` (the hyperparameters pick the
    tick's code — workflows with different bias decay cannot ride one
    batched pass) and one reliability slot count.  The host-side
    ``SampleLog`` is stripped: the fleet never reads it.
    """
    states = list(states)
    if not states:
        raise ValueError("stack_states needs at least one state")
    meta = states[0].meta
    for s in states[1:]:
        if s.meta != meta:
            raise ValueError(
                "fleet states must share StateMeta hyperparameters: "
                f"{s.meta} != {meta}")
    r_counts = {int(s.rel_succ.shape[0]) for s in states}
    if len(r_counts) > 1:
        raise ValueError(
            f"fleet states must share the reliability slot count, "
            f"got {sorted(r_counts)}")
    t_pad = max(int(s.model.median.shape[-1]) for s in states)
    n_pad = max(int(s.factors.shape[-1]) for s in states)
    nb_pad = max(max(int(s.bias_counts.shape[-1]) for s in states), n_pad)
    dev = states[0].device
    counts = np.array([[s.model.median.shape[-1] for s in states],
                       [s.factors.shape[-1] for s in states]], np.int64)
    t_count, n_count = _to_device(counts, dev, torch.int32)
    padded = [pad_state(s, t_pad, n_pad, nb_pad) for s in states]
    stacked = _map_leaves(lambda *ls: torch.stack(ls), *padded)
    return FleetState(state=stacked, t_count=t_count, n_count=n_count)


def fleet_tick_step(fleet: FleetState, obs, sizes):
    """One fused tick for every workflow at once, in one batched pass.

    ``obs`` is (W, B, 8) packed observation rows (host data: a numpy
    array, or a tensor, which is read back first) — pad a workflow's
    short tick with ``valid = 0`` rows (``pad_obs``); ``sizes`` is the
    (W,) per-workflow prediction input size.  The local-equivalent
    runtimes are de-adjusted on the device from each workflow's tick-start
    bias (``host_deadjust=False``, as the JAX package's fleet does).
    Returns ``(fleet', mean, std)`` with (W, T, N) estimate matrices; the
    fleet's leaves are updated in place (the counterpart of the JAX
    package's buffer donation), so ``fleet'`` holds the same tensors."""
    st = fleet.state
    W, T, N = st.factors.shape
    packed, wm, wb = pack_waves(_host_obs(obs).reshape(W, -1, OBS_WIDTH),
                                N, T)
    new, mean, std, _y = _stacked_tick_core(
        st, _to_device(packed, st.device, torch.float64),
        _size_tensor(sizes, st.factors).reshape(W), False, (wm, wb))
    return (FleetState(state=new, t_count=fleet.t_count,
                       n_count=fleet.n_count), mean, std)


def fleet_predict(fleet: FleetState, sizes):
    """(W, T, N) estimate matrices of every workflow at its own size,
    without absorbing anything — the tick-zero twin of
    ``fleet_tick_step``'s (mean, std) outputs."""
    st = fleet.state
    return _fold_predict(st.model, st, st.bias_counts, st.bias_log_sum,
                         st.bias_log_sq,
                         _size_tensor(sizes, st.factors).reshape(-1))


def pad_obs(obs_rows, batch: int) -> np.ndarray:
    """Pack one workflow's tick observations (each an 8-wide row, see
    ``core.tick``) into a fixed (batch, 8) float64 host block, padding
    with ``valid = 0`` rows that the tick ignores."""
    out = np.zeros((batch, OBS_WIDTH), np.float64)
    rows = np.asarray(obs_rows, np.float64)
    if rows.size:
        if rows.shape[0] > batch:
            raise ValueError(
                f"tick has {rows.shape[0]} observations, envelope is "
                f"{batch} — raise the fleet batch size")
        out[:rows.shape[0]] = rows
    return out


def fleet_slice(arr, fleet: FleetState, w: int) -> np.ndarray:
    """Workflow ``w``'s real (unpadded) cells of a (W, T, N) fleet
    output, as a host array."""
    t = int(fleet.t_count[w])
    n = int(fleet.n_count[w])
    a = arr[w][:t, :n]
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


#: partition specs, as tuples of mesh axis names per leaf dimension
_WF, _WF_TASK = ("wf",), ("wf", "task")


def fleet_pspecs(fleet: FleetState, mesh) -> FleetState:
    """Partition specs for every leaf of a ``FleetState``, as tuples of
    mesh axis names: workflows over the mesh's "wf" axis, task rows over
    "task" where a leaf has a task axis, everything else replicated
    (``()``).  Built structurally (field by field), not by shape sniffing
    — T and N extents can coincide."""
    names = mesh.axis_names
    wf = _WF if "wf" in names else ()
    wt = _WF_TASK if "wf" in names and "task" in names else wf
    st = fleet.state
    post = BLRPosterior(mu=wt, V=wt, a=wt, b=wt, x_scale=wt, y_scale=wt)
    stats = (None if st.model.stats is None
             else OnlineStats(moments=wt, log=None))
    model = BatchedTaskModel(correlated=wt, post=post, median=wt,
                             spread=wt, stats=stats)
    state = EstimatorState(
        model=model, factors=wt, node_cols=wf, bias_counts=wt,
        bias_log_sum=wt, bias_log_sq=wt, rel_succ=wf, rel_fail=wf,
        meta=st.meta)
    return FleetState(state=state, t_count=wf, n_count=wf)


def shard_fleet(fleet: FleetState, mesh) -> FleetState:
    """Lay a stacked fleet out over ``mesh``.

    Axis extents must divide the mesh ("wf" | W, "task" | T) — raises
    with the offending extents otherwise.  A (1, 1) mesh (one device)
    places every leaf whole on that device: a copy that owns its leaves,
    bit for bit the unsharded fleet.  A mesh of more than one device
    raises ``NotImplementedError``.
    """
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    w = int(fleet.t_count.shape[0])
    t = int(fleet.state.model.median.shape[-1])
    if "wf" in sizes and w % sizes["wf"] != 0:
        raise ValueError(f"fleet W={w} not divisible by mesh wf axis "
                         f"({sizes['wf']})")
    if "task" in sizes and t % sizes["task"] != 0:
        raise ValueError(f"fleet T={t} not divisible by mesh task axis "
                         f"({sizes['task']})")
    if mesh.devices.size != 1:
        raise NotImplementedError(
            f"shard_fleet over a {tuple(mesh.devices.shape)} mesh: a fleet "
            "spread over more than one device is not ported; one card is "
            "the (1, 1) mesh")
    dev = mesh.devices.flat[0]

    def place(x):
        return x.to(dev, copy=True)

    return FleetState(state=_map_leaves(place, fleet.state),
                      t_count=place(fleet.t_count),
                      n_count=place(fleet.n_count))
