"""Weights, caches and fitted estimator state carried across from the JAX
package.

The one place that maps the JAX package's trees onto the port's.  Both
packages keep the same names and the same stacked layouts (``blocks``
leaves carry a leading layers dim; ``embed`` (V, d), ``unembed`` (d, V),
``ln_f``), so the map is a checked copy: every name and shape of the
port's definition tree must be present in the JAX tree, and nothing else.
The input is numpy only (``jax.tree.map(np.asarray, params)``), so the
port still imports no JAX.

The AdamW state crosses the same way (``opt_state_from_jax``): m and v,
or the int8 codes and scales, the master copy and the step, checked
against the port's ``state_defs``.

The estimator's state crosses the same way: a posterior's six fields, a
``TaskModel`` and a ``BatchedTaskModel`` (with its (T, 8) moments and the
raw-sample log), each given as numpy arrays, become the port's on
``device`` in ``dtype`` (float64 by default), value for value.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.blr import (POSTERIOR_FIELDS, BatchedTaskModel,
                                  BLRPosterior, OnlineStats, SampleLog,
                                  TaskModel, _default_dtype, _to_device)
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig, is_def
from repro_torch.optim import AdamWConfig, state_defs


def _carry(tree, defs, device, path: str = ""):
    if is_def(defs):
        arr = np.array(tree, dtype=np.float32)     # a copy; bf16 -> f32 is exact
        if arr.shape != defs.shape:
            raise ValueError(f"{path}: shape {arr.shape}, the port expects "
                             f"{defs.shape}")
        return torch.from_numpy(arr).to(device=device, dtype=defs.dtype)
    if not isinstance(tree, dict) or set(tree) != set(defs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or '<root>'}: keys {got}, the port expects "
                         f"{sorted(defs)}")
    return {k: _carry(tree[k], defs[k], device, f"{path}/{k}")
            for k in sorted(defs)}


def params_from_jax(tree, cfg: ModelConfig, *, device=None) -> dict:
    """The JAX model's parameter tree (numpy leaves) as the port's params,
    in ``cfg.param_dtype`` on ``device`` (default: the CUDA card).  The
    names and shapes are the port model's own definition tree (``lm_def``,
    or ``encdec_def`` for encdec)."""
    return _carry(tree, build_model(cfg).param_defs, resolve_device(device))


def opt_state_from_jax(tree, cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                       device=None) -> dict:
    """The JAX package's AdamW state (numpy leaves: {"mv": per parameter
    {"m", "v"[, "master"]} or {"m_q", "m_s", "v_q", "v_s"}, "step"}) as the
    port's, each leaf in the dtype of the port's ``state_defs`` (codes
    int8, scales fp32, step int32) on ``device`` (default: the CUDA
    card)."""
    defs = state_defs(build_model(cfg).param_defs, opt_cfg)
    return _carry(tree, defs, resolve_device(device))


def caches_from_jax(tree, cfg: ModelConfig, *, device=None,
                    cache_dtype=torch.bfloat16) -> dict:
    """A JAX cache tree (numpy leaves) as the port's caches (the trees of
    ``Model.init_caches``).  The batch size (and where there is a KV cache,
    its length) comes from the family's own leaves: ssm from
    ``blocks/state``, hybrid from ``blocks/ssm/state`` and
    ``blocks/attn/k``, moe from ``blocks/moe_layer/k``, encdec from
    ``self/k`` and ``cross/k`` (the cross length), dense and vlm from
    ``blocks/k``; the ssm state stays float32."""
    cross_len = 0
    if cfg.family == "encdec":
        batch, max_len = np.shape(tree["self"]["k"])[1:3]
        cross_len = np.shape(tree["cross"]["k"])[2]
    elif cfg.family == "ssm":
        batch, max_len = np.shape(tree["blocks"]["state"])[1], 0
    elif cfg.family == "hybrid":
        batch = np.shape(tree["blocks"]["ssm"]["state"])[2]
        max_len = np.shape(tree["blocks"]["attn"]["k"])[2]
    elif cfg.family == "moe":
        batch, max_len = np.shape(tree["blocks"]["moe_layer"]["k"])[1:3]
    else:
        batch, max_len = np.shape(tree["blocks"]["k"])[1:3]
    defs = build_model(cfg).cache_defs(batch, max_len, cross_len,
                                       cache_dtype)
    return _carry(tree, defs, resolve_device(device))


def posterior_from_numpy(mu, V, a, b, x_scale, y_scale, *, device=None,
                         dtype=None) -> BLRPosterior:
    """A JAX ``BLRPosterior``'s fields (numpy; scalar or with a leading
    (T,) axis) as the port's posterior."""
    dev, dt = resolve_device(device), _default_dtype(dtype)
    return BLRPosterior(*(_to_device(np.asarray(v, np.float64), dev, dt)
                          for v in (mu, V, a, b, x_scale, y_scale)))


def _post(post, device, dtype):
    return posterior_from_numpy(*(post[f] for f in POSTERIOR_FIELDS),
                                device=device, dtype=dtype)


def task_model_from_numpy(correlated, median, spread, post=None, *,
                          device=None, dtype=None) -> TaskModel:
    """A JAX ``TaskModel`` as the port's: ``post`` maps the posterior's
    field names to numpy arrays, or is ``None`` for a median-fallback
    task."""
    return TaskModel(correlated=bool(correlated),
                     post=None if post is None else _post(post, device,
                                                          dtype),
                     median=float(median), spread=float(spread))


def batched_task_model_from_numpy(correlated, post, median, spread,
                                  moments=None, samples=None, *,
                                  device=None,
                                  dtype=None) -> BatchedTaskModel:
    """A JAX ``BatchedTaskModel`` as the port's.  ``post`` maps the
    posterior's field names to (T, ...) numpy arrays; ``moments`` (T, 8)
    and ``samples`` = (x, y, count), the ``SampleLog``'s arrays, carry the
    streamed statistics (both or neither: without them the model predicts
    but cannot update)."""
    dev, dt = resolve_device(device), _default_dtype(dtype)
    if (moments is None) != (samples is None):
        raise ValueError("moments and samples come together: the update "
                         "needs both")
    stats = None
    if moments is not None:
        x, y, count = samples
        stats = OnlineStats(
            moments=_to_device(np.asarray(moments, np.float64), dev, dt),
            log=SampleLog(np.array(x, np.float64), np.array(y, np.float64),
                          np.array(count, np.int64)))
    return BatchedTaskModel(
        correlated=_to_device(np.asarray(correlated, bool), dev, torch.bool),
        post=_post(post, dev, dt),
        median=_to_device(np.asarray(median, np.float64), dev, dt),
        spread=_to_device(np.asarray(spread, np.float64), dev, dt),
        stats=stats)
