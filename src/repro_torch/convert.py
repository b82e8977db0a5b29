"""Weights and caches carried across from the JAX package.

The one place that maps the JAX package's trees onto the port's.  Both
packages keep the same names and the same stacked layouts (``blocks``
leaves carry a leading layers dim; ``embed`` (V, d), ``unembed`` (d, V),
``ln_f``), so the map is a checked copy: every name and shape of the
port's definition tree must be present in the JAX tree, and nothing else.
The input is numpy only (``jax.tree.map(np.asarray, params)``), so the
port still imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig, is_def
from repro_torch.models.transformer import cache_def, lm_def


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
    in ``cfg.param_dtype`` on ``device`` (default: the CUDA card)."""
    return _carry(tree, lm_def(cfg), resolve_device(device))


def caches_from_jax(tree, cfg: ModelConfig, *, device=None,
                    cache_dtype=torch.bfloat16) -> dict:
    """A JAX cache tree (numpy leaves) as the port's caches: dense
    {"blocks": {"k", "v": (L, B, Tmax, Hkv, hd)}}, ssm {"blocks":
    {"conv": (L, B, k-1, conv_ch), "state": (L, B, H, P, N)}}.  The batch
    size (and for dense the cache length) comes from the family's own
    leaves; the ssm state stays float32."""
    if cfg.family == "ssm":
        batch = np.shape(tree["blocks"]["state"])[1]
        defs = cache_def(cfg, batch, 0, cache_dtype)
    else:
        k_shape = np.shape(tree["blocks"]["k"])
        defs = cache_def(cfg, k_shape[1], k_shape[2], cache_dtype)
    return _carry(tree, defs, resolve_device(device))

