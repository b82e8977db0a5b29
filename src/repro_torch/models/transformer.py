"""Decoder-only LM assembly, dense and ssm families.

Counterpart of ``repro.models.transformer``.  Block parameters and caches
keep the JAX package's stacked layout (a leading layers dim); the trunk is
a Python loop over the layers where the JAX package runs ``lax.scan``.
The other families, ``lm_loss`` and ``chunked_xent`` are not ported yet
(ROADMAP.md, Queue A).
"""
from __future__ import annotations

from typing import Any

import torch

from .common import ModelConfig, ParamDef, tree_map_defs
from .layers import (apply_mlp, apply_norm, attention_def, layernorm_def,
                     mlp_def, rmsnorm_def, self_attention)
from .mamba2 import apply_mamba2, decode_mamba2, mamba2_def

FAMILIES = ("dense", "ssm")


def norm_def(cfg: ModelConfig) -> dict:
    return layernorm_def(cfg.d_model) if cfg.norm == "layernorm" else rmsnorm_def(cfg.d_model)


def stack_defs(defs, n: int):
    """Add a leading stacked 'layers' dim to every ParamDef leaf."""
    return tree_map_defs(
        lambda d: ParamDef((n,) + d.shape, init=d.init, scale=d.scale,
                           dtype=d.dtype), defs)


def _index_tree(tree, j: int):
    """Layer ``j`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, j) for k, v in tree.items()}
    return tree[j]


def _dense_layer_def(cfg: ModelConfig) -> dict:
    return {"ln1": norm_def(cfg), "attn": attention_def(cfg),
            "ln2": norm_def(cfg), "mlp": mlp_def(cfg)}


def _ssm_layer_def(cfg: ModelConfig) -> dict:
    return {"ln": norm_def(cfg), "mamba": mamba2_def(cfg)}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue A "
            f"item 1); repro_torch runs the families {FAMILIES}")


def lm_def(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    layer = _ssm_layer_def if cfg.family == "ssm" else _dense_layer_def
    d: dict[str, Any] = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), dtype=cfg.param_dtype),
        "blocks": stack_defs(layer(cfg), cfg.n_layers),
        "ln_f": norm_def(cfg),
    }
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab), dtype=cfg.param_dtype)
    return d


# ---------------------------------------------------------------------------
# Cache definitions
# ---------------------------------------------------------------------------
def _kv_def(cfg: ModelConfig, batch: int, max_len: int, cache_dtype) -> dict:
    hd = cfg.resolved_head_dim()
    return {"k": ParamDef((batch, max_len, cfg.n_kv_heads, hd), init="zeros",
                          dtype=cache_dtype),
            "v": ParamDef((batch, max_len, cfg.n_kv_heads, hd), init="zeros",
                          dtype=cache_dtype)}


def _ssm_cache_def(cfg: ModelConfig, batch: int, cache_dtype) -> dict:
    s = cfg.ssm
    conv_ch = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    H = s.n_ssm_heads(cfg.d_model)
    return {"conv": ParamDef((batch, s.d_conv - 1, conv_ch), init="zeros",
                             dtype=cache_dtype),
            "state": ParamDef((batch, H, s.head_dim, s.d_state),
                              init="zeros",
                              dtype=torch.promote_types(cache_dtype,
                                                        torch.float32))}


def cache_def(cfg: ModelConfig, batch: int, max_len: int,
              cache_dtype=torch.bfloat16) -> dict:
    """dense: {"blocks": {"k", "v": (L, B, Tmax, Hkv, hd)}}; ssm:
    {"blocks": {"conv": (L, B, k-1, conv_ch), "state": (L, B, H, P, N)}},
    which do not grow with ``max_len``; the state is float32 (float64
    under a float64 ``cache_dtype``)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return {"blocks": stack_defs(_ssm_cache_def(cfg, batch, cache_dtype),
                                     cfg.n_layers)}
    return {"blocks": stack_defs(_kv_def(cfg, batch, max_len, cache_dtype),
                                 cfg.n_layers)}


# ---------------------------------------------------------------------------
# Trunk: embeddings + blocks + final norm
# ---------------------------------------------------------------------------
def _positions_for(B: int, T: int, offset: int, device) -> torch.Tensor:
    base = offset + torch.arange(T, device=device)
    return base[None, :].expand(B, T)


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    # Gather, then cast: the same values as the JAX package's gather from
    # a cfg.dtype copy of the table, without copying the whole table.
    return params["embed"][batch["tokens"]].to(cfg.dtype)


def _apply_dense_layer(p, h, cfg, positions, cache, cache_index):
    a, cache = self_attention(p["attn"], apply_norm(p["ln1"], h, cfg.norm),
                              cfg, causal=True, positions=positions,
                              cache=cache, cache_index=cache_index)
    h = h + a
    h = h + apply_mlp(p["mlp"], apply_norm(p["ln2"], h, cfg.norm), cfg)
    return h, cache


def _apply_ssm_layer(p, h, cfg, cache, cache_index, decode: bool = False):
    x = apply_norm(p["ln"], h, cfg.norm)
    if decode:
        o, cache = decode_mamba2(p["mamba"], x, cfg, cache)
    else:
        o, cache = apply_mamba2(p["mamba"], x, cfg, cache=cache,
                                cache_index=cache_index)
    return h + o, cache


def trunk(params, cfg: ModelConfig, batch: dict, caches: dict,
          cache_index: int, decode: bool = False):
    """Embed + all blocks + final norm over the caches, which are updated
    in place.  ``decode`` takes the ssm layers' one-token recurrence.
    Returns (h, caches)."""
    _check_family(cfg)
    h = _embed_inputs(params, cfg, batch)
    B, T = h.shape[0], h.shape[1]
    positions = (_positions_for(B, T, cache_index, h.device)
                 if cfg.family == "dense" else None)
    for layer in range(cfg.n_layers):
        p = _index_tree(params["blocks"], layer)
        cache = _index_tree(caches["blocks"], layer)
        if cfg.family == "ssm":
            h, _ = _apply_ssm_layer(p, h, cfg, cache, cache_index, decode)
        else:
            h, _ = _apply_dense_layer(p, h, cfg, positions, cache,
                                      cache_index)
    h = apply_norm(params["ln_f"], h, cfg.norm)
    return h, caches


def unembed_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def _logits(h, params, cfg: ModelConfig):
    """bf16 operands, fp32 accumulation and output, as the JAX package's
    ``preferred_element_type=float32``: the operands are rounded to
    cfg.dtype and the product is taken in fp32, where products of bf16
    values are exact."""
    w = unembed_matrix(params, cfg).to(cfg.dtype).float()
    return torch.einsum("btd,dv->btv", h.to(cfg.dtype).float(), w)


def lm_prefill(params, cfg: ModelConfig, batch: dict, caches):
    """Run the prompt through the trunk filling caches; returns last logits."""
    h, caches = trunk(params, cfg, batch, caches, cache_index=0)
    return _logits(h[:, -1:], params, cfg), caches


def lm_decode(params, cfg: ModelConfig, batch: dict, caches,
              cache_index: int):
    """One decode step: batch["tokens"]: (B, 1)."""
    h, caches = trunk(params, cfg, batch, caches, cache_index=cache_index,
                      decode=cfg.family == "ssm")
    return _logits(h, params, cfg), caches
