"""Decoder-only LM assembly: the dense, vlm, moe, ssm and hybrid families.

Counterpart of ``repro.models.transformer``.  Block parameters and caches
keep the JAX package's stacked layout (a leading scan-units dim); the trunk
is a Python loop over the units where the JAX package runs ``lax.scan``.
A scan unit is one layer, except in the zamba2 hybrid: a super-unit of
``hybrid_attn_every`` Mamba-2 layers (their leaves carry two stacked dims,
(units, every, ...)) followed by one application of a single weight-tied
shared attention block; the ``n_layers % hybrid_attn_every`` layers left
over form a tail of Mamba-2 layers without attention.  In the moe family a
unit is ``moe.every`` layers: ``every - 1`` dense layers ("dense_{j}")
and then one whose MLP is the MoE ("moe_layer"), so llama4's interleave
keeps the stacked leaves homogeneous.  The vlm family is the dense trunk
with precomputed vision embeddings prepended and M-RoPE positions.  The
encdec family is ``encdec.py``; ``lm_loss`` and ``chunked_xent`` are not
ported yet (ROADMAP.md, Queue A).
"""
from __future__ import annotations

from typing import Any

import torch

from .common import ModelConfig, ParamDef, tree_map_defs
from .layers import (apply_mlp, apply_norm, attention_def, layernorm_def,
                     mlp_def, rmsnorm_def, self_attention)
from .mamba2 import apply_mamba2, decode_mamba2, mamba2_def
from .moe import apply_moe, moe_def

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


def norm_def(cfg: ModelConfig) -> dict:
    return layernorm_def(cfg.d_model) if cfg.norm == "layernorm" else rmsnorm_def(cfg.d_model)


def stack_defs(defs, n: int):
    """Add a leading stacked 'layers' dim to every ParamDef leaf."""
    return tree_map_defs(
        lambda d: ParamDef((n,) + d.shape, init=d.init, scale=d.scale,
                           dtype=d.dtype), defs)


def _index_tree(tree, j: int):
    """Unit ``j`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, j) for k, v in tree.items()}
    return tree[j]


def _dense_layer_def(cfg: ModelConfig) -> dict:
    return {"ln1": norm_def(cfg), "attn": attention_def(cfg),
            "ln2": norm_def(cfg), "mlp": mlp_def(cfg)}


def _moe_layer_def(cfg: ModelConfig) -> dict:
    return {"ln1": norm_def(cfg), "attn": attention_def(cfg),
            "ln2": norm_def(cfg), "moe": moe_def(cfg)}


def _ssm_layer_def(cfg: ModelConfig) -> dict:
    return {"ln": norm_def(cfg), "mamba": mamba2_def(cfg)}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder-only LM; "
                         f"transformer.py builds {FAMILIES} (encdec: "
                         "encdec.py)")


def scan_unit_def(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    if cfg.family in ("dense", "vlm"):
        return _dense_layer_def(cfg)
    if cfg.family == "moe":
        unit = {"moe_layer": _moe_layer_def(cfg)}
        for j in range(cfg.moe.every - 1):
            unit[f"dense_{j}"] = _dense_layer_def(cfg)
        return unit
    if cfg.family == "ssm":
        return _ssm_layer_def(cfg)
    return {"ssm_layers": stack_defs(_ssm_layer_def(cfg),
                                     cfg.hybrid_attn_every)}


def n_scan_units(cfg: ModelConfig) -> int:
    if cfg.family == "moe":
        if cfg.n_layers % cfg.moe.every:
            raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                             f"moe.every={cfg.moe.every}")
        return cfg.n_layers // cfg.moe.every
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def hybrid_tail_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers % cfg.hybrid_attn_every if cfg.family == "hybrid" else 0


def lm_def(cfg: ModelConfig) -> dict:
    d: dict[str, Any] = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), dtype=cfg.param_dtype),
        "blocks": stack_defs(scan_unit_def(cfg), n_scan_units(cfg)),
        "ln_f": norm_def(cfg),
    }
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab), dtype=cfg.param_dtype)
    if cfg.family == "hybrid":
        d["shared_attn"] = _dense_layer_def(cfg)
        tail = hybrid_tail_layers(cfg)
        if tail:
            d["tail_blocks"] = stack_defs(_ssm_layer_def(cfg), tail)
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
    """dense, vlm: {"blocks": {"k", "v": (L, B, Tmax, Hkv, hd)}}; moe:
    {"blocks": {"moe_layer", "dense_{j}": {"k", "v": (U, B, Tmax, Hkv,
    hd)}}} with U = n_scan_units, one KV cache per layer of a unit; ssm:
    {"blocks": {"conv": (L, B, k-1, conv_ch), "state": (L, B, H, P, N)}},
    which do not grow with ``max_len``; hybrid: {"blocks": {"ssm": the ssm
    leaves as (U, every, B, ...), "attn": {"k", "v": (U, B, Tmax, Hkv,
    hd)}}, "tail": the ssm leaves as (tail, B, ...)}, one KV cache per
    application of the shared block (U = n_scan_units), "tail" only where
    there is a tail.  The state is float32 (float64 under a float64
    ``cache_dtype``)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return {"blocks": stack_defs(_ssm_cache_def(cfg, batch, cache_dtype),
                                     cfg.n_layers)}
    if cfg.family in ("dense", "vlm"):
        return {"blocks": stack_defs(_kv_def(cfg, batch, max_len,
                                             cache_dtype), cfg.n_layers)}
    if cfg.family == "moe":
        unit = {"moe_layer": _kv_def(cfg, batch, max_len, cache_dtype)}
        for j in range(cfg.moe.every - 1):
            unit[f"dense_{j}"] = _kv_def(cfg, batch, max_len, cache_dtype)
        return {"blocks": stack_defs(unit, n_scan_units(cfg))}
    unit = {"ssm": stack_defs(_ssm_cache_def(cfg, batch, cache_dtype),
                              cfg.hybrid_attn_every),
            "attn": _kv_def(cfg, batch, max_len, cache_dtype)}
    out = {"blocks": stack_defs(unit, n_scan_units(cfg))}
    tail = hybrid_tail_layers(cfg)
    if tail:
        out["tail"] = stack_defs(_ssm_cache_def(cfg, batch, cache_dtype),
                                 tail)
    return out


# ---------------------------------------------------------------------------
# Trunk: embeddings + blocks + final norm
# ---------------------------------------------------------------------------
def _positions_for(cfg: ModelConfig, batch: dict, B: int, T: int,
                   offset: int, device) -> torch.Tensor:
    """(B, T) positions ``offset + arange(T)``; under M-RoPE (B, T, 3): the
    batch's ``positions`` when given, else that arange in all three
    components."""
    if cfg.mrope and batch.get("positions") is not None:
        return batch["positions"]
    base = offset + torch.arange(T, device=device)
    if cfg.mrope:
        return base[None, :, None].expand(B, T, 3)
    return base[None, :].expand(B, T)


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    # Gather, then cast: the same values as the JAX package's gather from
    # a cfg.dtype copy of the table, without copying the whole table.
    h = params["embed"][batch["tokens"]].to(cfg.dtype)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        h = torch.cat([batch["vision_embeds"].to(cfg.dtype), h], dim=1)
    return h


def _apply_dense_layer(p, h, cfg, positions, cache, cache_index):
    """A dense layer; in the hybrid, the shared attention block."""
    a, cache = self_attention(p["attn"], apply_norm(p["ln1"], h, cfg.norm),
                              cfg, causal=True, positions=positions,
                              cache=cache, cache_index=cache_index)
    h = h + a
    h = h + apply_mlp(p["mlp"], apply_norm(p["ln2"], h, cfg.norm), cfg)
    return h, cache


def _apply_moe_layer(p, h, cfg, positions, cache, cache_index):
    """Attention, then the MoE in place of the MLP.  Returns (h, aux)."""
    a, _ = self_attention(p["attn"], apply_norm(p["ln1"], h, cfg.norm),
                          cfg, causal=True, positions=positions,
                          cache=cache, cache_index=cache_index)
    h = h + a
    mo, aux = apply_moe(p["moe"], apply_norm(p["ln2"], h, cfg.norm), cfg)
    return h + mo, aux


def _apply_moe_unit(p, h, cfg, positions, cache, cache_index):
    """The unit's ``every - 1`` dense layers, then its MoE layer (the JAX
    package's ``_apply_unit`` order)."""
    for j in range(cfg.moe.every - 1):
        key = f"dense_{j}"
        h, _ = _apply_dense_layer(p[key], h, cfg, positions, cache[key],
                                  cache_index)
    h, _ = _apply_moe_layer(p["moe_layer"], h, cfg, positions,
                            cache["moe_layer"], cache_index)
    return h


def _apply_ssm_layer(p, h, cfg, cache, cache_index, decode: bool = False):
    x = apply_norm(p["ln"], h, cfg.norm)
    if decode:
        o, cache = decode_mamba2(p["mamba"], x, cfg, cache)
    else:
        o, cache = apply_mamba2(p["mamba"], x, cfg, cache=cache,
                                cache_index=cache_index)
    return h + o, cache


def _apply_hybrid_unit(p, h, cfg, shared, positions, cache, cache_index,
                       decode):
    """``hybrid_attn_every`` Mamba-2 layers, then the shared block over
    this super-unit's own KV cache."""
    for j in range(cfg.hybrid_attn_every):
        h, _ = _apply_ssm_layer(_index_tree(p["ssm_layers"], j), h, cfg,
                                _index_tree(cache["ssm"], j), cache_index,
                                decode)
    h, _ = _apply_dense_layer(shared, h, cfg, positions, cache["attn"],
                              cache_index)
    return h


def trunk(params, cfg: ModelConfig, batch: dict, caches: dict,
          cache_index: int, decode: bool = False):
    """Embed + all blocks (+ the hybrid's tail) + final norm over the
    caches, which are updated in place.  ``decode`` takes the Mamba-2
    layers' one-token recurrence.  Returns (h, caches)."""
    _check_family(cfg)
    h = _embed_inputs(params, cfg, batch)
    B, T = h.shape[0], h.shape[1]
    positions = (None if cfg.family == "ssm" else
                 _positions_for(cfg, batch, B, T, cache_index, h.device))
    for u in range(n_scan_units(cfg)):
        p = _index_tree(params["blocks"], u)
        cache = _index_tree(caches["blocks"], u)
        if cfg.family == "ssm":
            h, _ = _apply_ssm_layer(p, h, cfg, cache, cache_index, decode)
        elif cfg.family == "hybrid":
            h = _apply_hybrid_unit(p, h, cfg, params["shared_attn"],
                                   positions, cache, cache_index, decode)
        elif cfg.family == "moe":
            h = _apply_moe_unit(p, h, cfg, positions, cache, cache_index)
        else:
            h, _ = _apply_dense_layer(p, h, cfg, positions, cache,
                                      cache_index)
    for j in range(hybrid_tail_layers(cfg)):
        h, _ = _apply_ssm_layer(_index_tree(params["tail_blocks"], j), h,
                                cfg, _index_tree(caches["tail"], j),
                                cache_index, decode)
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
    """Run the prompt through the trunk filling caches; returns last logits.
    ``batch``: "tokens" (B, T); for vlm optionally "vision_embeds" (B, Tv,
    d_model), prepended, and "positions" (B, Tv + T, 3)."""
    h, caches = trunk(params, cfg, batch, caches, cache_index=0)
    return _logits(h[:, -1:], params, cfg), caches


def lm_decode(params, cfg: ModelConfig, batch: dict, caches,
              cache_index: int):
    """One decode step: batch["tokens"]: (B, 1); under M-RoPE optionally
    batch["positions"]: (B, 1, 3)."""
    h, caches = trunk(params, cfg, batch, caches, cache_index=cache_index,
                      decode=cfg.family in ("ssm", "hybrid"))
    return _logits(h, params, cfg), caches
