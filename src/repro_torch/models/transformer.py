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
encdec family is ``encdec.py``.

Training: ``trunk`` without caches runs each unit under ``_remat`` (the
JAX package's ``jax.checkpoint`` per scan unit), ``lm_loss`` is the chunked
cross-entropy (``chunked_xent``) plus ``AUX_LOSS_COEF`` times the MoE
units' load-balancing losses.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .common import ModelConfig, ParamDef, tree_map_defs
from .layers import (apply_mlp, apply_norm, attention_def, layernorm_def,
                     mlp_def, rmsnorm_def, self_attention)
from .mamba2 import apply_mamba2, decode_mamba2, mamba2_def
from .moe import apply_moe, moe_def

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
AUX_LOSS_COEF = 0.01


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
    package's ``_apply_unit`` order).  Returns (h, the MoE layer's aux
    loss)."""
    for j in range(cfg.moe.every - 1):
        key = f"dense_{j}"
        h, _ = _apply_dense_layer(p[key], h, cfg, positions,
                                  _sub(cache, key), cache_index)
    return _apply_moe_layer(p["moe_layer"], h, cfg, positions,
                            _sub(cache, "moe_layer"), cache_index)


def _sub(cache, key):
    return None if cache is None else cache[key]


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
        h, _ = _apply_ssm_layer(
            _index_tree(p["ssm_layers"], j), h, cfg,
            None if cache is None else _index_tree(cache["ssm"], j),
            cache_index, decode)
    h, _ = _apply_dense_layer(shared, h, cfg, positions, _sub(cache, "attn"),
                              cache_index)
    return h


#: the products that the "dots" policy keeps: the JAX package's
#: ``dots_with_no_batch_dims_saveable`` keeps dot products without batch
#: dims, which the port's einsums reach as a bmm of batch 1 or an mm
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS or (op is torch.ops.aten.bmm.default
                       and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(fn, context_fn=None):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) where a
    gradient is being taken: only its inputs are kept, the rest is
    recomputed in the backward (``jax.checkpoint``)."""
    kw = {} if context_fn is None else {"context_fn": context_fn}

    @functools.wraps(fn)
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _remat(fn, cfg: ModelConfig):
    """``cfg.remat`` applied to ``fn``: "none" keeps every activation,
    "full" only the inputs, "dots" also the products without batch dims.
    Memory changes, never the numbers."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return _checkpoint(fn)
    if cfg.remat == "dots":
        return _checkpoint(fn, functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {cfg.remat!r} is not none, full or dots")


def trunk(params, cfg: ModelConfig, batch: dict, caches: dict | None = None,
          cache_index: int = 0, decode: bool = False):
    """Embed + all blocks (+ the hybrid's tail) + final norm.  With
    ``caches`` they are updated in place; without (training), each unit
    runs under ``_remat``.  ``decode`` takes the Mamba-2 layers'
    one-token recurrence.  Returns (h, caches, aux): aux is the sum of the
    MoE units' load-balancing losses (0 in the other families)."""
    _check_family(cfg)
    h = _embed_inputs(params, cfg, batch)
    B, T = h.shape[0], h.shape[1]
    positions = (None if cfg.family == "ssm" else
                 _positions_for(cfg, batch, B, T, cache_index, h.device))
    zero = torch.zeros((), dtype=torch.float32, device=h.device)

    def unit(p, h, cache):
        if cfg.family == "ssm":
            return _apply_ssm_layer(p, h, cfg, cache, cache_index,
                                    decode)[0], zero
        if cfg.family == "hybrid":
            return _apply_hybrid_unit(p, h, cfg, params["shared_attn"],
                                      positions, cache, cache_index,
                                      decode), zero
        if cfg.family == "moe":
            return _apply_moe_unit(p, h, cfg, positions, cache, cache_index)
        return _apply_dense_layer(p, h, cfg, positions, cache,
                                  cache_index)[0], zero

    def tail(p, h, cache):
        return _apply_ssm_layer(p, h, cfg, cache, cache_index, decode)[0]

    if caches is None:
        unit, tail = _remat(unit, cfg), _remat(tail, cfg)
    aux = zero
    for u in range(n_scan_units(cfg)):
        h, a = unit(_index_tree(params["blocks"], u), h,
                    None if caches is None
                    else _index_tree(caches["blocks"], u))
        aux = aux + a
    for j in range(hybrid_tail_layers(cfg)):
        h = tail(_index_tree(params["tail_blocks"], j), h,
                 None if caches is None else _index_tree(caches["tail"], j))
    h = apply_norm(params["ln_f"], h, cfg.norm)
    return h, caches, aux


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
    h, caches, _ = trunk(params, cfg, batch, caches, cache_index=0)
    return _logits(h[:, -1:], params, cfg), caches


def lm_decode(params, cfg: ModelConfig, batch: dict, caches,
              cache_index: int):
    """One decode step: batch["tokens"]: (B, 1); under M-RoPE optionally
    batch["positions"]: (B, 1, 3)."""
    h, caches, _ = trunk(params, cfg, batch, caches, cache_index=cache_index,
                         decode=cfg.family in ("ssm", "hybrid"))
    return _logits(h, params, cfg), caches


# ---------------------------------------------------------------------------
# Chunked cross-entropy and the loss
# ---------------------------------------------------------------------------
def _xent_chunk(hx, w, lx, mx):
    """Summed masked xent of one chunk and its token count; logits in fp32
    from the cfg.dtype operands (exact products, fp32 sums)."""
    logits = torch.einsum("bcd,dv->bcv", hx.float(), w.float())
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lx[..., None].long())[..., 0]
    return torch.sum((lse - ll) * mx), torch.sum(mx)


def chunked_xent(h, w_out, labels, mask, cfg: ModelConfig):
    """h: (B, T, d) -> mean masked token xent (fp32).  Logits exist one
    chunk of ``cfg.xent_chunk`` tokens at a time; T is padded to whole
    chunks (padding masked out), and each chunk is recomputed in the
    backward unless ``cfg.remat`` is "none", as the JAX package's
    ``jax.checkpoint`` of its scan body."""
    B, T, d = h.shape
    C = min(cfg.xent_chunk, T)
    n_chunks = -(-T // C)
    pad = n_chunks * C - T
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    h = h.to(cfg.dtype)
    w = w_out.to(cfg.dtype)
    body = _xent_chunk if cfg.remat == "none" else _checkpoint(_xent_chunk)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * C, (i + 1) * C)
        t, c = body(h[:, sl], w, labels[:, sl], mask[:, sl])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg: ModelConfig, batch: dict):
    """Mean next-token xent over ``batch["labels"]`` (masked by
    ``batch["mask"]`` where given) plus ``AUX_LOSS_COEF`` x the MoE aux
    loss.  vlm: over the text region after the vision embeddings.
    Returns (loss, {"xent", "aux"})."""
    h, _, aux = trunk(params, cfg, batch)
    labels = batch["labels"]
    mask = batch.get("mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32,
                       device=labels.device) if mask is None
            else mask.float())
    if cfg.family == "vlm" and "vision_embeds" in batch:
        h = h[:, batch["vision_embeds"].shape[1]:]
    loss = chunked_xent(h, unembed_matrix(params, cfg), labels, mask, cfg)
    return loss + AUX_LOSS_COEF * aux, {"xent": loss, "aux": aux}
