"""Core layers: norms, RoPE, attention with a KV cache, SwiGLU MLP.

Counterpart of ``repro.models.layers``.  Attention goes through
``repro_torch.kernels.flash_attention.mha``: the hand-written kernel on a
CUDA card, its plain version on the CPU.  Weights are kept in
``param_dtype`` and cast to the compute dtype at each use, as the JAX
package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import mha
from .common import ModelConfig, ParamDef


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_def(dim: int) -> dict:
    return {"scale": ParamDef((dim,), init="ones")}


def layernorm_def(dim: int) -> dict:
    return {"scale": ParamDef((dim,), init="ones"),
            "bias": ParamDef((dim,), init="zeros")}


def apply_norm(params: dict, x: torch.Tensor, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (split halves, not interleaved)
# ---------------------------------------------------------------------------
def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T) integer."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs                 # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------
def attention_def(cfg: ModelConfig) -> dict:
    if cfg.qkv_bias or cfg.mrope:
        raise NotImplementedError("QKV biases and M-RoPE are not ported yet "
                                  "(ROADMAP.md, Queue A item 1)")
    hd = cfg.resolved_head_dim()
    pd = cfg.param_dtype
    return {"wq": ParamDef((cfg.d_model, cfg.n_heads, hd), dtype=pd),
            "wk": ParamDef((cfg.d_model, cfg.n_kv_heads, hd), dtype=pd),
            "wv": ParamDef((cfg.d_model, cfg.n_kv_heads, hd), dtype=pd),
            "wo": ParamDef((cfg.n_heads, hd, cfg.d_model), dtype=pd)}


def attention_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig):
    dt = cfg.dtype
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(dt))
    return q, k, v


def attention_out(params: dict, o: torch.Tensor, cfg: ModelConfig):
    return torch.einsum("bthk,hkd->btd", o, params["wo"].to(cfg.dtype))


def self_attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   causal: bool, positions: torch.Tensor, cache: dict,
                   cache_index: int):
    """Self-attention over a KV cache.

    ``cache``: {"k": (B, Tmax, Hkv, D), "v": ...}; ``cache_index``: tokens
    already in the cache.  The new K/V are written at that offset and
    attention runs over the whole cache, masked to ``cache_index + T``
    keys.  Returns (out, cache); the cache tensors are updated in place.
    """
    q, k, v = attention_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    T, t_max = x.shape[1], cache["k"].shape[1]
    if cache_index + T > t_max:
        raise ValueError(f"cache of {t_max} positions cannot take {T} tokens "
                         f"at index {cache_index}")
    # In place, where the JAX package returns a new cache from
    # lax.dynamic_update_slice_in_dim.
    cache["k"][:, cache_index:cache_index + T] = k.to(cache["k"].dtype)
    cache["v"][:, cache_index:cache_index + T] = v.to(cache["v"].dtype)
    out = mha(q, cache["k"].to(cfg.dtype), cache["v"].to(cfg.dtype),
              causal=causal, kv_len=cache_index + T, q_offset=cache_index)
    return attention_out(params, out, cfg), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_def(cfg: ModelConfig) -> dict:
    if cfg.act != "swiglu":
        raise NotImplementedError(f"activation {cfg.act!r} is not ported yet "
                                  "(ROADMAP.md, Queue A item 1)")
    f, pd = cfg.d_ff, cfg.param_dtype
    return {"wg": ParamDef((cfg.d_model, f), dtype=pd),
            "wu": ParamDef((cfg.d_model, f), dtype=pd),
            "wd": ParamDef((f, cfg.d_model), dtype=pd)}


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig):
    dt = cfg.dtype
    g = torch.einsum("btd,df->btf", x, params["wg"].to(dt))
    u = torch.einsum("btd,df->btf", x, params["wu"].to(dt))
    return torch.einsum("btf,fd->btd", F.silu(g) * u, params["wd"].to(dt))
