"""Core layers: norms, RoPE / M-RoPE, self- and cross-attention, MLPs.

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


def mrope_sections(half: int) -> tuple[int, int, int]:
    """The (temporal, h, w) split of the rotary frequencies: Qwen2-VL's
    (16, 24, 24) at head dim 128, generalised to any head dim."""
    a = half // 4
    b = (half - a) // 2
    return a, b, half - a - b


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, T, H, D); positions3: (B, T, 3)
    integer [temporal, h, w].  Frequency i of each half rotates by the
    position component its section names."""
    half = x.shape[-1] // 2
    sections = mrope_sections(half) if sections is None else sections
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    comp = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                      for i, n in enumerate(sections)])           # (half,)
    ang = positions3.float()[..., comp] * freqs                   # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------
def attention_def(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim()
    pd = cfg.param_dtype
    d = {"wq": ParamDef((cfg.d_model, cfg.n_heads, hd), dtype=pd),
         "wk": ParamDef((cfg.d_model, cfg.n_kv_heads, hd), dtype=pd),
         "wv": ParamDef((cfg.d_model, cfg.n_kv_heads, hd), dtype=pd),
         "wo": ParamDef((cfg.n_heads, hd, cfg.d_model), dtype=pd)}
    if cfg.qkv_bias:
        d["bq"] = ParamDef((cfg.n_heads, hd), init="zeros", dtype=pd)
        d["bk"] = ParamDef((cfg.n_kv_heads, hd), init="zeros", dtype=pd)
        d["bv"] = ParamDef((cfg.n_kv_heads, hd), init="zeros", dtype=pd)
    return d


def attention_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The projections, each bias (``qkv_bias``) added in the compute
    dtype before RoPE."""
    dt = cfg.dtype
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def attention_out(params: dict, o: torch.Tensor, cfg: ModelConfig):
    return torch.einsum("bthk,hkd->btd", o, params["wo"].to(cfg.dtype))


def self_attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   causal: bool, positions: torch.Tensor,
                   cache: dict | None = None, cache_index: int = 0):
    """Self-attention, over a KV cache or (``cache`` None) over ``x`` alone.

    ``cache``: {"k": (B, Tmax, Hkv, D), "v": ...}; ``cache_index``: tokens
    already in the cache.  The new K/V are written at that offset and
    attention runs over the whole cache, masked to ``cache_index + T``
    keys.  ``positions``: (B, T), or (B, T, 3) under M-RoPE.  The causal
    mask starts at each row's first position, as the JAX package's does:
    ``cache_index`` for the (B, T) positions, which are ``cache_index +
    arange(T)``, and under M-RoPE the row's first temporal id (a per-row
    offset).  Without a cache (the encoder) the T keys are all there is
    and the mask starts at 0.  Returns (out, cache); the cache tensors are
    updated in place.
    """
    q, k, v = attention_qkv(params, x, cfg)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
        q_offset = positions[:, 0, 0].to(torch.int32)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        q_offset = cache_index
    if cache is None:
        out = mha(q, k, v, causal=causal)
        return attention_out(params, out, cfg), None
    T, t_max = x.shape[1], cache["k"].shape[1]
    if cache_index + T > t_max:
        raise ValueError(f"cache of {t_max} positions cannot take {T} tokens "
                         f"at index {cache_index}")
    # In place, where the JAX package returns a new cache from
    # lax.dynamic_update_slice_in_dim.
    cache["k"][:, cache_index:cache_index + T] = k.to(cache["k"].dtype)
    cache["v"][:, cache_index:cache_index + T] = v.to(cache["v"].dtype)
    out = mha(q, cache["k"].to(cfg.dtype), cache["v"].to(cfg.dtype),
              causal=causal, kv_len=cache_index + T, q_offset=q_offset)
    return attention_out(params, out, cfg), cache


def cross_attention_def(cfg: ModelConfig) -> dict:
    return attention_def(cfg.with_(qkv_bias=False))


def cross_attention(params: dict, x: torch.Tensor, kv_src, cfg: ModelConfig,
                    kv_cache: dict | None = None):
    """Decoder cross-attention, non-causal and without RoPE.  ``kv_src``:
    the encoder output (B, Ts, d), projected to K/V when ``kv_cache`` is
    None; with ``kv_cache`` ({"k", "v"} precomputed) it is not read.  As in
    the JAX package there is no ``kv_len``: every position of the cross
    cache is attended, zero-padded ones too.  Returns (out, kv_cache)."""
    dt = cfg.dtype
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(dt))
    if kv_cache is None:
        kv_cache = {
            "k": torch.einsum("btd,dhk->bthk", kv_src, params["wk"].to(dt)),
            "v": torch.einsum("btd,dhk->bthk", kv_src, params["wv"].to(dt))}
    out = mha(q, kv_cache["k"].to(dt), kv_cache["v"].to(dt), causal=False)
    return attention_out(params, out, cfg), kv_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_def(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    """The MLP's weights, ``d_ff`` wide (default ``cfg.d_ff``; the MoE
    shared expert's is ``d_ff_expert``)."""
    f, pd = d_ff or cfg.d_ff, cfg.param_dtype
    if cfg.act == "swiglu":
        return {"wg": ParamDef((cfg.d_model, f), dtype=pd),
                "wu": ParamDef((cfg.d_model, f), dtype=pd),
                "wd": ParamDef((f, cfg.d_model), dtype=pd)}
    return {"w1": ParamDef((cfg.d_model, f), dtype=pd),
            "b1": ParamDef((f,), init="zeros", dtype=pd),
            "w2": ParamDef((f, cfg.d_model), dtype=pd),
            "b2": ParamDef((cfg.d_model,), init="zeros", dtype=pd)}


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig):
    dt = cfg.dtype
    if cfg.act == "swiglu":
        g = torch.einsum("btd,df->btf", x, params["wg"].to(dt))
        u = torch.einsum("btd,df->btf", x, params["wu"].to(dt))
        return torch.einsum("btf,fd->btd", F.silu(g) * u, params["wd"].to(dt))
    h = torch.einsum("btd,df->btf", x, params["w1"].to(dt)) + params["b1"].to(dt)
    # jax.nn.gelu's default is the tanh form; torch's default is erf
    h = F.gelu(h, approximate="tanh")
    return (torch.einsum("btf,fd->btd", h, params["w2"].to(dt))
            + params["b2"].to(dt))
