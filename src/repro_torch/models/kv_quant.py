"""int8 KV cache: per-(position, head) absmax scales.

Counterpart of ``repro.models.kv_quant``.  K/V rows quantize
independently, so a decode append stays O(1); the codes are int8 and the
scales float32, a little over half the bytes of a bf16 cache.  Attention
over a quantized cache dequantizes the cache to the query's dtype and
runs ``kernels.flash_attention.mha`` on it: the hand-written kernel on a
CUDA card, its plain version on the CPU (a fused int8 kernel would be a
feature the JAX package does not have).
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..kernels.flash_attention import mha


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 codes, float32 scales (..., 1)).  Rounds half
    to even, as ``jnp.round``."""
    xf = x.float()
    # Divided by a tensor on x's device: CUDA divides a tensor by a Python
    # scalar as a product with its reciprocal, one ulp off the quotient
    # for ~4% of values, and the JAX package's scales are exact quotients.
    scale = xf.abs().amax(dim=-1, keepdim=True) / torch.full(
        (), 127.0, device=x.device)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_quant_cache(batch: int, max_len: int, n_kv_heads: int,
                     head_dim: int, *, device=None) -> dict:
    """Zero codes and unit scales on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    codes = (batch, max_len, n_kv_heads, head_dim)
    scales = (batch, max_len, n_kv_heads, 1)
    return {"k_q": torch.zeros(codes, dtype=torch.int8, device=dev),
            "k_s": torch.ones(scales, dtype=torch.float32, device=dev),
            "v_q": torch.zeros(codes, dtype=torch.int8, device=dev),
            "v_s": torch.ones(scales, dtype=torch.float32, device=dev)}


def append_quant_cache(cache: dict, k_new: torch.Tensor,
                       v_new: torch.Tensor, index: int) -> dict:
    """Write new K/V rows (B, T_new, H, D) at position ``index``, in
    place (the JAX package returns a new cache); returns the cache."""
    T = k_new.shape[1]
    if index + T > cache["k_q"].shape[1]:
        raise ValueError(f"cache of {cache['k_q'].shape[1]} positions cannot "
                         f"take {T} rows at index {index}")
    for name, new in (("k", k_new), ("v", v_new)):
        q, s = quantize_kv(new)
        cache[f"{name}_q"][:, index:index + T] = q
        cache[f"{name}_s"][:, index:index + T] = s
    return cache


def attention_over_quant_cache(q: torch.Tensor, cache: dict, *, kv_len,
                               causal: bool = False, chunk: int = 512,
                               q_offset=0) -> torch.Tensor:
    """q: (B, Tq, Hq, D) against an int8 cache; returns (B, Tq, Hq, D).
    ``chunk`` is the JAX package's XLA block size, kept for its signature;
    the flash kernel picks its own tiles."""
    k = dequantize_kv(cache["k_q"], cache["k_s"], q.dtype)
    v = dequantize_kv(cache["v_q"], cache["v_s"], q.dtype)
    return mha(q, k, v, causal=causal, kv_len=int(kv_len), q_offset=q_offset)
