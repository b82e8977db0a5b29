"""Shared model configuration and the parameter-definition tree.

Counterpart of ``repro.models.common``.  Parameters are nested dicts of
tensors; every leaf starts as a ``ParamDef`` (shape + init rule + dtype).
The JAX package's logical sharding axes (``AxisRules``) have no
counterpart: the port runs on one card, where every sharding is the
identity.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


# ---------------------------------------------------------------------------
# Configs (fields as in the JAX package; dtypes are torch dtypes)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1                 # MoE block every N layers (llama4: 2)
    shared_expert: bool = False    # additional always-on expert (llama4)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2                # d_inner = expand * d_model
    head_dim: int = 64             # mamba2 P
    chunk: int = 128               # SSD chunk length
    n_groups: int = 1              # B/C groups

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    rope_theta: float = 10_000.0
    mrope: bool = False            # qwen2-vl multimodal RoPE
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid_attn_every: int = 0     # zamba2: shared attn block every N ssm blocks
    enc_layers: int = 0            # encdec only
    dec_layers: int = 0
    # numerics / execution
    dtype: Any = torch.bfloat16    # activation/compute dtype
    param_dtype: Any = torch.float32
    attn_chunk: int = 512          # KV block of the JAX package's XLA attention
    xent_chunk: int = 2048         # token block for chunked cross entropy
    remat: str = "full"            # none | full | dots
    moe_groups: int = 0            # 0 -> infer from mesh dp size
    kernel_mode: str = "xla"       # xla | pallas (read by neither package)
    seq_shard: bool = True         # sequence-parallel activations (Megatron-SP)

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count of the dense and ssm families, counted
        as the JAX package's ``_param_count`` counts them (for ssm: the
        conv bias, ``dt_bias`` and the norms are left out)."""
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(self.d_model)
            nh = s.n_ssm_heads(self.d_model)
            per = (self.d_model * (2 * di + 2 * s.n_groups * s.d_state + nh)
                   + s.d_conv * (di + 2 * s.n_groups * s.d_state)   # conv
                   + nh * 2                                         # A_log, D
                   + di                                             # norm gate
                   + di * self.d_model)                             # out_proj
            return emb + self.n_layers * per
        if self.family != "dense":
            raise NotImplementedError(f"param_count of family {self.family!r}"
                                      " is not ported yet")
        hd = self.resolved_head_dim()
        attn = (self.d_model * self.n_heads * hd
                + 2 * self.d_model * self.n_kv_heads * hd
                + self.n_heads * hd * self.d_model)
        if self.qkv_bias:
            attn += self.n_heads * hd + 2 * self.n_kv_heads * hd
        mlp = (3 if self.act == "swiglu" else 2) * self.d_model * self.d_ff
        return emb + self.n_layers * (attn + mlp)


# ---------------------------------------------------------------------------
# Parameter tree construction
# ---------------------------------------------------------------------------
@dataclass
class ParamDef:
    """Deferred parameter: shape + init rule + dtype."""
    shape: tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones
    scale: float = 1.0
    dtype: Any = torch.float32


def init_leaf(gen: torch.Generator, d: ParamDef, device) -> torch.Tensor:
    """The JAX package's rule: N(0, 1) * scale / sqrt(fan_in) with
    ``fan_in = shape[-2]`` (for ``wq`` of shape (d, H, hd) that is the
    heads dim).  Same distribution, other random bits."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    std = d.scale / (fan_in ** 0.5)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(d.dtype)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef leaf, in sorted key order (the order
    JAX flattens dicts in)."""
    if is_def(defs):
        return fn(defs)
    return {k: tree_map_defs(fn, defs[k]) for k in sorted(defs)}


def tree_defs_init(defs, gen: torch.Generator, device):
    return tree_map_defs(lambda d: init_leaf(gen, d, device), defs)
