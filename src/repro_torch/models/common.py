"""Shared model configuration and the parameter-definition tree.

Counterpart of ``repro.models.common``.  Parameters are nested dicts of
tensors; every leaf starts as a ``ParamDef`` (shape + init rule + dtype).
The JAX package's logical sharding axes (``AxisRules``) have no
counterpart: the port runs on one card, where every sharding is the
identity.
"""
from __future__ import annotations

import dataclasses
import math
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
        """Analytic parameter count, counted as the JAX package's
        ``_param_count`` counts it (for ssm: the conv bias, ``dt_bias`` and
        the norms are left out; hybrid: the ssm count plus one shared
        attention block and its MLP; vlm: as dense; moe: every expert, the
        shared one and the router of each MoE layer; encdec: the norms are
        left out)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """As ``param_count``, with only the ``top_k`` routed experts (and
        the shared one) of each MoE layer counted."""
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim()
    attn = (cfg.d_model * cfg.n_heads * hd
            + 2 * cfg.d_model * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * cfg.d_model)
    if cfg.qkv_bias:
        attn += cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd
    return attn


def _mlp_params(d_model: int, d_ff: int, act: str) -> int:
    return (3 if act == "swiglu" else 2) * d_model * d_ff


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    mlp = _mlp_params(cfg.d_model, cfg.d_ff, cfg.act)
    if cfg.family == "encdec":
        return (emb + cfg.enc_layers * (_attn_params(cfg) + mlp)
                + cfg.dec_layers * (2 * _attn_params(cfg) + mlp))
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        nh = s.n_ssm_heads(cfg.d_model)
        per = (cfg.d_model * (2 * di + 2 * s.n_groups * s.d_state + nh)
               + s.d_conv * (di + 2 * s.n_groups * s.d_state)   # conv
               + nh * 2                                          # A_log, D
               + di                                              # norm gate
               + di * cfg.d_model)                               # out_proj
        return emb + cfg.n_layers * per
    if cfg.family == "hybrid":
        return (_param_count(cfg.with_(family="ssm"), active_only)
                + _attn_params(cfg) + mlp)
    # dense / vlm / moe
    total = emb
    for layer in range(cfg.n_layers):
        total += _attn_params(cfg)
        m = cfg.moe
        if m is not None and layer % m.every == m.every - 1:
            n = (m.top_k if active_only else m.n_experts) + m.shared_expert
            total += (n * _mlp_params(cfg.d_model, m.d_ff_expert, cfg.act)
                      + cfg.d_model * m.n_experts)              # router
        else:
            total += mlp
    return total


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


#: float32 bytes drawn at a time for a leaf narrower than float32
PIECE_BYTES = 1 << 30


def init_leaf(gen: torch.Generator, d: ParamDef, device) -> torch.Tensor:
    """The JAX package's rule: N(0, 1) * scale / sqrt(fan_in) with
    ``fan_in = shape[-2]`` (for ``wq`` of shape (d, H, hd) that is the
    heads dim).  Same distribution, other random bits.

    A leaf narrower than float32 whose float32 draw would pass
    ``PIECE_BYTES`` is drawn in pieces along its leading axes, each scaled
    and cast into the leaf: qwen3-moe's bf16 expert leaves are 19.3 GB
    each, 38.7 GB as one float32 draw."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    std = d.scale / (fan_in ** 0.5)
    numel = math.prod(d.shape)
    if d.dtype.itemsize >= 4 or 4 * numel <= PIECE_BYTES:
        # Scaled in place: one copy of the leaf at a time, which is what
        # lets starcoder2-15b's 24 GB stacked MLP leaves be drawn on one
        # card.
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(d.dtype)
    # the fewest leading axes whose every index holds a piece that fits
    lead = next(k for k in range(len(d.shape) + 1)
                if 4 * math.prod(d.shape[k:]) <= PIECE_BYTES)
    inner = d.shape[lead:]
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    rows = out.view(-1, *inner)
    step = PIECE_BYTES // (4 * math.prod(inner))
    for i in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - i)
        piece = torch.randn((n, *inner), generator=gen, dtype=torch.float32,
                            device=device)
        rows[i:i + n] = piece.mul_(std)
    return out


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
