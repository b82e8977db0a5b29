"""Shared model configuration, sharding vocabulary and the
parameter-definition tree.

Counterpart of ``repro.models.common``.  Parameters are nested dicts of
tensors; every leaf starts as a ``ParamDef`` (shape + logical axes + init
rule + dtype).  Logical axis names resolve to mesh axes through
``AxisRules``, as in the JAX package; a spec is a plain tuple with one
entry per dim (``None``, a mesh axis name or a tuple of names), equal to
the tuple of the JAX package's ``PartitionSpec``.  ``launch/sharding.py``
turns a spec into the slice a rank holds and the collectives of a
sharded train step.  A serving rank holds each leaf in its serving
layout (``ServingLayout``, ``serving_spec``, ``ssm_head_columns``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch


# ---------------------------------------------------------------------------
# Logical axis vocabulary (as the JAX package's)
# ---------------------------------------------------------------------------
# layers    : stacked layer dimension (never sharded)
# vocab     : embedding / output-projection vocabulary dim     -> "model"
# embed     : d_model dim of weights                           -> fsdp axes
# heads     : query heads                                      -> "model"
# kv_heads  : KV heads (GQA)                                   -> "model"
# mlp       : feed-forward hidden dim                          -> "model"
# experts   : MoE expert dim                                   -> "model"
# batch     : activation batch dim                             -> data axes
# act_*     : activation dims (read by the JAX package's GSPMD; the port
#             splits its serving activations in code, logical_constraint)
# ssm_*     : mamba2 state dims
DEFAULT_RULES: dict[str, Any] = {
    "layers": None,
    "vocab": "model",
    "embed": "__fsdp__",      # resolved to ("data",) / ("pod","data") at mesh time
    "embed_noshard": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": None,           # cache seq dim
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "batch": "__dp__",        # resolved to data axes
    "groups": "__dp__",
    "seq": None,
    "act_embed": None,
    "act_seq": "model",
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "embed_gather": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_inner": "model",
    "conv_dim": "model",
}


@dataclass(frozen=True)
class AxisRules:
    """Resolves logical axis names to mesh axes for a given mesh layout.

    ``axis_sizes`` enables dimension-aware resolution: a sharded dim whose
    size does not divide the mesh-axis product resolves to None
    (replicated), as in the JAX package, which rejects uneven shardings.
    """

    fsdp_axes: tuple[str, ...] = ("data",)
    dp_axes: tuple[str, ...] = ("data",)
    overrides: Mapping[str, Any] = field(default_factory=dict)
    axis_sizes: Mapping[str, int] = field(default_factory=dict)

    def _mesh_axes(self, name: str):
        table = dict(DEFAULT_RULES)
        table.update(self.overrides)
        mesh_axis = table.get(name, None)
        if mesh_axis in ("__fsdp__", "__dp__"):
            axes = self.fsdp_axes if mesh_axis == "__fsdp__" else self.dp_axes
            mesh_axis = axes if len(axes) > 1 else (axes[0] if axes else None)
        return mesh_axis

    def _shard_count(self, mesh_axis) -> int:
        if mesh_axis is None or not self.axis_sizes:
            return 1
        axes = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    def resolve(self, *logical: str | None,
                dims: Sequence[int] | None = None) -> tuple:
        """The spec of a leaf with these logical axes (and, given
        ``dims``, this shape)."""
        out = []
        for i, name in enumerate(logical):
            mesh_axis = None if name is None else self._mesh_axes(name)
            if dims is not None and mesh_axis is not None:
                n = self._shard_count(mesh_axis)
                if n > 1 and dims[i] % n != 0:
                    mesh_axis = None     # uneven: fall back to replication
            out.append(mesh_axis)
        return tuple(out)


def mesh_axis_sizes(mesh) -> dict:
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


def rules_for_mesh(mesh) -> AxisRules:
    names = mesh.axis_names
    sizes = mesh_axis_sizes(mesh)
    if "pod" in names:
        return AxisRules(fsdp_axes=("pod", "data"), dp_axes=("pod", "data"),
                         axis_sizes=sizes)
    if "data" in names:
        return AxisRules(fsdp_axes=("data",), dp_axes=("data",),
                         axis_sizes=sizes)
    # single-device / test mesh
    return AxisRules(fsdp_axes=(), dp_axes=(), axis_sizes=sizes)


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
    """Deferred parameter: shape + logical axes + init rule + dtype.
    ``logical_axes`` defaults to unnamed dims (replicated on any mesh)."""
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...] | None = None
    init: str = "normal"           # normal | zeros | ones
    scale: float = 1.0
    dtype: Any = torch.float32

    def spec(self, rules: AxisRules) -> tuple:
        axes = self.logical_axes
        if axes is None:
            axes = (None,) * len(self.shape)
        return rules.resolve(*axes, dims=self.shape)


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


def tree_defs_to_specs(defs, rules: AxisRules):
    return tree_map_defs(lambda d: d.spec(rules), defs)


def check_spec(spec: tuple) -> None:
    """Raises ``ValueError`` where ``spec`` names one mesh axis on two
    dims, as the JAX package's ``NamedSharding`` does (``kv_seq`` and
    ``kv_heads`` both over "model", say)."""
    seen = [a for e in spec for a in axes_of(e)]
    twice = sorted({a for a in seen if seen.count(a) > 1})
    if twice:
        raise ValueError(f"spec {spec} names mesh axis {twice[0]!r} on two "
                         "dims")


def local_shape(shape: Sequence[int], spec: tuple, sizes: Mapping[str, int]
                ) -> tuple[int, ...]:
    """The shape of one rank's slice of a ``shape`` leaf laid out by
    ``spec`` on a mesh of axis ``sizes`` (``NamedSharding.shard_shape``;
    a spec with one axis on two dims raises, ``check_spec``)."""
    check_spec(spec)
    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axes} ({n})")
        out.append(dim // n)
    return tuple(out)


@dataclass(frozen=True)
class Abstract:
    """A leaf without values: ``tensor`` is a ``meta`` tensor of the global
    shape and dtype, ``spec`` its layout and ``local_shape`` one rank's
    slice of it (the JAX package's ``ShapeDtypeStruct`` with a
    ``NamedSharding``)."""
    tensor: torch.Tensor
    spec: tuple
    local_shape: tuple[int, ...]


def abstract_leaf(shape, dtype, spec: tuple, mesh) -> Abstract:
    return Abstract(torch.empty(shape, dtype=dtype, device="meta"), spec,
                    local_shape(shape, spec, mesh_axis_sizes(mesh)))


def tree_defs_to_abstract(defs, mesh, rules: AxisRules):
    return tree_map_defs(
        lambda d: abstract_leaf(d.shape, d.dtype, d.spec(rules), mesh), defs)


def logical_constraint(x, rules: AxisRules, *logical: str | None):
    """``x`` unchanged.  The JAX package pins an activation's sharding
    here for GSPMD; the port splits activations where its code says so,
    not by a constraint.  Serving on a mesh (``Model.prefill`` /
    ``decode`` with ``rules`` and ``mesh``) holds the batch's rows over
    the dp axes, and between a column-parallel product and its
    row-parallel partner the heads, KV heads, MLP columns, SSM heads and
    vocab over "model" (``layers``, ``mamba2``, ``transformer``); the
    residual stream is whole on each rank after every row-parallel sum.
    The sharded train step computes every activation but the MoE's whole
    on each rank (parameters gathered, the batch split over the dp axes);
    its tensor-parallel half is ROADMAP.md Queue A item 6."""
    del rules, logical
    return x


# ---------------------------------------------------------------------------
# The serving layout: what a serving rank holds of each leaf
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ServingLayout:
    """A serving rank's copy of a leaf: its slice of ``spec`` and, where
    ``columns`` is given, those indices of its last dim (the Mamba-2
    leaves cut along heads, ``ssm_head_columns``)."""
    spec: tuple
    columns: tuple[int, ...] | None = None

    def local_shape(self, shape, sizes: Mapping[str, int]) -> tuple:
        out = local_shape(shape, self.spec, sizes)
        if self.columns is not None:
            out = out[:-1] + (len(self.columns),)
        return out


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def serving_spec(d: ParamDef, rules: AxisRules) -> tuple:
    """The serving layout of a leaf: its ``spec(rules)`` with the fsdp
    axes dropped.  A serving rank holds each weight whole over "data"
    (gathered once, at load, never per step) and its slice over "model"."""
    fsdp = set(rules.fsdp_axes)
    out = []
    for entry in d.spec(rules):
        kept = tuple(a for a in axes_of(entry) if a not in fsdp)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


def ssm_head_columns(cfg: ModelConfig, leaf: str, tp: int, index: int
                     ) -> tuple[int, ...]:
    """The columns of a Mamba-2 leaf that rank ``index`` of ``tp`` along
    "model" holds when the SSM heads are split (``n_groups`` 1): for
    ``in_proj`` [z_r | x_r | B | C | dt_r], for the conv leaves and the
    conv window [x_r | B | C], where z_r, x_r are the rank's H/tp heads'
    channels and dt_r its heads' columns; B and C are whole on every rank.
    ``_split_proj`` cuts the whole row at no head boundary, so these are
    not a contiguous slice of "ssm_inner" or "conv_dim"."""
    s = cfg.ssm
    if s.n_groups != 1:
        raise NotImplementedError(
            f"{cfg.arch}: SSM heads split over \"model\" with n_groups="
            f"{s.n_groups}; the head split takes B and C whole (n_groups 1)")
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    H = s.n_ssm_heads(cfg.d_model)
    hl = H // tp
    x_r = range(index * hl * s.head_dim, (index + 1) * hl * s.head_dim)
    if leaf == "conv":
        return (*x_r, *range(di, di + 2 * gn))
    if leaf != "in_proj":
        raise ValueError(f"no head columns for {leaf!r}")
    return (*x_r, *(di + c for c in x_r), *range(2 * di, 2 * di + 2 * gn),
            *range(2 * di + 2 * gn + index * hl,
                   2 * di + 2 * gn + (index + 1) * hl))
