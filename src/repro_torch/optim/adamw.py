"""AdamW with configurable state dtype (fp32 / bf16 / int8-blockwise).

Counterpart of ``repro.optim.adamw``, with the same state tree: for each
parameter {"m", "v"} in fp32 or bf16 (and "master", an fp32 copy, with
``master_fp32``), or {"m_q", "m_s", "v_q", "v_s"}, int8 codes in blocks
of 128 along the flattened leaf with an fp32 scale per block; and "step".

``apply_updates`` updates the parameters and the state in place, leaf by
leaf (the JAX package's jitted step donates both), so a step holds one
leaf's temporaries at a time beside them.  Every scalar of the update is
an fp32 tensor on the leaves' device, and every division divides by one:
CUDA divides by a Python scalar as a product with its reciprocal, which
would move the card off the CPU by an ulp.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.common import ParamDef, tree_map_defs


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "fp32"          # fp32 | bf16 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"           # cosine | constant
    # update a big stacked leaf one leading-dim slice at a time (the JAX
    # package scans over it); the same numbers, fewer temporaries
    scan_stacked: bool = False
    # keep an fp32 master copy in the optimizer state (bf16 params)
    master_fp32: bool = False


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), fp32: linear
    warmup, then constant or a cosine to 0 at ``total_steps``."""
    if isinstance(step, torch.Tensor):
        device = step.device
    step = _f32(step, device)
    warm = torch.clamp((step + 1) / _f32(max(cfg.warmup_steps, 1), device),
                       max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps)
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), device),
                    0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


# --- blockwise int8 state codec --------------------------------------------
_BLK = 128


def _q8_encode(x: torch.Tensor, blk: int = _BLK):
    """(int8 codes (n_blocks, blk), fp32 scales (n_blocks, 1)): each block
    of the flattened, zero-padded ``x`` over max|block| / 127."""
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % blk))
    blocks = flat.reshape(-1, blk)
    scale = blocks.abs().amax(dim=1, keepdim=True) / _f32(127.0, x.device)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _q8_decode(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


# ---------------------------------------------------------------------------
def state_defs(param_defs, cfg: AdamWConfig):
    """ParamDef tree of the optimizer state."""
    if cfg.state_dtype == "int8":
        def mk(d: ParamDef):
            nblk = -(-math.prod(d.shape) // _BLK)
            return {
                "m_q": ParamDef((nblk, _BLK), init="zeros", dtype=torch.int8),
                "m_s": ParamDef((nblk, 1), init="ones", dtype=torch.float32),
                "v_q": ParamDef((nblk, _BLK), init="zeros", dtype=torch.int8),
                "v_s": ParamDef((nblk, 1), init="ones", dtype=torch.float32),
            }
    elif cfg.state_dtype in ("fp32", "bf16"):
        dt = torch.bfloat16 if cfg.state_dtype == "bf16" else torch.float32

        def mk(d: ParamDef):
            out = {"m": ParamDef(d.shape, init="zeros", dtype=dt),
                   "v": ParamDef(d.shape, init="zeros", dtype=dt)}
            if cfg.master_fp32:
                out["master"] = ParamDef(d.shape, init=d.init, scale=d.scale,
                                         dtype=torch.float32)
            return out
    else:
        raise ValueError(f"state_dtype {cfg.state_dtype!r} is not fp32, "
                         "bf16 or int8")
    return {"mv": tree_map_defs(mk, param_defs),
            "step": ParamDef((), init="zeros", dtype=torch.int32)}


def leaves(tree) -> list:
    """The leaves of a nested dict, in sorted key order (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like, flat) -> dict:
    """A tree with ``like``'s keys and ``flat``'s leaves, in ``leaves``'s
    order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _state_leaves(mv) -> list:
    """The per-parameter state dicts, in the parameters' order."""
    if isinstance(mv, dict) and ("m" in mv or "m_q" in mv):
        return [mv]
    return [x for k in sorted(mv) for x in _state_leaves(mv[k])]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root, as XLA and CUDA take it.
    CUDA's fp32 sqrt is; torch's vectorised CPU sqrt is not (3 of 480
    values an ulp off, measured), so a CPU tensor goes through the exact
    double, whose root rounded once to fp32 is the correctly rounded root.
    A meta tensor (the dry run's stand-in for the card) takes the card's
    route."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _leaf_update(g, p, s, lr, cfg: AdamWConfig, bc1, bc2) -> None:
    """One leaf's update, written into p and s."""
    g = g.float()
    if cfg.state_dtype == "int8":
        m = _q8_decode(s["m_q"], s["m_s"], p.shape)
        v = _q8_decode(s["v_q"], s["v_s"], p.shape)
    else:
        m, v = s["m"].float(), s["v"].float()
    base = s.get("master", p)
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    update = (m / bc1) / (_sqrt(v / bc2) + cfg.eps)
    if p.dim() >= 2:  # decoupled weight decay on matrices only
        update = update + cfg.weight_decay * base.float()
    new_base = base.float() - lr * update
    p.copy_(new_base)
    if cfg.state_dtype == "int8":
        for name, x in (("m", m), ("v", v)):
            q, scale = _q8_encode(x)
            s[f"{name}_q"].copy_(q)
            s[f"{name}_s"].copy_(scale)
    else:
        s["m"].copy_(m)
        s["v"].copy_(v)
    if "master" in s:
        s["master"].copy_(new_base)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step on ``params`` with ``grads`` (trees of the same
    keys), in place.  Returns (params, state, metrics {"grad_norm",
    "lr"})."""
    step = state["step"]
    dev = step.device
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(_f32(cfg.clip_norm, dev) / (gnorm + 1e-9),
                            max=1.0)
    else:
        scale = _f32(1.0, dev)
    lr = lr_at(cfg, step)
    stepf = step.float() + 1
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), stepf)
    flat_p, flat_g = leaves(params), leaves(grads)
    flat_s = _state_leaves(state["mv"])
    if not len(flat_p) == len(flat_g) == len(flat_s):
        raise ValueError(f"{len(flat_p)} parameters, {len(flat_g)} "
                         f"gradients and {len(flat_s)} state leaves")
    for g, p, s in zip(flat_g, flat_p, flat_s):
        g = g * scale
        if (cfg.scan_stacked and cfg.state_dtype != "int8" and p.dim() >= 3
                and p.shape[0] <= 128):
            for i in range(p.shape[0]):
                _leaf_update(g[i], p[i], {k: x[i] for k, x in s.items()},
                             lr, cfg, bc1, bc2)
        else:
            _leaf_update(g, p, s, lr, cfg, bc1, bc2)
    state["step"] += 1
    return params, state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "apply_updates", "global_norm", "leaves", "lr_at",
           "state_defs", "unflatten"]
