"""Mixture-of-Experts with capacity-based, group-local dispatch.

Counterpart of ``repro.models.moe``: GShard/Switch-style routing, tokens
viewed as (G, S, d), each (token, k) assignment given a slot in its
expert by token-major rank, assignments past the capacity C dropped, and
every expert run over all C of its slots as one batched product of
(E, G*C, d) by (E, d, f).  No (S, E, C) one-hot dispatch tensor is built.
The router returns the Switch aux load-balancing loss.

Two rules make the port give the JAX package's answer where the
reference leaves the order open:

* top-k by a stable descending sort: tied probabilities keep the lower
  expert index first, as ``jax.lax.top_k`` does (``torch.topk`` does not
  promise an order);
* the (G, E, C) routing table is written by a scatter whose cells can be
  hit more than once: every dropped assignment writes the sentinel into
  cell (g, 0, C-1), where a kept token of an overflowing expert 0 also
  lands.  The JAX package's scatter on the CPU lets the last write win,
  so each cell takes the update with the largest flat position
  ``s*K + k`` aimed at it; the port picks that update with
  ``scatter_reduce("amax")`` over the positions, not by the order of a
  CUDA scatter, which is undefined for duplicate indices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamDef
from .layers import apply_mlp, mlp_def


def moe_def(cfg: ModelConfig) -> dict:
    m, pd = cfg.moe, cfg.param_dtype
    d = {"router": ParamDef((cfg.d_model, m.n_experts), scale=0.1, dtype=pd),
         "wg": ParamDef((m.n_experts, cfg.d_model, m.d_ff_expert), dtype=pd),
         "wu": ParamDef((m.n_experts, cfg.d_model, m.d_ff_expert), dtype=pd),
         "wd": ParamDef((m.n_experts, m.d_ff_expert, cfg.d_model), dtype=pd)}
    if m.shared_expert:
        d["shared"] = mlp_def(cfg, d_ff=m.d_ff_expert)
    return d


def _capacity(s_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(s_per_group * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # >=8, 8-aligned


def route(params: dict, xg: torch.Tensor, cfg: ModelConfig):
    """The router on xg (G, S, d), in fp32.  Returns (gate_vals (G, S, K)
    renormalised, expert_idx (G, S, K), slot (G, S*K): each assignment's
    token-major rank within its expert, keep (G, S*K): slot < C, aux)."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    logits = torch.einsum("gsd,de->gse", xg.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)                       # (G, S, E)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :K], expert_idx[..., :K]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux load-balance loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))                                 # (E,)
    counts = F.one_hot(expert_idx, E).sum(dim=2)                # (G, S, E)
    aux = E * torch.sum(me * counts.float().mean(dim=(0, 1)))

    G, S = xg.shape[:2]
    flat_e = expert_idx.reshape(G, S * K)                       # token-major
    oh = F.one_hot(flat_e, E)                                   # (G, S*K, E)
    slot = torch.gather(oh.cumsum(dim=1) - oh, 2, flat_e[..., None])[..., 0]
    keep = slot < _capacity(S, cfg)
    return gate_vals, expert_idx, slot, keep, aux


def _routing_table(flat_e, slot, keep, S: int, E: int, C: int):
    """(G, E, C) token index of each slot, S (the zero row) where empty:
    the JAX package's scatter, each cell taking the update with the
    largest flat position aimed at it."""
    G, SK = flat_e.shape
    K = SK // S
    cell = (torch.arange(G, device=flat_e.device)[:, None] * (E * C)
            + torch.where(keep, flat_e, 0) * C
            + torch.clamp(slot, max=C - 1)).reshape(-1)
    pos = torch.arange(G * SK, device=flat_e.device)
    last = torch.full((G * E * C,), -1, dtype=pos.dtype, device=pos.device)
    last = last.scatter_reduce(0, cell, pos, "amax")
    s_of = torch.arange(S, device=flat_e.device).repeat_interleave(K)
    value = torch.where(keep, s_of, S).reshape(-1)              # (G*S*K,)
    table = torch.where(last >= 0, value[last.clamp(min=0)], S)
    return table.reshape(G, E, C)


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d) -> (out, aux_loss)."""
    m = cfg.moe
    B, T, d = x.shape
    n_tok = B * T
    G = cfg.moe_groups or 1
    if n_tok % G or (n_tok // G) < m.n_experts // m.top_k:
        G = 1  # degenerate/smoke shapes: single group
    S = n_tok // G
    E, K = m.n_experts, m.top_k
    C = _capacity(S, cfg)

    xg = x.reshape(G, S, d)
    gate_vals, expert_idx, slot, keep, aux = route(params, xg, cfg)
    flat_e = expert_idx.reshape(G, S * K)
    table = _routing_table(flat_e, slot, keep, S, E, C)

    # gather into the dispatch buffer, row S the zero row
    xg_pad = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    dispatched = torch.gather(
        xg_pad, 1, table.reshape(G, E * C, 1).expand(G, E * C, d))

    # every expert over its C slots of every group: (E, G*C, d) x (E, d, f)
    dt = cfg.dtype
    xe = dispatched.to(dt).reshape(G, E, C, d).transpose(0, 1).reshape(
        E, G * C, d)
    h = (F.silu(torch.bmm(xe, params["wg"].to(dt)))
         * torch.bmm(xe, params["wu"].to(dt)))
    y_buf = torch.bmm(h, params["wd"].to(dt))                   # (E, G*C, d)
    y_flat = y_buf.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y_flat = torch.cat([y_flat, y_flat.new_zeros(G, 1, d)], dim=1)

    # combine: each token's K expert outputs, weighted by the gates in fp32
    addr = torch.where(keep, flat_e * C + torch.clamp(slot, max=C - 1), E * C)
    gathered = torch.gather(y_flat, 1,
                            addr[..., None].expand(G, S * K, d))
    out = (gathered.reshape(G, S, K, d).float()
           * gate_vals[..., None].float()).sum(dim=2)
    out = out.to(x.dtype).reshape(B, T, d)

    if m.shared_expert:
        out = out + apply_mlp(params["shared"], x, cfg)
    return out, aux.float()
