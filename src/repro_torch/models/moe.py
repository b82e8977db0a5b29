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

On a mesh (``apply_moe(..., rules=, mesh=)``, the sharded train step's
call) the reference's layout is written out, ``Shards`` holding it:

* groups over dp: the G groups of a microbatch are split over the dp
  axes, a rank's rows of the microbatch being its G/dp groups, so a rank
  routes its own groups; S, C and the one-group fallback for degenerate
  shapes are those of the whole microbatch (G must be a multiple of dp;
  where a shape falls back to one group while dp > 1, its group holds
  other ranks' tokens: with a gradient wanted that raises, and in
  inference, a decode step of few rows, the rank all-gathers the dp
  ranks' rows as GSPMD would and routes the one group whole,
  ``_one_group_over_dp``);
* the aux loss is a rank's share: the expert counts ``ce`` are summed
  over the dp axes, and the rank's ``me`` is the sum of its own router
  probabilities over the microbatch's G*S tokens, so the ranks' shares
  ``E * sum(me * ce)`` add up to the whole microbatch's aux, once (the
  step sums the loss over dp), and so do their gradients;
* experts over "model": the expert leaves ``wg``, ``wu``, ``wd`` are the
  rank's E/tp experts (``is_expert_leaf``; the step gathers them over the
  fsdp axes only).  The dispatch buffer is built whole on every "model"
  rank and the rank takes its experts' slots from it
  (``sharding.ExpertSlice``: no traffic; its backward all-gathers the
  slots' gradients, so every rank scatters the whole dispatch gradient
  into dx in the one-process order, and no rank sums partial dx).  The
  experts' outputs are all-gathered over "model"
  (``sharding.GatherOut``, its backward the rank's own slice: the
  loss is the same on every "model" rank, so no rank's gradient adds up
  tp copies) and every rank combines all K outputs of each of its
  tokens.  The router and the shared expert run whole on every rank.

Without a mesh, and on a mesh whose dp and expert axes hold one rank
each, the operators are the one-process ones.  With one dp rank the bits
are too wherever a batched product over a slice of the experts gives the
whole product's bits (the CPU's does).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from .common import AxisRules, ModelConfig, ParamDef
from .layers import apply_mlp, mlp_def


def moe_def(cfg: ModelConfig) -> dict:
    m, pd = cfg.moe, cfg.param_dtype
    d = {"router": ParamDef((cfg.d_model, m.n_experts), ("embed", "experts"),
                             scale=0.1, dtype=pd),
         "wg": ParamDef((m.n_experts, cfg.d_model, m.d_ff_expert),
                         ("experts", "embed", "expert_mlp"), dtype=pd),
         "wu": ParamDef((m.n_experts, cfg.d_model, m.d_ff_expert),
                         ("experts", "embed", "expert_mlp"), dtype=pd),
         "wd": ParamDef((m.n_experts, m.d_ff_expert, cfg.d_model),
                         ("experts", "expert_mlp", "embed"), dtype=pd)}
    if m.shared_expert:
        d["shared"] = mlp_def(cfg, d_ff=m.d_ff_expert)
    return d


def is_expert_leaf(d: ParamDef) -> bool:
    """Whether a leaf is laid out expert by expert (``wg``, ``wu``,
    ``wd``: its first axis after "layers" is "experts"), so that on a
    mesh a rank keeps and computes only its own experts.  The router's
    "experts" axis is its output's, and it runs whole."""
    axes = [a for a in d.logical_axes or () if a != "layers"]
    return axes[:1] == ["experts"]


def _capacity(s_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(s_per_group * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # >=8, 8-aligned


@dataclass(frozen=True)
class Shards:
    """Where ``apply_moe``'s work lies on a mesh: ``dp_axes`` the dp axes
    of more than one rank (their product ``dp``), over which the groups
    are split, and ``expert_axis`` the axis of more than one rank the
    experts are split over (None where they are whole)."""
    mesh: object
    dp_axes: tuple[str, ...]
    dp: int
    expert_axis: str | None

    @property
    def tp(self) -> int:
        return 1 if self.expert_axis is None else self.mesh.shape[
            self.expert_axis]


def shards_for(cfg: ModelConfig, rules: AxisRules, mesh) -> Shards:
    """The ``Shards`` of ``cfg`` on ``mesh`` under ``rules``.  Raises
    where G (``cfg.moe_groups``, 0 read as one) is not a multiple of the
    dp ranks, and where the experts would lie over a dp or fsdp axis (a
    rank's expert gradients would then need a sum the step does not
    make)."""
    dp_axes = tuple(a for a in rules.dp_axes if mesh.shape.get(a, 1) > 1)
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    G = cfg.moe_groups or 1
    if G % dp:
        raise ValueError(
            f"{cfg.arch}: moe_groups={cfg.moe_groups} gives {G} group(s) a "
            f"microbatch, which do not split over the {dp} ranks of the dp "
            f"axes {dp_axes}: set moe_groups to a multiple of {dp}")
    # the axes of the spec entry of the expert leaves' experts dim
    entry = rules.resolve("experts", dims=(cfg.moe.n_experts,))[0]
    axes = entry if isinstance(entry, tuple) else (entry,)
    live = [a for a in axes if a and mesh.shape.get(a, 1) > 1]
    if any(a in rules.dp_axes or a in rules.fsdp_axes for a in live) \
            or len(live) > 1:
        raise NotImplementedError(
            f"{cfg.arch}: the experts lie over {tuple(live)}; the sharded "
            "step splits them over one axis that is neither a dp nor an "
            "fsdp axis (\"model\")")
    return Shards(mesh, dp_axes, dp, live[0] if live else None)


def route(params: dict, xg: torch.Tensor, cfg: ModelConfig,
          shards: Shards | None = None):
    """The router on xg (G, S, d), in fp32 (fp64 for fp64 ``xg``).
    Returns (gate_vals (G, S, K) renormalised, expert_idx (G, S, K), slot (G, S*K): each assignment's
    token-major rank within its expert, keep (G, S*K): slot < C, aux).
    With ``shards`` over dp ranks, xg is this rank's groups and aux its
    share (module docstring)."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    ct = torch.promote_types(xg.dtype, torch.float32)
    logits = torch.einsum("gsd,de->gse", xg.to(ct), params["router"].to(ct))
    probs = torch.softmax(logits, dim=-1)                       # (G, S, E)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :K], expert_idx[..., :K]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux load-balance loss (Switch): E * sum_e f_e * P_e
    G, S = xg.shape[:2]
    counts = F.one_hot(expert_idx, E).sum(dim=2)                # (G, S, E)
    if shards is None or shards.dp == 1:
        me = probs.mean(dim=(0, 1))                             # (E,)
        ce = counts.to(ct).mean(dim=(0, 1))
    else:
        # the microbatch's means over its G*S tokens: ce whole (summed
        # over dp, no gradient), me this rank's share of it, so that the
        # shares' sum over dp is the aux, counted once
        from repro_torch.launch import sharding
        n = G * S * shards.dp
        me = probs.sum(dim=(0, 1)) / n
        ce = sharding.all_reduce(counts.to(ct).sum(dim=(0, 1)),
                                 shards.dp_axes, shards.mesh) / n
    aux = E * torch.sum(me * ce)

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


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig,
              rules: AxisRules | None = None, mesh=None):
    """x: (B, T, d) -> (out, aux_loss).  With ``rules`` and ``mesh``: x
    is this rank's rows of the microbatch, the expert leaves of ``params``
    are its slices, and aux is its share (module docstring)."""
    return _apply(params, x, cfg,
                  None if mesh is None else shards_for(cfg, rules, mesh))


def _one_group_over_dp(params, x, cfg, shards: Shards):
    """Inference on a microbatch whose tokens fall back to one group while
    its rows lie over the dp ranks (a decode step of few rows): the rank
    all-gathers every dp rank's rows of ``x`` over the dp axes (counted
    as "moe_tokens"), routes the one group whole as every dp rank does,
    and keeps its own rows of the output: GSPMD's gather of a group that
    spans ranks.  aux is the whole group's on every rank."""
    from repro_torch.launch import sharding
    B = x.shape[0]
    rows = sharding.Rows(sharding.dp_index(shards.mesh, shards.dp_axes) * B,
                         B, shards.dp_axes)
    whole = sharding.gather_rows(x, rows, shards.mesh, kind="moe_tokens")
    out, aux = _apply(params, whole, cfg,
                      replace(shards, dp_axes=(), dp=1))
    return rows.take(out), aux


def _apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
           shards: Shards | None):
    m = cfg.moe
    B, T, d = x.shape
    dp = 1 if shards is None else shards.dp
    n_tok = B * T * dp                      # the whole microbatch's tokens
    G = cfg.moe_groups or 1
    if n_tok % G or (n_tok // G) < m.n_experts // m.top_k:
        G = 1  # degenerate/smoke shapes: single group
    if G % dp:
        if not torch.is_grad_enabled():
            return _one_group_over_dp(params, x, cfg, shards)
        raise ValueError(
            f"{cfg.arch}: {n_tok} tokens a microbatch fall back to one MoE "
            f"group (fewer than E/K = {m.n_experts // m.top_k} tokens a "
            f"group, or not a multiple of moe_groups={cfg.moe_groups}); "
            f"one group over {dp} dp ranks would need other ranks' tokens")
    S = n_tok // G
    G //= dp                                # this rank's groups
    E, K = m.n_experts, m.top_k
    C = _capacity(S, cfg)

    xg = x.reshape(G, S, d)
    gate_vals, expert_idx, slot, keep, aux = route(params, xg, cfg, shards)
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
    ep = shards is not None and shards.expert_axis is not None
    if ep:
        # this rank's E/tp experts: their slots from the whole buffer
        from repro_torch.launch import sharding
        if params["wg"].shape[0] * shards.tp != E:
            raise ValueError(
                f"expert leaves of {params['wg'].shape[0]} experts on a "
                f"mesh of {shards.tp} ranks over {shards.expert_axis!r}: "
                f"expected this rank's {E // shards.tp} of {E}")
        xe = sharding.ExpertSlice.apply(xe, shards.mesh, shards.expert_axis)
    h = (F.silu(torch.bmm(xe, params["wg"].to(dt)))
         * torch.bmm(xe, params["wu"].to(dt)))
    y_buf = torch.bmm(h, params["wd"].to(dt))                   # (E, G*C, d)
    if ep:
        # every expert's outputs on every rank along the expert axis
        y_buf = sharding.GatherOut.apply(y_buf, shards.mesh,
                                            shards.expert_axis)
    y_flat = y_buf.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y_flat = torch.cat([y_flat, y_flat.new_zeros(G, 1, d)], dim=1)

    # combine: each token's K expert outputs, weighted by the gates in fp32
    addr = torch.where(keep, flat_e * C + torch.clamp(slot, max=C - 1), E * C)
    gathered = torch.gather(y_flat, 1,
                            addr[..., None].expand(G, S * K, d))
    out = (gathered.reshape(G, S, K, d).to(gate_vals.dtype)
           * gate_vals[..., None]).sum(dim=2)
    out = out.to(x.dtype).reshape(B, T, d)

    if m.shared_expert:
        out = out + apply_mlp(params["shared"], x, cfg)
    return out, aux
