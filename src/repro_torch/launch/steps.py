"""Step functions: train / prefill / decode, built per model.

Counterpart of ``repro.launch.steps``; PyTorch runs them eagerly, with no
jit.  ``make_train_step`` supports microbatched gradient accumulation
(grads averaged into fp32, as the JAX package's scan over microbatches)
and a gradient dtype.  The train step updates the parameters and the
optimizer state in place (the JAX package donates both).

On a mesh of more than one process (``launch.mesh.make_mesh``) the step
is sharded, with the collectives GSPMD inserts for the JAX package
written out (``launch.sharding``): parameters and AdamW state live as
each rank's slice of ``model.param_specs(rules)``.  The step computes in
the serving layout (``Model.serving_layouts``): each leaf is gathered
over the fsdp axes only (leaf by leaf, before the forward: FSDP's
gather, not layer by layer) and keeps its "model" slice, so a rank holds
and computes its heads, KV heads, MLP columns, vocab slice, SSM heads and
experts, with the tensor-parallel sums written out in the layers
(``models.layers``, ``mamba2``, ``transformer``, ``moe``).  A leaf whose
serving copy is wider than its stored slice is gathered over "model" too
(counted as "all_gather_model"): the MoE router and shared expert, which
run whole, and the Mamba-2 in_proj and conv leaves, computed in head
columns (``common.ssm_head_columns``).  The forward and backward run on
this rank's rows of the batch; each gradient goes back to the stored
slice: summed over the dp axes and cut over the fsdp ones; a leaf whole
in compute but split in storage is cut over "model" (every rank's
gradient of it is the whole one); a column leaf's gradient is written
into a zero row of the whole width and reduce-scattered over "model",
which adds the ranks' partial sums of the B and C columns once.  The
MoE's token groups are split over the dp axes (``models.moe``).  The
one-device step is this step on a mesh of one process, where every
collective has no other rank and does nothing, and every leaf is whole.

The prefill and decode steps serve on a mesh in the same layout
(``make_prefill_step``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.launch import sharding
from repro_torch.launch.mesh import ONE_PROCESS, make_rules
from repro_torch.models import Model
from repro_torch.models.common import AxisRules, axes_of, is_def
from repro_torch.models.moe import is_expert_leaf, shards_for
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.optim.adamw import leaves, unflatten


def _grads(model: Model, params, flat_p, batch, microbatches: int,
           grad_dtype, count=None, **loss_kw):
    """(loss, metrics, grads): ``model.loss`` of ``batch`` and its
    gradients with respect to ``flat_p`` (the leaves of ``params``), each
    batch leaf split into ``microbatches`` along dim 0, each microbatch's
    gradients divided by their count and summed in fp32, cast to
    ``grad_dtype`` where given; loss and metrics are the means over the
    microbatches.  ``count(mb)``, where given, is the token count each
    microbatch's summed xent is divided by; ``loss_kw`` go to
    ``Model.loss`` too."""
    def grad_fn(mb):
        kw = dict(loss_kw) if count is None else {**loss_kw,
                                                  "count": count(mb)}
        loss, metrics = model.loss(params, mb, **kw)
        # every leaf must reach the loss: autograd raises on one that does
        # not (a kernel with no backward would leave it so), rather than
        # training it with a zero gradient
        grads = torch.autograd.grad(loss, flat_p)
        if grad_dtype is not None:
            grads = [g.to(grad_dtype) for g in grads]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    if microbatches == 1:
        return grad_fn(batch)
    parts = {k: torch.chunk(v, microbatches, dim=0) for k, v in batch.items()}
    if any(len(v) != microbatches
           or v[0].shape[0] * microbatches != batch[k].shape[0]
           for k, v in parts.items()):
        raise ValueError(f"batch rows do not split into {microbatches} "
                         "microbatches")
    # fp32 sums (fp64 for fp64 leaves)
    acc = [torch.zeros(p.shape, dtype=torch.promote_types(p.dtype,
                                                          torch.float32),
                       device=p.device)
           for p in flat_p]
    losses, metricss = [], []
    for i in range(microbatches):
        loss, metrics, grads = grad_fn({k: v[i] for k, v in parts.items()})
        for a, g in zip(acc, grads):
            a.add_(g / torch.tensor(microbatches, dtype=g.dtype,
                                    device=g.device))
        losses.append(loss)
        metricss.append(metrics)
        del grads
    loss = torch.stack(losses).mean()
    metrics = {k: torch.stack([m[k] for m in metricss]).mean()
               for k in metricss[0]}
    return loss, metrics, acc


def _like(params, tree, missing):
    """``tree`` over the keys of ``params``, ``missing(leaf)`` at a leaf
    the model does not define (replicated: autograd raises for it, as for
    any leaf that does not reach the loss)."""
    if isinstance(params, dict):
        sub = tree if isinstance(tree, dict) else {}
        return {k: _like(v, sub.get(k), missing) for k, v in params.items()}
    return missing(params) if tree is None or isinstance(tree, dict) \
        else tree


def _entry(axes):
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


@dataclass(frozen=True, eq=False)
class _Leaf:
    """How the train step moves one leaf: ``stored`` is its layout in the
    parameters and AdamW state, ``gather`` the axes its stored slice is
    all-gathered over to the compute layout (the all-gathers counted
    under ``kinds[axis]``), and ``columns``, where given, the indices of
    its last dim (of ``width``) the rank computes with."""
    stored: sharding.Sharding
    gather: sharding.Sharding
    kinds: dict = field(default_factory=dict)
    columns: tuple[int, ...] | None = None
    width: int = 0

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        x = sharding.gather(x, self.gather, kinds=self.kinds)
        if self.columns is not None:
            x = x.index_select(-1, torch.tensor(self.columns,
                                                device=x.device))
        return x

    def reduce(self, g: torch.Tensor, summed: tuple[str, ...]
               ) -> torch.Tensor:
        """The gradient ``g`` of the compute layout back to the stored
        slice (module docstring)."""
        if self.columns is None:
            return sharding.reduce_grad(g, self.gather, summed)
        wide = g.new_zeros(g.shape[:-1] + (self.width,))
        wide.index_copy_(-1, torch.tensor(self.columns, device=g.device), g)
        return sharding.reduce_grad(wide, self.stored, summed + ("model",))


def _leaves_of(model: Model, rules: AxisRules, mesh):
    """The ``_Leaf`` of each parameter: stored by ``param_specs``,
    computed in ``serving_layouts``."""
    fsdp = set(rules.fsdp_axes)

    def plan(d, lay):
        if not is_def(d):
            return {k: plan(d[k], lay[k]) for k in d}
        stored = d.spec(rules)
        gather = tuple(_entry([a for a in axes_of(s)
                               if a not in axes_of(c)])
                       for s, c in zip(stored, lay.spec))
        own = "all_gather_experts" if is_expert_leaf(d) else "all_gather"
        kinds = {a: own if a in fsdp else f"all_gather_{a}"
                 for a in mesh.axis_names}
        return _Leaf(sharding.Sharding(mesh, stored),
                     sharding.Sharding(mesh, gather), kinds, lay.columns,
                     d.shape[-1])
    return plan(model.param_defs, model.serving_layouts(rules, mesh))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1, grad_dtype=None,
                    rules: AxisRules | None = None, mesh=None, *,
                    keep_grads: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss and gradients of ``model.loss`` (each batch leaf
    split into ``microbatches`` along dim 0, each microbatch's gradients
    divided by their count and summed in fp32), cast to ``grad_dtype``
    where given, then one AdamW step.  metrics: "loss", "xent", "aux"
    (means over microbatches), "grad_norm", "lr", and with
    ``keep_grads`` "grads", the gradient tree the update used.

    The step is sharded over ``mesh`` (module docstring; default
    ``launch.mesh.ONE_PROCESS``; ``rules`` default to
    ``launch.mesh.make_rules(mesh)``): ``params`` and ``opt_state`` are
    this rank's slices (``launch.sharding.init_local``), ``batch`` is this
    rank's rows of the global batch (``launch.sharding.local_batch``,
    microbatch by microbatch), each microbatch's xent is divided by the
    token count of the whole microbatch (its ``sum(mask)`` summed over the
    dp axes), and the metrics are the one-device step's (loss, xent and
    aux summed over the dp axes; "grads" this rank's slices).  On a mesh of
    one process every slice is the whole leaf and no collective runs: it
    is the one-device step.  Over "model" each rank computes its slices
    (module docstring): H/tp heads, d_ff/tp MLP columns, V/tp of each
    chunk's logits, H_ssm/tp SSM heads.

    With MoE layers, ``cfg.moe_groups`` groups a microbatch are split over
    the dp ranks and the experts over "model" (``models.moe``): each rank
    holds, gathers and computes E/tp experts of each expert leaf, and its
    aux loss is its share of the microbatch's.  The step raises where
    ``moe_groups`` (0 read as one group) is not a multiple of the dp
    ranks, and, when called, where a microbatch's token count falls back
    to one group while dp > 1.  It raises too for int8 AdamW state on more
    than one process."""
    mesh = mesh or ONE_PROCESS
    rules = rules or make_rules(mesh)
    summed = sharding.dp_axes(mesh, rules)
    if model.cfg.moe is not None:
        shards_for(model.cfg, rules, mesh)      # raises for a G off dp
    if opt_cfg.state_dtype == "int8" and mesh.size > 1:
        raise NotImplementedError(
            "int8 AdamW state is coded in blocks of the flattened whole "
            "leaf, which a rank's slice does not hold; use fp32 or bf16 "
            "state on a mesh")
    plans = _leaves_of(model, rules, mesh)

    def replicated(p):
        whole = sharding.Sharding(mesh, (None,) * p.dim())
        return _Leaf(whole, whole)

    def count(mb):
        labels = mb["labels"]
        mask = mb.get("mask")
        n = (torch.full((), float(labels.numel()), dtype=torch.float32,
                        device=labels.device) if mask is None
             else torch.sum(mask.float()))
        return sharding.all_reduce(n, summed, mesh)

    def train_step(params, opt_state, batch):
        flat_local = leaves(params)
        flat_plan = leaves(_like(params, plans, replicated))
        full = [plan.compute(p) for p, plan in zip(flat_local, flat_plan)]
        for p in full:
            p.requires_grad_(True)
        # a microbatch not split over dp divides by its own count
        loss, metrics, grads = _grads(model, unflatten(params, full), full,
                                      batch, microbatches, grad_dtype,
                                      count if summed else None,
                                      rules=rules, mesh=mesh)
        for p in flat_local:
            p.requires_grad_(False)
        del full
        grads = list(grads)
        local = []
        for i, plan in enumerate(flat_plan):
            local.append(plan.reduce(grads[i], summed))
            grads[i] = None        # the compute layout's gradient goes now
        if summed:
            # each rank's loss, xent and aux are its shares (the MoE's aux
            # too, models.moe): their dp sums are the batch's, the aux
            # counted once, not once a rank; so are the gradients' sums
            sums = sharding.all_reduce(
                torch.stack([loss, metrics["xent"], metrics["aux"]]),
                summed, mesh)
            loss = sums[0]
            metrics = {**metrics, "xent": sums[1], "aux": sums[2]}
        # each element of a leaf once, from the layout it lives in
        gnorm = torch.sqrt(sharding.sum_squares(
            local, [plan.stored for plan in flat_plan]))
        grads = unflatten(params, local)
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt_cfg, gnorm=gnorm)
        if keep_grads:
            opt_metrics["grads"] = grads
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def _serving(model: Model, rules, mesh):
    """(rules, the "model" axis) of a serving step on ``mesh``: (None,
    ``sharding.ONE_RANK``) without one; raises for rules the port cannot
    serve with (``Model.serving_axis``)."""
    if mesh is None:
        return None, sharding.ONE_RANK
    rules = rules or make_rules(mesh)
    return rules, model.serving_axis(rules, mesh)


def make_prefill_step(model: Model, rules: AxisRules | None = None,
                      mesh=None) -> Callable:
    """``prefill_step(params, batch, caches, rows=None) -> (logits,
    caches)``, as the JAX package's per ``rules``.

    Without ``mesh``, the one-process prefill.  On a mesh of processes
    (``launch.mesh.make_mesh``; ``rules`` default ``make_rules(mesh)``)
    each rank serves: ``params`` are its serving copies
    (``Model.serving_layouts``, ``sharding.init_serving`` /
    ``serve_tree``), ``batch`` its rows of the batch (``rows``, a
    ``sharding.Rows`` from ``sharding.serve_rows``; default: split over
    the dp axes), ``caches`` its cache slices (``Model.init_caches`` with
    ``rules`` and ``mesh``), and the logits are its rows' over its vocab
    slice.  Heads, KV heads, MLP, vocab and SSM heads go over "model",
    with the row-parallel sums written out (``models.layers``); the train
    step computes in the same layout.  Rules that put the KV cache's
    sequence over "model" (``kv_seq``; with ``kv_heads`` None where the
    KV heads would divide) split the caches by sequence, context-parallel
    decode (``layers.split_cache_attention``): the step then takes
    ``max_len``, the positions the caches were made for, since a
    ``max_len`` that does not divide over "model" keeps them whole
    (``sharding.model_axis``); without it such a step raises where it
    meets a KV cache.  The encoder-decoder refuses such rules."""
    rules, _ = _serving(model, rules, mesh)

    @torch.inference_mode()
    def prefill_step(params, batch, caches, rows=None, max_len=None):
        return model.prefill(params, batch, caches, rules=rules, mesh=mesh,
                             rows=rows, max_len=max_len)
    return prefill_step


def make_decode_step(model: Model, rules: AxisRules | None = None,
                     mesh=None) -> Callable:
    """``decode_step(params, batch, caches, cache_index, rows=None,
    max_len=None) -> (next_tok, logits, caches)``: ``next_tok`` holds the
    rank's rows, the greedy token over the vocab slices of "model"
    (``sharding.greedy``: the lowest index among equal maxima, as
    ``torch.argmax`` and ``jnp.argmax``), and ``logits`` the rank's vocab
    slice (``make_prefill_step``, ``max_len`` too; without a mesh, all
    rows and the whole vocab)."""
    rules, tp = _serving(model, rules, mesh)

    @torch.inference_mode()
    def decode_step(params, batch, caches, cache_index: int, rows=None,
                    max_len=None):
        logits, caches = model.decode(params, batch, caches, cache_index,
                                      rules=rules, mesh=mesh, rows=rows,
                                      max_len=max_len)
        next_tok = sharding.greedy(logits[:, -1], tp, model.cfg.vocab)
        return next_tok, logits, caches
    return decode_step
