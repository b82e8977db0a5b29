"""Step functions: train / prefill / decode, built per model.

Counterpart of ``repro.launch.steps``; PyTorch runs them eagerly, with no
jit.  ``make_train_step`` supports microbatched gradient accumulation
(grads averaged into fp32, as the JAX package's scan over microbatches)
and a gradient dtype.  The train step updates the parameters and the
optimizer state in place (the JAX package donates both).

On a mesh of more than one process (``launch.mesh.make_mesh``) the step
is sharded, with the collectives GSPMD inserts for the JAX package
written out (``launch.sharding``): parameters and AdamW state live as
each rank's slice of ``model.param_specs(rules)``; the step gathers every
parameter whole (leaf by leaf, before the forward: FSDP's gather, not
layer by layer), runs the forward and backward on this rank's rows of the
batch, sums the gradients over the dp axes and cuts them to the rank's
slice, and updates the slices.  Ranks along a non-dp axis ("model")
compute the same rows on the same gathered weights; tensor-parallel
compute over "model" is ROADMAP.md Queue A item 6.  The MoE layers are
the exception (``models.moe``): their token groups are split over the dp
axes and their experts over "model", so the expert leaves are gathered
over the fsdp axes only, each rank computing its own experts, and their
gradients come out of the backward already cut to the rank's experts.
The one-device step is this step on a mesh of one process, where every
collective has no other rank and does nothing.

The prefill and decode steps serve on a mesh with tensor-parallel compute
over "model" (``make_prefill_step``); the train step keeps the layout
above.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch import sharding
from repro_torch.launch.mesh import ONE_PROCESS, make_rules
from repro_torch.models import Model
from repro_torch.models.common import AxisRules, tree_map_defs
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
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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


def _compute_spec(d, rules: AxisRules, experts: tuple[str, ...]) -> tuple:
    """The layout a leaf is gathered to for the forward: its spec, less
    the expert axes ``experts`` on an expert leaf (``moe.is_expert_leaf``),
    which stays this rank's experts."""
    spec = list(d.spec(rules))
    if is_expert_leaf(d):
        i = d.logical_axes.index("experts")
        kept = tuple(a for a in sharding.axes_of(spec[i]) if a not in experts)
        spec[i] = kept or None
    return tuple(spec)


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
    is the one-device step.

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
    experts = ()
    if model.cfg.moe is not None:
        axis = shards_for(model.cfg, rules, mesh).expert_axis
        experts = (axis,) if axis else ()
    if opt_cfg.state_dtype == "int8" and mesh.size > 1:
        raise NotImplementedError(
            "int8 AdamW state is coded in blocks of the flattened whole "
            "leaf, which a rank's slice does not hold; use fp32 or bf16 "
            "state on a mesh")
    tree_sh = sharding.tree_shardings(model.param_specs(rules), mesh)
    # the layout of the forward's leaves: the expert leaves stay this
    # rank's experts (gathered over the fsdp axes only), the rest whole
    compute_sh = sharding.tree_shardings(tree_map_defs(
        lambda d: _compute_spec(d, rules, experts), model.param_defs), mesh)
    # the expert leaves' gathers are counted apart
    gather_kinds = tree_map_defs(
        lambda d: "all_gather_experts" if is_expert_leaf(d) else "all_gather",
        model.param_defs)

    def replicated(p):
        return sharding.Sharding(mesh, (None,) * p.dim())

    def count(mb):
        labels = mb["labels"]
        mask = mb.get("mask")
        n = (torch.full((), float(labels.numel()), dtype=torch.float32,
                        device=labels.device) if mask is None
             else torch.sum(mask.float()))
        return sharding.all_reduce(n, summed, mesh)

    def train_step(params, opt_state, batch):
        flat_local = leaves(params)
        flat_sh = leaves(_like(params, tree_sh, replicated))
        flat_csh = leaves(_like(params, compute_sh, replicated))
        kinds = leaves(_like(params, gather_kinds, lambda p: "all_gather"))
        full = [sharding.gather(p, csh, kind)
                for p, csh, kind in zip(flat_local, flat_csh, kinds)]
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
        for i, csh in enumerate(flat_csh):
            # an expert gradient is already this rank's experts: only its
            # dp sum and its fsdp cut are left (the layout it was gathered
            # to)
            local.append(sharding.reduce_grad(grads[i], csh, summed))
            grads[i] = None        # the whole gradient goes now
        if summed:
            # each rank's loss, xent and aux are its shares (the MoE's aux
            # too, models.moe): their dp sums are the batch's, the aux
            # counted once, not once a rank; so are the gradients' sums
            sums = sharding.all_reduce(
                torch.stack([loss, metrics["xent"], metrics["aux"]]),
                summed, mesh)
            loss = sums[0]
            metrics = {**metrics, "xent": sums[1], "aux": sums[2]}
        # each element of a leaf once, from the layout it lives in: an
        # expert leaf's slices along "model" are different experts
        gnorm = torch.sqrt(sharding.sum_squares(local, flat_sh))
        grads = unflatten(params, local)
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt_cfg, gnorm=gnorm)
        if keep_grads:
            opt_metrics["grads"] = grads
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def _serving(rules, mesh):
    """(rules, the "model" axis) of a serving step on ``mesh``: (None,
    ``sharding.ONE_RANK``) without one; raises for rules the port cannot
    serve with (``sharding.model_axis``)."""
    if mesh is None:
        return None, sharding.ONE_RANK
    rules = rules or make_rules(mesh)
    return rules, sharding.model_axis(mesh, rules)


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
    with the row-parallel sums written out (``models.layers``).  Rules
    that put the KV cache's sequence over "model" raise
    (``sharding.model_axis``)."""
    rules, _ = _serving(rules, mesh)

    @torch.inference_mode()
    def prefill_step(params, batch, caches, rows=None):
        return model.prefill(params, batch, caches, rules=rules, mesh=mesh,
                             rows=rows)
    return prefill_step


def make_decode_step(model: Model, rules: AxisRules | None = None,
                     mesh=None) -> Callable:
    """``decode_step(params, batch, caches, cache_index, rows=None) ->
    (next_tok, logits, caches)``: ``next_tok`` holds the rank's rows, the
    greedy token over the vocab slices of "model" (``sharding.greedy``:
    the lowest index among equal maxima, as ``torch.argmax`` and
    ``jnp.argmax``), and ``logits`` the rank's vocab slice
    (``make_prefill_step``; without a mesh, all rows and the whole
    vocab)."""
    rules, tp = _serving(rules, mesh)

    @torch.inference_mode()
    def decode_step(params, batch, caches, cache_index: int, rows=None):
        logits, caches = model.decode(params, batch, caches, cache_index,
                                      rules=rules, mesh=mesh, rows=rows)
        next_tok = sharding.greedy(logits[:, -1], tp, model.cfg.vocab)
        return next_tok, logits, caches
    return decode_step
