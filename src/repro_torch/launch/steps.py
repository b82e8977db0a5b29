"""Step functions: train / prefill / decode, built per model.

Counterpart of ``repro.launch.steps``; PyTorch runs them eagerly, with no
jit.  ``make_train_step`` supports microbatched gradient accumulation
(grads averaged into fp32, as the JAX package's scan over microbatches)
and a gradient dtype.  The train step updates the parameters and the
optimizer state in place (the JAX package donates both).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.optim.adamw import leaves, unflatten


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1, grad_dtype=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss and gradients of ``model.loss`` (each batch leaf
    split into ``microbatches`` along dim 0, each microbatch's gradients
    divided by their count and summed in fp32), cast to ``grad_dtype``
    where given, then one AdamW step.  metrics: "loss", "xent", "aux"
    (means over microbatches), "grad_norm", "lr"."""
    def grad_fn(params, flat_p, batch):
        loss, metrics = model.loss(params, batch)
        # every leaf must reach the loss: autograd raises on one that does
        # not (a kernel with no backward would leave it so), rather than
        # training it with a zero gradient
        grads = torch.autograd.grad(loss, flat_p)
        if grad_dtype is not None:
            grads = [g.to(grad_dtype) for g in grads]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(params, opt_state, batch):
        flat_p = leaves(params)
        for p in flat_p:
            p.requires_grad_(True)
        if microbatches > 1:
            parts = {k: torch.chunk(v, microbatches, dim=0)
                     for k, v in batch.items()}
            if any(len(v) != microbatches
                   or v[0].shape[0] * microbatches != batch[k].shape[0]
                   for k, v in parts.items()):
                raise ValueError(f"batch rows do not split into "
                                 f"{microbatches} microbatches")
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in flat_p]
            losses, metricss = [], []
            for i in range(microbatches):
                loss, metrics, grads = grad_fn(
                    params, flat_p, {k: v[i] for k, v in parts.items()})
                for a, g in zip(acc, grads):
                    a.add_(g / torch.tensor(microbatches, dtype=g.dtype,
                                            device=g.device))
                losses.append(loss)
                metricss.append(metrics)
                del grads
            grads = acc
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricss]).mean()
                       for k in metricss[0]}
        else:
            loss, metrics, grads = grad_fn(params, flat_p, batch)
        params, opt_state, opt_metrics = apply_updates(
            params, unflatten(params, grads), opt_state, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch, caches):
        return model.prefill(params, batch, caches)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(params, batch, caches, cache_index: int):
        logits, caches = model.decode(params, batch, caches, cache_index)
        # torch.argmax returns the first maximal index, as jnp.argmax does
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok, logits, caches
    return decode_step
