"""Fault-tolerant training driver.

Counterpart of ``repro.launch.train``, on one device (default: the CUDA
card):

  * checkpoint/restart: async checkpoints every ``ckpt_every`` steps and at
    the end; a run resumes from the last complete checkpoint, and the
    synthetic data is a function of the step, so a resumed run repeats the
    steps an uninterrupted one takes.
  * failure injection: ``fail_at_step`` raises ``InjectedFailure`` before
    that step; ``train_with_restarts`` restarts from the last checkpoint.
  * straggler watch: each step's wall time (ending in a synchronize on the
    card) against a predictive envelope (mean + k * sigma); slow steps are
    counted.
  * elastic restart: on a ``mesh`` of more than one process every rank
    runs ``train`` (the sharded step of ``launch.steps``); checkpoints
    hold whole arrays, so a run resumes on a mesh of another shape, each
    rank reading only its slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.data import SyntheticLMData
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_rules
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.common import (AxisRules, ModelConfig, is_def,
                                       tree_defs_init, tree_defs_to_specs)
from repro_torch.optim import AdamWConfig, state_defs


class InjectedFailure(RuntimeError):
    pass


@dataclass
class TrainReport:
    steps_run: int
    final_step: int
    losses: list = field(default_factory=list)
    restarts: int = 0
    straggler_steps: int = 0
    step_times: list = field(default_factory=list)


def _cast_like_defs(tree, defs):
    """A restored tree with each leaf in its definition's dtype (the
    checkpoint keeps the dtype, so this only moves leaves whose definition
    changed, e.g. a state written under another ``state_dtype``)."""
    if is_def(defs):
        return tree.to(defs.dtype)
    return {k: _cast_like_defs(tree[k], defs[k]) for k in sorted(defs)}


def train(cfg: ModelConfig, *, steps: int, seq: int, global_batch: int,
          ckpt_dir: str | Path | None = None, ckpt_every: int = 50,
          mesh=None, rules: AxisRules | None = None,
          opt_cfg: AdamWConfig | None = None,
          fail_at_step: int | None = None,
          step_time_envelope: tuple[float, float] | None = None,
          straggler_k: float = 3.0, seed: int = 0, log_every: int = 10,
          verbose: bool = False, microbatches: int = 1,
          device=None) -> TrainReport:
    """One training run on ``device`` (resumes from ``ckpt_dir`` if a
    checkpoint exists there).  ``microbatches`` splits each global batch
    for gradient accumulation (``make_train_step``).

    On a ``mesh`` of more than one process (``launch.mesh.make_mesh``;
    ``rules`` default to ``make_rules(mesh)``) every rank calls ``train``
    and computes on ``mesh.device``: each draws the global initial
    parameters from the one seed, leaf by leaf, and keeps its slice
    (``sharding.init_local``), draws each global batch and keeps its rows
    (``sharding.local_batch``), and saves and restores its slices of the
    one checkpoint.  ``losses`` and ``final_step`` are the same on every
    rank; ``params`` are the rank's slices."""
    sharded = mesh is not None and mesh.size > 1
    dev = mesh.device if sharded else resolve_device(device)
    model = build_model(cfg)
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, warmup_steps=20,
                                     total_steps=steps)
    data = SyntheticLMData(cfg, seq=seq, global_batch=global_batch,
                           seed=seed, device=dev)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches,
                              rules=rules, mesh=mesh)
    sdefs = state_defs(model.param_defs, opt_cfg)
    shardings = None
    if sharded:
        rules = rules or make_rules(mesh)
        shardings = sharding.tree_shardings(
            {"params": model.param_specs(rules),
             "opt": tree_defs_to_specs(sdefs, rules)}, mesh)

    start_step = 0
    params = opt_state = None
    ckpt = None
    if ckpt_dir is not None:
        ckpt = AsyncCheckpointer(ckpt_dir, shardings=shardings)
        if latest_step(ckpt_dir) is not None:
            state, manifest = restore(ckpt_dir, device=dev,
                                      shardings=shardings)
            params = _cast_like_defs(state["params"], model.param_defs)
            opt_state = _cast_like_defs(state["opt"], sdefs)
            start_step = manifest["step"] + 1
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = (sharding.init_local(model.param_defs, gen, dev,
                                      shardings["params"]) if sharded
                  else model.init(seed, device=dev))
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        opt_state = (sharding.init_local(sdefs, gen, dev, shardings["opt"])
                     if sharded else tree_defs_init(sdefs, gen, dev))

    report = TrainReport(steps_run=0, final_step=start_step)
    for step in range(start_step, steps):
        if fail_at_step is not None and step == fail_at_step:
            if ckpt is not None:
                ckpt.wait()
            raise InjectedFailure(f"injected node failure at step {step}")
        batch = data.batch(step)
        if sharded:
            batch = sharding.local_batch(batch, mesh, rules, microbatches)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])      # waits for the step
        dt = time.perf_counter() - t0
        report.step_times.append(dt)
        if step_time_envelope is not None and step > start_step:
            mean, sigma = step_time_envelope
            if dt > mean + straggler_k * sigma:
                report.straggler_steps += 1
        report.losses.append(loss)
        report.steps_run += 1
        report.final_step = step
        if verbose and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)",
                  flush=True)
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state},
                      metadata={"loss": loss})
    if ckpt is not None:
        ckpt.save(report.final_step, {"params": params, "opt": opt_state},
                  metadata={"final": True})
        ckpt.wait()
    report.params = params  # type: ignore[attr-defined]
    report.opt_state = opt_state  # type: ignore[attr-defined]
    return report


def train_with_restarts(cfg: ModelConfig, *, steps: int, seq: int,
                        global_batch: int, ckpt_dir: str | Path,
                        failures: list[int] | None = None,
                        max_restarts: int = 5, **kw) -> TrainReport:
    """Supervisor loop: run, catch (injected) failures, restart from the
    last checkpoint — the single-process analogue of a fleet controller."""
    failures = list(failures or [])
    restarts = 0
    while True:
        fail_at = failures[0] if failures else None
        try:
            rep = train(cfg, steps=steps, seq=seq, global_batch=global_batch,
                        ckpt_dir=ckpt_dir, fail_at_step=fail_at, **kw)
            rep.restarts = restarts
            return rep
        except InjectedFailure:
            failures.pop(0)
            restarts += 1
            if restarts > max_restarts:
                raise
