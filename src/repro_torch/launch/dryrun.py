"""The one-card dry run: trace every (arch x shape) cell's step on ``meta``
tensors and write its roofline record.

Counterpart of ``repro.launch.dryrun``, for one H100 (mesh "h100x1").
For each cell the parameters, optimizer state, caches and batch are
``meta`` tensors of the cell's shapes (no data, no card); the step of
the cell's kind runs once under ``analysis.step_stats``, the kernels on
their counting route (``kernels/_meta.py``).  The record holds what the
JAX package's holds (``status``, ``reason``, ``chips``, ``memory``,
``roofline``, ``params_total``, ``params_active``), with ``flops_by_op``
where it has ``hlo_census`` and ``fits_80gb`` where it has
``fits_16gb``.  Records go to experiments/artifacts/dryrun_torch/.

Usage:
  python -m repro_torch.launch.dryrun                  # all 40 cells
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.roofline import HBM_BYTES, Roofline, model_flops
from repro_torch.analysis.step_stats import step_stats
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, cell_applicable,
                                       input_specs)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.models.common import tree_map_defs
from repro_torch.optim import AdamWConfig, state_defs

ART_DIR = (Path(__file__).resolve().parents[3] / "experiments" / "artifacts"
           / "dryrun_torch")
MESH = "h100x1"

# Per-arch distribution settings, the JAX package's production defaults
# less what only a mesh has (llama4's ZeRO over the pod axis): bf16
# parameters with an fp32 master copy in the optimizer state, llama4's
# bf16 optimizer moments and capacity factor, zamba2 without sequence
# sharding (a no-op on one card, kept with the config).
ARCH_DIST = {
    "llama4-maverick-400b-a17b": dict(opt_state_dtype="bf16",
                                      param_dtype="bf16",
                                      master_fp32=True,
                                      microbatches=1,
                                      capacity_factor=1.25),
    "qwen2-7b": dict(param_dtype="bf16", master_fp32=True),
    "qwen2-vl-7b": dict(param_dtype="bf16", master_fp32=True),
    "stablelm-12b": dict(param_dtype="bf16", master_fp32=True),
    "stablelm-1.6b": dict(param_dtype="bf16", master_fp32=True),
    "starcoder2-15b": dict(param_dtype="bf16", master_fp32=True),
    "seamless-m4t-large-v2": dict(param_dtype="bf16", master_fp32=True),
    "qwen3-moe-30b-a3b": dict(param_dtype="bf16", master_fp32=True),
    "mamba2-1.3b": dict(param_dtype="bf16", master_fp32=True),
    "zamba2-1.2b": dict(param_dtype="bf16", master_fp32=True,
                        seq_shard=False),
}


def _cell_name(arch: str, shape: str, mesh: str = MESH) -> str:
    return f"{arch}__{shape}__{mesh}"


def _meta(defs):
    """A ``meta`` tensor for every ParamDef leaf."""
    return tree_map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def _nbytes(*trees) -> int:
    total = 0
    for tree in trees:
        if isinstance(tree, dict):
            total += _nbytes(*tree.values())
        elif isinstance(tree, torch.Tensor):
            total += tree.numel() * tree.element_size()
    return total


def _cell_config(arch: str, dist: dict):
    """The arch's full config under a distribution's settings (one card:
    one MoE group)."""
    cfg = get_config(arch).with_(moe_groups=1)
    if dist.get("param_dtype") == "bf16":
        cfg = cfg.with_(param_dtype=torch.bfloat16)
    if "capacity_factor" in dist and cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=dist["capacity_factor"]))
    if "seq_shard" in dist:
        cfg = cfg.with_(seq_shard=dist["seq_shard"])
    return cfg


def run_cell(arch: str, shape_name: str, *, spec: ShapeSpec | None = None,
             dist: dict | None = None) -> dict:
    """The record of one cell.  ``spec`` replaces ``SHAPES[shape_name]``
    and ``dist`` the arch's ``ARCH_DIST`` entry: a cut that the card
    runs (``chip_smoke.py`` phase 14: train_4k at global batch 8 in 2
    microbatches, fp32 weights and AdamW state, ``dist={"microbatches":
    2}``)."""
    shape = spec or SHAPES[shape_name]
    dist = ARCH_DIST.get(arch, {}) if dist is None else dist
    cfg = _cell_config(arch, dist)
    ok, why = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
           "kind": shape.kind, "family": cfg.family,
           "status": "skip" if not ok else "pending", "reason": why}
    if not ok:
        return rec

    t0 = time.time()
    model = build_model(cfg)
    params = _meta(model.param_defs)
    batch = input_specs(cfg, shape)
    B, T = shape.global_batch, shape.seq
    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            state_dtype=dist.get("opt_state_dtype", "fp32"),
            master_fp32=dist.get("master_fp32", False))
        opt_state = _meta(state_defs(model.param_defs, opt_cfg))
        step = make_train_step(model, opt_cfg,
                               microbatches=dist.get("microbatches", 1))
        args = (params, opt_state, batch)
        with step_stats() as stats:
            step(*args)
    else:
        caches = _meta(model.cache_defs(B, T, cross_len=T))
        args = (params, batch, caches)
        with step_stats() as stats, torch.no_grad():
            if shape.kind == "prefill":
                make_prefill_step(model)(*args)
            else:                   # one token against a full cache
                make_decode_step(model)(*args, T - 1)

    mflops, tokens = model_flops(cfg, shape.kind, T, B)
    roof = Roofline(arch=arch, shape=shape_name, mesh=MESH, chips=1,
                    flops_per_device=stats.flops,
                    bytes_per_device=stats.hbm_bytes_kernel_adj,
                    coll_bytes_per_device=float(stats.collective_bytes),
                    model_flops_total=mflops, step_tokens=tokens)
    memory = dict(argument_bytes=_nbytes(*args), temp_bytes=stats.peak_bytes)
    memory["hbm_estimate_bytes"] = (memory["argument_bytes"]
                                    + memory["temp_bytes"])
    memory["fits_80gb"] = bool(memory["hbm_estimate_bytes"] < HBM_BYTES)
    rec.update(status="ok", chips=1, trace_s=round(time.time() - t0, 2),
               microbatches=dist.get("microbatches", 1),
               global_batch=B, seq=T, memory=memory,
               roofline=roof.to_dict(), flops_by_op=stats.flops_by_op,
               params_total=cfg.param_count(),
               params_active=cfg.active_param_count())
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single"],
                    help="one card (more devices: ROADMAP.md, Queue A "
                         "item 6)")
    ap.add_argument("--out", default=str(ART_DIR))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    failures = 0
    for arch in archs:
        for shape in shapes:
            name = _cell_name(arch, shape)
            path = out_dir / f"{name}.json"
            if path.exists():
                print(f"[cached] {name}")
                continue
            t0 = time.time()
            try:
                rec = run_cell(arch, shape)
            except (ValueError, TypeError, KeyError, RuntimeError,
                    NotImplementedError) as e:
                # record the failure, keep sweeping: a shape or dtype
                # mismatch (ValueError, TypeError), an unknown arch or key
                # (KeyError), an operator with no meta kernel
                # (RuntimeError, NotImplementedError)
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": MESH,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
            path.write_text(json.dumps(rec, indent=1))
            extra = ""
            if rec["status"] == "ok":
                r = rec["roofline"]
                extra = (f" bound={r['bound']} "
                         f"roofline_frac={r['roofline_fraction']:.3f}"
                         f" hbm={rec['memory']['hbm_estimate_bytes']/1e9:.2f}GB"
                         f" trace={rec['trace_s']:.1f}s")
            print(f"[{rec['status']}] {name}{extra} ({time.time()-t0:.0f}s)",
                  flush=True)
    print(f"done; failures={failures}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
