"""The dry run: trace every (arch x shape) cell's step on ``meta`` tensors
and write its roofline record, on one card and on the production meshes.

Counterpart of ``repro.launch.dryrun``.  Three meshes (``MESHES``):

* "h100x1", one H100: the parameters, optimizer state, caches and batch
  are ``meta`` tensors of the cell's shapes (no data, no card) and the
  step of the cell's kind (the sharded step on ``launch.mesh.ONE_PROCESS``,
  every leaf whole) runs once under ``analysis.step_stats``, the kernels
  on their counting route (``kernels/_meta.py``);
* "pod16x16" (16 x 16 ("data", "model")) and "pod2x16x16" (2 x 16 x 16
  ("pod", "data", "model")), the JAX package's production meshes: this
  process is one rank (``rank``, default 0) of a default process group of
  256 or 512 ranks on torch's ``fake`` backend (``fake_group``: every
  collective returns at once, on ``meta`` tensors too), the mesh is
  ``launch.mesh.make_mesh`` of those dims, and the step is the port's
  sharded step (``launch.steps``) on the rank's ``meta`` inputs: its
  parameter and optimizer-state slices and its rows of the batch
  (train), or its serving copies of the weights, its cache slices and
  its rows (prefill, decode).  The rules are the reference's
  (``cell_rules``): ``kv_seq`` over "model" where the KV heads do not
  divide over it, llama4's ZeRO over the pod axis, the MoE's groups one
  a dp rank (``_moe_groups_for``).  ``step_stats`` counts the rank's
  FLOPs, bytes and peak and the census of its collectives
  (``analysis.collectives``).

The record holds what the JAX package's holds (``status``, ``reason``,
``chips``, ``memory``, ``roofline``, ``params_total``,
``params_active``; on a pod mesh ``collectives``, its
``bytes_per_device``, ``counts`` and ``bytes_by_op``), with
``flops_by_op`` where it has ``hlo_census``, ``fits_80gb`` where it has
``fits_16gb`` and, on a pod mesh, ``collectives_by_kind`` (calls,
payload and wire bytes by the port's kinds) and ``layout`` (the rules the
cell ran under).  The record is rank 0's: where ranks differ (rows or
cache parts that do not split evenly), ``run_cell(..., rank=r)`` traces
another.  Records go to experiments/artifacts/dryrun_torch/.

Usage:
  python -m repro_torch.launch.dryrun                  # all 120 cells
  python -m repro_torch.launch.dryrun --mesh card      # the 40 on one card
  python -m repro_torch.launch.dryrun --mesh both      # the 80 on the pods
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --mesh both --rank 255 --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.distributed

from repro_torch.analysis.roofline import HBM_BYTES, Roofline, model_flops
from repro_torch.analysis.step_stats import step_stats
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import sharding
from repro_torch.launch.mesh import ONE_PROCESS, make_mesh, make_rules
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, cell_applicable,
                                       input_specs)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.models.common import (is_def, mesh_axis_sizes,
                                       tree_defs_to_specs)
from repro_torch.optim import AdamWConfig, state_defs

ART_DIR = (Path(__file__).resolve().parents[3] / "experiments" / "artifacts"
           / "dryrun_torch")
MESH = "h100x1"
#: mesh name -> (dims, axes) of the reference's production meshes
#: (``make_production_mesh``); None for the one card
MESHES = {MESH: None,
          "pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: the CLI's --mesh: the reference's "single" and "multi", "card", "both"
#: (the two pods) and "all"
MESH_CHOICES = {"single": ("pod16x16",), "multi": ("pod2x16x16",),
                "card": (MESH,), "both": ("pod16x16", "pod2x16x16"),
                "all": (MESH, "pod16x16", "pod2x16x16")}

# Per-arch distribution settings, the JAX package's production defaults:
# bf16 parameters with an fp32 master copy in the optimizer state,
# llama4's ZeRO over the pod axis (a mesh's only), bf16 optimizer moments
# and capacity factor, zamba2 without sequence sharding (a no-op in the
# port, kept with the config).
ARCH_DIST = {
    "llama4-maverick-400b-a17b": dict(fsdp_over_pod=True,
                                      opt_state_dtype="bf16",
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


def _nbytes(*trees) -> int:
    total = 0
    for tree in trees:
        if isinstance(tree, dict):
            total += _nbytes(*tree.values())
        elif isinstance(tree, torch.Tensor):
            total += tree.numel() * tree.element_size()
    return total


def _moe_groups_for(cfg, mesh, rules) -> int:
    """The reference's MoE groups on a mesh: one a data-parallel rank (the
    product of the rules' dp axes; 1 on the one card)."""
    dp = 1
    for a in rules.dp_axes:
        dp *= mesh.shape[a]
    return dp


def cell_rules(cfg, mesh, dist: dict):
    """The rules of a cell on ``mesh``, as the reference's ``run_cell``
    derives them: the arch's ``overrides``, ``kv_seq`` over "model" where
    the KV heads do not divide over it (the KV heads then fall back to
    whole by the rules' dimension-aware resolution), ZeRO over the pod
    axis where ``dist`` asks (``fsdp_over_pod``).  Reads only the mesh's
    ``axis_names`` and ``shape``."""
    overrides = dict(dist.get("overrides", {}))
    if cfg.n_kv_heads % int(mesh.shape["model"]) != 0:
        overrides.setdefault("kv_seq", "model")
    return make_rules(mesh, fsdp_over_pod=dist.get("fsdp_over_pod", False),
                      overrides=overrides)


def _cell_config(arch: str, dist: dict, mesh=ONE_PROCESS, rules=None):
    """The arch's full config under a distribution's settings, its MoE
    groups those of ``mesh`` under ``rules`` (``_moe_groups_for``; the
    one card's mesh by default)."""
    cfg = get_config(arch)
    cfg = cfg.with_(moe_groups=_moe_groups_for(
        cfg, mesh, make_rules(mesh) if rules is None else rules))
    if dist.get("param_dtype") == "bf16":
        cfg = cfg.with_(param_dtype=torch.bfloat16)
    if "capacity_factor" in dist and cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=dist["capacity_factor"]))
    if "seq_shard" in dist:
        cfg = cfg.with_(seq_shard=dist["seq_shard"])
    return cfg


@contextmanager
def fake_group(world: int, rank: int = 0):
    """The default process group as ``rank`` of ``world`` ranks on torch's
    ``fake`` backend (``torch.testing._internal.distributed.fake_pg``):
    no other process, every collective returns at once and leaves its
    output as it was.  Raises where a default group exists; destroys the
    group on the way out, whatever happens."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:      # not caught by the sweep: it stops
        raise ImportError(
            "the dry run on a mesh traces one rank over torch's fake "
            "process group, and this torch has no "
            "torch.testing._internal.distributed.fake_pg") from e
    dist = torch.distributed
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; the "
                           "dry run on a mesh starts its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_meta(defs, layouts, mesh):
    """A ``meta`` tensor of this rank's shape of each leaf of ``defs``:
    ``layouts`` is the matching tree of ``sharding.Sharding`` (a stored
    slice) or of ``common.ServingLayout`` (a serving copy)."""
    if not is_def(defs):
        return {k: local_meta(defs[k], layouts[k], mesh) for k in defs}
    if isinstance(layouts, sharding.Sharding):
        shape = layouts.shard_shape(defs.shape)
    else:
        shape = layouts.local_shape(defs.shape, mesh_axis_sizes(mesh))
    return torch.empty(shape, dtype=defs.dtype, device="meta")


def trace_rank(cfg, shape, dist, mesh, rules):
    """(stats, args) of a cell's sharded step on this rank of ``mesh``:
    its parameter and AdamW-state slices and its rows of the batch
    (train), or its serving copies, cache slices and rows (prefill,
    decode), all ``meta``.  On ``ONE_PROCESS`` this is the one card's
    step, every leaf whole."""
    model = build_model(cfg)
    batch = input_specs(cfg, shape)
    B, T = shape.global_batch, shape.seq
    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            state_dtype=dist.get("opt_state_dtype", "fp32"),
            master_fp32=dist.get("master_fp32", False))
        mb = dist.get("microbatches", 1)
        params = local_meta(model.param_defs, sharding.tree_shardings(
            model.param_specs(rules), mesh), mesh)
        sdefs = state_defs(model.param_defs, opt_cfg)
        opt_state = local_meta(sdefs, sharding.tree_shardings(
            tree_defs_to_specs(sdefs, rules), mesh), mesh)
        batch = sharding.local_batch(batch, mesh, rules, mb)
        step = make_train_step(model, opt_cfg, microbatches=mb, rules=rules,
                               mesh=mesh)
        args = (params, opt_state, batch)
        with step_stats() as stats:
            step(*args)
        return stats, args
    params = local_meta(model.param_defs,
                        model.serving_layouts(rules, mesh), mesh)
    max_len = sharding.cache_len(T, rules, mesh)
    caches = model.init_caches(B, max_len, cross_len=T, device="meta",
                               rules=rules, mesh=mesh)
    rows = sharding.serve_rows(mesh, rules, B)
    batch = {k: rows.take(v) for k, v in batch.items()}
    args = (params, batch, caches)
    with step_stats() as stats, torch.no_grad():
        if shape.kind == "prefill":
            make_prefill_step(model, rules, mesh)(*args, rows, max_len)
        else:                       # one token against a full cache
            make_decode_step(model, rules, mesh)(*args, T - 1, rows,
                                                 max_len)
    return stats, args


def trace_cell(arch: str, shape_name: str, *, mesh: str = MESH,
               spec: ShapeSpec | None = None, dist: dict | None = None,
               rank: int = 0):
    """(record, ``StepStats``) of one cell on ``mesh`` (a key of
    ``MESHES``), traced as ``rank`` on a pod mesh; the stats are None for
    a skip.  ``spec`` replaces ``SHAPES[shape_name]`` and ``dist`` the
    arch's ``ARCH_DIST`` entry: a cut that the card runs
    (``chip_smoke.py`` phase 14: train_4k at global batch 8 in 2
    microbatches, fp32 weights and AdamW state, ``dist={"microbatches":
    2}``)."""
    shape = spec or SHAPES[shape_name]
    dist = ARCH_DIST.get(arch, {}) if dist is None else dist
    cfg = _cell_config(arch, dist)
    ok, why = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "kind": shape.kind, "family": cfg.family,
           "status": "skip" if not ok else "pending", "reason": why}
    if not ok:
        return rec, None

    t0 = time.time()
    extra = {}
    if MESHES[mesh] is None:
        stats, args = trace_rank(cfg, shape, dist, ONE_PROCESS,
                                 make_rules(ONE_PROCESS))
        chips = 1
    else:
        dims, axes = MESHES[mesh]
        chips = math.prod(dims)
        with fake_group(chips, rank):
            m = make_mesh(dims, axes, device="meta")
            rules = cell_rules(cfg, m, dist)
            cfg = _cell_config(arch, dist, m, rules)
            stats, args = trace_rank(cfg, shape, dist, m, rules)
        extra = dict(
            rank=rank,
            layout={"fsdp_axes": list(rules.fsdp_axes),
                    "dp_axes": list(rules.dp_axes),
                    "overrides": dict(rules.overrides),
                    "moe_groups": cfg.moe_groups},
            collectives={"bytes_per_device": stats.collective_bytes,
                         "counts": stats.collective_counts,
                         "bytes_by_op": stats.collective_bytes_by_op},
            collectives_by_kind=stats.collectives_by_kind)

    B, T = shape.global_batch, shape.seq
    mflops, tokens = model_flops(cfg, shape.kind, T, B)
    roof = Roofline(arch=arch, shape=shape_name, mesh=mesh, chips=chips,
                    flops_per_device=stats.flops,
                    bytes_per_device=stats.hbm_bytes_kernel_adj,
                    coll_bytes_per_device=float(stats.collective_bytes),
                    model_flops_total=mflops, step_tokens=tokens)
    memory = dict(argument_bytes=_nbytes(*args), temp_bytes=stats.peak_bytes)
    memory["hbm_estimate_bytes"] = (memory["argument_bytes"]
                                    + memory["temp_bytes"])
    memory["fits_80gb"] = bool(memory["hbm_estimate_bytes"] < HBM_BYTES)
    rec.update(status="ok", chips=chips, trace_s=round(time.time() - t0, 2),
               microbatches=dist.get("microbatches", 1),
               global_batch=B, seq=T, memory=memory,
               roofline=roof.to_dict(), flops_by_op=stats.flops_by_op,
               params_total=cfg.param_count(),
               params_active=cfg.active_param_count(), **extra)
    return rec, stats


def run_cell(arch: str, shape_name: str, *, mesh: str = MESH,
             spec: ShapeSpec | None = None, dist: dict | None = None,
             rank: int = 0) -> dict:
    """The record of one cell (``trace_cell``)."""
    return trace_cell(arch, shape_name, mesh=mesh, spec=spec, dist=dist,
                      rank=rank)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="all", choices=list(MESH_CHOICES),
                    help="single: pod16x16, multi: pod2x16x16, card: "
                         "h100x1, both: the two pods, all: the three")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank a pod mesh's cells are traced as")
    ap.add_argument("--out", default=str(ART_DIR))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh in MESH_CHOICES[args.mesh]:
                name = _cell_name(arch, shape, mesh)
                path = out_dir / f"{name}.json"
                if path.exists():
                    print(f"[cached] {name}")
                    continue
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mesh=mesh,
                                   rank=args.rank)
                except (ValueError, TypeError, KeyError, RuntimeError,
                        NotImplementedError) as e:
                    # record the failure, keep sweeping: a shape or dtype
                    # mismatch (ValueError, TypeError), an unknown arch or
                    # key (KeyError), an operator with no meta kernel
                    # (RuntimeError, NotImplementedError)
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                path.write_text(json.dumps(rec, indent=1))
                extra = ""
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    extra = (f" bound={r['bound']} "
                             f"roofline_frac={r['roofline_fraction']:.3f}"
                             f" hbm={rec['memory']['hbm_estimate_bytes']/1e9:.2f}GB"
                             f" coll={r['coll_bytes_per_device']/1e9:.2f}GB"
                             f" trace={rec['trace_s']:.1f}s")
                print(f"[{rec['status']}] {name}{extra} "
                      f"({time.time()-t0:.0f}s)", flush=True)
    print(f"done; failures={failures}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
