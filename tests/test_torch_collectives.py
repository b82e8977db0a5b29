"""The census of collectives (``repro_torch.analysis.collectives``, filled by
``analysis.step_stats``) and the dry run on the production meshes
(``repro_torch.launch.dryrun``: one rank of pod16x16 and pod2x16x16 on
``meta`` tensors over torch's fake process group), held to the JAX
package where it can be.

The reference's sharded compile does not run under JAX 0.9.0
(``tests/test_dryrun_plumbing.py::test_small_mesh_spmd_compile``), so no
reference census exists to compare with; the census is held three ways:

* (a) the ring model: each of the five ops at group sizes 2, 4 and 16
  gives ``repro.analysis.hlo_stats.analyze_hlo``'s wire bytes on HLO text
  that states the op, its payload and its ``replica_groups``; the five
  call sites of ``launch.sharding`` record the op and group size they
  run, and no other code of the port calls a collective;
* (b) the twin of the failing reference test: qwen2-7b's and
  mamba2-1.3b's smoke configs (``moe_groups`` 4) on a (2, 2, 2) ("pod",
  "data", "model") fake mesh, a train step at 8 x 64 and a decode step:
  finite FLOPs, a census above 0, and every rank's census equal to rank
  0's;
* (c) FLOPs over ranks: on a (2, 2) fake mesh the FLOPs of the four ranks
  add up to the one-process step's for the dense configs; where a part
  runs whole on every "model" rank the excess is computed and named
  (``_excess``): Mamba-2's B and C columns of ``in_proj`` and of the
  conv, the MoE router and shared expert, and a MoE decode step whose
  tokens fall back to one group (every dp rank then runs the whole
  group);
* (d) ``run_cell`` at both pod meshes writes the reference's record keys
  with its ``collectives``; skips follow ``cell_applicable``; a
  ``LotaruML`` fitted from a pod16x16 record has a collective term;
* (e) the rules each cell runs under at both production meshes (``kv_seq``
  over "model" where the KV heads do not divide, llama4's ZeRO over the
  pod axis, the MoE groups) equal those the reference's ``run_cell``
  derives, for all ten archs;
* (f) no test leaves a default process group behind.

The spawned gloo steps' own counts are held to the census in
tests/test_torch_tp_train.py, test_torch_serve_mesh.py and
test_torch_context_parallel.py.
"""
import math
import os
import re
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.analysis.hlo_stats import analyze_hlo
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.launch.mesh import make_rules as jax_make_rules
from repro_torch.analysis import collectives, step_stats
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import (ARCH_DIST, MESHES, _cell_config,
                                       _moe_groups_for, cell_rules,
                                       fake_group, run_cell, trace_rank)
from repro_torch.launch.mesh import ONE_PROCESS, Mesh, make_mesh, make_rules
from repro_torch.launch.shapes import SHAPES, ShapeSpec, cell_applicable
from repro_torch.models.moe import _capacity

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
POD_MESHES = ("pod16x16", "pod2x16x16")


@pytest.fixture(autouse=True)
def _no_group_left_behind():
    """(f): no test starts or ends with a default process group."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (a) the ring model and the call sites
# ---------------------------------------------------------------------------
HLO = """HloModule m

ENTRY %main (p: {ins}) -> {out} {{
  %p = {ins}{{0}} parameter(0)
  ROOT %c = {out}{{0}} {op}(%p), {groups}
}}
"""


def _hlo(op, dtype, n, g):
    """One collective of ``op`` over groups of ``g`` ranks whose payload
    is ``n`` elements (an all-gather's output, a reduce-scatter's
    input)."""
    ins = out = f"{dtype}[{n}]"
    if op == "all-gather":
        ins = f"{dtype}[{n // g}]"
    elif op == "reduce-scatter":
        out = f"{dtype}[{n // g}]"
    groups = ("source_target_pairs={{0,1}}" if op == "collective-permute"
              else f"replica_groups=[{16 // g},{g}]<=[16]")
    return HLO.format(ins=ins, out=out, op=op, groups=groups)


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("op", collectives.OPS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_model_is_analyze_hlos(op, g, dtype):
    n = 4096 * 3
    tdtype = torch.float32 if dtype == "f32" else torch.bfloat16
    with collectives.census() as c:
        collectives.record("probe", op, g,
                           torch.empty(n, dtype=tdtype, device="meta"))
    ref = analyze_hlo(_hlo(op, dtype, n, g))
    assert ref.collective_counts == dict(c.counts) == {op: 1}
    assert ref.collective_bytes_by_op == c.bytes_by_op
    assert ref.collective_bytes == c.total_bytes > 0
    kind = c.by_kind["probe"]
    assert kind["calls"] == 1
    assert kind["payload_bytes"] == n * (4 if dtype == "f32" else 2)
    assert kind["wire_bytes"] == collectives.wire_bytes(
        op, kind["payload_bytes"], g)


def test_the_five_call_sites_record_their_op_and_group():
    """On a (2, 4) fake mesh: ``gather`` (all-gather over each axis),
    ``reduce_grad`` (reduce-scatter, then all-reduce over an axis the
    spec does not name), ``all_reduce``, ``sum_squares`` (over the world)
    and ``axis_sum`` record their op, group size and payload, and
    ``BYTES``/``CALLS`` keep counting by kind."""
    with fake_group(8, 5):
        mesh = make_mesh((2, 4), ("data", "model"), device="meta")
        x = torch.empty(3, 8, device="meta")
        sharding.reset_counts()
        with step_stats() as stats:
            sharding.gather(x, sharding.Sharding(mesh, ("data", "model")))
            sharding.reduce_grad(torch.empty(8, 32, device="meta"),
                                 sharding.Sharding(mesh, ("model", None)),
                                 ("data", "model"))
            sharding.all_reduce(torch.empty(5, device="meta"), ("data",),
                                mesh)
            sharding.sum_squares([x], [sharding.Sharding(mesh, (None,
                                                                None))])
            sharding.axis_sum(torch.empty(7, device="meta"),
                              sharding.train_axis(mesh), "tp_sum")
        calls, moved = dict(sharding.CALLS), dict(sharding.BYTES)
    assert stats.collective_counts == {"all-gather": 2, "reduce-scatter": 1,
                                       "all-reduce": 4}
    f = 4
    want = {  # kind: [(op, group, payload bytes)]
        "all_gather": [("all-gather", 2, 6 * 8 * f),
                       ("all-gather", 4, 6 * 32 * f)],
        "reduce_scatter": [("reduce-scatter", 4, 8 * 32 * f)],
        "all_reduce": [("all-reduce", 2, 2 * 32 * f), ("all-reduce", 2, 5 * f),
                       ("all-reduce", 8, f)],
        "tp_sum": [("all-reduce", 4, 7 * f)]}
    for kind, rows in want.items():
        got = stats.collectives_by_kind[kind]
        assert got["calls"] == calls[kind] == len(rows)
        assert got["payload_bytes"] == moved[kind] == sum(b for _, _, b in rows)
        assert got["wire_bytes"] == pytest.approx(sum(
            collectives.wire_bytes(op, b, g) for op, g, b in rows), rel=1e-15)
    assert stats.collective_bytes == int(sum(
        v["wire_bytes"] for v in stats.collectives_by_kind.values()))
    sites = {r["site"].rsplit(":", 1)[0] for r in stats.collective_sites}
    assert sites == {"tests/test_torch_collectives.py"}


#: ``torch.distributed`` calls that move data between ranks
_COLLECTIVE_CALL = re.compile(
    r"\bdist\.(all_reduce|all_gather\w*|reduce_scatter\w*|all_to_all\w*|"
    r"broadcast\w*|reduce|gather|scatter|send|recv|isend|irecv|"
    r"batch_isend_irecv)\(")


def test_no_collective_bypasses_the_recorder():
    """Every collective of the port is one of ``launch.sharding``'s five
    sites, each of which hands its call to ``collectives.record``."""
    port = ROOT / "src" / "repro_torch"
    found = {}
    for path in sorted(port.rglob("*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if _COLLECTIVE_CALL.search(line):
                found.setdefault(path.relative_to(port).as_posix(),
                                 []).append(n)
    assert list(found) == ["launch/sharding.py"], found
    src = (port / "launch" / "sharding.py").read_text().splitlines()
    for n in found["launch/sharding.py"]:
        assert "record(" in "\n".join(src[n:n + 3]), src[n - 1]
    assert len(found["launch/sharding.py"]) == 5


# ---------------------------------------------------------------------------
# (b) the twin of the reference's small-mesh compile
# ---------------------------------------------------------------------------
SMALL = {"train": ShapeSpec("t", "train", 64, 8),
         "prefill": ShapeSpec("p", "prefill", 64, 8),
         "decode": ShapeSpec("d", "decode", 64, 8)}


def _rank_trace(cfg, spec, dims, axes, rank, rules=None):
    with fake_group(math.prod(dims), rank):
        mesh = make_mesh(dims, axes, device="meta")
        stats, _ = trace_rank(cfg, spec, {}, mesh,
                              rules or make_rules(mesh))
    return stats


def _census(stats):
    return (stats.collective_counts, stats.collective_bytes_by_op,
            stats.collectives_by_kind)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-1.3b"])
def test_small_mesh_trace_twin_of_the_spmd_compile(arch, kind):
    cfg = smoke_config(arch).with_(moe_groups=4)
    dims, axes = (2, 2, 2), ("pod", "data", "model")
    ranks = [_rank_trace(cfg, SMALL[kind], dims, axes, r) for r in range(8)]
    for r, stats in enumerate(ranks):
        assert math.isfinite(stats.flops) and stats.flops > 0, r
        assert stats.collective_bytes > 0, r
        assert stats.flops == ranks[0].flops, r
        assert _census(stats) == _census(ranks[0]), r
    kinds = set(ranks[0].collectives_by_kind)
    if kind == "train":       # fsdp over ("pod", "data"): gathered, scattered
        assert {"all_gather", "reduce_scatter", "tp_sum", "tp_grad"} <= kinds
    else:
        assert {"tp_sum", "argmax"} <= kinds


# ---------------------------------------------------------------------------
# (c) FLOPs over ranks
# ---------------------------------------------------------------------------
def _passes(kind):
    """How often a product of the layer's input runs in a step: once in
    inference; in training the forward, full remat's recompute and the
    two gradients (input and weight)."""
    return 4 if kind == "train" else 1


def _excess(cfg, kind, one, dp, tp):
    """The FLOPs the ranks of a (dp, tp) mesh spend beyond the one-process
    step's (``one``, its ``StepStats``), by name, for SMALL's shapes."""
    spec = SMALL[kind]
    tokens = spec.global_batch * (1 if kind == "decode" else spec.seq)
    d = cfg.d_model
    out = {}
    if cfg.ssm is not None:
        s = cfg.ssm
        gn2 = 2 * s.n_groups * s.d_state
        conv_dim = s.d_inner(d) + gn2
        # B and C columns whole on every "model" rank: in_proj's and the
        # depthwise conv's (its FLOPs scale with the channels)
        out["ssm_bc_in_proj"] = ((tp - 1) * 2 * tokens * d * gn2
                                 * cfg.n_layers * _passes(kind))
        conv = sum(v for k, v in one.flops_by_op.items()
                   if k.startswith("aten.convolution"))
        out["ssm_bc_conv"] = (tp - 1) * conv * gn2 / conv_dim
    if cfg.moe is not None:
        m = cfg.moe
        n_moe = cfg.n_layers // m.every
        router = 2 * tokens * d * m.n_experts * n_moe
        shared = (2 * tokens * d * m.d_ff_expert * n_moe
                  if m.shared_expert else 0)
        n_tok = tokens // dp
        fallback = n_tok * dp // cfg.moe_groups < m.n_experts // m.top_k
        if kind == "decode" and fallback:
            # one group over the dp ranks: each rank gathers the group and
            # routes it (router and shared expert whole on every rank), its
            # E/tp experts over all C slots on each of the dp ranks
            C = _capacity(tokens, cfg)
            experts = 3 * 2 * m.n_experts * C * d * m.d_ff_expert * n_moe
            out["moe_one_group_router"] = (dp * tp - 1) * router
            out["moe_one_group_experts"] = (dp - 1) * experts
            if shared:
                out["moe_one_group_shared"] = (dp * tp - 1) * 3 * shared
        else:
            # the router and shared expert whole on every "model" rank;
            # the shared expert's down product is not recomputed by remat
            out["moe_router"] = (tp - 1) * router * _passes(kind)
            if shared:
                out["moe_shared"] = (tp - 1) * shared * (
                    11 if kind == "train" else 3)
    if cfg.family not in ("ssm",) and cfg.n_kv_heads % tp:
        raise AssertionError("KV projections kept whole: not at SMALL")
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_summed_over_ranks_are_the_one_process_steps(arch, kind):
    cfg = smoke_config(arch)
    if cfg.moe is not None:
        cfg = cfg.with_(moe_groups=4)
    one, _ = trace_rank(cfg, SMALL[kind], {}, ONE_PROCESS,
                        make_rules(ONE_PROCESS))
    per = [_rank_trace(cfg, SMALL[kind], (2, 2), ("data", "model"), r)
           for r in range(4)]
    excess = _excess(cfg, kind, one, 2, 2)
    total = sum(s.flops for s in per)
    assert total == one.flops + sum(excess.values()), (excess,
                                                       total - one.flops)
    dense = cfg.ssm is None and cfg.moe is None
    assert (not excess) == dense
    assert all(v > 0 for v in excess.values())


# ---------------------------------------------------------------------------
# (d) the pod meshes' records
# ---------------------------------------------------------------------------
#: the reference's record keys (``src/repro/launch/dryrun.py``) that the
#: port's carries; ``flops_by_op`` stands where it has ``hlo_census``
REF_KEYS = {"arch", "shape", "mesh", "kind", "family", "status", "reason",
            "chips", "memory", "roofline", "params_total", "params_active",
            "collectives"}


@pytest.mark.parametrize("mesh", POD_MESHES)
@pytest.mark.parametrize("arch,shape", [
    ("stablelm-1.6b", "decode_32k"), ("mamba2-1.3b", "long_500k"),
    ("qwen2-7b", "long_500k"), ("qwen2-7b", "decode_32k")])
def test_pod_mesh_record_has_the_references_keys(arch, shape, mesh):
    rec = run_cell(arch, shape, mesh=mesh)
    ok, _ = cell_applicable(get_config(arch), SHAPES[shape])
    assert rec["mesh"] == mesh
    assert rec["status"] == ("ok" if ok else "skip")
    if not ok:
        return
    assert REF_KEYS | {"flops_by_op", "collectives_by_kind",
                       "layout"} <= rec.keys()
    assert rec["chips"] == math.prod(MESHES[mesh][0])
    coll = rec["collectives"]
    assert coll.keys() == {"bytes_per_device", "counts", "bytes_by_op"}
    # each op's wire bytes rounded down to whole bytes, as HloStats'
    assert 0 <= coll["bytes_per_device"] - sum(
        coll["bytes_by_op"].values()) < len(coll["counts"])
    assert coll["bytes_per_device"] > 0
    assert rec["roofline"]["coll_bytes_per_device"] == \
        coll["bytes_per_device"]
    assert rec["roofline"]["collective_s"] > 0
    assert sum(k["calls"] for k in rec["collectives_by_kind"].values()) == \
        sum(coll["counts"].values())
    mem = rec["memory"]
    assert mem["hbm_estimate_bytes"] == (mem["argument_bytes"]
                                         + mem["temp_bytes"])
    # qwen2-7b's 4 KV heads do not divide over 16: the caches' sequence
    # goes over "model", and a decode step merges the ranks' partial rows
    kv_seq = get_config(arch).n_kv_heads % 16 != 0
    assert ("kv_seq" in rec["layout"]["overrides"]) == kv_seq
    assert ("cp_merge" in rec["collectives_by_kind"]) == (
        kv_seq and rec["kind"] == "decode" and rec["family"] != "ssm")


def test_lotaru_ml_fitted_from_a_pod_record_prices_its_collectives():
    from repro_torch.core import LotaruML
    from repro_torch.core.profiler import BenchResult
    rec = run_cell("stablelm-1.6b", "decode_32k", mesh="pod16x16")
    local = BenchResult(node="local", cpu_events_s=450.0,
                        matmul_gflops=90.0, mem_gbps=18.0,
                        io_read_mbps=420.0, io_write_mbps=420.0,
                        link_gbps=10.0)
    target = BenchResult(node="n0", cpu_events_s=200.0, matmul_gflops=900.0,
                         mem_gbps=300.0, io_read_mbps=300.0,
                         io_write_mbps=300.0, link_gbps=50.0)
    est = LotaruML(local, {"n0": target}, device="cpu")
    est.fit_cell(rec, lambda c, f: 1e-3 * f * c["roofline"]["step_tokens"]
                 + 0.5)
    cell = est.cells[est.cell_names()[0]]
    assert cell.coll == rec["collectives"]["bytes_per_device"] > 0
    assert cell.weights[2] > 0
    assert est._terms(cell, target)[2] > 0


# ---------------------------------------------------------------------------
# (e) the rules at the production meshes against the reference's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_dryrun():
    """``repro.launch.dryrun`` (its ARCH_DIST and ``_moe_groups_for``); it
    sets XLA_FLAGS for 512 host devices on import, which is put back at
    once so that no later JAX backend in this process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _reference_rules(ref, arch, mesh):
    """What the reference's ``run_cell`` derives on ``mesh``."""
    cfg = jax_get_config(arch)
    d = ref.ARCH_DIST.get(arch, {})
    overrides = dict(d.get("overrides", {}))
    if cfg.n_kv_heads % int(mesh.shape["model"]) != 0:
        overrides.setdefault("kv_seq", "model")
    rules = jax_make_rules(mesh, fsdp_over_pod=d.get("fsdp_over_pod", False),
                           overrides=overrides)
    return rules, ref._moe_groups_for(cfg, mesh, rules), d


@pytest.mark.parametrize("mesh_name", POD_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_rules_match_the_references_run_cell(arch, mesh_name,
                                                  reference_dryrun):
    dims, axes = MESHES[mesh_name]
    mesh = Mesh(axes, dims, (0,) * len(dims))     # a stand-in: no group
    jrules, jgroups, jdist = _reference_rules(reference_dryrun, arch, mesh)
    rules = cell_rules(get_config(arch), mesh, ARCH_DIST[arch])
    for f in ("fsdp_axes", "dp_axes", "overrides", "axis_sizes"):
        assert getattr(rules, f) == getattr(jrules, f), f
    assert ARCH_DIST[arch].get("fsdp_over_pod", False) == \
        jdist.get("fsdp_over_pod", False)
    cfg = _cell_config(arch, ARCH_DIST[arch], mesh, rules)
    assert cfg.moe_groups == jgroups == _moe_groups_for(cfg, mesh, rules)
    # the resolved layout of each logical axis, at the config's widths
    c = get_config(arch)
    for name, n in (("kv_seq", 32768), ("kv_heads", c.n_kv_heads),
                    ("heads", c.n_heads), ("batch", 128), ("embed", c.d_model)):
        assert rules.resolve(name, dims=(n,)) == tuple(
            jrules.resolve(name, dims=(n,))), name
