"""The port's step accounting (``repro_torch.analysis.step_stats``) and
one-card dry run (``repro_torch.launch.dryrun``) held to the JAX
package's on the CPU.

* FLOPs: at the smoke configs, B 2 x T 64, float32 activations, the
  port's prefill and decode steps on CPU tensors (the kernels' plain
  versions) count exactly what ``repro.analysis.hlo_stats.analyze_hlo``
  counts in the reference's compiled step, for all ten configs (train:
  ``tests/test_torch_dryrun_train.py``).
* The kernels' ``meta`` route (the dry run's) counts exactly what their
  plain versions count on CPU tensors, for all ten configs and the three
  kinds of step, and for direct calls with each mix of gradients.
* Bytes and peak memory of a linear layer, an ``mha`` call and an ``ssd``
  call equal the counts worked out by hand.
* ``run_cell``'s records carry the reference's keys; long_500k is a skip
  for the eight full-attention archs.

Each reference step is compiled once per module (``ref_flops``).
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.hlo_stats import analyze_hlo
from repro.analysis.roofline import Roofline as JRoofline
from repro.configs import list_archs
from repro.configs import smoke_config as jsmoke_config
from repro.launch.shapes import concrete_batch as jconcrete_batch
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import AxisRules
from repro.models import build_model as jbuild_model
from repro.models.common import tree_defs_init as jtree_defs_init
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import state_defs as jstate_defs
from repro_torch.analysis import step_stats
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import mha
from repro_torch.kernels.flash_attention.ref import attention_ref_flops
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_flops
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.shapes import concrete_batch
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.models.common import tree_defs_init, tree_map_defs
from repro_torch.optim import AdamWConfig, state_defs

RULES = AxisRules(fsdp_axes=(), dp_axes=())
B, T = 2, 64
ARCHS = list_archs()


@functools.lru_cache(maxsize=None)
def ref_flops(arch: str, kind: str, remat: str = "full") -> float:
    """``analyze_hlo(...).flops`` of the reference's compiled step."""
    cfg = jsmoke_config(arch).with_(dtype=jnp.float32, remat=remat)
    model = jbuild_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = jconcrete_batch(cfg, kind, B, T)
    if kind == "train":
        opt = JAdamWConfig()
        state = jtree_defs_init(jstate_defs(model.param_defs, opt),
                                jax.random.PRNGKey(1))
        lowered = jax.jit(jmake_train_step(model, RULES, opt)).lower(
            params, state, batch)
    else:
        caches = model.init_caches(B, T, cross_len=T)
        if kind == "prefill":
            lowered = jax.jit(jmake_prefill_step(model, RULES)).lower(
                params, batch, caches)
        else:
            lowered = jax.jit(jmake_decode_step(model, RULES)).lower(
                params, batch, caches, jnp.asarray(T - 1, jnp.int32))
    return analyze_hlo(lowered.compile().as_text()).flops


def _meta(defs):
    return tree_map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def port_stats(arch: str, kind: str, device: str, remat: str = "full"):
    """``step_stats`` of the port's step at the same config: on CPU
    tensors (the kernels' plain versions) or on ``meta`` tensors (their
    counting route)."""
    cfg = smoke_config(arch).with_(dtype=torch.float32, remat=remat)
    model = build_model(cfg)
    opt = AdamWConfig()
    batch = concrete_batch(cfg, kind, B, T, device="cpu")
    if device == "meta":
        params = _meta(model.param_defs)
        state = _meta(state_defs(model.param_defs, opt))
        caches = _meta(model.cache_defs(B, T, cross_len=T))
        batch = {k: torch.empty_like(v, device="meta")
                 for k, v in batch.items()}
    else:
        params = model.init(0, device="cpu")
        state = tree_defs_init(state_defs(model.param_defs, opt), None, "cpu")
        caches = model.init_caches(B, T, cross_len=T, device="cpu")
    if kind == "train":
        with step_stats() as stats:
            make_train_step(model, opt)(params, state, batch)
    else:
        with step_stats() as stats, torch.no_grad():
            if kind == "prefill":
                make_prefill_step(model)(params, batch, caches)
            else:
                make_decode_step(model)(params, batch, caches, T - 1)
    return stats


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_inference_flops_equal_analyze_hlo(arch, kind):
    assert port_stats(arch, kind, "cpu").flops == ref_flops(arch, kind)


@pytest.mark.parametrize("kind,remat", [("train", "none"), ("train", "full"),
                                        ("prefill", "full"),
                                        ("decode", "full")])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_route_counts_the_plain_versions_flops(arch, kind, remat):
    cpu = port_stats(arch, kind, "cpu", remat)
    meta = port_stats(arch, kind, "meta", remat)
    assert meta.flops == cpu.flops
    assert sum(meta.flops_by_op.values()) == meta.flops


def _inputs(shapes, device, wants):
    g = torch.Generator().manual_seed(0)
    out = []
    for shp, want in zip(shapes, wants):
        t = (torch.randn(shp, generator=g) if device == "cpu"
             else torch.empty(shp, device="meta"))
        out.append(t.requires_grad_(want))
    return out


@pytest.mark.parametrize("wants", [(True, True, True), (True, False, False),
                                   (False, True, True), (False, False, True)])
def test_mha_gradient_flops_on_both_routes(wants):
    """Autograd through ``attention_ref`` (CPU) and the meta route's
    backward count the same products, whichever inputs want a gradient;
    the formula says how many."""
    shapes = [(2, 24, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)]
    counts = []
    for device in ("cpu", "meta"):
        q, k, v = _inputs(shapes, device, wants)
        with step_stats() as stats:
            out = mha(q, k, v, causal=True, kv_len=33, q_offset=9)
            torch.autograd.grad(out.float().sum(),
                                [t for t in (q, k, v) if t.requires_grad],
                                allow_unused=True)
        counts.append(stats.flops)
    fwd = attention_ref_flops(2, 4, 24, 40, 16)
    assert counts[0] == counts[1] == fwd + attention_ref_flops(
        2, 4, 24, 40, 16, grads=wants)


@pytest.mark.parametrize("T_,chunk,state0,use", [
    (64, 16, False, "y"), (50, 16, True, "y"), (50, 16, True, "both"),
    (40, 16, False, "state"), (12, 16, True, "both")])
@pytest.mark.parametrize("wants", [(True,) * 5, (True, False, False,
                                                 False, False),
                                   (False, True, True, False, False),
                                   (False, False, False, True, True)])
def test_ssd_gradient_flops_on_both_routes(T_, chunk, state0, use, wants):
    """Autograd through ``ssd_chunked`` (CPU) and the meta route's
    backward count the same products: ragged T, one chunk, an initial
    state that wants a gradient, y, the final state or both in the
    loss."""
    Bb, H, P, G, N = 2, 4, 8, 2, 8
    shapes = [(Bb, T_, H, P), (Bb, T_, H), (H,), (Bb, T_, G, N),
              (Bb, T_, G, N), (Bb, H, P, N)]
    all_wants = wants + (state0,)
    counts = []
    for device in ("cpu", "meta"):
        x, dt, a, B_, C_, s0 = _inputs(shapes, device, all_wants)
        with step_stats() as stats:
            y, st = ssd(x, dt, a, B_, C_, chunk=chunk,
                        state0=s0 if state0 else None)
            loss = {"y": y.sum(), "state": st.sum(),
                    "both": y.sum() + st.sum()}[use]
            torch.autograd.grad(loss, [t for t in (x, dt, a, B_, C_, s0)
                                       if t.requires_grad],
                                allow_unused=True)
        counts.append(stats.flops)
    assert counts[0] == counts[1]
    assert counts[1] == ssd_chunked_flops(Bb, T_, H, P, N, chunk) + \
        ssd_chunked_flops(Bb, T_, H, P, N, chunk, grads=all_wants,
                          dy=use != "state", dstate=use != "y")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_linear_layer_by_hand(device):
    """x (8, 32) @ w^T (48, 32) + b: x, w and b read once, the output
    written once and the only tensor the step makes."""
    x, w, b = _inputs([(8, 32), (48, 32), (48,)], device, (False,) * 3)
    with step_stats() as stats:
        torch.nn.functional.linear(x, w, b)
    assert stats.flops == 2 * 8 * 32 * 48
    assert stats.hbm_bytes_kernel_adj == 4 * (8 * 32 + 48 * 32 + 48 + 8 * 48)
    assert stats.peak_bytes == 4 * 8 * 48
    assert stats.collective_bytes == 0


def test_composite_ops_count_under_inference_mode():
    """Under inference_mode an einsum reaches the counter whole (as the
    serving loop runs): its product is counted all the same."""
    x, w = _inputs([(2, 8, 16), (16, 24)], "cpu", (False, False))
    with torch.inference_mode(), step_stats() as stats:
        torch.einsum("btd,df->btf", x, w)
    assert stats.flops_by_op == {"aten.bmm": 2 * 2 * 8 * 16 * 24}


def test_mha_call_by_hand():
    """A meta mha call: q, k, v read once, the bf16 output written once
    and held; nothing inside the call counts."""
    Bb, S, H, D = 2, 64, 4, 32
    q, k, v = (torch.empty(Bb, S, H, D, dtype=torch.bfloat16, device="meta")
               for _ in range(3))
    with step_stats() as stats:
        out = mha(q, k, v, causal=True)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    one = 2 * Bb * S * H * D
    assert stats.hbm_bytes_kernel_adj == 4 * one
    assert stats.peak_bytes == one
    assert stats.flops == attention_ref_flops(Bb, H, S, S, D)
    assert stats.flops_by_op == {"flash_attention": stats.flops}


def test_ssd_call_by_hand():
    """A meta ssd call: x (bf16), dt, a, B_, C_ (bf16) read once, y and
    the final state (fp32) written once and held."""
    Bb, T_, H, P, G, N = 2, 100, 8, 16, 1, 32
    bf, f32 = torch.bfloat16, torch.float32
    x = torch.empty(Bb, T_, H, P, dtype=bf, device="meta")
    dt = torch.empty(Bb, T_, H, dtype=f32, device="meta")
    a = torch.empty(H, dtype=f32, device="meta")
    B_, C_ = (torch.empty(Bb, T_, G, N, dtype=bf, device="meta")
              for _ in range(2))
    with step_stats() as stats:
        y, st = ssd(x, dt, a, B_, C_, chunk=32)
    assert (y.shape, st.shape) == ((Bb, T_, H, P), (Bb, H, P, N))
    made = 4 * (Bb * T_ * H * P + Bb * H * P * N)
    read = 2 * Bb * T_ * H * P + 4 * (Bb * T_ * H + H) + 2 * 2 * Bb * T_ * N
    assert stats.hbm_bytes_kernel_adj == read + made
    assert stats.peak_bytes == made
    assert stats.flops == ssd_chunked_flops(Bb, T_, H, P, N, 32)


#: the keys of the JAX package's record (src/repro/launch/dryrun.py,
#: ``run_cell``) that the port's record carries; ``flops_by_op`` stands
#: where it has ``hlo_census``
REF_KEYS = {"arch", "shape", "mesh", "kind", "family", "status", "reason",
            "chips", "memory", "roofline", "params_total", "params_active"}


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-1.6b", "train_4k"), ("mamba2-1.3b", "prefill_32k"),
    ("qwen2-vl-7b", "decode_32k"), ("zamba2-1.2b", "long_500k"),
    ("qwen3-moe-30b-a3b", "prefill_32k"),
    ("seamless-m4t-large-v2", "train_4k")])
def test_run_cell_record_has_the_references_keys(arch, shape):
    rec = run_cell(arch, shape)
    assert rec["status"] == "ok" and rec["mesh"] == "h100x1"
    assert REF_KEYS | {"flops_by_op"} <= rec.keys()
    ref = JRoofline("a", "s", "m", 1, 1.0, 1.0, 0.0, 1.0, 1).to_dict()
    assert rec["roofline"].keys() == ref.keys()
    mem = rec["memory"]
    assert mem.keys() == {"argument_bytes", "temp_bytes",
                          "hbm_estimate_bytes", "fits_80gb"}
    assert mem["hbm_estimate_bytes"] == (mem["argument_bytes"]
                                         + mem["temp_bytes"])
    assert mem["fits_80gb"] == (mem["hbm_estimate_bytes"] < 80e9)
    assert rec["roofline"]["flops_per_device"] == sum(
        rec["flops_by_op"].values()) > 0
    assert rec["roofline"]["coll_bytes_per_device"] == 0
    assert math.isfinite(rec["roofline"]["step_time_s"])


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_skips_the_full_attention_archs(arch):
    rec = run_cell(arch, "long_500k")
    subquadratic = rec["family"] in ("ssm", "hybrid")
    assert rec["status"] == ("ok" if subquadratic else "skip")


@pytest.mark.parametrize("shape,axes,groups", [
    ((1, 1, 1), ("pod", "data", "model"), 1),
    ((16, 16), ("data", "model"), 16),
    ((2, 16, 16), ("pod", "data", "model"), 32)])
def test_moe_groups_are_the_dp_ranks_and_one_on_the_card(shape, axes,
                                                         groups):
    """``_moe_groups_for`` is the reference's rule (the product of the dp
    axes): 1 on the one card's mesh, so every MoE cell keeps one group
    and its record."""
    from repro_torch.launch.dryrun import (ARCH_DIST, _cell_config,
                                           _moe_groups_for)
    from repro_torch.launch.mesh import Mesh, make_rules
    mesh = Mesh(axes, shape, (0,) * len(shape))
    for arch in ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"):
        cfg = _cell_config(arch, ARCH_DIST[arch])
        assert _moe_groups_for(cfg, mesh, make_rules(mesh)) == groups
        assert cfg.moe_groups == 1
