"""The port's training path against the JAX package's, on the CPU.

Inputs come from numpy seeds (parameters from the JAX model's init,
carried across with ``params_from_jax``; batches from the two
``SyntheticLMData``, which are equal) and go through both packages.

Tolerances:
* loss and every gradient leaf at float32 activations: 1e-4 x the JAX
  value's max |.| (the models' bar, tests/test_torch_models.py), with the
  attention weights at unit score variance (``wq`` and ``wk`` scaled by
  head_dim**-0.5, as ``test_torch_families.py``): the init's scores have
  std 8 at the smoke widths, near one-hot softmax, where fp32 rounding
  alone moves seamless's gradients by 1.1e-4 (measured; 1.3e-6 at unit
  variance).  On the CPU the attention and the SSD scan are their plain
  versions, which autograd differentiates.
* the train step (AdamW after the gradients): 1e-4 x max |param| on the
  parameters after the step, 1e-5 relative on the loss and grad norm.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import list_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.data import SyntheticLMData as JaxData
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import AxisRules
from repro.models import ModelConfig as JaxModelConfig
from repro.models import MoEConfig as JaxMoEConfig
from repro.models import build_model as jax_build_model
from repro.models.common import tree_defs_init as jax_tree_defs_init
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import moe_def as jax_moe_def
from repro.models.transformer import chunked_xent as jax_chunked_xent
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import state_defs as jax_state_defs
from repro_torch.configs import smoke_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import SyntheticLMData
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig, MoEConfig, tree_defs_init
from repro_torch.models.moe import apply_moe, moe_def
from repro_torch.models.transformer import chunked_xent
from repro_torch.optim import AdamWConfig, state_defs
from repro_torch.optim.adamw import leaves

RULES = AxisRules(fsdp_axes=(), dp_axes=())
B, T = 2, 24


def _unit_score_scale(tree, s):
    return {k: (_unit_score_scale(v, s) if isinstance(v, dict)
                else v * s if k in ("wq", "wk") else v)
            for k, v in tree.items()}


def _both(arch, dtype=(jnp.float32, torch.float32), **kw):
    """(JAX cfg, model, params; port cfg, model, params) at unit score
    variance, the same values on both sides."""
    jcfg = jax_smoke_config(arch).with_(dtype=dtype[0], **kw)
    cfg = smoke_config(arch).with_(dtype=dtype[1], **kw)
    jmodel = jax_build_model(jcfg)
    jparams = _unit_score_scale(jmodel.init(jax.random.PRNGKey(0)),
                                jcfg.resolved_head_dim() ** -0.5)
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params


def _grads(model, params, batch):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    return loss.detach(), metrics, grads


def _rel(out, ref) -> float:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_every_gradient_leaf_match_jax(arch):
    jcfg, jmodel, jparams, cfg, model, params = _both(arch)
    jbatch = JaxData(jcfg, seq=T, global_batch=B, seed=1).batch(0)
    batch = SyntheticLMData(cfg, seq=T, global_batch=B, seed=1,
                            device="cpu").batch(0)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, RULES), has_aux=True)(jparams)
    loss, metrics, grads = _grads(model, params, batch)
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    for name in ("xent", "aux"):
        assert abs(float(metrics[name]) - float(jmet[name])) <= \
            1e-4 * max(abs(float(jmet[name])), 1e-30), name
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for path, g, jg in zip(paths, grads, jleaves):
        assert g.shape == jg.shape, path
        assert _rel(g.numpy(), jg) <= 1e-4, (path, _rel(g.numpy(), jg))
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_moe_aux_loss_enters_the_loss():
    """lm_loss = xent + 0.01 x the sum of the MoE units' aux losses."""
    *_, cfg, model, params = _both("qwen3-moe-30b-a3b")
    batch = SyntheticLMData(cfg, seq=T, global_batch=B, seed=1,
                            device="cpu").batch(0)
    loss, metrics = model.loss(params, batch)
    assert float(metrics["aux"]) > 0.5 * cfg.n_layers
    torch.testing.assert_close(loss, metrics["xent"] + 0.01 * metrics["aux"])


@pytest.mark.parametrize("T_,C,masked", [(70, 32, True), (64, 32, False),
                                         (20, 64, True)])
def test_chunked_xent_matches_jax_with_a_padded_last_chunk(T_, C, masked):
    """T 70 in chunks of 32: the last chunk holds 6 tokens and 26 of
    padding; T 20 < C: one chunk of T.  Values and the gradients of h and
    the unembedding, fp32, 1e-5 relative."""
    rng = np.random.default_rng(3)
    d, V = 16, 50
    h = rng.normal(0, 1, (2, T_, d)).astype(np.float32)
    w = rng.normal(0, 0.3, (d, V)).astype(np.float32)
    labels = rng.integers(0, V, (2, T_)).astype(np.int32)
    mask = (rng.random((2, T_)) > 0.3 if masked
            else np.ones((2, T_))).astype(np.float32)
    jcfg = jax_smoke_config("stablelm-1.6b").with_(dtype=jnp.float32,
                                                   xent_chunk=C)
    cfg = smoke_config("stablelm-1.6b").with_(dtype=torch.float32,
                                              xent_chunk=C)
    jval, (jgh, jgw) = jax.value_and_grad(
        lambda h_, w_: jax_chunked_xent(h_, w_, jnp.asarray(labels),
                                        jnp.asarray(mask), jcfg, RULES),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    val = chunked_xent(th, tw, torch.from_numpy(labels),
                       torch.from_numpy(mask), cfg)
    gh, gw = torch.autograd.grad(val, (th, tw))
    assert abs(float(val) - float(jval)) <= 1e-5 * abs(float(jval))
    assert _rel(gh.numpy(), jgh) <= 1e-5
    assert _rel(gw.numpy(), jgw) <= 1e-5


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_number(remat):
    """Checkpointing recomputes the same values: loss and gradients equal
    bit for bit to remat "none" (dense and moe units)."""
    for arch in ("stablelm-1.6b", "qwen3-moe-30b-a3b"):
        *_, cfg, model, params = _both(arch, remat="none")
        batch = SyntheticLMData(cfg, seq=T, global_batch=B, seed=2,
                                device="cpu").batch(0)
        ref = _grads(model, params, batch)
        out = _grads(build_model(cfg.with_(remat=remat)), params, batch)
        assert torch.equal(out[0], ref[0])
        for g, r in zip(out[2], ref[2]):
            assert torch.equal(g, r)


@pytest.mark.parametrize("microbatches,grad_dtype", [
    (1, None), (2, None), (2, "bfloat16")])
def test_train_step_matches_jax(microbatches, grad_dtype):
    """One train step (loss, grads, clip, AdamW) from the same params,
    state and batch: the loss, the grad norm and the parameters after the
    step."""
    jcfg, jmodel, jparams, cfg, model, params = _both("stablelm-1.6b")
    jopt = JaxAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstate = jax_tree_defs_init(jax_state_defs(jmodel.param_defs, jopt),
                                jax.random.PRNGKey(1))
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, opt,
                               device="cpu")
    jbatch = JaxData(jcfg, seq=T, global_batch=4, seed=4).batch(0)
    batch = SyntheticLMData(cfg, seq=T, global_batch=4, seed=4,
                            device="cpu").batch(0)
    jgd = None if grad_dtype is None else jnp.bfloat16
    gd = None if grad_dtype is None else torch.bfloat16
    jstep = jax.jit(jax_make_train_step(jmodel, RULES, jopt, microbatches,
                                        jgd))
    jp2, js2, jm = jstep(jparams, jstate, jbatch)
    step = make_train_step(model, opt, microbatches, gd)
    p2, s2, m = step(params, state, batch)
    for k in ("loss", "grad_norm", "lr", "xent"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    assert int(s2["step"]) == int(js2["step"]) == 1
    for path_p, jp, p in zip(jax.tree_util.tree_flatten_with_path(jp2)[0],
                             jax.tree.leaves(jp2), leaves(p2)):
        assert _rel(p.detach().numpy(), jp) <= 1e-4, path_p[0]


def test_train_step_raises_on_a_leaf_without_gradient():
    """A parameter with no path to the loss (as a kernel with no backward
    would leave wq) stops the step instead of training on a zero
    gradient."""
    cfg = smoke_config("stablelm-1.6b").with_(dtype=torch.float32)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    params = model.init(0, device="cpu")
    state = tree_defs_init(state_defs(model.param_defs, opt),
                           torch.Generator().manual_seed(1), "cpu")
    batch = SyntheticLMData(cfg, seq=T, global_batch=2, seed=4,
                            device="cpu").batch(0)
    step = make_train_step(model, opt)
    orphan = {**params, "orphan": torch.zeros(4)}
    with pytest.raises(RuntimeError, match="not have been used"):
        step(orphan, state, batch)
    before = [p.clone() for p in leaves(params)]
    params, state, m = step(params, state, batch)
    assert math.isfinite(float(m["loss"]))
    assert all(not torch.equal(p, b) for p, b in zip(leaves(params), before)
               if p.dim() >= 2)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-vl-7b",
                                  "qwen3-moe-30b-a3b", "mamba2-1.3b",
                                  "zamba2-1.2b", "seamless-m4t-large-v2"])
def test_synthetic_lm_data_equals_jax(arch):
    """dense, vlm, moe, ssm, hybrid, encdec: every key, value for value,
    also for a host's slice."""
    for host, count in ((0, 1), (1, 2)):
        ref = JaxData(jax_smoke_config(arch), seq=40, global_batch=4,
                      seed=3).batch(7, host, count)
        out = SyntheticLMData(smoke_config(arch), seq=40, global_batch=4,
                              seed=3, device="cpu").batch(7, host, count)
        assert sorted(out) == sorted(ref)
        for k, v in ref.items():
            jv = np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                            else v)
            tv = out[k].float() if out[k].dtype == torch.bfloat16 else out[k]
            assert str(out[k].dtype).split(".")[1] == str(v.dtype), k
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=k)


def test_small_lm_learns():
    """Twin of tests/test_training_convergence.py on the port: the same
    config, optimizer, data and thresholds."""
    cfg = ModelConfig(arch="conv-test", family="dense", n_layers=2,
                      d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
                      vocab=2048, head_dim=32, norm="rmsnorm", act="swiglu",
                      attn_chunk=64, xent_chunk=64, remat="full")
    model = build_model(cfg)
    opt = AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=100,
                      schedule="constant")
    params = model.init(0, device="cpu")
    state = tree_defs_init(state_defs(model.param_defs, opt),
                           torch.Generator().manual_seed(1), "cpu")
    data = SyntheticLMData(cfg, seq=64, global_batch=8, seed=0, device="cpu")
    step = make_train_step(model, opt)
    first = None
    for i in range(40):
        params, state, m = step(params, state, data.batch(i))
        if first is None:
            first = float(m["loss"])
    last = float(m["loss"])
    uniform = math.log(cfg.vocab)
    assert first > uniform - 1.0
    assert last < first - 1.5, (first, last)
    assert last < uniform - 1.0


def test_moe_gradients_reach_all_params():
    """Twin of tests/test_moe.py's: every leaf of the MoE block gets a
    gradient, and each equals the JAX package's (fp32, 1e-4 x max)."""
    jcfg = JaxModelConfig(arch="t", family="moe", n_layers=1, d_model=32,
                          n_heads=4, n_kv_heads=4, d_ff=32, vocab=64,
                          head_dim=8,
                          moe=JaxMoEConfig(n_experts=8, top_k=2,
                                           d_ff_expert=32))
    cfg = ModelConfig(arch="t", family="moe", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=4, d_ff=32, vocab=64, head_dim=8,
                      moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32),
                      dtype=torch.float32)
    jcfg = jcfg.with_(dtype=jnp.float32)
    jparams = jax_tree_defs_init(jax_moe_def(jcfg), jax.random.PRNGKey(0))
    x = np.random.default_rng(1).normal(0, 1, (2, 32, 32)).astype(np.float32)

    def jloss(p):
        out, aux = jax_apply_moe(p, jnp.asarray(x), jcfg, RULES)
        return jnp.mean(out ** 2) + 0.01 * aux
    jg = jax.grad(jloss)(jparams)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in jparams.items()}
    assert set(params) == set(moe_def(cfg))
    out, aux = apply_moe(params, torch.from_numpy(x), cfg)
    loss = torch.mean(out ** 2) + 0.01 * aux
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    for k, g in zip(names, grads):
        assert float(g.abs().sum()) > 0, k
        assert _rel(g.numpy(), jg[k]) <= 1e-4, k
