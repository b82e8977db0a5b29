"""The port's sharded train step and checkpoints, in ``gloo`` processes on
the CPU, against the JAX package's one-device step.

Three spawns (``launch.mesh.spawn``: fresh processes meeting through a
``file://`` rendezvous under ``tmp_path``, no port bound, each joined
within 180 s):

* a (2, 2) ("data", "model") mesh of four processes takes one step of a
  dense (qwen2-7b), an ssm (mamba2-1.3b) and an encoder-decoder
  (seamless) smoke config in float32, with 2 microbatches and a mask
  that is not all ones.  Loss and the gathered gradients are held to the
  JAX package's one-device ``make_train_step`` (``AxisRules((), ())``,
  weights carried by ``repro_torch.convert``) at 1e-4 x max |.|, the
  models' bar (tests/test_torch_models.py), at unit score variance as
  tests/test_torch_train.py; ``grad_norm`` to the port's one-device step
  within 1e-6 relative; the updated weights to the port's one-device
  AdamW fed the same (gathered) gradients, at 1e-6 x max.
* two processes: MoE at ``moe_groups`` 0 (one group) on a (2, 1) mesh
  raises, one group not splitting over two dp ranks
  (tests/test_torch_moe_mesh.py runs MoE over groups); on a (1, 2) mesh
  it runs, each rank computing its 4 of the 8 experts and its 2 of the 4
  attention heads, its loss, grad norm and gathered gradients within
  1e-4 x max of the one-device step (the models' bar: the row-parallel
  sums add fp32 partials in another order,
  tests/test_torch_tp_train.py), and in float64 within 1e-12 x max.
* a (2, 2) mesh trains 3 steps and fails before the third; its last
  checkpoint restores through the one-process ``restore`` and onto a
  (1, 1) mesh bit for bit equal to the gathered state, and a one-process
  run resumed from it gives the uninterrupted run's losses at 1e-5.

The workers import no JAX (the children import this module); the JAX
side runs in the test process.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_mesh, make_rules, spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.common import tree_defs_init, tree_defs_to_specs
from repro_torch.optim import AdamWConfig, apply_updates, state_defs
from repro_torch.optim.adamw import leaves, unflatten

ARCHS = ("qwen2-7b", "mamba2-1.3b", "seamless-m4t-large-v2")
B, T, MICRO = 8, 16, 2
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def _cfg(arch):
    return smoke_config(arch).with_(dtype=torch.float32)


def _cfg64(arch):
    return _cfg(arch).with_(dtype=torch.float64, param_dtype=torch.float64)


def _batch64(batch):
    return {k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}


def _batch(cfg):
    batch = SyntheticLMData(cfg, seq=T, global_batch=B, seed=3,
                            device="cpu").batch(0)
    lengths = torch.tensor([16, 9, 12, 5, 16, 3, 11, 7])
    batch["mask"] = (torch.arange(T)[None] < lengths[:, None]).float()
    return batch


def _zero_state(model):
    return tree_defs_init(state_defs(model.param_defs, OPT), None, "cpu")


def _copy(tree):
    return unflatten(tree, [x.clone() for x in leaves(tree)])


def _gathered(tree, shardings):
    return [sharding.gather(x, sh).clone()
            for x, sh in zip(leaves(tree), leaves(shardings))]


def _step_worker(rank, device, inputs, out):
    """One sharded step of each config from the given global weights."""
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    rules = make_rules(mesh)
    results = {}
    for arch, (params, batch) in torch.load(inputs).items():
        model = build_model(_cfg(arch))
        psh = sharding.tree_shardings(model.param_specs(rules), mesh)
        local = unflatten(params, [sharding.shard(x, sh).clone()
                                   for x, sh in zip(leaves(params),
                                                    leaves(psh))])
        ssh = sharding.tree_shardings(
            tree_defs_to_specs(state_defs(model.param_defs, OPT), rules),
            mesh)
        state = sharding.init_local(state_defs(model.param_defs, OPT), None,
                                    device, ssh)
        step = make_train_step(model, OPT, MICRO, rules=rules, mesh=mesh,
                               keep_grads=True)
        p2, _, m = step(local, state,
                         sharding.local_batch(batch, mesh, rules, MICRO))
        results[arch] = {
            "metrics": {k: m[k] for k in ("loss", "xent", "aux",
                                          "grad_norm", "lr")},
            "grads": _gathered(m["grads"], psh),
            "params": _gathered(p2, psh),
            "local_grad_shapes": [tuple(g.shape)
                                  for g in leaves(m["grads"])],
            "bytes": dict(sharding.BYTES)}
    if rank == 0:
        torch.save(results, out)


def _moe_worker(rank, device, inputs, out):
    params, batch = torch.load(inputs)
    model = build_model(_cfg("qwen3-moe-30b-a3b"))
    wide = make_mesh((2, 1), ("data", "model"), device=device)
    try:
        make_train_step(model, OPT, rules=make_rules(wide), mesh=wide)
        raised = ""
    except ValueError as e:
        raised = str(e)
    mesh = make_mesh((1, 2), ("data", "model"), device=device)
    rules = make_rules(mesh)
    psh = sharding.tree_shardings(model.param_specs(rules), mesh)
    local = unflatten(params, [sharding.shard(x, sh).clone()
                               for x, sh in zip(leaves(params),
                                                leaves(psh))])
    ssh = sharding.tree_shardings(
        tree_defs_to_specs(state_defs(model.param_defs, OPT), rules), mesh)
    state = sharding.init_local(state_defs(model.param_defs, OPT), None,
                                device, ssh)
    step = make_train_step(model, OPT, rules=rules, mesh=mesh,
                           keep_grads=True)
    _, _, m = step(local, state, sharding.local_batch(batch, mesh, rules))
    grads = _gathered(m["grads"], psh)
    # the same step in float64
    model64 = build_model(_cfg64("qwen3-moe-30b-a3b"))
    # (the step updated ``local`` in place: the slices again)
    local64 = unflatten(params, [sharding.shard(x, sh).double()
                                 for x, sh in zip(leaves(params),
                                                  leaves(psh))])
    state64 = sharding.init_local(state_defs(model64.param_defs, OPT), None,
                                  device, ssh)
    _, _, m64 = make_train_step(model64, OPT, rules=rules, mesh=mesh,
                                keep_grads=True)(
        local64, state64,
        sharding.local_batch(_batch64(batch), mesh, rules))
    grads64 = _gathered(m64["grads"], psh)
    if rank == 0:
        torch.save({"raised": raised, "loss": m["loss"],
                    "grad_norm": m["grad_norm"], "grads": grads,
                    "loss64": m64["loss"], "grads64": grads64}, out)


def _ckpt_worker(rank, device, ckpt_dir, out):
    from repro_torch.launch.train import InjectedFailure, train
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    rules = make_rules(mesh)
    cfg = _cfg("qwen2-7b")
    try:
        train(cfg, steps=3, seq=T, global_batch=B, ckpt_dir=ckpt_dir,
              ckpt_every=1, mesh=mesh, rules=rules, opt_cfg=OPT,
              fail_at_step=2, seed=0, microbatches=MICRO)
    except InjectedFailure:
        pass
    # the state the checkpoint holds, gathered from this run's slices
    from repro_torch.checkpoint import restore
    model = build_model(cfg)
    tree_sh = sharding.tree_shardings(
        {"params": model.param_specs(rules),
         "opt": tree_defs_to_specs(state_defs(model.param_defs, OPT),
                                   rules)}, mesh)
    state, _ = restore(ckpt_dir, device=device, shardings=tree_sh)
    gathered = _gathered(state, tree_sh)
    if rank == 0:
        torch.save(gathered, out)


def _run(tmp_path, fn, nprocs, *args):
    spawn(fn, nprocs, args, rendezvous=tmp_path / f"rdv_{fn.__name__}",
          backend="gloo", device="cpu", timeout_s=180)


def _rel(out, ref) -> float:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _unit_score_scale(tree, s):
    return {k: (_unit_score_scale(v, s) if isinstance(v, dict)
                else v * s if k in ("wq", "wk") else v)
            for k, v in tree.items()}


def test_two_by_two_step_matches_the_jax_one_device_step(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.models import AxisRules, build_model as jax_build_model
    from repro.models.common import tree_defs_init as jax_tree_defs_init
    from repro.optim import AdamWConfig as JaxAdamWConfig
    from repro.optim import state_defs as jax_state_defs
    from repro_torch.convert import params_from_jax

    jrules = AxisRules(fsdp_axes=(), dp_axes=())
    jopt = JaxAdamWConfig(lr=OPT.lr, warmup_steps=OPT.warmup_steps,
                          total_steps=OPT.total_steps)
    inputs, refs = {}, {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32)
        cfg = _cfg(arch)
        jmodel = jax_build_model(jcfg)
        jparams = _unit_score_scale(jmodel.init(jax.random.PRNGKey(0)),
                                    jcfg.resolved_head_dim() ** -0.5)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
        batch = _batch(cfg)
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        jstate = jax_tree_defs_init(jax_state_defs(jmodel.param_defs, jopt),
                                    jax.random.PRNGKey(1))
        _, _, jm = jax.jit(jax_make_train_step(jmodel, jrules, jopt,
                                               MICRO))(jparams, jstate,
                                                       jbatch)

        def mb_grads(p):
            gs = []
            for i in range(MICRO):
                mb = {k: v[i * B // MICRO:(i + 1) * B // MICRO]
                      for k, v in jbatch.items()}
                gs.append(jax.grad(lambda q: jmodel.loss(q, mb, jrules)[0])(p))
            return jax.tree.map(lambda a, b: (a + b) / MICRO, *gs)
        jgrads = jax.tree.leaves(jax.jit(mb_grads)(jparams))
        # the port's one-device step on the same inputs
        model = build_model(cfg)
        one = make_train_step(model, OPT, MICRO, keep_grads=True)
        _, _, m1 = one(_copy(params), _zero_state(model), batch)
        refs[arch] = (jm, jgrads, m1)
        inputs[arch] = (params, batch)
    torch.save(inputs, tmp_path / "inputs.pt")
    _run(tmp_path, _step_worker, 4, tmp_path / "inputs.pt",
         tmp_path / "out.pt")
    out = torch.load(tmp_path / "out.pt")
    for arch in ARCHS:
        jm, jgrads, m1 = refs[arch]
        r = out[arch]
        m = r["metrics"]
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-4 * abs(float(jm["loss"])), arch
        assert abs(float(m["xent"]) - float(jm["xent"])) <= \
            1e-4 * abs(float(jm["xent"])), arch
        assert float(m["aux"]) == float(jm["aux"]) == 0.0
        assert abs(float(m["grad_norm"]) - float(m1["grad_norm"])) <= \
            1e-6 * float(m1["grad_norm"]), arch
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"]), arch
        assert len(r["grads"]) == len(jgrads)
        for g, jg in zip(r["grads"], jgrads):
            assert g.shape == jg.shape
            assert _rel(g.numpy(), jg) <= 1e-4, (arch, _rel(g.numpy(), jg))
        # some leaves were sharded: their local slices are smaller
        model = build_model(_cfg(arch))
        full = [tuple(x.shape) for x in r["grads"]]
        assert any(loc != f for loc, f in zip(r["local_grad_shapes"], full))
        assert r["bytes"].get("reduce_scatter", 0) > 0
        assert r["bytes"].get("all_gather", 0) > 0
        # the update: the one-device AdamW fed the gathered gradients
        ref_p = _copy(inputs[arch][0])
        apply_updates(ref_p, unflatten(ref_p, r["grads"]),
                      _zero_state(model), OPT)
        for p, q in zip(r["params"], leaves(ref_p)):
            assert _rel(p.numpy(), q.numpy()) <= 1e-6, arch


def test_moe_raises_over_dp_and_runs_over_model(tmp_path):
    cfg = _cfg("qwen3-moe-30b-a3b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = _batch(cfg)
    torch.save((params, batch), tmp_path / "inputs.pt")
    _run(tmp_path, _moe_worker, 2, tmp_path / "inputs.pt",
         tmp_path / "out.pt")
    out = torch.load(tmp_path / "out.pt")
    assert "do not split over the 2 ranks" in out["raised"]
    one = make_train_step(model, OPT, keep_grads=True)
    _, _, m = one(_copy(params), _zero_state(model), batch)
    assert abs(float(out["loss"]) - float(m["loss"])) <= \
        1e-4 * abs(float(m["loss"]))
    assert abs(float(out["grad_norm"]) - float(m["grad_norm"])) <= \
        1e-4 * float(m["grad_norm"])
    for g, ref in zip(out["grads"], leaves(m["grads"])):
        assert _rel(g.numpy(), ref.numpy()) <= 1e-4
    # float64: the order of the sums alone
    model64 = build_model(_cfg64("qwen3-moe-30b-a3b"))
    _, _, m64 = make_train_step(model64, OPT, keep_grads=True)(
        unflatten(params, [x.double() for x in leaves(params)]),
        tree_defs_init(state_defs(model64.param_defs, OPT), None, "cpu"),
        _batch64(batch))
    assert abs(float(out["loss64"]) - float(m64["loss"])) <= \
        1e-12 * abs(float(m64["loss"]))
    for g, ref in zip(out["grads64"], leaves(m64["grads"])):
        assert g.dtype == torch.float64
        assert _rel(g.numpy(), ref.numpy()) <= 1e-12


def test_checkpoint_of_a_mesh_restores_anywhere(tmp_path):
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.launch.train import train

    ckpt = tmp_path / "ckpt"
    _run(tmp_path, _ckpt_worker, 4, ckpt, tmp_path / "out.pt")
    gathered = torch.load(tmp_path / "out.pt")
    assert latest_step(ckpt) == 1
    cfg = _cfg("qwen2-7b")
    model = build_model(cfg)
    whole, manifest = restore(ckpt, device="cpu")
    assert manifest["step"] == 1
    assert len(leaves(whole)) == len(gathered)
    for a, b in zip(leaves(whole), gathered):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    rules = make_rules(mesh)
    tree_sh = sharding.tree_shardings(
        {"params": model.param_specs(rules),
         "opt": tree_defs_to_specs(state_defs(model.param_defs, OPT),
                                   rules)}, mesh)
    one, _ = restore(ckpt, device="cpu", shardings=tree_sh)
    for a, b in zip(leaves(one), gathered):
        assert torch.equal(a, b)
    # elastic: the (2, 2) run's checkpoint resumed by one process
    kw = dict(steps=3, seq=T, global_batch=B, opt_cfg=OPT, seed=0,
              microbatches=MICRO, device="cpu")
    resumed = train(cfg, ckpt_dir=ckpt, mesh=mesh, rules=rules, **kw)
    straight = train(cfg, **kw)
    assert resumed.steps_run == 1 and resumed.final_step == 2
    assert math.isclose(resumed.losses[-1], straight.losses[-1],
                        rel_tol=1e-5)
