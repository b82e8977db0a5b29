"""MoE over groups on ("data", "model") meshes of gloo processes on the
CPU: each rank's token groups over dp and its experts over "model"
(``repro_torch.models.moe``, ``launch.steps.make_train_step``).

One module-scoped spawn of four gloo processes (``launch.mesh.spawn``, a
``file://`` rendezvous, joined within 180 s; the references are computed
in this process meanwhile) forms the (2, 2), (4, 1) and
(1, 4) meshes in turn.  On each, every rank takes one sharded step of the
smoke configs of qwen3-moe-30b-a3b (8 experts, top-2) and
llama4-maverick-400b-a17b (8 experts, top-1, a shared expert, MoE every
2nd layer) at ``moe_groups`` = dp, from the same global weights, in
float32, with 2 microbatches, a mask that is not all ones and unit score
variance (tests/test_torch_sharded_train.py's batch).  (2, 2) also runs
qwen3-moe at G = 2 dp, and at G = dp with ``capacity_factor`` 0.5, where
the capacity drops assignments and the per-group C decides the answer.

* Loss, xent, aux and the gathered gradients are held to the JAX
  package's unsharded ``Model.loss`` and ``jax.grad`` of the whole batch
  at the same ``moe_groups`` (``AxisRules((), ())``, weights carried by
  ``repro_torch.convert``) at 1e-4 x max |.|, the models' bar.  The
  reference's own ``apply_moe`` does not run on a mesh of JAX 0.9.0's
  default axis types (ROADMAP Queue C), so the unsharded loss is what
  GSPMD's layout promises to equal.
* Against the port's one-process step at the same G: on (1, 4) the loss,
  xent, aux and gathered gradients within 1e-4 x max |.| (the models'
  bar: attention is split over "model" too, and its row-parallel sums
  add fp32 partials in another order, tests/test_torch_tp_train.py), and
  in float64 within 1e-12 x max; with dp > 1 ``grad_norm`` within 1e-6
  relative.  The updated weights, on every
  mesh, within 1e-6 x max of the one-process AdamW fed the gathered
  gradients (the update itself; a gradient element near zero may change
  its sign at the rounding level, and AdamW's first step follows it).
* What a rank holds: each expert leaf's local slice, the expert leaves the
  forward sees and the gradients hold E/tp experts, and the expert
  leaves' gathers (``sharding.BYTES["all_gather_experts"]``) move 1/tp of
  a whole gather; the exchange over "model" runs only where tp > 1.
* A checkpoint of the (2, 2) step's updated parameters and AdamW state
  (``save_sharded``) restores whole in one process and onto the (1, 4)
  mesh (``restore(shardings=)``, each rank E/4 experts) bit for bit equal
  to the gathered state.
* The raises: ``make_train_step`` for a G that is not a multiple of dp
  (``moe_groups`` 0, read as one group, and 3 on (2, 2)), and the step
  for a microbatch whose tokens fall back to one group while dp > 1.

The workers import no JAX (the children import this module); the JAX
side runs in the test process.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_mesh, make_rules, spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.common import tree_defs_init, tree_defs_to_specs
from repro_torch.optim import AdamWConfig, apply_updates, state_defs
from repro_torch.optim.adamw import leaves, unflatten

ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
B, T, MICRO = 8, 16, 2
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
MESHES = ((2, 2), (4, 1), (1, 4))
#: (mesh, arch, moe_groups, capacity factor or None for the config's)
CASES = tuple((shape, arch, shape[0], None)
              for shape in MESHES for arch in ARCHS) + (
    ((2, 2), ARCHS[0], 4, None), ((2, 2), ARCHS[0], 2, 0.5))
EXPERT_LEAVES = ("wd", "wg", "wu")
#: the case whose updated state is saved as a checkpoint of its mesh
CKPT = CASES[0]


def _cfg(arch, groups, cf=None, dtype=torch.float32):
    cfg = smoke_config(arch).with_(dtype=dtype, moe_groups=groups)
    if dtype == torch.float64:
        cfg = cfg.with_(param_dtype=dtype)
    if cf is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _batch(cfg, seq=T):
    batch = SyntheticLMData(cfg, seq=seq, global_batch=B, seed=3,
                            device="cpu").batch(0)
    lengths = torch.tensor([16, 9, 12, 5, 16, 3, 11, 7]).clamp(max=seq)
    batch["mask"] = (torch.arange(seq)[None] < lengths[:, None]).float()
    return batch


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    return tree.double() if tree.is_floating_point() else tree


def _zero_state(model):
    return tree_defs_init(state_defs(model.param_defs, OPT), None, "cpu")


def _copy(tree):
    return unflatten(tree, [x.clone() for x in leaves(tree)])


def _paths(tree, prefix=()):
    """Each leaf's key path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _is_expert(path) -> bool:
    return len(path) >= 2 and path[-2] == "moe" and path[-1] in EXPERT_LEAVES


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _state_shardings(model, rules, mesh):
    return sharding.tree_shardings(
        {"params": model.param_specs(rules),
         "opt": tree_defs_to_specs(state_defs(model.param_defs, OPT),
                                   rules)}, mesh)


def _case_on(rank_mesh, rules, device, arch, groups, cf, params, batch,
             ckpt=None, dtype=torch.float32):
    """One sharded step of a case on this rank: what the tests read.
    With ``ckpt``, the updated parameters and AdamW state are saved there
    as a checkpoint of the mesh (``save_sharded``)."""
    cfg = _cfg(arch, groups, cf, dtype)
    model = build_model(cfg)
    psh = sharding.tree_shardings(model.param_specs(rules), rank_mesh)
    local = unflatten(params, [sharding.shard(x, sh).clone()
                               for x, sh in zip(leaves(params),
                                                leaves(psh))])
    ssh = sharding.tree_shardings(
        tree_defs_to_specs(state_defs(model.param_defs, OPT), rules),
        rank_mesh)
    state = sharding.init_local(state_defs(model.param_defs, OPT), None,
                                device, ssh)
    step = make_train_step(model, OPT, MICRO, rules=rules, mesh=rank_mesh,
                           keep_grads=True)
    seen = []
    apply_moe = transformer.apply_moe

    def recording(p, *args):
        seen.append(tuple(p["wg"].shape))
        return apply_moe(p, *args)
    transformer.apply_moe = recording
    sharding.reset_counts()
    try:
        p2, s2, m = step(local, state,
                         sharding.local_batch(batch, rank_mesh, rules, MICRO))
    finally:
        transformer.apply_moe = apply_moe
    if ckpt is not None:
        from repro_torch.checkpoint.store import save_sharded
        save_sharded(ckpt, 1, {"params": p2, "opt": s2},
                     _state_shardings(model, rules, rank_mesh))
    return {"metrics": {k: m[k] for k in ("loss", "xent", "aux",
                                          "grad_norm")},
            "grads": [sharding.gather(g, sh).clone()
                      for g, sh in zip(leaves(m["grads"]), leaves(psh))],
            "params": [sharding.gather(x, sh).clone()
                       for x, sh in zip(leaves(p2), leaves(psh))],
            "local_shapes": [tuple(x.shape) for x in leaves(local)],
            "grad_shapes": [tuple(g.shape) for g in leaves(m["grads"])],
            "forward_wg": seen,
            "bytes": dict(sharding.BYTES), "calls": dict(sharding.CALLS)}


def _moe_mesh_worker(rank, device, inputs, out_dir):
    from repro_torch.checkpoint import restore
    params, batch = torch.load(inputs)
    results = {}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), device=device)
        rules = make_rules(mesh)
        for case in CASES:
            if case[0] == shape:
                _, arch, groups, cf = case
                results[case] = _case_on(
                    mesh, rules, device, arch, groups, cf, params[arch],
                    batch[arch], out_dir / "ckpt" if case == CKPT else None)
                if shape[0] == 1:
                    results[case, "f64"] = _case_on(
                        mesh, rules, device, arch, groups, cf,
                        _f64(params[arch]), _f64(batch[arch]),
                        dtype=torch.float64)
        if shape == (1, 4):
            # the (2, 2) step's checkpoint restored onto this mesh
            tree_sh = _state_shardings(build_model(_cfg(*CKPT[1:])), rules,
                                       mesh)
            state, _ = restore(out_dir / "ckpt", device=device,
                               shardings=tree_sh)
            results["restored"] = {
                "local_shapes": [tuple(x.shape) for x in leaves(state)],
                "gathered": [sharding.gather(x, sh).clone() for x, sh in
                             zip(leaves(state), leaves(tree_sh))]}
        if shape == (2, 2):
            arch = ARCHS[0]
            errors = [_raises(lambda g=g: make_train_step(
                build_model(_cfg(arch, g)), OPT, MICRO, rules=rules,
                mesh=mesh)) for g in (0, 3)]
            # 4 rows x 1 token a microbatch: 2 tokens a group, fewer than
            # E/K = 4, so the reference takes one group
            short = {k: v[:, :1] for k, v in batch[arch].items()}
            errors.append(_raises(lambda: _case_on(
                mesh, rules, device, arch, 2, None, params[arch], short)))
            results["errors"] = errors
        results[shape, "coords"] = mesh.coords
    torch.save(results, out_dir / f"rank{rank}.pt")


def _unit_score_scale(tree, s):
    return {k: (_unit_score_scale(v, s) if isinstance(v, dict)
                else v * s if k in ("wq", "wk") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX package's weights (unit score variance) of each arch, as
    numpy and as the port's params, and each arch's batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    from repro_torch.convert import params_from_jax

    jparams, params, batches = {}, {}, {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32)
        jmodel = jax_build_model(jcfg)
        jp = _unit_score_scale(jmodel.init(jax.random.PRNGKey(0)),
                               jcfg.resolved_head_dim() ** -0.5)
        jparams[arch] = jax.tree.map(np.asarray, jp)
        params[arch] = params_from_jax(jparams[arch], _cfg(arch, 1),
                                       device="cpu")
        batches[arch] = _batch(_cfg(arch, 1))
    path = tmp_path_factory.mktemp("moe_mesh_in") / "inputs.pt"
    torch.save((params, batches), path)
    return jparams, params, batches, path


def _jax_refs(inputs):
    """The JAX package's unsharded loss, xent, aux (means over the
    microbatches) and gradients (their mean) of each (arch, G, cf)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import AxisRules
    from repro.models import build_model as jax_build_model

    jparams, _, batches, _ = inputs
    rules = AxisRules(fsdp_axes=(), dp_axes=())
    refs = {}
    for _, arch, groups, cf in CASES:
        if (arch, groups, cf) in refs:
            continue
        jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32,
                                            moe_groups=groups)
        if cf is not None:
            jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                                      capacity_factor=cf))
        jmodel = jax_build_model(jcfg)
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batches[arch].items()}

        def mb_loss_grads(p, jmodel=jmodel, jbatch=jbatch):
            outs = []
            for i in range(MICRO):
                mb = {k: v[i * B // MICRO:(i + 1) * B // MICRO]
                      for k, v in jbatch.items()}
                (loss, met), g = jax.value_and_grad(
                    lambda q: jmodel.loss(q, mb, rules), has_aux=True)(p)
                outs.append((loss, met["xent"], met["aux"], g))
            mean = jax.tree.map(lambda *xs: sum(xs) / MICRO, *outs)
            return mean
        loss, xent, aux, g = jax.jit(mb_loss_grads)(jparams[arch])
        refs[arch, groups, cf] = (
            float(loss), float(xent), float(aux),
            [np.asarray(x) for x in jax.tree.leaves(g)])
    return refs


def _port_refs(inputs):
    """The port's one-process step of each (arch, G, cf): its metrics,
    gradients and the dropped assignments its routers counted."""
    _, params, batches, _ = inputs
    refs = {}
    route = moe.route
    for _, arch, groups, cf in CASES:
        if (arch, groups, cf) in refs:
            continue
        dropped = []

        def counting(*args):
            out = route(*args)
            dropped.append(int((~out[3]).sum()))
            return out
        model = build_model(_cfg(arch, groups, cf))
        step = make_train_step(model, OPT, MICRO, keep_grads=True)
        moe.route = counting
        try:
            _, _, m = step(_copy(params[arch]), _zero_state(model),
                           batches[arch])
        finally:
            moe.route = route
        refs[arch, groups, cf] = (m, leaves(m["grads"]), sum(dropped))
    return refs


@pytest.fixture(scope="module")
def runs(inputs):
    """(each rank's results of the four-process run, ``_jax_refs``,
    ``_port_refs``): the references are computed while the ranks run."""
    out = inputs[3].parent
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn, _moe_mesh_worker, 4, (inputs[3], out),
                          rendezvous=out / "rendezvous", backend="gloo",
                          device="cpu", timeout_s=180)
        refs = _jax_refs(inputs), _port_refs(inputs)
        job.result()
    return ([torch.load(out / f"rank{r}.pt") for r in range(4)],) + refs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_refs(runs):
    return runs[1]


@pytest.fixture(scope="module")
def port_refs(runs):
    return runs[2]


def _rel(out, ref) -> float:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _ids(case):
    shape, arch, groups, cf = case
    return (f"{shape[0]}x{shape[1]}-{arch.split('-')[0]}-G{groups}"
            + ("" if cf is None else f"-cf{cf}"))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_step_matches_the_jax_unsharded_loss_and_gradient(case, ranks,
                                                          jax_refs):
    _, arch, groups, cf = case
    jloss, jxent, jaux, jgrads = jax_refs[arch, groups, cf]
    for r, rank in enumerate(ranks):
        out = rank[case]
        m = out["metrics"]
        for name, ref in (("loss", jloss), ("xent", jxent), ("aux", jaux)):
            assert abs(float(m[name]) - ref) <= 1e-4 * abs(ref), \
                (r, name, float(m[name]), ref)
        assert len(out["grads"]) == len(jgrads)
        for g, jg in zip(out["grads"], jgrads):
            assert g.shape == jg.shape
            assert _rel(g.numpy(), jg) <= 1e-4, (r, _rel(g.numpy(), jg))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_step_against_the_one_process_step(case, ranks, inputs, port_refs):
    shape, arch, groups, cf = case
    m1, g1, _ = port_refs[arch, groups, cf]
    model = build_model(_cfg(arch, groups, cf))
    for r, rank in enumerate(ranks):
        out = rank[case]
        m = out["metrics"]
        if shape[0] == 1:
            # no dp sum: each rank computes its experts and its attention
            # heads of the same rows
            for name in ("loss", "xent", "aux"):
                assert abs(float(m[name]) - float(m1[name])) <= \
                    1e-4 * abs(float(m1[name])), (r, name)
            for g, ref in zip(out["grads"], g1):
                assert _rel(g.numpy(), ref.numpy()) <= 1e-4, r
        assert abs(float(m["grad_norm"]) - float(m1["grad_norm"])) <= \
            1e-6 * float(m1["grad_norm"]), r
        ref_p = _copy(inputs[1][arch])
        apply_updates(ref_p, unflatten(ref_p, out["grads"]),
                      _zero_state(model), OPT)
        for p, q in zip(out["params"], leaves(ref_p)):
            assert _rel(p.numpy(), q.numpy()) <= 1e-6, r


@pytest.mark.parametrize("case", [c for c in CASES if c[0][0] == 1],
                         ids=_ids)
def test_float64_step_over_model_is_the_one_process_step(case, ranks,
                                                         inputs):
    """In float64 the (1, 4) step (experts and attention heads over
    "model") is within 1e-12 x max of the port's one-process step: the
    split changes only the order of the sums."""
    _, arch, groups, cf = case
    model = build_model(_cfg(arch, groups, cf, torch.float64))
    _, _, m1 = make_train_step(model, OPT, MICRO, keep_grads=True)(
        _f64(inputs[1][arch]),
        tree_defs_init(state_defs(model.param_defs, OPT), None, "cpu"),
        _f64(inputs[2][arch]))
    for r, rank in enumerate(ranks):
        out = rank[case, "f64"]
        for name in ("loss", "xent", "aux"):
            assert abs(float(out["metrics"][name]) - float(m1[name])) <= \
                1e-12 * abs(float(m1[name])), (r, name)
        for g, ref in zip(out["grads"], leaves(m1["grads"])):
            assert g.dtype == torch.float64
            assert _rel(g.numpy(), ref.numpy()) <= 1e-12, r


def test_capacity_drops_assignments_in_the_half_capacity_case(port_refs):
    assert port_refs[ARCHS[0], 2, 0.5][2] > 0
    assert port_refs[ARCHS[0], 2, None][2] < port_refs[ARCHS[0], 2, 0.5][2]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_rank_holds_and_gathers_its_experts_only(case, ranks, inputs):
    shape, arch, groups, cf = case
    dp, tp = shape
    params = inputs[1][arch]
    paths = _paths(params)
    whole = [tuple(x.shape) for x in leaves(params)]
    experts = [i for i, p in enumerate(paths) if _is_expert(p)]
    assert len(experts) == 3
    E = smoke_config(arch).moe.n_experts
    whole_bytes = sum(leaves(params)[i].numel() * 4 for i in experts)
    for rank in ranks:
        out = rank[case]
        for i in experts:
            # (layers, experts, ...): the experts over "model", one of the
            # other dims over "data"
            loc = out["local_shapes"][i]
            assert loc[1] == E // tp
            assert np.prod(loc) * dp * tp == np.prod(whole[i])
            assert out["grad_shapes"][i] == loc
        assert out["forward_wg"] and all(s[0] == E // tp
                                         for s in out["forward_wg"])
        moved = out["bytes"].get("all_gather_experts", 0)
        assert moved == (whole_bytes // tp if dp > 1 else 0)
        assert (out["bytes"].get("exchange", 0) > 0) == (tp > 1)


def test_the_raises(ranks):
    zero, three, short = ranks[0]["errors"]
    assert "ValueError" in zero and "multiple of 2" in zero
    assert "ValueError" in three and "multiple of 2" in three
    assert "ValueError" in short and "one group" in short
    for rank in ranks[1:]:
        assert rank["errors"] == ranks[0]["errors"]


def test_checkpoint_of_a_moe_mesh_restores_whole_and_resharded(ranks,
                                                               inputs):
    from repro_torch.checkpoint import restore
    _, arch, groups, cf = CKPT
    model = build_model(_cfg(arch, groups, cf))
    paths = _paths({"params": model.param_defs,
                    "opt": state_defs(model.param_defs, OPT)})
    E = smoke_config(arch).moe.n_experts
    # restored whole in one process: the (2, 2) step's gathered parameters
    whole, _ = restore(inputs[3].parent / "ckpt", device="cpu")
    for a, b in zip(leaves(whole["params"]), ranks[0][CKPT]["params"]):
        assert torch.equal(a, b)
    # restored onto the (1, 4) mesh: each rank's expert slices E/4, the
    # gathered state the whole one
    for rank in ranks:
        got = rank["restored"]
        assert len(got["gathered"]) == len(leaves(whole)) == len(paths)
        for a, b in zip(got["gathered"], leaves(whole)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for path, loc in zip(paths, got["local_shapes"]):
            # a parameter's path, or its AdamW moment's (.../wg/m)
            if _is_expert(path) or _is_expert(path[:-1]):
                assert loc[1] == E // 4, (path, loc)
