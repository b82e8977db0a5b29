"""Tensor-parallel training over "model" on ("data", "model") meshes of
gloo processes on the CPU: ``launch.steps.make_train_step`` with each
rank holding, gathering and computing its "model" slices (its heads, KV
heads, MLP columns, vocab slice and SSM heads) and the backward of the
split written out.

Two spawns (``launch.mesh.spawn``, ``file://`` rendezvous, each joined
within 240 s, one thread a rank) run one after the other while the
references are computed in this process: four processes form the (2, 2) and (1, 4) meshes in turn, two
form (1, 2).  On each mesh every rank takes one step of each of the
smoke configs of stablelm-1.6b (MHA, layernorm), qwen2-7b (GQA with QKV
bias; its 2 KV heads whole on every rank at tp 4), qwen2-vl-7b (M-RoPE,
vision embeddings), starcoder2-15b (GELU with b1/b2), mamba2-1.3b,
zamba2-1.2b (the shared attention block and a tail), qwen3-moe-30b-a3b
(experts over "model", ``moe_groups`` 2) and seamless-m4t-large-v2, from
the same global weights (drawn from a numpy seed by the init's rule, at
unit score variance as tests/test_torch_train.py, the init's constant
leaves perturbed), with 2 microbatches, a mask that is not
all ones and ``xent_chunk`` 6 (three chunks of 16 tokens, the last one
padded).

* Loss, xent, aux and the gathered gradients in float32 are held to the
  JAX package's unsharded ``Model.loss`` and ``jax.grad``
  (``AxisRules((), ())``, weights carried by ``repro_torch.convert``) at
  1e-4 x max |.|, the models' bar (tests/test_torch_models.py).  The
  reference's own sharded step does not run under JAX 0.9.0's
  ``Explicit`` axes (ROADMAP Queue C), so the unsharded loss is what
  GSPMD's layout promises to equal.
* In float64 the step is within 1e-12 x max of the port's one-process
  step: the split changes only the order of the sums.
* What a rank computes: H/tp heads in attention, d_ff/tp MLP columns and
  H hd / tp rows of ``wo`` in the row-parallel products, V/tp logits a
  chunk (no chunk's whole logits), SSM heads/tp in the scan; its stored
  slices (the gradients' shapes) are ``param_specs``'.
* What a rank gathers: on (1, 2) only the leaves whose compute layout is
  wider than their stored slice (the Mamba-2 in_proj and conv leaves, the
  MoE router), none for a dense config; on (2, 2) at most 0.55 of the
  gather-everything step's bytes for the dense configs.
* The tensor-parallel collectives of a step by kind, the remat's repeats
  included, for stablelm-1.6b, qwen2-7b (KV heads whole at tp 4: their
  weights' gradients summed once, "kv_grad") and mamba2-1.3b (the gated
  norm's sum in both directions, "norm_sum").
* The census of the same step traced on ``meta`` tensors as rank 0 of
  the same mesh over a fake process group
  (``analysis.step_stats``, ``launch.dryrun.fake_group``): calls and
  payload bytes by kind equal what every gloo rank counted.

In this process: the (1, 1) mesh's step is the step without a mesh bit
for bit.  The workers import no JAX (the children import this module).
"""
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.analysis import step_stats
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import fake_group, local_meta
from repro_torch.launch.mesh import make_mesh, make_rules, spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, layers, mamba2, transformer
from repro_torch.models.common import (is_def, tree_defs_init,
                                      tree_defs_to_specs)
from repro_torch.optim import AdamWConfig, state_defs
from repro_torch.optim.adamw import leaves, unflatten

ARCHS = ("stablelm-1.6b", "qwen2-7b", "qwen2-vl-7b", "starcoder2-15b",
         "mamba2-1.3b", "zamba2-1.2b", "qwen3-moe-30b-a3b",
         "seamless-m4t-large-v2")
DENSE = ("stablelm-1.6b", "qwen2-7b", "qwen2-vl-7b", "starcoder2-15b",
         "seamless-m4t-large-v2")
B, T, MICRO, XENT_CHUNK, MOE_GROUPS = 8, 16, 2, 6, 2
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
FOUR, TWO = ((2, 2), (1, 4)), ((1, 2),)
MESHES = FOUR + TWO
TOL, TOL64 = 1e-4, 1e-12
#: the tensor-parallel collective kinds a step's counts are held to
TP_KINDS = ("embed_sum", "tp_sum", "tp_grad", "kv_grad", "norm_sum", "xent",
            "all_gather_model")


def _cfg(arch, dtype=torch.float32):
    cfg = smoke_config(arch).with_(dtype=dtype, xent_chunk=XENT_CHUNK)
    if dtype == torch.float64:
        cfg = cfg.with_(param_dtype=dtype)
    return cfg.with_(moe_groups=MOE_GROUPS) if cfg.moe is not None else cfg


def _batch(cfg):
    batch = SyntheticLMData(cfg, seq=T, global_batch=B, seed=3,
                            device="cpu").batch(0)
    lengths = torch.tensor([16, 9, 12, 5, 16, 3, 11, 7])
    batch["mask"] = (torch.arange(T)[None] < lengths[:, None]).float()
    return batch


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    return tree.double() if tree.is_floating_point() else tree


def _paths(tree, prefix=()):
    """Each leaf's key path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


#: (module, name, what to record of a call's positional arguments)
PROBES = (
    (layers, "mha", lambda a: ("heads", a[0].shape[2])),
    (layers, "row_parallel", lambda a: ("row_k", a[1].shape[0])),
    (mamba2, "row_parallel", lambda a: ("ssm_row_k", a[1].shape[0])),
    (mamba2, "ssd", lambda a: ("ssm_heads", a[0].shape[2])),
    (transformer, "_xent_chunk_split", lambda a: ("vocab", a[1].shape[-1])),
    (transformer, "_xent_chunk", lambda a: ("whole_vocab", a[1].shape[-1])),
)


def _probed(fn):
    """``fn()`` with the PROBES' functions recording what they are called
    with: {kind: set of sizes}."""
    seen = {}
    saved = [(m, n, getattr(m, n)) for m, n, _ in PROBES]

    def probe(f, what):
        def call(*args, **kw):
            kind, size = what(args)
            seen.setdefault(kind, set()).add(int(size))
            return f(*args, **kw)
        return call
    for (m, n, what), (_, _, f) in zip(PROBES, saved):
        setattr(m, n, probe(f, what))
    try:
        out = fn()
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    return out, seen


def _step(mesh, rules, device, cfg, params, batch):
    """One sharded step from the global ``params``: what the tests read."""
    model = build_model(cfg)
    psh = sharding.tree_shardings(model.param_specs(rules), mesh)
    local = unflatten(params, [sharding.shard(x, sh).clone()
                               for x, sh in zip(leaves(params),
                                                leaves(psh))])
    sdefs = state_defs(model.param_defs, OPT)
    state = sharding.init_local(
        sdefs, None, device,
        sharding.tree_shardings(tree_defs_to_specs(sdefs, rules), mesh))
    step = make_train_step(model, OPT, MICRO, rules=rules, mesh=mesh,
                           keep_grads=True)
    sharding.reset_counts()
    (_, _, m), seen = _probed(lambda: step(
        local, state, sharding.local_batch(batch, mesh, rules, MICRO)))
    out = {"metrics": {k: m[k] for k in ("loss", "xent", "aux")},
           "grad_shapes": [tuple(g.shape) for g in leaves(m["grads"])],
           "stored_shapes": [sh.shard_shape(x.shape) for x, sh in
                             zip(leaves(params), leaves(psh))],
           "seen": seen, "bytes": dict(sharding.BYTES),
           "calls": dict(sharding.CALLS)}
    out["grads"] = [sharding.gather(g, sh).clone()
                    for g, sh in zip(leaves(m["grads"]), leaves(psh))]
    # the gather-everything step's bytes: every stored slice gathered whole
    sharding.reset_counts()
    for x, sh in zip(leaves(local), leaves(psh)):
        sharding.gather(x, sh)
    out["whole_gather_bytes"] = sum(sharding.BYTES.values())
    return out


def _tp_worker(rank, device, shapes, inputs, out_dir):
    # smoke widths: one thread a rank keeps the spawn light beside the
    # suite's other workers
    torch.set_num_threads(1)
    params, batches = torch.load(inputs)
    results = {}
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"), device=device)
        rules = make_rules(mesh)
        for arch in ARCHS:
            results[shape, arch] = _step(mesh, rules, device, _cfg(arch),
                                         params[arch], batches[arch])
            f64 = _step(mesh, rules, device, _cfg(arch, torch.float64),
                        _f64(params[arch]), _f64(batches[arch]))
            results[shape, arch, "f64"] = {
                "loss": f64["metrics"]["loss"], "grads": f64["grads"]}
    torch.save(results, out_dir / f"rank{rank}.pt")


def _draw(defs, rng):
    """Weights of a def tree from ``rng`` (numpy float32): the init's
    N(0, scale^2 / fan_in) draws, and the init's constant leaves (biases,
    norm scales, A_log, D, dt_bias) plus N(0, 0.1^2) noise, so that a
    bias added on every rank shows."""
    if not is_def(defs):
        return {k: _draw(defs[k], rng) for k in sorted(defs)}
    if defs.init in ("zeros", "ones"):
        x = (defs.init == "ones") + 0.1 * rng.standard_normal(defs.shape)
    else:
        fan_in = defs.shape[-2] if len(defs.shape) >= 2 else defs.shape[-1]
        x = rng.standard_normal(defs.shape) * defs.scale / fan_in ** 0.5
    return x.astype(np.float32)


def _scale_heads(tree, s):
    """``wq`` and ``wk`` times ``s``: unit score variance at s =
    head_dim**-0.5 (tests/test_torch_train.py)."""
    return {k: (_scale_heads(v, s) if isinstance(v, dict)
                else v * s if k in ("wq", "wk") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each arch's weights from a numpy seed (as numpy and as the port's
    whole params) and its batch, saved for the ranks."""
    from repro_torch.convert import params_from_jax

    rng = np.random.default_rng(11)
    weights, params, batches = {}, {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        weights[arch] = _scale_heads(
            _draw(build_model(cfg).param_defs, rng),
            np.float32(cfg.resolved_head_dim() ** -0.5))
        params[arch] = params_from_jax(weights[arch], cfg, device="cpu")
        batches[arch] = _batch(cfg)
    d = tmp_path_factory.mktemp("tp_train_in")
    torch.save((params, batches), d / "inputs.pt")
    return weights, params, batches, d


def _jax_refs(weights, batches):
    """The JAX package's unsharded loss, xent, aux (means over the
    microbatches) and gradients (their mean) of each arch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import AxisRules
    from repro.models import build_model as jax_build_model

    rules = AxisRules(fsdp_axes=(), dp_axes=())
    refs = {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32,
                                            xent_chunk=XENT_CHUNK)
        if jcfg.moe is not None:
            jcfg = jcfg.with_(moe_groups=MOE_GROUPS)
        jmodel = jax_build_model(jcfg)
        jbatch = {k: jnp.asarray(v.float().numpy() if v.dtype ==
                                 torch.bfloat16 else v.numpy())
                  for k, v in batches[arch].items()}
        if "vision_embeds" in jbatch:
            jbatch["vision_embeds"] = jbatch["vision_embeds"].astype(
                jnp.bfloat16)

        def mb_loss_grads(p, jmodel=jmodel, jbatch=jbatch):
            outs = []
            for i in range(MICRO):
                mb = {k: v[i * B // MICRO:(i + 1) * B // MICRO]
                      for k, v in jbatch.items()}
                (loss, met), g = jax.value_and_grad(
                    lambda q: jmodel.loss(q, mb, rules), has_aux=True)(p)
                outs.append((loss, met["xent"], met["aux"], g))
            return jax.tree.map(lambda *xs: sum(xs) / MICRO, *outs)
        loss, xent, aux, g = jax.jit(mb_loss_grads)(
            jax.tree.map(jnp.asarray, weights[arch]))
        refs[arch] = (float(loss), float(xent), float(aux),
                      [np.asarray(x) for x in jax.tree.leaves(g)])
    return refs


def _port_f64_refs(params, batches):
    """The port's one-process float64 step of each arch: (loss, grads)."""
    refs = {}
    for arch in ARCHS:
        cfg = _cfg(arch, torch.float64)
        model = build_model(cfg)
        state = tree_defs_init(state_defs(model.param_defs, OPT), None, "cpu")
        _, _, m = make_train_step(model, OPT, MICRO, keep_grads=True)(
            _f64(params[arch]), state, _f64(batches[arch]))
        refs[arch] = (m["loss"], leaves(m["grads"]))
    return refs


@pytest.fixture(scope="module")
def runs(inputs):
    """(each mesh's ranks' results, the JAX references, the port's float64
    references): the references are computed while the ranks run."""
    weights, params, batches, d = inputs
    spawns = {"four": (4, FOUR), "two": (2, TWO)}

    def run_spawns():
        # one after the other: at most four ranks at a time
        for sub, (n, shapes) in spawns.items():
            (d / sub).mkdir()
            spawn(_tp_worker, n, (shapes, d / "inputs.pt", d / sub),
                  rendezvous=d / sub / "rendezvous", backend="gloo",
                  device="cpu", timeout_s=240)
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_spawns)
        refs = _jax_refs(weights, batches)
        refs64 = _port_f64_refs(params, batches)
        job.result()
    ranks = {}
    for sub, (n, shapes) in spawns.items():
        loaded = [torch.load(d / sub / f"rank{r}.pt") for r in range(n)]
        for shape in shapes:
            ranks[shape] = loaded
    return ranks, refs, refs64


def _rel(out, ref) -> float:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_the_jax_unsharded_loss_and_gradient(arch, shape,
                                                          runs):
    ranks, refs, _ = runs
    jloss, jxent, jaux, jgrads = refs[arch]
    for r, rank in enumerate(ranks[shape]):
        out = rank[shape, arch]
        m = out["metrics"]
        for name, ref in (("loss", jloss), ("xent", jxent), ("aux", jaux)):
            assert abs(float(m[name]) - ref) <= TOL * max(abs(ref), 1e-30), \
                (r, name, float(m[name]), ref)
        assert len(out["grads"]) == len(jgrads)
        for g, jg in zip(out["grads"], jgrads):
            assert g.shape == jg.shape
            assert _rel(g.numpy(), jg) <= TOL, (r, _rel(g.numpy(), jg))


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_float64_step_is_the_one_process_step_up_to_sum_order(arch, shape,
                                                              runs):
    ranks, _, refs64 = runs
    loss, grads = refs64[arch]
    for r, rank in enumerate(ranks[shape]):
        out = rank[shape, arch, "f64"]
        assert abs(float(out["loss"]) - float(loss)) <= \
            TOL64 * abs(float(loss)), r
        for g, ref in zip(out["grads"], grads):
            assert g.dtype == torch.float64
            assert _rel(g.numpy(), ref.numpy()) <= TOL64, \
                (r, _rel(g.numpy(), ref.numpy()))


def _expected_seen(cfg, tp):
    """What a rank's probes see at tp (module docstring)."""
    seen = {"vocab": {cfg.vocab // tp}}
    if cfg.family != "ssm":
        seen["heads"] = {cfg.n_heads // tp}
        seen["row_k"] = {cfg.n_heads * cfg.resolved_head_dim() // tp}
        if cfg.family != "moe":
            seen["row_k"].add(cfg.d_ff // tp)
    if cfg.ssm is not None:
        seen["ssm_heads"] = {cfg.ssm.n_ssm_heads(cfg.d_model) // tp}
        seen["ssm_row_k"] = {cfg.ssm.d_inner(cfg.d_model) // tp}
    return seen


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_computes_its_model_slices(arch, shape, runs):
    ranks, _, _ = runs
    want = _expected_seen(_cfg(arch), shape[1])
    for rank in ranks[shape]:
        out = rank[shape, arch]
        # no whole_vocab: no rank forms a chunk's whole logits
        assert out["seen"] == want, (out["seen"], want)
        # the gradients come back as the stored slices, as before
        assert out["grad_shapes"] == out["stored_shapes"]


def _wider_in_compute(arch):
    """The leaves a rank gathers over "model": those whose compute layout
    is wider than their stored slice."""
    names = (("in_proj", "conv_w", "conv_b")
             if _cfg(arch).ssm is not None else ())
    return names + (("router",) if _cfg(arch).moe is not None else ())


@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_bytes_drop_to_what_is_wider_in_compute(arch, runs,
                                                         inputs):
    ranks, _, _ = runs
    params = inputs[1][arch]
    wider = _wider_in_compute(arch)
    want = sum(x.numel() * x.element_size()
               for p, x in zip(_paths(params), leaves(params))
               if p[-1] in wider)
    for rank in ranks[(1, 2)]:
        moved = rank[(1, 2), arch]["bytes"]
        gathered = sum(v for k, v in moved.items()
                       if k.startswith("all_gather"))
        assert gathered == want == moved.get("all_gather_model", 0)
        assert (want == 0) == (arch in DENSE)
    if arch in DENSE:
        for rank in ranks[(2, 2)]:
            out = rank[(2, 2), arch]
            gathered = sum(v for k, v in out["bytes"].items()
                           if k.startswith("all_gather"))
            assert 0 < gathered <= 0.55 * out["whole_gather_bytes"], \
                (gathered, out["whole_gather_bytes"])


def _expected_calls(arch, tp):
    """The tensor-parallel collectives of a step on a rank at tp > 1
    (MICRO microbatches, full remat; each layer's forward runs again in
    the backward, up to its last product whose input the backward keeps:
    the down product's sum is not recomputed, the xent chunk's gather
    is).  Dense: per microbatch the embedding's sum; per layer two
    row-parallel sums forward and one in the recompute, two ``CopyIn``
    gradients (attention's and the MLP's input) and, where the KV heads
    are whole, the KV leaves' (4 with QKV bias); per xent chunk its
    gather twice; one ``CopyIn`` gradient of the xent's input.  mamba2:
    per layer the gated norm's sum in the forward, the recompute and the
    backward, out_proj's sum once, in_proj's input gradient; the three
    column leaves gathered over "model" once a step."""
    cfg = _cfg(arch)
    L, M = cfg.n_layers, MICRO
    chunks = math.ceil(T / XENT_CHUNK)
    calls = {"embed_sum": M, "xent": 2 * chunks * M}
    if cfg.family == "ssm":
        calls.update(norm_sum=3 * L * M, tp_sum=L * M, tp_grad=(L + 1) * M,
                     all_gather_model=3)
        return calls
    calls.update(tp_sum=3 * L * M, tp_grad=(2 * L + 1) * M)
    if cfg.n_kv_heads % tp:
        calls["kv_grad"] = (4 if cfg.qkv_bias else 2) * L * M
    return calls


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ("stablelm-1.6b", "qwen2-7b",
                                  "mamba2-1.3b"))
def test_tp_collectives_of_a_step_by_kind(arch, shape, runs):
    ranks, _, _ = runs
    want = _expected_calls(arch, shape[1])
    for rank in ranks[shape]:
        calls = rank[shape, arch]["calls"]
        got = {k: v for k, v in calls.items() if k in TP_KINDS}
        assert got == want, (got, want)


def _traced_census(shape, arch, rank, batch):
    """The census of ``_step``'s step traced as ``rank`` of ``shape`` on
    ``meta`` tensors of the rank's shapes over a fake process group."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    with fake_group(math.prod(shape), rank):
        mesh = make_mesh(shape, ("data", "model"), device="meta")
        rules = make_rules(mesh)
        sdefs = state_defs(model.param_defs, OPT)
        params = local_meta(model.param_defs, sharding.tree_shardings(
            model.param_specs(rules), mesh), mesh)
        state = local_meta(sdefs, sharding.tree_shardings(
            tree_defs_to_specs(sdefs, rules), mesh), mesh)
        step = make_train_step(model, OPT, MICRO, rules=rules, mesh=mesh,
                               keep_grads=True)
        with step_stats() as stats:
            step(params, state, sharding.local_batch(
                {k: v.to("meta") for k, v in batch.items()}, mesh, rules,
                MICRO))
    return stats.collectives_by_kind


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_census_of_the_traced_step_is_what_the_ranks_counted(arch, shape,
                                                             runs, inputs):
    ranks, _, _ = runs
    census = _traced_census(shape, arch, 0, inputs[2][arch])
    for rank in ranks[shape]:
        out = rank[shape, arch]
        assert {k: v["calls"] for k, v in census.items()} == out["calls"]
        assert {k: v["payload_bytes"] for k, v in census.items()} == \
            out["bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_mesh_is_the_step_without_a_mesh_bit_for_bit(arch):
    """make_train_step through the (1, 1) mesh and ``make_rules`` against
    the step without a mesh: loss, gradients and updated weights equal
    bit for bit (the init's weights, bf16 activations)."""
    cfg = smoke_config(arch).with_(xent_chunk=XENT_CHUNK)
    model = build_model(cfg)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    batch = _batch(cfg)
    outs = []
    for kw in ({}, {"rules": make_rules(mesh), "mesh": mesh}):
        params = model.init(0, device="cpu")
        state = tree_defs_init(state_defs(model.param_defs, OPT), None, "cpu")
        p2, _, m = make_train_step(model, OPT, MICRO, keep_grads=True,
                                   **kw)(params, state, batch)
        outs.append([m["loss"], m["grad_norm"]] + leaves(m["grads"])
                    + leaves(p2))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
