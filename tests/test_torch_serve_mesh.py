"""Serving on ("data", "model") meshes of gloo processes on the CPU:
``launch.steps.make_prefill_step`` / ``make_decode_step`` and
``launch.serve.ServeLoop`` with ``rules`` and ``mesh``, each rank holding
its serving copies of the weights (``Model.serving_layouts``) and its
cache slices, rows over "data" and heads, KV heads, MLP, vocab and SSM
heads over "model".

Two spawns (``launch.mesh.spawn``, ``file://`` rendezvous, each joined
within 180 s) run at once: four processes form the (2, 2), (4, 1) and
(1, 4) meshes in turn, two form (1, 2) and (2, 1).  On each mesh every
rank serves every case: the smoke configs of stablelm-1.6b (MHA,
layernorm), qwen2-7b (GQA, QKV bias; KV heads whole at tp 4),
qwen2-vl-7b (M-RoPE, text only), starcoder2-15b (GELU with b1/b2),
mamba2-1.3b, zamba2-1.2b (shared attention and a tail), qwen3-moe-30b-a3b
(experts over "model", ``moe_groups`` 4 over the dp rows) and
seamless-m4t-large-v2 (through the steps on ``shapes.concrete_batch``),
at float32 activations and float32 caches: a prefill of B x 8 tokens (B
4; 16 for the MoE, so that every decode group holds E/K tokens), then 3
decode steps fed the JAX package's greedy tokens (teacher forcing).  The
weights are the JAX package's init with its constant leaves (biases,
norm scales, the SSM's A_log, D, dt_bias) perturbed, so that a bias
added on every rank or a slice taken from the wrong place shows.
qwen2-7b at B 3 serves rows replicated over "data" (3 does not split).

* Prefill and every decode step's logits, gathered over the vocab slices
  and dp rows, are held to the JAX package's unsharded
  ``make_prefill_step`` / ``make_decode_step`` (``AxisRules((), ())``,
  weights carried by ``repro_torch.convert``) at 1e-4 x max |logit|, the
  models' bar (tests/test_torch_models.py).  The reference's own
  sharded serve fails under JAX 0.9.0 at its embedding gather (ROADMAP
  Queue C), so the unsharded steps are what GSPMD's layout promises to
  equal.
* The caches after the last step, rebuilt whole (the conv windows by
  ``mamba2.whole_conv_window``), at the same bar against the reference's.
* Greedy tokens equal the reference's wherever its top-2 margin exceeds
  the bar.
* What a rank holds: at (1, 2) qwen2-7b's weights at most 0.55 of one
  process's, its KV cache half; a decode step's collectives on a dense
  config at tp > 1: 2 x n_layers "tp_sum", one "embed_sum", one
  "argmax".
* In float64 every arch's mesh serve is within 1e-12 x max of the
  port's one-process serve of the rank's rows: the split changes only
  the order of sums.
* ``ServeLoop`` on (1, 2) and (2, 1) serves the tokens one process
  serves; ``CopyIn`` / ``SumOut`` give the whole function's gradients;
  a MoE decode whose groups fall back to one on dp > 1 gathers the
  group's tokens over dp ("moe_tokens", once a MoE layer) and serves the
  rank's rows as one process does (at the models' bar).
* The census of the prefill and of the last decode step, traced on
  ``meta`` tensors as rank 0 of the same mesh over a fake process group
  (``analysis.step_stats``, ``launch.dryrun.fake_group``): calls and
  payload bytes by kind equal what every gloo rank counted.

In this process: the (1, 1) mesh is bit for bit the path without a mesh,
and the steps build with ``kv_seq`` over "model" (context-parallel
decode, tests/test_torch_context_parallel.py).  The workers import no
JAX (the children import this module).
"""
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.analysis import step_stats
from repro_torch.configs import smoke_config
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import fake_group, local_meta
from repro_torch.launch.mesh import Mesh, make_mesh, make_rules, spawn
from repro_torch.launch.serve import ServeLoop, make_requests, serve_queue
from repro_torch.launch.shapes import concrete_batch
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.mamba2 import whole_conv_window

ARCHS = ("stablelm-1.6b", "qwen2-7b", "qwen2-vl-7b", "starcoder2-15b",
         "mamba2-1.3b", "zamba2-1.2b", "qwen3-moe-30b-a3b",
         "seamless-m4t-large-v2")
T, STEPS, MOE_GROUPS = 8, 3, 4
#: (arch, batch rows)
CASES = tuple((a, 16 if "moe" in a else 4) for a in ARCHS) + (
    ("qwen2-7b", 3),)
FOUR, TWO = ((2, 2), (4, 1), (1, 4)), ((1, 2), (2, 1))
MESHES = FOUR + TWO
TOL = 1e-4
SERVE_ARCHS = ("qwen2-7b", "mamba2-1.3b")
SERVE_REQUESTS, SERVE_NEW = 8, 4


def _cfg(arch):
    cfg = smoke_config(arch).with_(dtype=torch.float32)
    return cfg.with_(moe_groups=MOE_GROUPS) if cfg.moe is not None else cfg


def _batch(cfg, B):
    """The prompt batch of a case, from a seed."""
    if cfg.family == "encdec":
        return concrete_batch(cfg, "prefill", B, T, seed=0, device="cpu")
    rng = np.random.default_rng(B)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)))}


def _caches(model, B, **kw):
    return model.init_caches(B, T + STEPS, cross_len=T,
                             cache_dtype=torch.float32, **kw)


def _wait_for(path, timeout_s=200.0):
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)
    return torch.load(path)


def _serve_case(mesh, rules, device, arch, B, params, batch, forced):
    """One case on this rank: its logits, tokens and caches."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    local = sharding.serve_tree(params, model.serving_layouts(rules, mesh),
                                mesh)
    rows = sharding.serve_rows(mesh, rules, B)
    caches = _caches(model, B, device=device, rules=rules, mesh=mesh)
    prefill = make_prefill_step(model, rules, mesh)
    decode = make_decode_step(model, rules, mesh)
    tp = sharding.model_axis(mesh, rules)
    sharding.reset_counts()
    logits, caches = prefill(local, {k: rows.take(v) for k, v in
                                     batch.items()}, caches, rows=rows)
    out = {"prefill_calls": dict(sharding.CALLS),
           "prefill_bytes": dict(sharding.BYTES)}
    out.update(logits=[logits], tokens=[
        sharding.greedy(logits[:, -1], tp, cfg.vocab)],
        rows=(rows.start, rows.count, rows.axes))
    for s in range(STEPS):
        sharding.reset_counts()
        tok, logits, caches = decode(local, {"tokens": rows.take(
            forced[s])[:, None]}, caches, T + s, rows=rows)
        out["logits"].append(logits)
        out["tokens"].append(tok)
    out["calls"] = dict(sharding.CALLS)
    out["bytes"] = dict(sharding.BYTES)
    out["caches"] = caches
    out["weight_bytes"] = sum(x.numel() * x.element_size()
                              for x in _leaves(local))
    out["cache_bytes"] = sum(x.numel() * x.element_size()
                             for x in _leaves(caches))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _operators(mesh, device):
    """y = SumOut(silu(CopyIn(x) W1_r) W2_r), the rank's MLP columns, and
    the gradients of sum(y c) (float64)."""
    tp = sharding.model_axis(mesh, make_rules(mesh))
    gen = torch.Generator().manual_seed(5)
    x, w1, w2, c = (torch.randn(s, generator=gen, dtype=torch.float64)
                    for s in ((3, 6), (6, 8), (8, 6), (3, 6)))
    start, n = tp.part(8)
    x = x.to(device).requires_grad_(True)
    w1r = w1[:, start:start + n].to(device).requires_grad_(True)
    w2r = w2[start:start + n].to(device).requires_grad_(True)
    h = torch.nn.functional.silu(sharding.CopyIn.apply(x, tp) @ w1r)
    y = sharding.SumOut.apply(h @ w2r, tp)
    torch.sum(y * c.to(device)).backward()
    return {"y": y.detach(), "dx": x.grad, "dw1": w1r.grad, "dw2": w2r.grad,
            "part": (start, n)}


def _moe_fallback_raises(mesh, rules, device, params):
    """A qwen3-moe decode of 4 rows on dp > 1: 4 tokens in 4 groups fall
    back to one group, which spans the dp ranks, so the rank gathers the
    group's tokens.  Returns (the largest gap between the rank's logits
    and the one-process decode's of its rows and vocab slice, over their
    largest |logit|; the step's collective calls)."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    model = build_model(cfg)
    local = sharding.serve_tree(params, model.serving_layouts(rules, mesh),
                                mesh)
    rows = sharding.serve_rows(mesh, rules, 4)
    toks = torch.tensor([[3], [1], [4], [1]])
    sharding.reset_counts()
    _, logits, _ = make_decode_step(model, rules, mesh)(
        local, {"tokens": rows.take(toks)},
        _caches(model, 4, device=device, rules=rules, mesh=mesh), 0,
        rows=rows)
    calls = dict(sharding.CALLS)
    _, whole, _ = make_decode_step(model)(
        params, {"tokens": toks}, _caches(model, 4, device=device), 0)
    V = logits.shape[-1]
    v0 = mesh.index("model") * V if V != cfg.vocab else 0
    ref = rows.take(whole)[..., v0:v0 + V]
    return float((logits - ref).abs().max() / ref.abs().max()), calls


def _float64_gap(mesh, rules, device, arch):
    """The largest gap between this rank's logits and the port's own
    one-process serve of the same weights and of this rank's rows, both
    in float64 (weights, activations and caches; the plain attention and
    the norms compute in fp32 in both, as the JAX package's do), over the
    vocab slice, relative to the largest |logit|: what the split over
    "model" changes is the order of the sums."""
    f64 = torch.float64
    cfg = _cfg(arch).with_(dtype=f64, param_dtype=f64)
    model = build_model(cfg)
    params = model.init(0, device=device)
    B = 16 if cfg.moe is not None else 4
    batch = _batch(cfg, B)
    if "src_embeds" in batch:
        batch["src_embeds"] = batch["src_embeds"].to(f64)
    forced = torch.randint(0, cfg.vocab, (STEPS, B),
                           generator=torch.Generator().manual_seed(9))
    rows = sharding.serve_rows(mesh, rules, B)
    # the MoE's groups span the whole batch: its reference serves it all
    ref_rows = rows if cfg.moe is None else sharding.Rows(0, B)
    runs = []
    for kw, p, extra, take in (
            ({}, params, {}, ref_rows.take),
            ({"rules": rules, "mesh": mesh},
             sharding.serve_tree(params, model.serving_layouts(rules, mesh),
                                 mesh), {"rows": rows}, rows.take)):
        caches = model.init_caches(B if extra else ref_rows.count,
                                   T + STEPS, cross_len=T, cache_dtype=f64,
                                   device=device, **kw)
        with torch.inference_mode():
            logits, caches = make_prefill_step(model, **kw)(
                p, {k: take(v) for k, v in batch.items()}, caches, **extra)
            out = [logits]
            for s in range(STEPS):
                _, logits, caches = make_decode_step(model, **kw)(
                    p, {"tokens": take(forced[s])[:, None]}, caches, T + s,
                    **extra)
                out.append(logits)
        runs.append(out)
    whole, part = runs
    V = part[0].shape[-1]
    v0 = mesh.index("model") * V if V != cfg.vocab else 0
    if ref_rows is not rows:
        whole = [rows.take(w) for w in whole]
    return max(float((a - w[..., v0:v0 + V]).abs().max() / w.abs().max())
               for a, w in zip(part, whole))


def _serve_mesh_worker(rank, device, shapes, in_dir, out_dir):
    params, batches = torch.load(in_dir / "inputs.pt")
    forced = _wait_for(in_dir / "forced.pt")
    results = {}
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"), device=device)
        rules = make_rules(mesh)
        for arch, B in CASES:
            results[shape, arch, B] = _serve_case(
                mesh, rules, device, arch, B, params[arch],
                batches[arch, B], forced[arch, B])
        results[shape, "coords"] = mesh.coords
        results[shape, "operators"] = _operators(mesh, device)
        results[shape, "float64"] = {a: _float64_gap(mesh, rules, device, a)
                                     for a in ARCHS}
        if shape[0] > 1:
            results[shape, "moe_fallback"] = _moe_fallback_raises(
                mesh, rules, device, params["qwen3-moe-30b-a3b"])
        if shape in TWO:
            for arch in SERVE_ARCHS:
                loop = ServeLoop(_cfg(arch), rules=rules, mesh=mesh)
                done = serve_queue(loop, make_requests(
                    loop.cfg.vocab, SERVE_REQUESTS, SERVE_NEW))["done"]
                results[shape, "serve", arch] = [r.out for r in done]
    torch.save(results, out_dir / f"rank{rank}.pt")


def _perturb_constant_leaves(tree, rng):
    """The leaves the init leaves constant (biases, norm scales, the conv
    bias, ``A_log``, ``D``, ``dt_bias``) plus N(0, 0.1) noise, so that a
    bias added on every rank, or a slice taken from the wrong place,
    shows."""
    if isinstance(tree, dict):
        return {k: _perturb_constant_leaves(tree[k], rng) for k in sorted(tree)}
    if np.all(tree == tree.flat[0]):
        return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(
            tree.dtype)
    return tree


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX package's weights of each arch, its constant leaves
    perturbed (as numpy and as the port's whole params), and each case's
    batch, saved for the ranks."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    from repro_torch.convert import params_from_jax

    jparams, params, batches = {}, {}, {}
    rng = np.random.default_rng(7)
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32)
        jparams[arch] = _perturb_constant_leaves(jax.tree.map(
            np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0))),
            rng)
        params[arch] = params_from_jax(jparams[arch], _cfg(arch),
                                       device="cpu")
    for arch, B in CASES:
        batches[arch, B] = _batch(_cfg(arch), B)
    d = tmp_path_factory.mktemp("serve_mesh_in")
    torch.save((params, batches), d / "inputs.pt")
    return jparams, params, batches, d


def _jax_refs(jparams, batches):
    """Each case through the JAX package's unsharded steps: prefill, then
    greedy decode (the tokens fed back are the ones the ranks are fed):
    the logits of each call, the forced tokens and the last caches."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch.steps import make_decode_step as jdecode
    from repro.launch.steps import make_prefill_step as jprefill
    from repro.models import AxisRules
    from repro.models import build_model as jax_build_model

    rules = AxisRules(fsdp_axes=(), dp_axes=())
    refs = {}
    for arch, B in CASES:
        jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32)
        if jcfg.moe is not None:
            jcfg = jcfg.with_(moe_groups=MOE_GROUPS)
        jmodel = jax_build_model(jcfg)
        caches = jmodel.init_caches(B, T + STEPS, cross_len=T,
                                    cache_dtype=jnp.float32)
        batch = {k: jnp.asarray(v.numpy()) for k, v in
                 batches[arch, B].items()}
        logits, caches = jax.jit(jprefill(jmodel, rules))(jparams[arch],
                                                          batch, caches)
        out = [np.asarray(logits)]
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        forced = []
        decode = jax.jit(jdecode(jmodel, rules))
        for s in range(STEPS):
            forced.append(torch.from_numpy(np.asarray(tok, np.int64)))
            tok, logits, caches = decode(jparams[arch],
                                         {"tokens": tok[:, None]}, caches,
                                         jnp.asarray(T + s, jnp.int32))
            out.append(np.asarray(logits))
        refs[arch, B] = {"logits": out, "forced": forced,
                         "caches": jax.tree.map(np.asarray, caches)}
    return refs


def _one_process_serves(arch):
    loop = ServeLoop(_cfg(arch), device="cpu")
    done = serve_queue(loop, make_requests(loop.cfg.vocab, SERVE_REQUESTS,
                                           SERVE_NEW))["done"]
    return [r.out for r in done]


@pytest.fixture(scope="module")
def runs(inputs):
    """(each spawn's ranks' results by mesh shape, the JAX references, the
    one-process ``ServeLoop`` tokens): the spawns start while the
    references are computed; the ranks wait for the forced tokens."""
    jparams, _, batches, d = inputs
    spawns = {"four": (4, FOUR), "two": (2, TWO)}
    for sub in spawns:
        (d / sub).mkdir()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(spawn, _serve_mesh_worker, n,
                            (shapes, d, d / sub),
                            rendezvous=d / sub / "rendezvous",
                            backend="gloo", device="cpu", timeout_s=240)
                for sub, (n, shapes) in spawns.items()]
        refs = _jax_refs(jparams, batches)
        tmp = d / "forced.tmp"
        torch.save({k: r["forced"] for k, r in refs.items()}, tmp)
        os.replace(tmp, d / "forced.pt")
        serves = {a: _one_process_serves(a) for a in SERVE_ARCHS}
        for job in jobs:
            job.result()
    ranks = {}
    for sub, (n, shapes) in spawns.items():
        loaded = [torch.load(d / sub / f"rank{r}.pt") for r in range(n)]
        for shape in shapes:
            ranks[shape] = loaded
    return ranks, refs, serves


def _ids(case):
    return f"{case[0].split('-')[0]}{case[0].split('-')[1]}-B{case[1]}"


def _rebuild_logits(ranks, shape, case, step):
    """The whole (B, 1, V) logits of a step from the ranks' row and vocab
    slices; replicas must agree bit for bit."""
    arch, B = case
    V = _cfg(arch).vocab
    whole = np.full((B, 1, V), np.nan, np.float32)
    for rank in ranks:
        out = rank[shape, arch, B]
        part = out["logits"][step].numpy()
        start, count, _ = out["rows"]
        vl = part.shape[-1]
        v0 = rank[shape, "coords"][1] * vl if vl != V else 0
        sl = (slice(start, start + count), slice(None),
              slice(v0, v0 + vl))
        seen = whole[sl]
        assert np.all(np.isnan(seen) | (seen == part))
        whole[sl] = part
    assert not np.isnan(whole).any()
    return whole


def _rel(out, ref) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_logits_match_the_jax_unsharded_steps(case, shape, runs):
    ranks, refs, _ = runs
    ref = refs[case]["logits"]
    for step in range(STEPS + 1):
        out = _rebuild_logits(ranks[shape], shape, case, step)
        assert out.shape == ref[step].shape
        assert _rel(out, ref[step]) <= TOL, (step, _rel(out, ref[step]))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_greedy_tokens_match_where_the_margin_is_clear(case, shape, runs):
    ranks, refs, _ = runs
    ref = refs[case]["logits"]
    for step in range(STEPS + 1):
        last = ref[step][:, -1]
        top2 = np.sort(last, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > TOL * np.abs(last).max()
        want = np.argmax(last, axis=-1)
        for rank in ranks[shape]:
            out = rank[shape, case[0], case[1]]
            start, count, _ = out["rows"]
            got = out["tokens"][step].numpy()
            sl = slice(start, start + count)
            assert np.all((got == want[sl]) | ~clear[sl]), step


def _place(whole, part, spec, coords, shape, columns=None):
    """``part`` into ``whole`` at the slice of a rank at ``coords``."""
    mesh = Mesh(("data", "model"), shape, coords, torch.device("cpu"))
    sl = sharding.Sharding(mesh, spec).slices(whole.shape)
    if columns is not None:
        sl = sl[:-1] + (list(columns),)
        idx = np.ix_(*[np.arange(whole.shape[i])[s]
                       for i, s in enumerate(sl[:-1])], sl[-1])
        whole[idx] = part
    else:
        whole[sl] = part


def _rebuild_caches(ranks, shape, arch, B):
    """The whole caches from each rank's slices: each leaf placed by its
    serving layout; the conv windows also by ``whole_conv_window``, held
    equal to the placement."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    defs = model.cache_defs(B, T + STEPS, T, torch.float32)

    def build(defs, path):
        if isinstance(defs, dict):
            return {k: build(defs[k], path + (k,)) for k in defs}
        whole = np.full(defs.shape, np.nan, np.float32)
        parts = {}
        for rank in ranks:
            coords = rank[shape, "coords"]
            mesh = Mesh(("data", "model"), shape, coords,
                        torch.device("cpu"))
            lay = model.serving_cache_layouts(make_rules(mesh), mesh, B,
                                              T + STEPS, T, torch.float32)
            for k in path:
                lay = lay[k]
            part = rank[shape, arch, B]["caches"]
            for k in path:
                part = part[k]
            _place(whole, part.numpy(), lay.spec, coords, shape, lay.columns)
            parts[coords] = part
        assert not np.isnan(whole).any(), path
        if path[-1] == "conv":
            rows = {}
            for (i, j), part in sorted(parts.items()):
                rows.setdefault(i, []).append(part)
            # the rows of each "data" index, its "model" ranks in order
            rebuilt = [whole_conv_window(p, cfg) for _, p in
                       sorted(rows.items())]
            split = ranks[0][shape, arch, B]["rows"][2]
            # (..., B, k-1, channels): the rows are dim -3
            rebuilt = (torch.cat(rebuilt, dim=-3) if split
                       else rebuilt[0]).numpy()
            assert np.array_equal(rebuilt, whole), path
        return whole
    return build(defs, ())


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], prefix + (k,)).items()}
    return {prefix: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_caches_rebuilt_whole_match_the_reference(case, shape, runs):
    ranks, refs, _ = runs
    whole = _flat(_rebuild_caches(ranks[shape], shape, *case))
    ref = _flat(refs[case]["caches"])
    assert whole.keys() == ref.keys()
    for path, r in ref.items():
        assert whole[path].shape == r.shape, path
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(whole[path] - r).max() <= TOL * scale, path


def test_a_rank_holds_its_slices_and_counts_its_collectives(runs, inputs):
    ranks, _, _ = runs
    params = inputs[1]["qwen2-7b"]
    one_weights = sum(x.numel() * 4 for x in _leaves(params))
    one_cache = sum(x.numel() * 4 for x in _leaves(
        _caches(build_model(_cfg("qwen2-7b")), 4, device="cpu")))
    for rank in ranks[(1, 2)]:
        out = rank[(1, 2), "qwen2-7b", 4]
        assert out["weight_bytes"] <= 0.55 * one_weights
        assert out["cache_bytes"] * 2 == one_cache
    for shape in MESHES:
        for rank in ranks[shape]:
            for arch in ("stablelm-1.6b", "qwen2-7b"):
                calls = rank[shape, arch, 4]["calls"]
                want = ({} if shape[1] == 1 else
                        {"tp_sum": 2 * _cfg(arch).n_layers, "embed_sum": 1,
                         "argmax": 1})
                assert calls == want, (shape, arch, calls)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_copy_in_and_sum_out_give_the_whole_gradients(shape, runs):
    ranks, _, _ = runs
    gen = torch.Generator().manual_seed(5)
    x, w1, w2, c = (torch.randn(s, generator=gen, dtype=torch.float64)
                    for s in ((3, 6), (6, 8), (8, 6), (3, 6)))
    x.requires_grad_(True)
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    y = torch.nn.functional.silu(x @ w1) @ w2
    torch.sum(y * c).backward()
    for rank in ranks[shape]:
        out = rank[shape, "operators"]
        start, n = out["part"]
        assert n == 8 // shape[1]
        torch.testing.assert_close(out["y"], y.detach(), rtol=0, atol=1e-12)
        torch.testing.assert_close(out["dx"], x.grad, rtol=0, atol=1e-12)
        torch.testing.assert_close(out["dw1"], w1.grad[:, start:start + n],
                                   rtol=0, atol=1e-12)
        torch.testing.assert_close(out["dw2"], w2.grad[start:start + n],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_float64_serve_on_a_mesh_is_one_process_up_to_sum_order(shape,
                                                                 runs):
    """In float64 the split over "model" changes only the order of the
    sums: every arch's logits within 1e-12 x max of the port's
    one-process serve of the rank's rows."""
    ranks, _, _ = runs
    for rank in ranks[shape]:
        for arch, gap in rank[shape, "float64"].items():
            assert gap <= 1e-12, (arch, gap)


@pytest.mark.parametrize("shape", TWO, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_loop_on_a_mesh_serves_the_one_process_tokens(arch, shape,
                                                            runs):
    ranks, _, serves = runs
    for rank in ranks[shape]:
        assert rank[shape, "serve", arch] == serves[arch]


def test_moe_decode_falling_back_to_one_group_on_dp_raises(runs):
    """Once raised here; the step now gathers the one group's tokens over
    "data" (once a MoE layer) and serves the rank's rows as one process
    serves them."""
    ranks, _, _ = runs
    n_moe = _cfg("qwen3-moe-30b-a3b").n_layers
    for shape in MESHES:
        if shape[0] > 1:
            for rank in ranks[shape]:
                gap, calls = rank[shape, "moe_fallback"]
                assert gap <= TOL, (shape, gap)
                assert calls["moe_tokens"] == n_moe, (shape, calls)


def _traced_census(shape, arch, B, batch):
    """The census of a case's prefill and of a decode step, traced as rank
    0 of ``shape`` on ``meta`` tensors of the rank's shapes over a fake
    process group: ({kind: calls}, {kind: payload bytes}) of each."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    with fake_group(shape[0] * shape[1], 0):
        mesh = make_mesh(shape, ("data", "model"), device="meta")
        rules = make_rules(mesh)
        params = local_meta(model.param_defs,
                            model.serving_layouts(rules, mesh), mesh)
        rows = sharding.serve_rows(mesh, rules, B)
        caches = _caches(model, B, device="meta", rules=rules, mesh=mesh)
        with step_stats() as pre:
            make_prefill_step(model, rules, mesh)(
                params, {k: rows.take(v.to("meta")) for k, v in
                         batch.items()}, caches, rows=rows)
        with step_stats() as dec:
            make_decode_step(model, rules, mesh)(
                params, {"tokens": torch.zeros(rows.count, 1,
                                               dtype=torch.long,
                                               device="meta")},
                caches, T + STEPS - 1, rows=rows)
    return [({k: v["calls"] for k, v in s.collectives_by_kind.items()},
             {k: v["payload_bytes"] for k, v in
              s.collectives_by_kind.items()}) for s in (pre, dec)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_census_of_the_traced_steps_is_what_the_ranks_counted(case, shape,
                                                              runs, inputs):
    ranks, _, _ = runs
    (pre_calls, pre_bytes), (calls, moved) = _traced_census(
        shape, *case, inputs[2][case])
    for rank in ranks[shape]:
        out = rank[(shape,) + case]
        assert pre_calls == out["prefill_calls"]
        assert pre_bytes == out["prefill_bytes"]
        assert calls == out["calls"] and moved == out["bytes"]


def _mesh_one(coords=(0, 0), dims=(1, 1)):
    return Mesh(("data", "model"), dims, coords, torch.device("cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_mesh_is_the_path_without_a_mesh_bit_for_bit(arch,
                                                                  inputs):
    """make_prefill_step / make_decode_step through the (1, 1) mesh and
    ``make_rules`` against the steps without a mesh: logits, tokens and
    caches equal bit for bit (the init's weights, bf16 activations)."""
    cfg = smoke_config(arch)
    if cfg.moe is not None:
        cfg = cfg.with_(moe_groups=MOE_GROUPS)
    model = build_model(cfg)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    rules = make_rules(mesh)
    B = 16 if cfg.moe is not None else 4
    batch = _batch(cfg, B)
    params = model.init(0, device="cpu")
    local = sharding.serve_tree(params, model.serving_layouts(rules, mesh),
                                mesh)
    outs = []
    for kw, p in (({}, params), ({"rules": rules, "mesh": mesh}, local)):
        prefill = make_prefill_step(model, **kw)
        decode = make_decode_step(model, **kw)
        caches = model.init_caches(B, T + STEPS, cross_len=T, device="cpu",
                                   **kw)
        with torch.inference_mode():
            logits, caches = prefill(p, batch, caches)
            got = [logits]
            tok = torch.argmax(logits[:, -1], dim=-1)
            for s in range(STEPS):
                tok, logits, caches = decode(p, {"tokens": tok[:, None]},
                                             caches, T + s)
                got += [logits, tok]
        outs.append(got + _leaves(caches))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_serve_loop_on_the_one_process_mesh_is_bit_for_bit():
    cfg = smoke_config("qwen2-7b")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    served = []
    for kw in ({}, {"mesh": mesh}):
        loop = ServeLoop(cfg, device="cpu", **kw)
        served.append([r.out for r in loop.run_batch(
            make_requests(cfg.vocab, 4, 3))])
    assert served[0] == served[1]


def test_kv_seq_over_model_raises():
    """Rules with ``kv_seq`` over "model" once raised here; the steps and
    the loop now build with them (context-parallel decode, served in
    tests/test_torch_context_parallel.py), and only ``kv_seq`` over
    another axis raises."""
    model = build_model(smoke_config("qwen2-7b"))
    mesh = _mesh_one(dims=(1, 2))
    rules = make_rules(mesh, overrides={"kv_seq": "model"})
    for make in (make_prefill_step, make_decode_step):
        make(model, rules, mesh)
    ServeLoop(smoke_config("qwen2-7b"), device="cpu", rules=rules,
              mesh=mesh)
    with pytest.raises(NotImplementedError, match="over \"model\" alone"):
        make_decode_step(model, make_rules(mesh, overrides={
            "kv_seq": "data"}), mesh)
