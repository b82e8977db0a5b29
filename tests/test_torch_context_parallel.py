"""Context-parallel decode on ("data", "model") meshes of gloo processes on
the CPU: rules with ``kv_seq`` over "model" split each KV cache by
sequence, rank r of tp holding positions [r L, (r + 1) L) (L = max_len /
tp) of every KV head; a decode step attends every query head over the
rank's part with the row log-sum-exp and merges the ranks' partial rows
(``layers.split_cache_attention``, ``sharding.merge_partials``).

The rules are the JAX dry run's (``src/repro/launch/dryrun.py``): where
``n_kv_heads % tp`` is not 0 it sets ``{"kv_seq": "model"}`` and the KV
heads fall back to whole; where the KV heads divide, the split is forced
with ``{"kv_seq": "model", "kv_heads": None, "act_kv_heads": None}``
(``kv_seq`` and ``kv_heads`` both over "model" names one axis on two
dims, which raises).  Two spawns (``launch.mesh.spawn``, ``file://``
rendezvous) run at once: two processes form (1, 2), four form (1, 4)
and then (2, 2).  Every rank serves the smoke configs of stablelm-1.6b,
qwen2-7b, qwen2-vl-7b (M-RoPE positions whose temporal ids lag the cache
index by 0-3 positions a row, so that a rank's causal offset is negative
for some rows), starcoder2-15b, qwen3-moe-30b-a3b, zamba2-1.2b (the shared
attention) and mamba2-1.3b (no KV cache: the rule changes nothing), at
float32 activations and caches: a prefill of B x 3 tokens, then 5
decode steps fed tokens drawn from a seed, so a cache of 8 positions
(L 4 at tp 2, 2 at tp 4): a later rank's part is empty during the first
decode steps, the prompt crosses a part at tp 4, and decode crosses
each part's end.  qwen2-7b also serves 4 steps into 7 positions, which
do not divide over "model": the caches stay whole along the sequence
(the path without the rule).  A rank computes on one thread: the
spawns share the host with the suite's other workers.

* Prefill and decode logits, gathered over the rows and vocab slices,
  against the JAX package's unsharded ``make_prefill_step`` /
  ``make_decode_step`` (``AxisRules((), ())``) at 1e-4 x max |logit|;
  the caches, rebuilt whole along the sequence, against the reference's.
* In float64 each rank's serve is within 1e-12 x max of the port's
  one-process serve of its rows: the split reorders sums only.
* A rank's K/V cache holds 1/tp of the whole (of its rows); a decode
  step's collectives are those of the step without the rule plus one
  "cp_q" and one "cp_merge" per attention layer; at 7 positions the
  serve is the one without the rule, bit for bit.
* ``ServeLoop`` on each mesh serves the tokens one process serves; the
  merge of partials over a split key range (with empty parts and rows
  that see no key) is the plain attention over the whole range.
* The census of the prefill and of the last decode step under the rule,
  traced on ``meta`` tensors as rank 0 of the same mesh over a fake
  process group (``analysis.step_stats``, ``launch.dryrun.fake_group``):
  calls and payload bytes by kind equal what every gloo rank counted.

In this process: the cache specs of the ten configs equal the JAX
package's under the dry run's override on a 16 x 16 mesh; a spec with one
axis on two dims raises; the encoder-decoder refuses the rule; the plain
and meta routes return the row lse at Sq 1.  The workers import no JAX
(the children import this module).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.analysis import step_stats
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.kernels.flash_attention import attention_ref, lse_ref, mha
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import fake_group, local_meta
from repro_torch.launch.mesh import Mesh, make_mesh, make_rules, spawn
from repro_torch.launch.serve import ServeLoop, make_requests, serve_queue
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.common import AxisRules

ARCHS = ("stablelm-1.6b", "qwen2-7b", "qwen2-vl-7b", "starcoder2-15b",
         "qwen3-moe-30b-a3b", "zamba2-1.2b", "mamba2-1.3b")
T, STEPS, MOE_GROUPS = 3, 5, 4
#: (arch, batch rows, decode steps): caches of T + steps positions; 7
#: does not divide over "model"
CASES = tuple((a, 16 if "moe" in a else 4, STEPS) for a in ARCHS) + (
    ("qwen2-7b", 4, STEPS - 1),)
FOUR, TWO = ((1, 4), (2, 2)), ((1, 2),)
MESHES = TWO + FOUR
TOL = 1e-4
#: M-RoPE: each row's temporal id lags its position by this much
LAGS = (0, 1, 2, 3)
SERVE_ARCH, SERVE_REQUESTS, SERVE_NEW = "qwen2-7b", 8, 5


def _n_attention(cfg) -> int:
    """The attention layers a forward runs (zamba2: the shared block's
    applications)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def _cfg(arch, dtype=torch.float32):
    cfg = smoke_config(arch).with_(dtype=dtype)
    if dtype == torch.float64:
        cfg = cfg.with_(param_dtype=dtype)
    return cfg.with_(moe_groups=MOE_GROUPS) if cfg.moe is not None else cfg


def cp_overrides(cfg, tp: int) -> dict:
    """The JAX dry run's rule where the KV heads do not divide over
    "model"; where they do, the split forced, the KV heads whole."""
    if cfg.n_kv_heads % tp:
        return {"kv_seq": "model"}
    return {"kv_seq": "model", "kv_heads": None, "act_kv_heads": None}


def _positions(B, start, n):
    """M-RoPE positions (B, n, 3) of positions [start, start + n): the
    temporal id lags by ``LAGS`` (never below 0), h and w vary."""
    t = torch.arange(start, start + n)
    lag = torch.tensor(LAGS[:B])[:, None]
    return torch.stack([torch.clamp(t - lag, min=0),
                        (t % 3).expand(B, n), (t % 5).expand(B, n)], dim=-1)


def _inputs(cfg, B, steps):
    """The case's prompt batch and decode batches, from a seed."""
    rng = np.random.default_rng(B + steps)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)))}
    decodes = [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, 1)))} for _ in range(steps)]
    if cfg.mrope:
        batch["positions"] = _positions(B, 0, T)
        for s, d in enumerate(decodes):
            d["positions"] = _positions(B, T + s, 1)
    return batch, decodes


def _serve(model, params, batch, decodes, B, max_len, dtype, rules=None,
           mesh=None):
    """A prefill and the decode steps on this rank (or one process):
    the logits of each call, the caches, the collectives of the prefill
    and of the last step (calls and payload bytes by kind) and the
    rows."""
    kw = {} if mesh is None else {"rules": rules, "mesh": mesh}
    rows = sharding.serve_rows(mesh, rules, B)
    extra = {} if mesh is None else {"rows": rows, "max_len": max_len}
    caches = model.init_caches(B, max_len, cache_dtype=dtype, device="cpu",
                               **kw)
    prefill, decode = make_prefill_step(model, **kw), make_decode_step(
        model, **kw)
    sharding.reset_counts()
    logits, caches = prefill(params, {k: rows.take(v) for k, v in
                                      batch.items()}, caches, **extra)
    counts = {"prefill_calls": dict(sharding.CALLS),
              "prefill_bytes": dict(sharding.BYTES)}
    out = [logits]
    for s, d in enumerate(decodes):
        sharding.reset_counts()
        _, logits, caches = decode(params, {k: rows.take(v) for k, v in
                                            d.items()}, caches, T + s,
                                   **extra)
        out.append(logits)
    counts.update(calls=dict(sharding.CALLS), bytes=dict(sharding.BYTES))
    return out, caches, counts, rows


def _kv_numel(caches) -> int:
    def walk(t, key=None):
        if isinstance(t, dict):
            return sum(walk(v, k) for k, v in t.items())
        return t.numel() if key in ("k", "v") else 0
    return walk(caches)


def _case(mesh, device, arch, B, steps, params):
    """One case on this rank: its logits and caches with the rule, the
    collectives of a decode step with and without it, its K/V numel and
    the float64 gap to one process."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    tp = mesh.shape["model"]
    rules = make_rules(mesh, overrides=cp_overrides(cfg, tp))
    local = sharding.serve_tree(params, model.serving_layouts(rules, mesh),
                                mesh)
    batch, decodes = _inputs(cfg, B, steps)
    logits, caches, counts, rows = _serve(model, local, batch, decodes, B,
                                         T + steps, torch.float32, rules,
                                         mesh)
    plain = make_rules(mesh)
    base = _serve(model, sharding.serve_tree(
        params, model.serving_layouts(plain, mesh), mesh), batch,
        decodes[:1], B, T + steps, torch.float32, plain, mesh)[2]["calls"]
    whole = _kv_numel(model.init_caches(rows.count, T + steps,
                                        cache_dtype=torch.float32,
                                        device="cpu"))
    same = None
    if (T + steps) % tp:
        # a max_len that does not divide: the path without kv_seq's rule
        # (the same KV heads layout), bit for bit
        rest = {k: v for k, v in cp_overrides(cfg, tp).items()
                if k != "kv_seq"}
        without = make_rules(mesh, overrides=rest)
        w_logits, w_caches, _, _ = _serve(
            model, sharding.serve_tree(params, model.serving_layouts(
                without, mesh), mesh), batch, decodes, B, T + steps,
            torch.float32, without, mesh)
        same = all(torch.equal(a, b) for a, b in zip(
            logits + _leaves(caches), w_logits + _leaves(w_caches)))
    return {"logits": logits, "caches": caches, **counts,
            "base_calls": base, "kv_numel": _kv_numel(caches),
            "kv_whole": whole, "same_without_rule": same,
            "rows": (rows.start, rows.count, rows.axes),
            "float64": _float64_gap(mesh, arch, B, steps)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _float64_gap(mesh, arch, B, steps):
    """The largest gap between this rank's float64 logits and the port's
    one-process float64 serve (weights from seed 0) of its rows, over
    its vocab slice, relative to the largest |logit|."""
    f64 = torch.float64
    cfg = _cfg(arch, f64)
    model = build_model(cfg)
    rules = make_rules(mesh, overrides=cp_overrides(cfg, mesh.shape["model"]))
    params = model.init(0, device="cpu")
    batch, decodes = _inputs(cfg, B, steps)
    rows = sharding.serve_rows(mesh, rules, B)
    # the MoE's groups span the whole batch: its reference serves it all
    ref_rows = rows if cfg.moe is None else sharding.Rows(0, B)
    whole = _serve(model, params, {k: ref_rows.take(v) for k, v in
                                   batch.items()},
                   [{k: ref_rows.take(v) for k, v in d.items()}
                    for d in decodes], ref_rows.count, T + steps, f64)[0]
    part = _serve(model, sharding.serve_tree(
        params, model.serving_layouts(rules, mesh), mesh), batch, decodes,
        B, T + steps, f64, rules, mesh)[0]
    V = part[0].shape[-1]
    v0 = mesh.index("model") * V if V != cfg.vocab else 0
    if ref_rows is not rows:
        whole = [rows.take(w) for w in whole]
    return max(float((a - w[..., v0:v0 + V]).abs().max() / w.abs().max())
               for a, w in zip(part, whole))


def _merge_check(mesh):
    """The merge of the ranks' partial attention over their parts of 16
    keys against ``attention_ref`` over all of them (float64): kv_len 5
    leaves the later parts empty, per-row offsets leave some rows no key
    on some ranks (and one row none at all), and the heads are kept
    whole or split over "model".  Returns the largest gap."""
    tp = sharding.model_axis(mesh, make_rules(mesh))
    gen = torch.Generator().manual_seed(11)
    B, Hq, Hkv, S, D = 4, 8, 2, 16, 8
    q = torch.randn(B, 1, Hq, D, generator=gen, dtype=torch.float64)
    k = torch.randn(B, S, Hkv, D, generator=gen, dtype=torch.float64)
    v = torch.randn(B, S, Hkv, D, generator=gen, dtype=torch.float64)
    L = S // tp.size
    start = tp.index * L
    gaps = []
    for kv_len, off in ((5, torch.tensor([4, 1, 0, 4])),
                        (16, torch.tensor([15, 9, 3, -1])),
                        (16, 15)):
        o, lse = mha(q, k[:, start:start + L], v[:, start:start + L],
                     kv_len=min(max(kv_len - start, 0), L),
                     q_offset=off - start, return_lse=True)
        ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), kv_len=kv_len,
                            q_offset=off).transpose(1, 2)
        hl = Hq // tp.size
        for heads, want in ((None, ref),
                            (hl, ref[:, :, tp.index * hl:(tp.index + 1)
                                     * hl])):
            got = sharding.merge_partials(o, lse, tp, heads)
            assert got.shape == want.shape and got.dtype == want.dtype
            gaps.append(float((got - want).abs().max()))
    return max(gaps)


def _cp_worker(rank, device, shapes, in_dir, out_dir):
    torch.set_num_threads(1)
    params = torch.load(in_dir / "inputs.pt")
    results = {}
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"), device=device)
        for arch, B, steps in CASES:
            results[shape, arch, B, steps] = _case(mesh, device, arch, B,
                                                   steps, params[arch])
        results[shape, "coords"] = mesh.coords
        results[shape, "merge"] = _merge_check(mesh)
        cfg = _cfg(SERVE_ARCH)
        loop = ServeLoop(cfg, rules=make_rules(
            mesh, overrides=cp_overrides(cfg, shape[1])), mesh=mesh)
        done = serve_queue(loop, make_requests(cfg.vocab, SERVE_REQUESTS,
                                               SERVE_NEW))["done"]
        results[shape, "serve"] = [r.out for r in done]
    torch.save(results, out_dir / f"rank{rank}.pt")


def _perturb_constant_leaves(tree, rng):
    """The leaves the init leaves constant (biases, norm scales, ``A_log``,
    ``D``, ``dt_bias``) plus N(0, 0.1) noise, so that a bias added on
    every rank, or a slice taken from the wrong place, shows."""
    if isinstance(tree, dict):
        return {k: _perturb_constant_leaves(tree[k], rng) for k in sorted(tree)}
    if np.all(tree == tree.flat[0]):
        return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(
            tree.dtype)
    return tree


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each arch's weights drawn by the port's init from seed 0 (the JAX
    package's init rule and names; no JAX init to compile), its constant
    leaves perturbed: numpy for the JAX package's steps, and as the
    port's whole params (``convert.params_from_jax``), saved for the
    ranks."""
    from repro_torch.convert import params_from_jax

    jparams, params = {}, {}
    rng = np.random.default_rng(7)
    for arch in ARCHS:
        jparams[arch] = _perturb_constant_leaves(_numpy_tree(
            build_model(_cfg(arch)).init(0, device="cpu")), rng)
        params[arch] = params_from_jax(jparams[arch], _cfg(arch),
                                       device="cpu")
    d = tmp_path_factory.mktemp("context_parallel_in")
    torch.save(params, d / "inputs.pt")
    return jparams, d


def _jax_refs(jparams):
    """Each case through the JAX package's unsharded steps: the logits of
    each call and the last caches."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch.steps import make_decode_step as jdecode
    from repro.launch.steps import make_prefill_step as jprefill
    from repro.models import AxisRules as JaxAxisRules
    from repro.models import build_model as jax_build_model

    rules = JaxAxisRules(fsdp_axes=(), dp_axes=())
    refs = {}
    for arch, B, steps in CASES:
        jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32)
        if jcfg.moe is not None:
            jcfg = jcfg.with_(moe_groups=MOE_GROUPS)
        jmodel = jax_build_model(jcfg)
        caches = jmodel.init_caches(B, T + steps, cache_dtype=jnp.float32)
        batch, decodes = _inputs(_cfg(arch), B, steps)

        def jx(tree):
            return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
        logits, caches = jax.jit(jprefill(jmodel, rules))(jparams[arch],
                                                          jx(batch), caches)
        out = [np.asarray(logits)]
        decode = jax.jit(jdecode(jmodel, rules))
        for s, d in enumerate(decodes):
            _, logits, caches = decode(jparams[arch], jx(d), caches,
                                       jnp.asarray(T + s, jnp.int32))
            out.append(np.asarray(logits))
        refs[arch, B, steps] = {"logits": out,
                                "caches": jax.tree.map(np.asarray, caches)}
    return refs


@pytest.fixture(scope="module")
def runs(inputs):
    """(the ranks' results by mesh shape, the JAX references, the
    one-process ``ServeLoop`` tokens): the spawns run while the
    references are computed."""
    jparams, d = inputs
    spawns = {"four": (4, FOUR), "two": (2, TWO)}
    for sub in spawns:
        (d / sub).mkdir()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(spawn, _cp_worker, n, (shapes, d, d / sub),
                            rendezvous=d / sub / "rendezvous",
                            backend="gloo", device="cpu", timeout_s=400)
                for sub, (n, shapes) in spawns.items()]
        refs = _jax_refs(jparams)
        loop = ServeLoop(_cfg(SERVE_ARCH), device="cpu")
        serve = [r.out for r in serve_queue(loop, make_requests(
            loop.cfg.vocab, SERVE_REQUESTS, SERVE_NEW))["done"]]
        for job in jobs:
            job.result()
    ranks = {}
    for sub, (n, shapes) in spawns.items():
        loaded = [torch.load(d / sub / f"rank{r}.pt") for r in range(n)]
        for shape in shapes:
            ranks[shape] = loaded
    return ranks, refs, serve


def _ids(case):
    arch, B, steps = case
    return f"{arch.split('-')[0]}{arch.split('-')[1]}-B{B}-M{T + steps}"


def _mesh_at(shape, coords):
    return Mesh(("data", "model"), shape, coords, torch.device("cpu"))


def _rebuild_logits(ranks, shape, case, step):
    """The whole (B, 1, V) logits of a call from the ranks' row and vocab
    slices; replicas agree bit for bit."""
    arch, B, _ = case
    V = _cfg(arch).vocab
    whole = np.full((B, 1, V), np.nan, np.float32)
    for rank in ranks:
        out = rank[(shape,) + case]
        part = out["logits"][step].numpy()
        start, count, _ = out["rows"]
        vl = part.shape[-1]
        v0 = rank[shape, "coords"][1] * vl if vl != V else 0
        sl = (slice(start, start + count), slice(None), slice(v0, v0 + vl))
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
    for step in range(case[2] + 1):
        out = _rebuild_logits(ranks[shape], shape, case, step)
        assert out.shape == ref[step].shape
        assert _rel(out, ref[step]) <= TOL, (step, _rel(out, ref[step]))


def _rebuild_caches(ranks, shape, case):
    """The whole caches from each rank's slices, each leaf placed by its
    serving layout under the rule (the KV leaves along the sequence)."""
    arch, B, steps = case
    cfg = _cfg(arch)
    model = build_model(cfg)
    defs = model.cache_defs(B, T + steps, 0, torch.float32)

    def build(d, path):
        if isinstance(d, dict):
            return {k: build(d[k], path + (k,)) for k in d}
        whole = np.full(d.shape, np.nan, np.float32)
        for rank in ranks:
            mesh = _mesh_at(shape, rank[shape, "coords"])
            lay = model.serving_cache_layouts(
                make_rules(mesh, overrides=cp_overrides(cfg, shape[1])),
                mesh, B, T + steps, 0, torch.float32)
            part = rank[(shape,) + case]["caches"]
            for k in path:
                lay, part = lay[k], part[k]
            sl = sharding.Sharding(mesh, lay.spec).slices(whole.shape)
            if lay.columns is not None:
                idx = np.ix_(*[np.arange(n)[s] for n, s in
                               zip(whole.shape, sl[:-1])], list(lay.columns))
                whole[idx] = part.numpy()
            else:
                whole[sl] = part.numpy()
        assert not np.isnan(whole).any(), path
        return whole
    return build(defs, ())


def _flat(tree, prefix=()):
    """{path: leaf} of a tree of dicts."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], prefix + (k,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_caches_rebuilt_whole_match_the_reference(case, shape, runs):
    ranks, refs, _ = runs
    whole = _flat(_rebuild_caches(ranks[shape], shape, case))
    ref = _flat(refs[case]["caches"])
    assert whole.keys() == ref.keys()
    for path, r in ref.items():
        r = np.asarray(r, np.float32)
        assert whole[path].shape == r.shape, path
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(whole[path] - r).max() <= TOL * scale, path


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_float64_serve_is_one_process_up_to_sum_order(shape, runs):
    ranks, _, _ = runs
    for rank in ranks[shape]:
        for case in CASES:
            gap = rank[(shape,) + case]["float64"]
            assert gap <= 1e-12, (case, gap)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_rank_holds_its_part_and_counts_its_collectives(shape, runs):
    """A split cache holds 1/tp of the K/V positions of the rank's rows
    (the whole where max_len does not divide, and then the serve is the
    one without the rule bit for bit); a decode step's collectives are
    the step's without the rule plus one "cp_q" and one "cp_merge" per
    attention layer."""
    ranks, _, _ = runs
    tp = shape[1]
    for rank in ranks[shape]:
        for case in CASES:
            arch, _, steps = case
            out = rank[(shape,) + case]
            split = (T + steps) % tp == 0
            n_attn = _n_attention(_cfg(arch))
            assert out["kv_numel"] * (tp if split else 1) == out["kv_whole"]
            assert out["same_without_rule"] is (None if split else True)
            want = dict(out["base_calls"])
            if split and n_attn:
                want.update(cp_q=n_attn, cp_merge=n_attn)
            assert out["calls"] == want, (case, out["calls"], want)


def _traced_census(shape, arch, B, steps):
    """The census of a case's prefill and of its last decode step under
    the rule, traced as rank 0 of ``shape`` on ``meta`` tensors of the
    rank's shapes over a fake process group: ({kind: calls}, {kind:
    payload bytes}) of each."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    batch, decodes = _inputs(cfg, B, steps)
    max_len = T + steps
    with fake_group(shape[0] * shape[1], 0):
        mesh = make_mesh(shape, ("data", "model"), device="meta")
        rules = make_rules(mesh, overrides=cp_overrides(cfg, shape[1]))
        params = local_meta(model.param_defs,
                            model.serving_layouts(rules, mesh), mesh)
        rows = sharding.serve_rows(mesh, rules, B)
        caches = model.init_caches(B, max_len, cache_dtype=torch.float32,
                                   device="meta", rules=rules, mesh=mesh)
        kw = {"rows": rows, "max_len": max_len}
        with step_stats() as pre:
            make_prefill_step(model, rules, mesh)(
                params, {k: rows.take(v.to("meta")) for k, v in
                         batch.items()}, caches, **kw)
        with step_stats() as dec:
            make_decode_step(model, rules, mesh)(
                params, {k: rows.take(v.to("meta")) for k, v in
                         decodes[-1].items()}, caches, T + steps - 1, **kw)
    return [({k: v["calls"] for k, v in s.collectives_by_kind.items()},
             {k: v["payload_bytes"] for k, v in
              s.collectives_by_kind.items()}) for s in (pre, dec)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_census_of_the_traced_steps_is_what_the_ranks_counted(case, shape,
                                                              runs):
    ranks, _, _ = runs
    (pre_calls, pre_bytes), (calls, moved) = _traced_census(shape, *case)
    for rank in ranks[shape]:
        out = rank[(shape,) + case]
        assert pre_calls == out["prefill_calls"]
        assert pre_bytes == out["prefill_bytes"]
        assert calls == out["calls"] and moved == out["bytes"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_merge_of_partials_is_the_whole_attention(shape, runs):
    ranks, _, _ = runs
    for rank in ranks[shape]:
        assert rank[shape, "merge"] <= 1e-13


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_serve_loop_serves_the_one_process_tokens(shape, runs):
    ranks, _, serve = runs
    for rank in ranks[shape]:
        assert rank[shape, "serve"] == serve


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_the_jax_package_under_the_dry_run_rule(arch):
    """Specs only, no devices: each config at full width on a 16 x 16
    ("data", "model") mesh with the dry run's override (``kv_seq`` over
    "model" where ``n_kv_heads % 16`` is not 0), at a max_len that
    divides over "model" and one that does not."""
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.models.common import AxisRules as JaxAxisRules

    sizes = {"data": 16, "model": 16}
    cfg = get_config(arch)
    over = {"kv_seq": "model"} if cfg.n_kv_heads % 16 else {}
    jrules = JaxAxisRules(overrides=over, axis_sizes=sizes)
    rules = AxisRules(overrides=over, axis_sizes=sizes)
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(cfg)
    for max_len in (32768 + 16, 32768 + 1):
        want = jmodel.cache_specs(jrules, 32, max_len, cross_len=256)
        got = _flat(model.cache_specs(rules, 32, max_len, cross_len=256))
        assert got.keys() == _flat(want).keys()
        for path, spec in _flat(want).items():
            assert got[path] == tuple(spec), (path, got[path], spec)


def test_one_axis_on_two_dims_raises():
    """``kv_seq`` over "model" where the KV heads divide over "model" too
    names "model" on two dims of a KV cache leaf: ``init_caches`` raises
    (the JAX package's ``NamedSharding`` does), as does such a spec."""
    mesh = _mesh_at((1, 2), (0, 0))
    model = build_model(smoke_config("stablelm-1.6b"))
    with pytest.raises(ValueError, match="on two dims"):
        model.init_caches(4, 16, device="cpu", mesh=mesh, rules=make_rules(
            mesh, overrides={"kv_seq": "model"}))
    with pytest.raises(ValueError, match="on two dims"):
        sharding.Sharding(mesh, (None, "model", "model"))
    # the forced rule builds, and so does a max_len that does not divide
    rules = make_rules(mesh, overrides=cp_overrides(model.cfg, 2))
    for max_len, local in ((16, 8), (15, 15)):
        caches = model.init_caches(4, max_len, device="cpu", mesh=mesh,
                                   rules=rules)
        assert caches["blocks"]["k"].shape[2] == local


def test_encoder_decoder_refuses_the_rule():
    model = build_model(smoke_config("seamless-m4t-large-v2"))
    mesh = _mesh_at((1, 2), (0, 0))
    rules = make_rules(mesh, overrides={"kv_seq": "model", "kv_heads": None,
                                        "act_kv_heads": None})
    for make in (make_prefill_step, make_decode_step):
        with pytest.raises(NotImplementedError, match="Configurations the "
                                                      "port does not yet run"):
            make(model, rules, mesh)


def test_serve_loop_sizes_split_caches_to_whole_parts():
    mesh = _mesh_at((1, 4), (0, 1))
    rules = make_rules(mesh, overrides={"kv_seq": "model"})
    assert [sharding.cache_len(n, rules, mesh) for n in (13, 16, 17)] == [
        16, 16, 20]
    assert sharding.cache_len(13, make_rules(mesh), mesh) == 13
    assert sharding.cache_len(13, None, None) == 13


def test_a_layer_without_the_caches_length_raises():
    """A step on rules that split ``kv_seq`` but given no max_len cannot
    tell a split cache from a whole one, and raises where it meets one;
    mamba2 (no KV cache) needs none."""
    mesh = _mesh_at((1, 1), (0, 0))
    tp = sharding.ModelAxis(mesh, "model", 2, 0, seq=None)
    cfg = _cfg("qwen2-7b")
    params = build_model(cfg).init(0, device="cpu")["blocks"]
    from repro_torch.models.layers import self_attention
    x = torch.zeros(1, 1, cfg.d_model)
    cache = {"k": torch.zeros(1, 8, 2, 8), "v": torch.zeros(1, 8, 2, 8)}
    attn = {k: v[0] for k, v in params["attn"].items()}
    with pytest.raises(ValueError, match="max_len"):
        self_attention(attn, x, cfg, causal=True,
                       positions=torch.zeros(1, 1, dtype=torch.long),
                       cache=cache, cache_index=3, tp=tp)
    assert sharding.model_axis(_mesh_at((1, 2), (0, 0)), make_rules(
        _mesh_at((1, 2), (0, 0)), overrides={"kv_seq": "model"})).seq is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_and_meta_routes_return_the_row_lse_at_one_query(dtype):
    """``mha(return_lse=True)`` at Sq 1 on the CPU is ``attention_ref`` and
    ``lse_ref`` (-inf and 0 where a row sees no key: kv_len 0, a negative
    per-row offset); on ``meta`` it makes both shapes."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(3, 1, 4, 8, generator=gen, dtype=dtype)
    k = torch.randn(3, 10, 2, 8, generator=gen, dtype=dtype)
    v = torch.randn(3, 10, 2, 8, generator=gen, dtype=dtype)
    off = torch.tensor([5, -2, 9])
    for kw in ({"kv_len": 7, "q_offset": off}, {"kv_len": 0, "q_offset": 3},
               {"kv_len": 10, "q_offset": -1}):
        out, lse = mha(q, k, v, return_lse=True, **kw)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        assert torch.equal(out, attention_ref(qt, kt, vt, **kw).transpose(
            1, 2))
        assert torch.equal(lse, lse_ref(qt, kt, **kw))
        assert lse.shape == (3, 4, 1)
        empty = torch.isinf(lse)
        assert bool(empty[1].all())
        assert bool((out.transpose(1, 2)[empty] == 0).all())
    mo, ml = mha(*(t.to("meta") for t in (q, k, v)), return_lse=True)
    assert mo.shape == q.shape and ml.shape == (3, 4, 1)
    assert ml.dtype == torch.float32
