"""The port's encoder-decoder (``models/encdec.py``, cross-attention, the
cache-free encoder attention), ``launch/shapes.py`` and the serve loop's
answer to seamless, against the JAX package on the CPU.

The same numpy inputs and the JAX init (carried across with
``params_from_jax``) go through both packages.  Bars as
tests/test_torch_models.py: 1e-4 x max|logit| (or x max|output|) in
float32, 3e-2 in bf16, the bf16 model at unit score variance
(tests/test_torch_families.py says why).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import list_archs as jax_list_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import shapes as jax_shapes
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.models import AxisRules
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro_torch.configs import smoke_config
from repro_torch.convert import caches_from_jax, params_from_jax
from repro_torch.launch import shapes
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, encdec, layers

RULES = AxisRules(fsdp_axes=(), dp_axes=())
ARCH = "seamless-m4t-large-v2"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
B, T_SRC, T, STEPS = 2, 9, 6, 3


def _scaled_close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol, rtol=0)


def _unit_score_scale(tree, s):
    return {k: (_unit_score_scale(v, s) if isinstance(v, dict)
                else v * np.float32(s) if k in ("wq", "wk") else v)
            for k, v in tree.items()}


def _models(dtype, seed=0):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jax_smoke_config(ARCH).with_(dtype=jdt)
    cfg = smoke_config(ARCH).with_(dtype=tdt)
    jmodel = jax_build_model(jcfg)
    nparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    # the layer norms start at scale 1 and bias 0: redraw them, so that a
    # mix-up of the decoder's three norms would show
    rng = np.random.default_rng(seed + 7)
    for blocks in ("enc_blocks", "dec_blocks"):
        for name, p in nparams[blocks].items():
            if name.startswith("ln"):
                p["scale"] = rng.normal(1, 0.2, p["scale"].shape).astype(
                    np.float32)
                p["bias"] = rng.normal(0, 0.2, p["bias"].shape).astype(
                    np.float32)
    if dtype == "bfloat16":
        nparams = _unit_score_scale(nparams, cfg.resolved_head_dim() ** -0.5)
    return (jmodel, jax.tree.map(jnp.asarray, nparams), build_model(cfg),
            params_from_jax(nparams, cfg, device="cpu"), cfg, tol)


def _inputs(cfg, seed=0, t_src=T_SRC):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, t_src, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab, (B, T)),
            rng.integers(0, cfg.vocab, (STEPS, B, 1)))


# ---------------------------------------------------------------------------
# Whole model: prefill and three decode steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cross_len", [T_SRC, T_SRC + 5, T_SRC - 3],
                         ids=["cross=src", "padded", "cut"])
def test_prefill_and_decode_match_jax(dtype, cross_len):
    jmodel, jparams, model, params, cfg, tol = _models(dtype)
    src, prompt, forced = _inputs(cfg)
    cd = DTYPES[dtype][:2]
    jcaches = jmodel.init_caches(B, T + STEPS, cross_len=cross_len,
                                 cache_dtype=cd[0])
    caches = model.init_caches(B, T + STEPS, cross_len=cross_len,
                               cache_dtype=cd[1], device="cpu")
    jl, jcaches = jmodel.prefill(
        jparams, {"src_embeds": jnp.asarray(src),
                  "tokens": jnp.asarray(prompt)}, jcaches, RULES)
    with torch.inference_mode():
        tl, caches = model.prefill(
            params, {"src_embeds": torch.from_numpy(src),
                     "tokens": torch.from_numpy(prompt)}, caches)
    pairs = [(jl, tl)]
    for s in range(STEPS):
        jl, jcaches = jmodel.decode(jparams, {"tokens": jnp.asarray(forced[s])},
                                    jcaches, jnp.asarray(T + s, jnp.int32),
                                    RULES)
        with torch.inference_mode():
            tl, caches = model.decode(
                params, {"tokens": torch.from_numpy(forced[s])}, caches,
                T + s)
        pairs.append((jl, tl))
    for jl, tl in pairs:
        assert tl.shape == (B, 1, cfg.vocab) and tl.dtype == torch.float32
        _scaled_close(tl.numpy(), jl, tol)
        if dtype == "float32":
            np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                          np.asarray(jl).argmax(-1))
    carried = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                              device="cpu", cache_dtype=cd[1])
    assert set(carried) == {"self", "cross"}
    assert carried["cross"]["k"].shape[2] == cross_len
    flat = torch.utils._pytree.tree_flatten_with_path
    for (path, a), (_, b) in zip(flat(carried)[0], flat(caches)[0]):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   atol=4 * tol, rtol=tol, err_msg=str(path))


def test_decode_consistent_with_longer_prefill():
    """The port's prefill over T + 1 target tokens against a prefill over
    T and one decode step, the same source (tests/test_models_smoke.py's
    check for the decoder-only models, here with a cross cache)."""
    _, _, model, params, cfg, _ = _models("float32")
    src, prompt, forced = _inputs(cfg, seed=2)
    toks = torch.from_numpy(np.concatenate([prompt, forced[0]], axis=1))
    batch = {"src_embeds": torch.from_numpy(src)}
    f32 = {"cache_dtype": torch.float32, "device": "cpu"}
    with torch.inference_mode():
        full, _ = model.prefill(params, {**batch, "tokens": toks},
                                model.init_caches(B, T + 1, T_SRC, **f32))
        _, c = model.prefill(params, {**batch, "tokens": toks[:, :T]},
                             model.init_caches(B, T + 1, T_SRC, **f32))
        dec, _ = model.decode(params, {"tokens": toks[:, T:]}, c, T)
    torch.testing.assert_close(full, dec, atol=1e-4, rtol=1e-4)


def _f32_gap(score_scale):
    """seamless at full width cut to 2 + 2 layers (vocab 512), the port in
    float32 against itself in float64 (caches in the compute type), with
    every ``wq`` and ``wk`` multiplied by ``score_scale``: the largest
    logit gap over a prefill and two decode steps, relative to
    max|logit|."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH).with_(enc_layers=2, dec_layers=2, n_layers=4,
                                 vocab=512)
    params = build_model(cfg).init(0, device="cpu")

    def scale(t):
        return {k: (scale(v) if isinstance(v, dict)
                    else v * score_scale if k in ("wq", "wk") else v)
                for k, v in t.items()}
    params = scale(params)
    src = shapes.concrete_batch(cfg, "prefill", 2, 6,
                                device="cpu")["src_embeds"]
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2, 1)))
    logits = []
    for dt in (torch.float32, torch.float64):
        m = build_model(cfg.with_(dtype=dt))
        p = torch.utils._pytree.tree_map(lambda t: t.to(dt), params)
        caches = m.init_caches(2, 8, cache_dtype=dt, device="cpu")
        with torch.inference_mode():
            out, caches = m.prefill(p, {"tokens": prompt,
                                        "src_embeds": src.to(dt)}, caches)
            outs = [out.double()]
            for s in range(2):
                out, caches = m.decode(p, {"tokens": forced[s]}, caches, 6 + s)
                outs.append(out.double())
        logits.append(outs)
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(*logits))


def test_full_width_rounding_growth():
    """Why chip_smoke.py holds seamless's card-against-CPU bar at unit score
    variance: with the init's weights (score std ~64 at d 1024, 16 heads)
    the six attentions of 2 + 2 layers are near one-hot, and fp32 rounding
    alone moves the logits past 1e-4 (measured: 7.4e-4); with ``wq`` and
    ``wk`` scaled by head_dim**-0.5 the gap stays at rounding size
    (7.5e-7)."""
    unit = _f32_gap(64 ** -0.5)
    native = _f32_gap(1.0)
    assert unit <= 1e-5
    assert native > 1e-4 and native >= 100 * unit


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_matches_jax(dtype):
    _, jparams, _, params, cfg, tol = _models(dtype)
    jcfg = jax_smoke_config(ARCH).with_(dtype=DTYPES[dtype][0])
    src, _, _ = _inputs(cfg, seed=1)
    ref = jax_encdec.encode(jparams, jcfg, jnp.asarray(src), RULES)
    out = encdec.encode(params, cfg, torch.from_numpy(src))
    assert out.dtype == cfg.dtype
    _scaled_close(out.float().numpy(), ref, tol)


@pytest.mark.parametrize("cross_len", [T_SRC + 4, T_SRC, T_SRC - 2],
                         ids=["padded", "equal", "cut"])
def test_build_cross_caches_matches_jax(cross_len):
    """Each decoder layer's cross K/V from the encoder output: the first
    min(T_src, cross_len) positions, zero padding after them."""
    _, jparams, model, params, cfg, tol = _models("float32")
    jcfg = jax_smoke_config(ARCH).with_(dtype=jnp.float32)
    src, _, _ = _inputs(cfg, seed=3)
    enc = np.array(jax_encdec.encode(jparams, jcfg, jnp.asarray(src),
                                       RULES))
    jc = jax_build_model(jcfg).init_caches(B, 4, cross_len=cross_len,
                                           cache_dtype=jnp.float32)
    ref = jax_encdec.build_cross_caches(jparams, jcfg, jnp.asarray(enc), jc)
    caches = model.init_caches(B, 4, cross_len, cache_dtype=torch.float32,
                               device="cpu")
    caches["cross"]["k"].fill_(7.0)     # stale values must be overwritten
    out = encdec.build_cross_caches(params, cfg, torch.from_numpy(enc),
                                    caches)
    assert out is caches["cross"]
    n = min(T_SRC, cross_len)
    for name in ("k", "v"):
        assert out[name].shape == (cfg.dec_layers, B, cross_len,
                                   cfg.n_kv_heads, cfg.resolved_head_dim())
        _scaled_close(out[name].numpy(), ref[name], 1e-6)
        assert torch.all(out[name][:, :, n:] == 0)


@pytest.mark.parametrize("given", [False, True], ids=["from_src", "cached"])
def test_cross_attention_matches_jax(given):
    """Non-causal over every key, no RoPE; with a cache the source is not
    read."""
    jcfg = jax_smoke_config(ARCH).with_(dtype=jnp.float32)
    cfg = smoke_config(ARCH).with_(dtype=torch.float32)
    rng = np.random.default_rng(4)
    hd, d = cfg.resolved_head_dim(), cfg.d_model
    p = {"wq": rng.normal(0, 0.3, (d, cfg.n_heads, hd)),
         "wk": rng.normal(0, 0.3, (d, cfg.n_kv_heads, hd)),
         "wv": rng.normal(0, 0.3, (d, cfg.n_kv_heads, hd)),
         "wo": rng.normal(0, 0.3, (cfg.n_heads, hd, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    assert set(layers.cross_attention_def(cfg)) == set(p)
    x = rng.normal(0, 1, (B, 5, d)).astype(np.float32)
    src = rng.normal(0, 1, (B, 11, d)).astype(np.float32)
    kv = None
    if given:
        kv = {n: rng.normal(0, 1, (B, 11, cfg.n_kv_heads, hd)).astype(
            np.float32) for n in ("k", "v")}
    ref, _ = jax_layers.cross_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        None if given else jnp.asarray(src), jcfg,
        kv_cache=None if kv is None else jax.tree.map(jnp.asarray, kv))
    out, cache = layers.cross_attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        None if given else torch.from_numpy(src), cfg,
        kv_cache=None if kv is None else {k: torch.from_numpy(v)
                                          for k, v in kv.items()})
    assert set(cache) == {"k", "v"} and cache["k"].shape[1] == 11
    _scaled_close(out.numpy(), ref, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_cache_free_self_attention_matches_jax(causal):
    jcfg = jax_smoke_config(ARCH).with_(dtype=jnp.float32)
    cfg = smoke_config(ARCH).with_(dtype=torch.float32)
    rng = np.random.default_rng(5)
    hd, d = cfg.resolved_head_dim(), cfg.d_model
    p = {"wq": rng.normal(0, 0.3, (d, cfg.n_heads, hd)),
         "wk": rng.normal(0, 0.3, (d, cfg.n_kv_heads, hd)),
         "wv": rng.normal(0, 0.3, (d, cfg.n_kv_heads, hd)),
         "wo": rng.normal(0, 0.3, (cfg.n_heads, hd, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (B, 8, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8), (B, 8))
    ref, rc = jax_layers.self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        causal=causal, positions=jnp.asarray(pos))
    out, cache = layers.self_attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        cfg, causal=causal, positions=torch.from_numpy(pos.copy()))
    assert rc is None and cache is None
    _scaled_close(out.numpy(), ref, 1e-5)


def test_cache_free_decode_trunk_matches_jax():
    """The decoder without caches (the loss path's trunk): self-attention
    over the tokens alone, cross-attention over the encoder output."""
    jmodel, jparams, _, params, cfg, tol = _models("float32")
    jcfg = jax_smoke_config(ARCH).with_(dtype=jnp.float32)
    src, prompt, _ = _inputs(cfg, seed=6)
    enc = jax_encdec.encode(jparams, jcfg, jnp.asarray(src), RULES)
    ref, _ = jax_encdec.decode_trunk(jparams, jcfg, jnp.asarray(prompt), enc,
                                     RULES)
    out, caches = encdec.decode_trunk(params, cfg, torch.from_numpy(prompt),
                                      torch.from_numpy(np.array(enc)))
    assert caches is None
    _scaled_close(out.numpy(), ref, tol)


def test_encdec_layout_follows_the_jax_package():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    def shapes_of(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(shapes_of(v, f"{path}/{k}"))
            return out
        return {path: tuple(tree.shape)}
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert shapes_of(build_model(port).param_defs) == shapes_of(
            jax_build_model(ref).param_defs)
    cfg = smoke_config(ARCH)
    got = build_model(cfg).init_caches(2, 9, cross_len=5, device="cpu")
    assert shapes_of(got) == shapes_of(
        jax_build_model(jax_smoke_config(ARCH)).init_caches(2, 9,
                                                            cross_len=5))
    # cross_len 0 takes max_len, as the JAX package
    assert build_model(cfg).init_caches(
        2, 9, device="cpu")["cross"]["k"].shape[2] == 9


# ---------------------------------------------------------------------------
# Entry points: shapes, steps, the serve loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", jax_list_archs())
def test_concrete_batch_shapes_match_jax(arch, kind):
    jb = jax_shapes.concrete_batch(jax_smoke_config(arch), kind, 3, 12)
    tb = shapes.concrete_batch(smoke_config(arch), kind, 3, 12, device="cpu")
    assert set(tb) == set(jb)
    for k, v in jb.items():
        assert tuple(tb[k].shape) == v.shape, k
        assert tb[k].is_floating_point() == jnp.issubdtype(v.dtype,
                                                           jnp.floating), k
    if "tokens" in tb and kind != "decode":
        assert int(tb["tokens"].min()) >= 0
        assert int(tb["tokens"].max()) < smoke_config(arch).vocab
    again = shapes.concrete_batch(smoke_config(arch), kind, 3, 12,
                                  device="cpu")
    assert all(torch.equal(again[k], tb[k]) for k in tb)


def test_cells_match_jax():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == {
        k: vars(v) for k, v in jax_shapes.SHAPES.items()}
    for arch in jax_list_archs():
        for name in shapes.SHAPES:
            assert shapes.cell_applicable(
                get_config(arch), shapes.SHAPES[name]) == \
                jax_shapes.cell_applicable(jax_get_config(arch),
                                           jax_shapes.SHAPES[name])


def test_steps_drive_seamless_from_concrete_batch():
    """The encoder-decoder's entry point: ``make_prefill_step`` /
    ``make_decode_step`` fed by ``concrete_batch``, as
    tests/test_models_smoke.py drives the JAX package (source and target
    both 12 long)."""
    cfg = smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = shapes.concrete_batch(cfg, "prefill", 2, 12, device="cpu")
    caches = model.init_caches(2, 12 + 4, cross_len=12, device="cpu")
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    with torch.inference_mode():
        logits, caches = prefill(params, batch, caches)
        assert logits.shape == (2, 1, cfg.vocab)
        tok = torch.argmax(logits[:, -1], dim=-1)
        for s in range(4):
            tok, logits, caches = decode(params, {"tokens": tok[:, None]},
                                         caches, 12 + s)
            assert logits.shape == (2, 1, cfg.vocab)
            assert bool(torch.isfinite(logits).all())


def test_serve_loop_cannot_serve_seamless_in_either_package():
    """Both serving loops batch tokens only; the encoder-decoder's prefill
    needs the source frames, so both fail naming ``src_embeds``."""
    prompt = np.arange(1, 6)
    jloop = JaxServeLoop(jax_smoke_config(ARCH), max_batch=1)
    with pytest.raises(KeyError, match="src_embeds"):
        jloop.run_batch([JaxRequest(rid=0, prompt=prompt, max_new=2)])
    loop = ServeLoop(smoke_config(ARCH), max_batch=1, device="cpu")
    with pytest.raises(KeyError, match="src_embeds"):
        loop.run_batch([Request(rid=0, prompt=prompt, max_new=2)])
