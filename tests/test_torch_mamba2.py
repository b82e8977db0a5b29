"""The port's mamba2 model against the JAX package's, on the CPU.

Parameters come from the JAX model's ``init(PRNGKey(0))`` and are carried
across with ``params_from_jax``; inputs are made with numpy from a seed.

Tolerances, relative to the largest |output|:
* float32 activations: 1e-4, with float32 caches in the whole-model
  tests: what is left is summation order.  (With the bf16 conv cache, one
  window element whose fp32 value lies on a bf16 rounding boundary can
  round one ulp apart in the two packages, which moved the next decode
  step's logits past 1e-4 x max|logit| on the smoke config.)
* bfloat16 activations (the config's): 3e-2, as for stablelm: bf16 rounds
  at other places in the two frameworks (inside XLA's fused ops against
  after each torch op).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import AxisRules
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as jax_mamba2
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import caches_from_jax, params_from_jax
from repro_torch.models import build_model
from repro_torch.models import mamba2

RULES = AxisRules(fsdp_axes=(), dp_axes=())
ARCH = "mamba2-1.3b"
B, T, STEPS = 2, 7, 3
CASES = {"float32": (jnp.float32, torch.float32, 1e-4),
         "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
#: the whole-model tests keep their caches in the compute dtype
CACHE = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The 48-layer CPU runs below are many small ops: with several test
    workers on one host, torch's default of a thread per core makes their
    OpenMP regions wait on each other for minutes.  One thread each keeps
    them at tens of seconds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(dtype, **kw):
    jdt, tdt, tol = CASES[dtype]
    jcfg = jax_smoke_config(ARCH).with_(dtype=jdt, **kw)
    cfg = smoke_config(ARCH).with_(dtype=tdt, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params, tol


def _scaled_close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", sorted(CASES))
def test_causal_conv_matches_jax(dtype):
    jdt, tdt, tol = CASES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 9, 12)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, 12)).astype(np.float32)
    b = rng.normal(0, 0.1, (12,)).astype(np.float32)
    ref = jax_mamba2._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w),
                                  jnp.asarray(b))
    out = mamba2._causal_conv(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w), torch.from_numpy(b))
    assert out.dtype == tdt and out.is_contiguous()
    # bf16: one rounding of the output (2^-8 relative) apart at most
    _scaled_close(out.float().numpy(), ref, 1e-6 if dtype == "float32"
                  else 1e-2)


@pytest.mark.parametrize("dtype", sorted(CASES))
def test_apply_and_decode_mamba2_match_jax(dtype):
    """One mamba2 block of the smoke model: prefill with a cache, then
    decode steps, against the JAX block, outputs and caches."""
    jcfg, _, jparams, cfg, _, params, tol = _models(dtype)
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["mamba"])
    p = {k: v[0] for k, v in params["blocks"]["mamba"].items()}
    rng = np.random.default_rng(1)
    u = rng.normal(0, 1, (B, T + STEPS, cfg.d_model)).astype(np.float32)
    jdt, tdt = CASES[dtype][:2]
    jcache = jax.tree.map(lambda t: t[0],
                          jax_build_model(jcfg).init_caches(B, 1)["blocks"])
    cache = {k: v[0].clone() for k, v in
             build_model(cfg).init_caches(B, 1, device="cpu")["blocks"].items()}
    jo, jcache = jax_mamba2.apply_mamba2(jp, jnp.asarray(u[:, :T], jdt), jcfg,
                                         cache=jcache)
    with torch.inference_mode():
        o, cache = mamba2.apply_mamba2(p, torch.from_numpy(u[:, :T]).to(tdt),
                                       cfg, cache=cache)
    outs = [(o, jo)]
    for s in range(STEPS):
        uj = jnp.asarray(u[:, T + s:T + s + 1], jdt)
        jo, jcache = jax_mamba2.decode_mamba2(jp, uj, jcfg, jcache)
        with torch.inference_mode():
            o, cache = mamba2.decode_mamba2(
                p, torch.from_numpy(u[:, T + s:T + s + 1]).to(tdt), cfg, cache)
        outs.append((o, jo))
    for o, jo in outs:
        _scaled_close(o.float().numpy(), jo, tol)
    for name in ("conv", "state"):
        assert cache[name].dtype == (torch.float32 if name == "state"
                                     else torch.bfloat16)
        _scaled_close(cache[name].float().numpy(), jcache[name], tol)


def _prefill_decode_both(dtype):
    jcfg, jmodel, jparams, cfg, model, params, tol = _models(dtype)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (B, T))
    forced = rng.integers(0, cfg.vocab, (STEPS, B))
    jcd, cd = CACHE[dtype]
    jcaches = jmodel.init_caches(B, max_len=T + STEPS, cache_dtype=jcd)
    caches = model.init_caches(B, max_len=T + STEPS, cache_dtype=cd,
                               device="cpu")
    jl, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                 jcaches, RULES)
    with torch.inference_mode():
        tl, caches = model.prefill(params, {"tokens": torch.from_numpy(prompt)},
                                   caches)
    pairs = [(jl, tl)]
    for s in range(STEPS):
        tok = forced[s][:, None]
        jl, jcaches = jmodel.decode(jparams, {"tokens": jnp.asarray(tok)},
                                    jcaches, jnp.asarray(T + s, jnp.int32),
                                    RULES)
        with torch.inference_mode():
            tl, caches = model.decode(params, {"tokens": torch.from_numpy(tok)},
                                      caches, T + s)
        pairs.append((jl, tl))
    return pairs, jcaches, caches, cfg, tol, cd


@pytest.mark.parametrize("dtype", sorted(CASES))
def test_prefill_and_decode_logits_match_jax(dtype):
    """Prefill, then three teacher-forced decode steps."""
    pairs, _, _, _, tol, _ = _prefill_decode_both(dtype)
    for jl, tl in pairs:
        _scaled_close(tl.float().numpy(), jl, tol)
        if dtype == "float32":
            np.testing.assert_array_equal(tl.float().numpy().argmax(-1),
                                          np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("dtype", sorted(CASES))
def test_caches_from_jax_carries_ssm_caches(dtype):
    """The JAX model's filled caches, carried across, equal the caches the
    port filled from the same prompts; the batch size comes from the ssm
    leaves (there are no "k"/"v" leaves to read it from)."""
    _, jcaches, caches, cfg, tol, cd = _prefill_decode_both(dtype)
    carried = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                              device="cpu", cache_dtype=cd)
    assert set(carried["blocks"]) == {"conv", "state"}
    assert carried["blocks"]["conv"].dtype == cd
    assert carried["blocks"]["state"].dtype == torch.float32
    for name in ("conv", "state"):
        assert carried["blocks"][name].shape == caches["blocks"][name].shape
        _scaled_close(caches["blocks"][name].float().numpy(),
                      carried["blocks"][name].float().numpy(), tol)


def test_decode_consistent_second_length():
    """Port of the JAX package's regression (tests/test_models_smoke.py):
    prefill over T2 + 1 = 18 tokens against prefill over T2 = 17 and one
    decode step.  18 lands one token past the smoke chunk (16): the
    chunked scan's ragged last chunk and its carry, against the decode
    recurrence and the conv window."""
    T2 = 17
    cfg = smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T2 + 1)))
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": tokens},
                                model.init_caches(B, T2 + 1, device="cpu"))
        _, caches = model.prefill(params, {"tokens": tokens[:, :T2]},
                                  model.init_caches(B, T2 + 1, device="cpu"))
        dec, _ = model.decode(params, {"tokens": tokens[:, T2:]}, caches, T2)
    np.testing.assert_allclose(full[:, -1].float().numpy(),
                               dec[:, -1].float().numpy(), atol=3e-2,
                               rtol=3e-2)


def test_full_config_matches_jax_and_counts_params():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "head_dim", "norm", "act", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for f in ("d_state", "d_conv", "expand", "head_dim", "chunk", "n_groups"):
        assert getattr(cfg.ssm, f) == getattr(jcfg.ssm, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert 1.4e9 < cfg.param_count() < 1.5e9
    scfg, sj = smoke_config(ARCH), jax_smoke_config(ARCH)
    assert scfg.param_count() == sj.param_count()
    assert scfg.ssm == type(scfg.ssm)(**vars(sj.ssm))


def _full_depth_f32_gap(d_model, n_layers):
    """``n_layers`` random mamba2 layers at width ``d_model`` (heads of 64,
    N 128): the port in float32 against itself in float64, caches in the
    compute type; the largest logit gap over a prefill and two decode
    steps, relative to max|logit|."""
    cfg = get_config(ARCH).with_(d_model=d_model, n_layers=n_layers,
                                 vocab=8192)
    params = build_model(cfg).init(0, device="cpu")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2, 1)))
    logits = []
    for dt in (torch.float32, torch.float64):
        m = build_model(cfg.with_(dtype=dt))
        p = torch.utils._pytree.tree_map(lambda t: t.to(dt), params)
        caches = m.init_caches(2, 8, cache_dtype=dt, device="cpu")
        with torch.inference_mode():
            out, caches = m.prefill(p, {"tokens": prompt}, caches)
            outs = [out.double()]
            for s in range(2):
                out, caches = m.decode(p, {"tokens": forced[s]}, caches, 6 + s)
                outs.append(out.double())
        logits.append(outs)
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(*logits))


@pytest.mark.parametrize("d_model", [256, 512, 1024])
def test_full_depth_rounding_growth(d_model):
    """Why chip_smoke.py holds the card to the CPU at all 48 layers with
    the stablelm bound, 1e-4 x max|logit|, and unscaled weights: under the
    init rule the SSM layers grow fp32 rounding only about tenfold over 48
    layers (measured: 1.9e-5 at d 256, 1.5e-5 at d 512, 1.7e-5 at d 1024,
    against ~1e-6 after 2 layers), unlike stablelm's near one-hot
    attention (tests/test_torch_models.py::test_full_depth_rounding_growth)."""
    torch.manual_seed(0)
    shallow = _full_depth_f32_gap(d_model, 2)
    deep = _full_depth_f32_gap(d_model, 48)
    assert shallow <= 5e-6
    assert deep <= 5e-5


@pytest.mark.parametrize("d_model", [512, 1024])
def test_full_depth_prefill_decode_consistency(d_model):
    """The CPU's side of chip_smoke.py's check at full width: 48 random
    layers in float32, the last logits of a prefill over 129 tokens
    against a prefill over 128 (one chunk) and one decode step, bound
    1e-4 x max|logit|.  Without any kernel the gap is fp32 rounding grown
    over 48 layers, and the order of the sums moves it tenfold (measured
    here with one thread: 2.0e-6 at d 512, 3.2e-6 at d 1024; the same runs
    with eight threads: 2.7e-6 and 3.3e-5)."""
    cfg = get_config(ARCH).with_(d_model=d_model, vocab=8192,
                                 dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    T = cfg.ssm.chunk
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, (2, T + 1)))
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": toks}, model.init_caches(
            2, T + 1, cache_dtype=torch.float32, device="cpu"))
        caches = model.init_caches(2, T + 1, cache_dtype=torch.float32,
                                   device="cpu")
        _, caches = model.prefill(params, {"tokens": toks[:, :T]}, caches)
        dec, _ = model.decode(params, {"tokens": toks[:, T:]}, caches, T)
    full, dec = full[:, -1], dec[:, -1]
    assert float((full - dec).abs().max() / full.abs().max()) <= 1e-4
