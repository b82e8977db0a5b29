"""The port's stablelm model against the JAX package's, on the CPU.

The smoke stablelm config; parameters come from the JAX model's
``init(PRNGKey(0))`` and are carried across with ``params_from_jax``.
Prefill, then three teacher-forced decode steps, through both packages.

Tolerances, relative to the largest |logit|:
* float32 activations: 1e-4.  Both packages then compute in fp32 and
  round K/V to the same bf16 cache; what is left is summation order
  (measured: at most 9.6e-7).
* bfloat16 activations (the config's): 3e-2.  bf16 rounds at other places
  in the two frameworks (inside XLA's fused einsums versus after each
  torch op); measured: at most 8.4e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import list_archs as jax_list_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.models import AxisRules
from repro.models import build_model as jax_build_model
from repro.models.layers import apply_norm as jax_apply_norm
from repro.models.layers import apply_rope as jax_apply_rope
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import caches_from_jax, params_from_jax
from repro_torch.models import build_model
from repro_torch.models.layers import apply_norm, apply_rope

RULES = AxisRules(fsdp_axes=(), dp_axes=())
B, T, STEPS = 2, 7, 3
CASES = {"float32": (jnp.float32, torch.float32, 1e-4),
         "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _run_both(dtype, tie=False):
    jdt, tdt, tol = CASES[dtype]
    jcfg = jax_smoke_config("stablelm-1.6b").with_(dtype=jdt,
                                                   tie_embeddings=tie)
    cfg = smoke_config("stablelm-1.6b").with_(dtype=tdt, tie_embeddings=tie)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (B, T))
    forced = rng.integers(0, cfg.vocab, (STEPS, B))

    jcaches = jmodel.init_caches(B, max_len=T + STEPS)
    caches = model.init_caches(B, max_len=T + STEPS, device="cpu")
    jl, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                 jcaches, RULES)
    with torch.inference_mode():
        tl, caches = model.prefill(params, {"tokens": torch.from_numpy(prompt)},
                                   caches)
    pairs = [(np.asarray(jl, np.float32), tl.float().numpy())]
    for s in range(STEPS):
        tok = forced[s][:, None]
        jl, jcaches = jmodel.decode(jparams, {"tokens": jnp.asarray(tok)},
                                    jcaches, jnp.asarray(T + s, jnp.int32),
                                    RULES)
        with torch.inference_mode():
            tl, caches = model.decode(params, {"tokens": torch.from_numpy(tok)},
                                      caches, T + s)
        pairs.append((np.asarray(jl, np.float32), tl.float().numpy()))
    return pairs, jcaches, caches, tol


@pytest.mark.parametrize("dtype,tie", [("float32", False), ("bfloat16", False),
                                       ("float32", True)])
def test_prefill_and_decode_match_jax(dtype, tie):
    pairs, jcaches, caches, tol = _run_both(dtype, tie)
    for ref, out in pairs:
        assert out.shape == ref.shape
        assert np.all(np.isfinite(out))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out / scale, ref / scale, atol=tol, rtol=0)
        if dtype == "float32":
            np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    # the caches filled by the two packages agree too
    cfg = smoke_config("stablelm-1.6b")
    carried = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                              device="cpu")
    for name in ("k", "v"):
        np.testing.assert_allclose(
            caches["blocks"][name].float().numpy(),
            carried["blocks"][name].float().numpy(), atol=tol * 4, rtol=tol)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (2, 3, 16)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 16).astype(np.float32),
         "bias": rng.normal(0, 0.1, 16).astype(np.float32)}
    ref = jax_apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    out = apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 5, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, 45), (2, 5))
    ref = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    out = apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                     10_000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_init_matches_jax_std_rule():
    """Same init rule as the JAX package: std = 1/sqrt(shape[-2])."""
    cfg = smoke_config("stablelm-1.6b").with_(d_model=64, n_heads=8,
                                              n_kv_heads=8, d_ff=256)
    params = build_model(cfg).init(0, device="cpu")
    wq = params["blocks"]["attn"]["wq"]            # (L, d, H, hd)
    assert wq.dtype == torch.float32
    assert abs(wq.std().item() - 1 / np.sqrt(cfg.n_heads)) < 0.02
    wd = params["blocks"]["mlp"]["wd"]             # (L, f, d)
    assert abs(wd.std().item() - 1 / np.sqrt(cfg.d_ff)) < 0.01
    assert torch.equal(params["ln_f"]["scale"], torch.ones(cfg.d_model))
    assert torch.equal(params["blocks"]["ln1"]["bias"],
                       torch.zeros(cfg.n_layers, cfg.d_model))
    again = build_model(cfg).init(0, device="cpu")
    assert torch.equal(again["embed"], params["embed"])


def test_full_config_matches_jax_and_counts_params():
    from repro.configs import get_config as jax_get_config
    jcfg, cfg = jax_get_config("stablelm-1.6b"), get_config("stablelm-1.6b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "norm", "act", "rope_theta", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert 1.6e9 < cfg.param_count() < 1.7e9
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32


#: every field of ModelConfig that a config file sets (dtypes are the
#: frameworks' own and are compared by name)
CONFIG_FIELDS = ("arch", "family", "n_layers", "d_model", "n_heads",
                 "n_kv_heads", "d_ff", "vocab", "head_dim", "qkv_bias",
                 "norm", "act", "rope_theta", "mrope", "tie_embeddings",
                 "hybrid_attn_every", "enc_layers", "dec_layers",
                 "attn_chunk", "xent_chunk", "remat", "moe_groups",
                 "kernel_mode", "seq_shard")


def test_port_serves_the_jax_packages_ten_archs():
    """``list_archs()`` holds the JAX package's ten architectures, and each
    full and smoke config matches the JAX package's field for field (the
    MoE and SSM sub-configs too; dtypes by name)."""
    from repro.configs import get_config as jax_get_config
    from repro.configs import smoke_config as jax_smoke
    assert sorted(list_archs()) == sorted(jax_list_archs())
    assert len(list_archs()) == 10
    for arch in list_archs():
        for port, ref in ((get_config(arch), jax_get_config(arch)),
                          (smoke_config(arch), jax_smoke(arch))):
            for f in CONFIG_FIELDS:
                assert getattr(port, f) == getattr(ref, f), (arch, f)
            for sub in ("moe", "ssm"):
                a, b = getattr(port, sub), getattr(ref, sub)
                assert (a is None) == (b is None), (arch, sub)
                if a is not None:
                    assert vars(a) == vars(b), (arch, sub)
            for f in ("dtype", "param_dtype"):
                assert (str(getattr(port, f)).split(".")[-1]
                        == jnp.dtype(getattr(ref, f)).name), (arch, f)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_param_counts_match_jax(arch):
    """``param_count`` and ``active_param_count`` of the full config (and
    of llama4 cut to one unit, as chip_smoke.py runs it) equal the JAX
    package's."""
    from repro.configs import get_config as jax_get_config
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    if cfg.moe is not None:
        assert cfg.active_param_count() < cfg.param_count()
        cut = {"n_layers": cfg.moe.every}
        assert (cfg.with_(**cut).param_count()
                == jcfg.with_(**cut).param_count())
    else:
        assert cfg.active_param_count() == cfg.param_count()


def _full_depth_f32_gap(d_model, score_scale):
    """24 random layers at width ``d_model`` (heads of 64): the port in
    float32 against itself in float64, caches in the compute type, with
    ``wq`` and ``wk`` multiplied by ``score_scale``; the largest logit gap
    over a prefill and two decode steps, relative to max|logit|."""
    cfg = get_config("stablelm-1.6b").with_(
        d_model=d_model, n_heads=d_model // 64, n_kv_heads=d_model // 64,
        head_dim=64, d_ff=d_model * 11 // 4, vocab=8192)
    model = build_model(cfg.with_(dtype=torch.float32))
    params = model.init(0, device="cpu")
    attn = params["blocks"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * score_scale, attn["wk"] * score_scale
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


@pytest.mark.parametrize("d_model", [512, 1024])
def test_full_depth_rounding_growth(d_model):
    """Why the card-vs-CPU check at full depth (chip_smoke.py) scales the
    attention weights: the init rule (std 1/sqrt(shape[-2]), the heads dim
    of ``wq``) gives scores of std head_dim = 64, softmax is near one-hot,
    and 24 layers grow fp32 rounding by orders of magnitude (measured:
    4.9e-2 at d 512, 5.5e-3 at d 1024).  With ``wq`` and ``wk`` scaled by
    head_dim**-0.5 the scores have unit std and the gap stays at rounding
    size (measured: 9.7e-7 and 9.3e-7)."""
    torch.manual_seed(0)
    unit = _full_depth_f32_gap(d_model, 64 ** -0.5)
    native = _full_depth_f32_gap(d_model, 1.0)
    assert unit <= 1e-5
    assert native >= 100 * unit
