"""The port's MoE (``models/moe.py``) and its two configs against the JAX
package, on the CPU.

The same numpy inputs and parameters (the JAX init, carried across with
``params_from_jax`` or as numpy) go through both packages.  Bars:
``apply_moe`` 1e-5 x max|out| in float32 and 3e-2 in bf16; whole models
1e-4 x max|logit| in float32 and 3e-2 in bf16, as
tests/test_torch_models.py (the bf16 models at unit score variance, as
tests/test_torch_families.py explains).

Two places where the reference leaves an order open are held exactly:
tied router probabilities (``jax.lax.top_k`` puts the lower expert first)
and the routing table's colliding writes (every dropped assignment writes
the sentinel into cell (g, 0, C-1), where an overflowing expert 0 also
keeps a token; the JAX package's CPU scatter lets the last write win).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import AxisRules
from repro.models import MoEConfig as JaxMoEConfig
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro.models.common import tree_defs_init
from repro.models.moe import _capacity as jax_capacity
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import moe_def as jax_moe_def
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import caches_from_jax, params_from_jax
from repro_torch.models import MoEConfig, ModelConfig, build_model
from repro_torch.models import common
from repro_torch.models.common import ParamDef, init_leaf
from repro_torch.models.moe import _capacity, apply_moe, moe_def, route

RULES = AxisRules(fsdp_axes=(), dp_axes=())
ARCHS = ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, T, STEPS = 2, 7, 3


def _cfgs(E=8, K=2, cf=1.25, shared=False, groups=0, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    kw = dict(arch="t", family="moe", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=32, vocab=64, head_dim=8, moe_groups=groups)
    moe = dict(n_experts=E, top_k=K, d_ff_expert=32, capacity_factor=cf,
               shared_expert=shared)
    return (JaxModelConfig(**kw, moe=JaxMoEConfig(**moe), dtype=jdt),
            ModelConfig(**kw, moe=MoEConfig(**moe), dtype=tdt))


def _params(jcfg, seed=0):
    """The JAX init of ``moe_def`` as numpy."""
    return jax.tree.map(np.asarray,
                        tree_defs_init(jax_moe_def(jcfg),
                                       jax.random.PRNGKey(seed)))


def _both(jcfg, cfg, nparams, x):
    """(out, aux) of both packages on the same numpy inputs."""
    jdt = jcfg.dtype
    jout, jaux = jax_apply_moe(jax.tree.map(jnp.asarray, nparams),
                               jnp.asarray(x, jdt), jcfg, RULES)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), nparams)
    out, aux = apply_moe(tparams, torch.from_numpy(x).to(cfg.dtype), cfg)
    return (np.asarray(jout, np.float32), float(jaux),
            out.float().numpy(), float(aux))


def _scaled_close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------
def test_capacity_formula():
    """tests/test_moe.py's cases, and the JAX formula at other sizes."""
    _, cfg = _cfgs(E=128, K=8, cf=1.25)
    assert _capacity(32768, cfg) == 2560          # 32768*8*1.25/128
    assert _capacity(4, cfg) == 8                 # floor at 8
    for E, K, cf in ((128, 8, 1.25), (128, 1, 2.0), (8, 2, 1.25)):
        jcfg, cfg = _cfgs(E=E, K=K, cf=cf)
        for s in (1, 7, 60, 61, 1000, 4096):
            assert _capacity(s, cfg) == jax_capacity(s, jcfg)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("E,K,shared,groups", [
    (8, 1, False, 0), (8, 2, False, 0), (16, 4, False, 0),
    (8, 1, True, 0),                      # llama4's shared expert
    (8, 2, False, 2),                     # two routing groups
    (8, 2, False, 3),                     # 3 does not divide: one group
], ids=["E8K1", "E8K2", "E16K4", "shared", "G2", "G3"])
def test_apply_moe_matches_jax(dtype, E, K, shared, groups):
    jcfg, cfg = _cfgs(E=E, K=K, shared=shared, groups=groups, dtype=dtype)
    nparams = _params(jcfg, seed=E + K)
    x = np.random.default_rng(E * K).normal(0, 1, (2, 16, 32)).astype(
        np.float32)
    jout, jaux, out, aux = _both(jcfg, cfg, nparams, x)
    _scaled_close(out, jout, MOE_TOL[dtype])
    assert aux == pytest.approx(jaux, rel=1e-5)


def test_route_drops_past_capacity():
    """Every kept slot is below C and unique within its expert; the drops
    are the assignments of rank C and more."""
    _, cfg = _cfgs(E=8, K=2, cf=0.5)
    params = {"router": torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (32, 8)).astype(np.float32))}
    xg = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (1, 64, 32)).astype(np.float32))
    gates, idx, slot, keep, _ = route(params, xg, cfg)
    C = _capacity(64, cfg)
    assert torch.allclose(gates.sum(-1), torch.ones(1, 64))
    flat = idx.reshape(1, -1)
    for e in range(8):
        mine = slot[flat == e]
        assert torch.equal(mine, torch.arange(len(mine)))
    assert torch.equal(keep, slot < C) and int((~keep).sum()) > 0


def test_huge_capacity_equals_dense_mixture():
    """tests/test_moe.py's identity: with capacity past the tokens (no
    drops) and K = E, the output is the gate-weighted mixture of every
    expert's MLP."""
    _, cfg = _cfgs(E=4, K=4, cf=64.0)
    gen = torch.Generator().manual_seed(0)
    params = {k: init_leaf(gen, d, "cpu") for k, d in moe_def(cfg).items()}
    x = torch.randn(1, 8, 32, generator=gen)
    out, _ = apply_moe(params, x, cfg)
    gates = torch.softmax(x @ params["router"], dim=-1)
    dense = torch.zeros_like(x)
    for e in range(4):
        h = (torch.nn.functional.silu(x @ params["wg"][e])
             * (x @ params["wu"][e]))
        dense = dense + gates[..., e:e + 1] * (h @ params["wd"][e])
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-5)


def test_tied_router_keeps_lower_experts_first():
    """A zero router makes every probability 1/E: both packages route each
    token to experts 0..K-1, so experts 0 and 1 overflow."""
    jcfg, cfg = _cfgs(E=8, K=2)
    nparams = _params(jcfg, seed=1)
    nparams["router"] = np.zeros_like(nparams["router"])
    x = np.random.default_rng(1).normal(0, 1, (2, 16, 32)).astype(np.float32)
    _, idx, _, keep, _ = route(
        {"router": torch.from_numpy(nparams["router"])},
        torch.from_numpy(x).reshape(1, 32, 32), cfg)
    assert torch.equal(idx, torch.tensor([0, 1]).expand(1, 32, 2))
    assert int(keep.sum()) == 2 * _capacity(32, cfg)
    jout, jaux, out, aux = _both(jcfg, cfg, nparams, x)
    _scaled_close(out, jout, MOE_TOL["float32"])
    assert aux == jaux == 2.0


def _routed_to(experts, E=4):
    """A router and inputs that send token s to ``experts[s]`` (K 1):
    input s is a positive vector scaled per token, router column e its
    indicator."""
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(0, 1, (1, len(experts), 32))).astype(np.float32)
    x[0, :, :E] = 0.0
    for s, e in enumerate(experts):
        x[0, s, e] = 10.0
    router = np.zeros((32, E), np.float32)
    router[np.arange(E), np.arange(E)] = 1.0
    return x, router


def test_expert0_overflow_zeroes_its_last_kept_token():
    """The reference's collision: 16 tokens all on expert 0, C 8.  Tokens
    8-15 are dropped and write the sentinel into cell (0, 7), where token
    7 was kept; the last write wins, so token 7's output is the zero row
    in both packages, though it was kept."""
    jcfg, cfg = _cfgs(E=4, K=1)
    nparams = _params(jcfg)
    x, nparams["router"] = _routed_to([0] * 16)
    jout, _, out, _ = _both(jcfg, cfg, nparams, x)
    norms = np.abs(out[0]).sum(-1)
    assert np.all(norms[:7] > 0) and np.all(norms[7:] == 0)
    np.testing.assert_array_equal(np.abs(jout[0]).sum(-1) == 0, norms == 0)
    _scaled_close(out, jout, MOE_TOL["float32"])


def test_collision_won_by_the_last_write():
    """Drops of expert 1 come first, and expert 0's kept token in slot C-1
    is the last assignment: it writes last and keeps its output (both
    packages); a drop after it would zero it again."""
    jcfg, cfg = _cfgs(E=4, K=1)
    nparams = _params(jcfg)
    for order, zero_last_kept in (([1] * 12 + [0] * 8, False),
                                  ([1] * 12 + [0] * 8 + [1], True)):
        x, nparams["router"] = _routed_to(order)
        jout, _, out, _ = _both(jcfg, cfg, nparams, x)
        assert (np.abs(out[0, 19]).sum() == 0) == zero_last_kept
        np.testing.assert_array_equal(np.abs(jout[0]).sum(-1) == 0,
                                      np.abs(out[0]).sum(-1) == 0)
        _scaled_close(out, jout, MOE_TOL["float32"])


# ---------------------------------------------------------------------------
# Configs, layouts, init
# ---------------------------------------------------------------------------
def _shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    return {path: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layout_follows_the_jax_package(arch):
    """The full and smoke definition trees (names, shapes) and the caches
    of both packages agree; llama4's unit is one dense and one MoE layer."""
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (smoke_config(arch), jax_smoke_config(arch))):
        assert vars(port.moe) == vars(ref.moe)
        assert _shapes(build_model(port).param_defs) == _shapes(
            jax_build_model(ref).param_defs)
    cfg = smoke_config(arch)
    caches = build_model(cfg).init_caches(2, 9, device="cpu")
    assert _shapes(caches) == _shapes(
        jax_build_model(jax_smoke_config(arch)).init_caches(2, 9))
    unit = set(build_model(get_config(arch)).param_defs["blocks"])
    assert unit == ({"moe_layer", "dense_0"} if arch.startswith("llama4")
                    else {"moe_layer"})


def test_narrow_leaf_drawn_in_pieces(monkeypatch):
    """A bf16 leaf past ``PIECE_BYTES`` of float32 is drawn piece by piece
    along its leading axes (here 2 x 3 rows of 4 x 8), each piece scaled
    and cast; a float32 leaf is drawn whole, as before."""
    monkeypatch.setattr(common, "PIECE_BYTES", 4 * 4 * 8 * 3)
    d = ParamDef((2, 5, 4, 8), dtype=torch.bfloat16)
    got = init_leaf(torch.Generator().manual_seed(3), d, "cpu")
    gen = torch.Generator().manual_seed(3)
    rows = [torch.randn((n, 4, 8), generator=gen) for n in (3, 3, 3, 1)]
    want = (torch.cat(rows) * 4 ** -0.5).to(torch.bfloat16).reshape(d.shape)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    f = ParamDef((2, 5, 4, 8))
    got = init_leaf(torch.Generator().manual_seed(3), f, "cpu")
    whole = torch.randn(f.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, whole * 4 ** -0.5)


# ---------------------------------------------------------------------------
# Whole models: prefill and three decode steps
# ---------------------------------------------------------------------------
def _unit_score_scale(tree, s):
    return {k: (_unit_score_scale(v, s) if isinstance(v, dict)
                else v * np.float32(s) if k in ("wq", "wk") else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(arch).with_(dtype=jdt)
    cfg = smoke_config(arch).with_(dtype=tdt)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    nparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    if dtype == "bfloat16":
        nparams = _unit_score_scale(nparams, cfg.resolved_head_dim() ** -0.5)
    jparams = jax.tree.map(jnp.asarray, nparams)
    params = params_from_jax(nparams, cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (B, T))
    forced = rng.integers(0, cfg.vocab, (STEPS, B, 1))
    jcd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jcaches = jmodel.init_caches(B, T + STEPS, cache_dtype=jcd)
    caches = model.init_caches(B, T + STEPS, cache_dtype=tdt, device="cpu")
    jl, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                 jcaches, RULES)
    with torch.inference_mode():
        tl, caches = model.prefill(params,
                                   {"tokens": torch.from_numpy(prompt)},
                                   caches)
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
        _scaled_close(tl.numpy(), jl, MODEL_TOL[dtype])
    # the JAX caches carried across hold what the port's caches hold
    carried = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                              device="cpu", cache_dtype=tdt)
    flat = torch.utils._pytree.tree_flatten_with_path
    for (path, a), (_, b) in zip(flat(carried)[0], flat(caches)[0]):
        assert a.shape == b.shape and a.dtype == b.dtype == tdt, path
        if dtype == "float32":
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=4e-4,
                                       rtol=1e-4, err_msg=str(path))
