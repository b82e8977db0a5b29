"""The port's optimizer against the JAX package's, on the CPU.

The same parameters, state and gradients (numpy, from seeds) go through
``repro.optim`` and ``repro_torch.optim``.  Without clipping the update
is element-wise fp32 arithmetic in the same order, and the port's equals
the JAX package's bit for bit: every parameter, m, v, master, scale and
int8 code (0 differing).  With clipping the grad norm is a sum whose order
differs by an ulp now and then, so: parameters, fp32 state and scales
within 1e-6 relative of the JAX values' max (measured 2.2e-7); bf16 state
within one bf16 ulp (2^-8); int8 codes at most one apart, and the
parameters under int8 state within 1e-4 (a code at a rounding boundary
moves by one step: measured 5.9e-5).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models.common import ParamDef as JaxParamDef
from repro.models.common import tree_defs_init as jax_tree_defs_init
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import compress_grads as jax_compress_grads
from repro.optim import global_norm as jax_global_norm
from repro.optim import lr_at as jax_lr_at
from repro.optim import state_defs as jax_state_defs
from repro_torch.models.common import ParamDef, tree_defs_init
from repro_torch.optim import (AdamWConfig, apply_updates, compress_grads,
                               decompress_grads, global_norm, lr_at,
                               state_defs)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype == jnp.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _close(out, ref, rel, what):
    out, ref = _np(out).astype(np.float64), _np(ref).astype(np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(out - ref).max() <= rel * scale, (what, np.abs(out - ref).max() / scale)


KW = dict(lr=0.05, weight_decay=0.0, clip_norm=0.0, warmup_steps=0,
          schedule="constant")


def _setup(state_dtype="fp32", master=False, stacked=True, **kw):
    """(JAX cfg, params, state; port cfg, params, state) with equal values;
    a master copy starts at the parameters, as tests/test_optim.py's.
    ``stacked`` adds a 3-d leaf "s" of 480 values (not a whole int8
    block) to tests/test_optim.py's two."""
    kw = {**KW, **kw}
    jdefs = {"w": JaxParamDef((8, 16), (None, None)),
             "b": JaxParamDef((16,), (None,), init="zeros")}
    if stacked:
        jdefs["s"] = JaxParamDef((3, 4, 40), (None, None, None))
    jcfg = JaxAdamWConfig(state_dtype=state_dtype, master_fp32=master, **kw)
    cfg = AdamWConfig(state_dtype=state_dtype, master_fp32=master, **kw)
    jparams = jax_tree_defs_init(jdefs, jax.random.PRNGKey(0))
    jstate = jax_tree_defs_init(jax_state_defs(jdefs, jcfg),
                                jax.random.PRNGKey(1))
    if master:
        for k in jparams:
            jstate["mv"][k]["master"] = jparams[k].astype(jnp.float32)
    defs = {"w": ParamDef((8, 16)), "b": ParamDef((16,), init="zeros")}
    if stacked:
        defs["s"] = ParamDef((3, 4, 40))
    sdefs = state_defs(defs, cfg)
    state = _to_torch(jstate)
    # the port's state tree has the JAX package's keys, shapes and dtypes
    flat_defs = {k: d for k, d in _walk(sdefs)}
    for k, t in _walk(state):
        assert t.shape == flat_defs[k].shape and t.dtype == flat_defs[k].dtype
    return jcfg, jparams, jstate, cfg, _to_torch(jparams), state


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _grads(seed, params):
    rng = np.random.default_rng(seed)
    g = {k: rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
         for k, v in params.items()}
    return ({k: jnp.asarray(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in g.items()})


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_adamw_steps_equal_jax_bit_for_bit(state_dtype):
    """30 steps with the same gradients, warmup and weight decay, no
    clipping: every leaf of the parameters and the state equal."""
    jcfg, jp, js, cfg, p, s = _setup(state_dtype, weight_decay=0.1,
                                     warmup_steps=5)
    for i in range(30):
        jg, g = _grads(i, jp)
        jp, js, jm = jax_apply_updates(jp, jg, js, jcfg)
        p, s, m = apply_updates(p, g, s, cfg)
        assert float(m["lr"]) == float(jm["lr"])
        for k in jp:
            assert int((_np(p[k]) != _np(jp[k])).sum()) == 0, (i, k)
        assert int(s["step"]) == int(js["step"]) == i + 1
        for (path, t), (_, j) in zip(_walk(s["mv"]), _walk(js["mv"])):
            assert int((_np(t) != _np(j)).sum()) == 0, (i, path)


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_clipped_cosine_steps_match_jax(state_dtype):
    """30 steps with clipping (the grad norm's sum), a cosine schedule and
    weight decay, at the bars of the module docstring."""
    jcfg, jp, js, cfg, p, s = _setup(state_dtype, clip_norm=0.5,
                                     weight_decay=0.1, warmup_steps=5,
                                     schedule="cosine", total_steps=30)
    for i in range(30):
        jg, g = _grads(i, jp)
        jp, js, jm = jax_apply_updates(jp, jg, js, jcfg)
        p, s, m = apply_updates(p, g, s, cfg)
        _close(m["grad_norm"], jm["grad_norm"], 1e-6, "grad_norm")
        _close(m["lr"], jm["lr"], 1e-6, "lr")
        for k in jp:
            _close(p[k], jp[k], 1e-4 if state_dtype == "int8" else 1e-6,
                   (i, k))
        for (path, t), (_, j) in zip(_walk(s["mv"]), _walk(js["mv"])):
            if path[-1].endswith("_q"):
                d = np.abs(_np(t).astype(int) - _np(j).astype(int))
                assert int(d.max()) <= 1, (i, path)
            elif state_dtype == "bf16" and path[-1] in ("m", "v"):
                _close(t, j, 2 ** -8, (i, path))
            else:
                _close(t, j, 1e-6, (i, path))


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_adamw_minimises_quadratic(state_dtype):
    """tests/test_optim.py's check on the port."""
    *_, cfg, params, state = _setup(state_dtype, stacked=False)
    target = {"w": torch.ones(8, 16), "b": torch.full((16,), 0.5)}

    def loss_fn(p):
        return sum(torch.mean((p[k] - target[k]) ** 2) for k in p)
    l0 = float(loss_fn(params))
    for _ in range(150):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves),
                                                     list(leaves.values()))))
        params, state, _ = apply_updates(params, grads, state, cfg)
    l1 = float(loss_fn(params))
    assert l1 < l0 * 0.05, (state_dtype, l0, l1)


def test_master_fp32_tracks_params_and_matches_jax():
    jcfg, jp, js, cfg, p, s = _setup("bf16", master=True)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    jg = jax.tree.map(lambda x: jnp.ones_like(x, jnp.bfloat16) * 0.1, jp)
    g = {k: torch.full_like(v, 0.1) for k, v in p.items()}
    jp2, js2, _ = jax_apply_updates(jp, jg, js, jcfg)
    p2, s2, _ = apply_updates(p, g, s, cfg)
    np.testing.assert_allclose(_np(p2["w"]), _np(s2["mv"]["w"]["master"]),
                               atol=1e-2)
    assert p2["w"].dtype == torch.bfloat16
    assert s2["mv"]["w"]["master"].dtype == torch.float32
    for k in jp2:
        _close(s2["mv"][k]["master"], js2["mv"][k]["master"], 1e-6, k)
        assert torch.equal(p2[k], s2["mv"][k]["master"].to(torch.bfloat16))
        # the cast of equal fp32 masters: equal bf16 parameters
        _close(p2[k], jp2[k], 2 ** -8, k)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_and_global_norm_match_jax(schedule):
    jcfg = JaxAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          schedule=schedule)
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      schedule=schedule)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        ref = float(jax_lr_at(jcfg, step))
        assert abs(float(lr_at(cfg, step)) - ref) <= 1e-7 * max(ref, 1e-30)
        assert float(lr_at(cfg, torch.tensor(step, dtype=torch.int32))) \
            == float(lr_at(cfg, step))
    if schedule == "cosine":       # tests/test_optim.py's values
        assert float(lr_at(cfg, 0)) < 0.2
        assert float(lr_at(cfg, 10)) == pytest.approx(1.0, abs=0.05)
        assert float(lr_at(cfg, 100)) < 0.05
    t = {"x": torch.full((4,), 3.0), "y": torch.full((4,), 4.0)}
    assert float(global_norm(t)) == pytest.approx(10.0)
    rng = np.random.default_rng(2)
    g = {k: rng.normal(0, 1, s).astype(np.float32)
         for k, s in (("a", (7, 5)), ("b", (33,)), ("c", (2, 3, 4)))}
    _close(global_norm({k: torch.from_numpy(v) for k, v in g.items()}),
           jax_global_norm({k: jnp.asarray(v) for k, v in g.items()}),
           1e-6, "global_norm")


def test_scan_stacked_gives_the_unscanned_numbers():
    """A stacked leaf updated one leading slice at a time equals the
    whole-leaf update bit for bit."""
    out = []
    for scan in (False, True):
        *_, cfg, p, s = _setup("fp32", weight_decay=0.1, scan_stacked=scan)
        for i in range(3):
            _, g = _grads(i, p)
            p, s, _ = apply_updates(p, g, s, cfg)
        out.append((p, s))
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k])
        for n in ("m", "v"):
            assert torch.equal(out[0][1]["mv"][k][n], out[1][1]["mv"][k][n])


def test_compression_roundtrip_and_error_feedback_match_jax():
    """tests/test_optim.py's bounds on the port; the int8 codes equal the
    JAX package's (0 differing), scales and error feedback within 1e-6."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (64, 32)).astype(np.float32)
    g = {"w": torch.from_numpy(w)}
    q, ef = compress_grads(g)
    deq = decompress_grads(q, g)
    rel = float(torch.linalg.norm(deq["w"] - g["w"]) / torch.linalg.norm(g["w"]))
    assert rel < 0.02
    jq, jef = jax_compress_grads({"w": jnp.asarray(w)})
    assert int((q["w"]["q"].numpy() != np.asarray(jq["w"]["q"])).sum()) == 0
    _close(q["w"]["s"], jq["w"]["s"], 1e-6, "scales")
    _close(ef["w"], jef["w"], 1e-6, "error feedback")
    acc = torch.zeros_like(g["w"])
    ef = jef = None
    for _ in range(20):
        q, ef = compress_grads(g, ef)
        jq, jef = jax_compress_grads({"w": jnp.asarray(w)}, jef)
        assert int((q["w"]["q"].numpy() != np.asarray(jq["w"]["q"])).sum()) == 0
        acc = acc + decompress_grads(q, g)["w"] / 20.0
    drift = float(torch.linalg.norm(acc - g["w"]) / torch.linalg.norm(g["w"]))
    assert drift < 0.01


def test_state_defs_init_like_jax():
    """Zero m/v and codes, unit scales, step 0 in int32, as the JAX
    package's defs give them."""
    for state_dtype in ("fp32", "bf16", "int8"):
        cfg = AdamWConfig(state_dtype=state_dtype)
        st = tree_defs_init(state_defs({"w": ParamDef((300,))}, cfg),
                            torch.Generator().manual_seed(0), "cpu")
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
        if state_dtype == "int8":
            assert st["mv"]["w"]["m_q"].shape == (3, 128)
            assert bool((st["mv"]["w"]["m_s"] == 1).all())
        else:
            assert st["mv"]["w"]["m"].dtype == (
                torch.bfloat16 if state_dtype == "bf16" else torch.float32)


@pytest.mark.parametrize("state_dtype,master", [("fp32", False),
                                                ("bf16", True),
                                                ("int8", False)])
def test_opt_state_from_jax_carries_every_leaf(state_dtype, master):
    """``convert.opt_state_from_jax``: the JAX package's AdamW state of the
    stablelm smoke model after two steps (m/v, int8 codes and scales, the
    master copy, the step) becomes the port's, value for value, in the
    dtypes of the port's ``state_defs``."""
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import smoke_config
    from repro_torch.convert import opt_state_from_jax
    from repro_torch.models import build_model
    jcfg = JaxAdamWConfig(state_dtype=state_dtype, master_fp32=master)
    cfg = AdamWConfig(state_dtype=state_dtype, master_fp32=master)
    jmodel = jax_build_model(jax_smoke_config("stablelm-1.6b"))
    jp = jmodel.init(jax.random.PRNGKey(0))
    js = jax_tree_defs_init(jax_state_defs(jmodel.param_defs, jcfg),
                            jax.random.PRNGKey(1))
    for i in range(2):
        jg, _ = _grads(i, {k: v for k, v in _walk_dict(jp)})
        jp, js, _ = jax_apply_updates(jp, _rebuild(jp, jg), js, jcfg)
    state = opt_state_from_jax(jax.tree.map(np.asarray, js),
                               smoke_config("stablelm-1.6b"), cfg,
                               device="cpu")
    defs = dict(_walk(state_defs(
        build_model(smoke_config("stablelm-1.6b")).param_defs, cfg)))
    assert int(state["step"]) == 2
    for (path, t), (_, j) in zip(_walk(state), _walk(js)):
        assert t.dtype == defs[path].dtype and t.shape == defs[path].shape
        assert int((_np(t) != _np(j)).sum()) == 0, path


def _walk_dict(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, flattened to one level."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk_dict(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _rebuild(like, flat, prefix=""):
    return {k: (_rebuild(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[f"{prefix}{k}"]) for k, v in like.items()}
