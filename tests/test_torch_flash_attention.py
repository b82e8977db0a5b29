"""The port's attention (plain version on CPU tensors) against the JAX
package: its oracle, its Pallas kernel in interpret mode, and the model's
chunked XLA attention with a cache offset; the backward's plain version
(``attention_bwd_ref``) against ``jax.grad`` of that chunked attention,
the gradient the JAX package trains with.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16 (bf16 rounds the output at 2^-8 relative).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.layers import chunked_attention
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_ref, kernel,
                                                 lse_ref, mha)

SHAPES = [
    (1, 2, 2, 64, 64, 32, True),
    (2, 4, 2, 128, 128, 64, True),      # GQA
    (1, 4, 1, 96, 160, 32, False),      # MQA, unaligned, bidir
    (1, 2, 2, 1, 256, 64, False),       # decode shape
    (1, 4, 2, 70, 70, 160, True),       # stablelm-12b's head dim, GQA
    (2, 8, 2, 1, 100, 160, False),      # a decode row at head dim 160
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, q_shape).astype(np.float32),
            rng.normal(0, 1, kv_shape).astype(np.float32),
            rng.normal(0, 1, kv_shape).astype(np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_ref_matches_jax_oracle(B, Hq, Hkv, Sq, Sk, D, causal,
                                          dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(0, (B, Hq, Sq, D), (B, Hkv, Sk, D))
    ref = jax_attention_ref(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                            jnp.asarray(v, jdt), causal=causal)
    out = attention_ref(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                        torch.from_numpy(v).to(tdt), causal=causal)
    assert out.dtype == tdt and tuple(out.shape) == (B, Hq, Sq, D)
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal", [SHAPES[0], SHAPES[2]])
def test_mha_matches_pallas_kernel_interpret(B, Hq, Hkv, Sq, Sk, D, causal):
    q, k, v = _inputs(0, (B, Hq, Sq, D), (B, Hkv, Sk, D))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=64, block_k=64, interpret=True)
    # mha takes the model layout (B, S, H, D)
    t = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    out = mha(*t, causal=causal).transpose(1, 2)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


def test_kv_len_mask():
    q, k, v = _inputs(1, (1, 2, 8, 32), (1, 2, 128, 32))
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, kv_len=50)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=False, kv_len=50, block_k=32, interpret=True)
    out = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=False,
                        kv_len=50)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=2e-5)
    # keys beyond kv_len must not affect the output
    k2 = k.copy()
    k2[:, :, 50:] = 1e3
    out2 = attention_ref(*map(torch.from_numpy, (q, k2, v)), causal=False,
                         kv_len=50)
    np.testing.assert_allclose(_np(out2), _np(ref), atol=2e-5)


@pytest.mark.parametrize("Sq,q_offset,kv_len", [
    (1, 39, 40),        # decode: one row at position 39 over a 64-slot cache
    (12, 0, 12),        # prefill over a cache longer than the prompt
    (5, 20, 25),        # a chunk appended at an offset
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mha_matches_chunked_attention_over_cache(Sq, q_offset, kv_len,
                                                  dtype):
    jdt, tdt, tol = DTYPES[dtype]
    B, Hq, Hkv, Sk, D = 2, 4, 2, 64, 32
    q, k, v = _inputs(2, (B, Sq, Hq, D), (B, Sk, Hkv, D))
    ref = chunked_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=True, chunk=16,
        q_offset=jnp.full((B,), q_offset, jnp.int32), kv_len=kv_len)
    out = mha(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
              causal=True, kv_len=kv_len, q_offset=q_offset)
    assert tuple(out.shape) == (B, Sq, Hq, D)
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


def test_cpu_tensors_never_launch_the_kernel():
    before = kernel.LAUNCHES
    q, k, v = _inputs(3, (1, 4, 2, 32), (1, 8, 2, 32))
    mha(*map(torch.from_numpy, (q, k, v)), causal=True, kv_len=6, q_offset=4)
    assert kernel.LAUNCHES == before == 0


def test_kernel_wrapper_rejects_cpu_tensors():
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.flash_attention(q, q, q)


H100_SMS = 132


@pytest.mark.parametrize("B,T,steps", [(4, 15, 12), (4, 13, 12), (1, 5, 4)])
def test_serve_shapes_take_one_split_and_the_tensor_cores(B, T, steps):
    """At the serve shapes (stablelm-1.6b: 32 heads, no GQA) a decode step
    is one launch with no scratch, and a bf16 prefill goes to the tensor
    cores; a float32 prefill keeps the CUDA-core kernel."""
    H = 32
    for kv_len in range(T + 1, T + steps + 1):
        assert kernel.plan(torch.bfloat16, B, H, H, 1, kv_len,
                           H100_SMS) == ("decode_split", 1)
    assert kernel.plan(torch.bfloat16, B, H, H, T, T,
                       H100_SMS) == ("prefill_mma", 1)
    assert kernel.plan(torch.float32, B, H, H, T, T, H100_SMS) == ("fp32", 1)


@pytest.mark.parametrize("B,Hq,Hkv,kv_len", [
    (8, 32, 32, 32768),      # the 32k decode of chip_smoke.py
    (1, 32, 32, 32768),
    (1, 32, 8, 8192),        # GQA: one block per kv head
    (1, 64, 1, 100000),      # MQA, 8 heads a block
])
def test_long_decode_splits_fill_two_waves(B, Hq, Hkv, kv_len):
    splits = kernel.decode_splits(B, Hq, Hkv, kv_len, H100_SMS)
    blocks = B * Hkv * -(-(Hq // Hkv) // kernel.DECODE_HEADS)
    assert blocks * splits >= kernel.DECODE_WAVES * H100_SMS
    # each split keeps at least one ring of keys
    ring = kernel.DECODE_TILE * kernel.DECODE_STAGES
    assert -(-kv_len // splits) >= ring


@pytest.mark.parametrize("kv_len,want", [(0, 1), (1, 1), (191, 1), (192, 1),
                                         (193, 2), (4096, 22)])
def test_decode_splits_stop_at_one_ring_per_split(kv_len, want):
    """One block (B 1, one head): the split count is capped by kv_len."""
    assert kernel.decode_splits(1, 1, 1, kv_len, H100_SMS) == want


@pytest.mark.parametrize("Sq,offsets,kv_len", [
    (1, (9, 40), 41),       # decode rows whose temporal ids differ
    (5, (0, 20), 25),       # a chunk, each row at its own offset
    (6, (3, 3), 30),        # equal offsets other than the cache index
])
@pytest.mark.parametrize("D", [32, 160])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_per_row_offsets_match_chunked_attention(Sq, offsets, kv_len, D,
                                                 dtype):
    """The reference masks each row from its own first position id
    (``q_offset`` (B,)); the port takes a (B,) integer tensor there, and
    on the CPU gives what an int per row would."""
    jdt, tdt, tol = DTYPES[dtype]
    B, Hq, Hkv, Sk = 2, 4, 2, 64
    q, k, v = _inputs(7, (B, Sq, Hq, D), (B, Sk, Hkv, D))
    ref = chunked_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=True, chunk=16, q_offset=jnp.asarray(offsets, jnp.int32),
        kv_len=kv_len)
    t = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    out = mha(*t, causal=True, kv_len=kv_len,
              q_offset=torch.tensor(offsets, dtype=torch.int32))
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
    for b, off in enumerate(offsets):
        row = mha(*(x[b:b + 1] for x in t), causal=True, kv_len=kv_len,
                  q_offset=off)
        assert torch.equal(row, out[b:b + 1])


#: (B, Hq, Hkv, Sq, Sk, D, causal): chip_smoke.py phase 13a's cases at
#: small sizes: causal and non-causal self-attention, cross (Sq != Sk),
#: GQA 1/4/7/8, D 32/64/128/160, lengths off the kernel's 64-row tiles
BWD_SHAPES = [
    (2, 4, 4, 24, 24, 32, True),
    (1, 8, 2, 20, 20, 64, True),       # GQA 4
    (1, 7, 1, 17, 17, 128, True),      # GQA 7
    (1, 8, 1, 33, 33, 160, True),      # GQA 8, D 160
    (2, 4, 4, 20, 20, 64, False),      # encoder
    (2, 4, 2, 9, 30, 32, False),       # cross, GQA 2
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal", BWD_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_bwd_ref_matches_jax_grad(B, Hq, Hkv, Sq, Sk, D, causal,
                                            dtype):
    """dq, dk, dv of the flash formulas against jax.grad of the JAX
    package's ``chunked_attention`` (chunk 16: several KV chunks and a
    padded one), each within the forward's bar relative to the JAX
    gradient's max (bf16: both round q, k, v, the output and the
    gradients to bf16, at other places)."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(11, (B, Sq, Hq, D), (B, Sk, Hkv, D))
    do = np.random.default_rng(12).normal(0, 1, (B, Sq, Hq, D)).astype(
        np.float32)

    def f(q_, k_, v_):
        out = chunked_attention(q_, k_, v_, causal=causal, chunk=16)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))
    jgrads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).transpose(1, 2)
                  for x in (q, k, v))
    tdo = torch.from_numpy(do).to(tdt).transpose(1, 2)
    out = attention_ref(tq, tk, tv, causal=causal)
    lse = lse_ref(tq, tk, causal=causal)
    grads = attention_bwd_ref(tq, tk, tv, out, tdo, lse, causal=causal)
    for name, g, jg, t in zip("qkv", grads, jgrads, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape, name
        ref = _np(jg)
        err = np.abs(_np(g.transpose(1, 2)) - ref).max() / np.abs(ref).max()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal", BWD_SHAPES[:3])
def test_attention_bwd_ref_is_the_gradient_of_attention_ref(B, Hq, Hkv, Sq,
                                                            Sk, D, causal):
    """The formulas give what autograd takes through ``attention_ref``
    (float32, 2e-5 of the max), and through ``mha`` on the CPU."""
    q, k, v = _inputs(13, (B, Hq, Sq, D), (B, Hkv, Sk, D))
    do = torch.from_numpy(np.random.default_rng(14).normal(
        0, 1, (B, Hq, Sq, D)).astype(np.float32))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attention_ref(*t, causal=causal)
    auto = torch.autograd.grad((out * do).sum(), t)
    via_mha = torch.autograd.grad(
        (mha(*(x.transpose(1, 2) for x in t), causal=causal).transpose(1, 2)
         * do).sum(), t)
    with torch.no_grad():
        grads = attention_bwd_ref(*t, out, do, lse_ref(*t[:2], causal=causal),
                                  causal=causal)
    for g, a, m in zip(grads, auto, via_mha):
        scale = float(a.abs().max())
        assert float((g - a).abs().max()) <= 2e-5 * scale
        assert torch.equal(a, m)


def test_lse_definition():
    """lse: the natural log of the sum of exp(scaled score) over the keys
    a row sees (float64 numpy reference), -inf for a row that sees none;
    exp(s - lse) then sums to 1 over a row's keys."""
    q, k, _ = _inputs(15, (2, 4, 6, 32), (2, 2, 40, 32))
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    for kw in ({"causal": True, "q_offset": 3, "kv_len": 30},
               {"causal": False, "kv_len": 25},
               {"causal": True, "q_offset": torch.tensor([0, 20])}):
        lse = lse_ref(tq, tk, **kw)
        assert lse.shape == (2, 4, 6) and lse.dtype == torch.float32
        kk = np.repeat(k.astype(np.float64), 2, axis=1)
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) / np.sqrt(32)
        kv_len = kw.get("kv_len", 40)
        off = kw.get("q_offset", 0)
        off = off.numpy()[:, None] if isinstance(off, torch.Tensor) else \
            np.full((2, 1), off)
        kpos = np.arange(40)
        valid = kpos[None, None, :] < kv_len
        if kw["causal"]:
            valid = valid & (kpos[None, None, :]
                             <= (off + np.arange(6))[:, :, None])
        ref = np.log(np.where(valid[:, None], np.exp(s), 0).sum(-1))
        np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-6, atol=1e-6)
        p = np.where(valid[:, None], np.exp(s - lse.numpy()[..., None]), 0)
        np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-5)
    none = lse_ref(tq, tk, causal=False, kv_len=0)
    assert bool(torch.isneginf(none).all())


def test_bwd_plan_by_dtype():
    """bf16 takes the tensor-core backward, float32 the CUDA-core one."""
    assert kernel.bwd_plan(torch.bfloat16) == "mma"
    assert kernel.bwd_plan(torch.float32) == "cuda_core"


def test_bwd_wrapper_rejects_cpu_tensors():
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 2, 4))


def test_cpu_gradients_never_launch_the_kernels():
    """On CPU tensors ``mha`` is the plain version under autograd: a
    backward launches neither kernel."""
    fwd, bwd = kernel.LAUNCHES, kernel.BWD_LAUNCHES
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(16, (1, 6, 4, 32), (1, 6, 2, 32)))
    mha(q, k, v, causal=True).sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert (kernel.LAUNCHES, kernel.BWD_LAUNCHES) == (fwd, bwd)
