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


@pytest.mark.parametrize("dtype,D,path", [
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 160, "mma"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 160, "cuda_core")])
def test_bwd_plan_by_dtype(dtype, D, path):
    """bf16 takes the Hopper kernel (wgmma fed by TMA) at D 32, 64 and 128
    and the mma.sync kernels at D 160; float32 the CUDA-core kernels."""
    assert kernel.bwd_plan(dtype, D) == path
    assert kernel.BWD_KERNELS[path][1].startswith("flash_bwd_")


@pytest.mark.parametrize("D", [32, 64, 128])
def test_bwd_geometry_fits_a_block(D):
    """The wgmma path's tiles: TMA boxes of 128-byte rows (64-byte at D
    32) that cover D, a ring of at least two stages, two dQ share buffers
    (a reducer lane each), all in the shared memory one block may take."""
    g = kernel.bwd_geometry(D)
    assert g["box"] * g["boxes"] == D and 2 * g["box"] == g["swizzle"]
    assert g["swizzle"] == (64 if D == 32 else 128)
    assert g["stages"] >= 2 and g["dq_stages"] == 2
    assert g["keys"] == 2 * 64 and g["rows"] == 64 and g["threads"] == 384
    assert g["smem"] <= kernel.SMEM_LIMIT
    # the bytes that must sit at 1,024-byte boundaries (TMA's 128-byte
    # swizzle, the wgmma operands): K, V, each ring stage, the dS^T buffers
    for size in (g["keys"] * D * 2, 2 * g["rows"] * D * 2,
                 g["keys"] * g["rows"] * 2):
        assert size % 1024 == 0


def test_bwd_geometry_refuses_d160():
    with pytest.raises(ValueError, match="wgmma path"):
        kernel.bwd_geometry(160)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [
    (4, 32, 32, 4096, 4096, 64), (4, 28, 4, 4096, 4096, 128),
    (1, 8, 2, 300, 65, 32), (2, 4, 4, 1, 63, 64)])
def test_bwd_scratch_sizes(B, Hq, Hkv, Sq, Sk, D):
    """Scratch words of a call: lse2 and Delta over whole query tiles, the
    fp32 dQ accumulator (as large as dq in fp32 over whole tiles), the
    counters (a dQ box, a (kv head, key tile, warpgroup), the tile
    counter), and dK/dV sums only where a GQA group shares a kv head."""
    n = kernel.bwd_scratch(B, Hq, Hkv, Sq, Sk, D)
    mq, n_kt = -(-Sq // 64), -(-Sk // 128)
    assert n["stats"] == 2 * B * Hq * mq * 64
    assert n["dq_accum"] == B * Hq * mq * 64 * D
    assert n["sems"] == B * Hq * mq * max(1, D // 64) + B * Hkv * n_kt * 2 + 1
    assert n["dkv_accum"] == (B * Hkv * n_kt * 2 * 128 * D if Hq > Hkv else 0)


@pytest.mark.parametrize("B,Hq,Hkv,Sk", [(2, 4, 4, 300), (1, 28, 4, 4096),
                                         (3, 8, 1, 65)])
def test_bwd_tile_order(B, Hq, Hkv, Sk):
    """Every (key tile, head, batch row) once; the key tiles of a head
    next to each other, its last key tile first; the tiles a tile waits
    for (the next key tile of its head, the previous head of its GQA
    group) come before it, which is what keeps the persistent grid from
    waiting on a tile no block has taken."""
    tiles, blocks = kernel.bwd_tiles(B, Hq, Sk, 132)
    n_kt, group = -(-Sk // 128), Hq // Hkv
    assert tiles == n_kt * B * Hq and blocks == min(tiles, 132)
    index = {kernel.bwd_tile(t, Hq, Sk): t for t in range(tiles)}
    assert len(index) == tiles
    for (n, h, b), t in index.items():
        assert index[(n_kt - 1, h, b)] == t - (n_kt - 1 - n)
        if n + 1 < n_kt:
            assert index[(n + 1, h, b)] < t
        if h % group:
            assert index[(n, h - 1, b)] < t


@pytest.mark.parametrize("Sq,Sk,kv_len,causal,q_offset", [
    (300, 300, 300, True, 0), (65, 129, 129, True, 64), (129, 65, 65, False, 0),
    (40, 130, 100, True, 60), (300, 1, 1, False, 0), (63, 300, 250, True, 237),
    (200, 512, 0, True, 0)])
def test_bwd_visits_and_sum_order(Sq, Sk, kv_len, causal, q_offset):
    """The key tiles that visit a query tile are 0 .. bwd_last_key_tile(m)
    (so summing from the last down orders every dQ add), a key tile visits
    a query tile iff one of the tile's rows sees one of its keys, and
    every (row, key) the mask lets through lies in a visited pair."""
    n_kt, mq = -(-Sk // 128), -(-Sq // 64)
    visits = {n: set(kernel.bwd_visits(n, Sq, kv_len, causal, q_offset))
              for n in range(n_kt)}
    for m in range(mq):
        seen = [n for n in range(n_kt) if m in visits[n]]
        if seen:
            last = kernel.bwd_last_key_tile(m, kv_len, causal, q_offset)
            assert seen == list(range(last + 1))
        for n in range(n_kt):
            keys = np.arange(n * 128, min(n * 128 + 128, kv_len))
            rows = np.arange(m * 64, m * 64 + 64)
            sees = keys.size > 0 and (not causal or bool(
                (keys[:, None] <= q_offset + rows[None, :]).any()))
            assert (m in visits[n]) == sees
    valid = np.arange(Sk)[None, :] < kv_len
    if causal:
        valid = valid & (np.arange(Sk)[None, :]
                         <= q_offset + np.arange(Sq)[:, None])
    for i, j in zip(*np.nonzero(np.broadcast_to(valid, (Sq, Sk)))):
        assert i // 64 in visits[j // 128]


def _tiled_bwd(q, k, v, out, do, lse, causal, kv_len, q_offset):
    """The wgmma path's arithmetic in fp32 torch on the CPU: tiles in
    ``bwd_tile`` order, the query tiles ``bwd_visits`` names, dQ's shares
    summed from the last key tile down, dK and dV over a GQA group's heads
    in head order."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group, scale = Hq // Hkv, D ** -0.5
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    delta = (do * out).sum(-1)
    shares = {}
    tiles, _ = kernel.bwd_tiles(B, Hq, Sk, 132)
    for t in range(tiles):
        n, h, b = kernel.bwd_tile(t, Hq, Sk)
        keys = torch.arange(n * 128, min(n * 128 + 128, Sk))
        kk, vv = k[b, h // group, keys], v[b, h // group, keys]
        for m in kernel.bwd_visits(n, Sq, kv_len, causal, q_offset):
            rows = torch.arange(m * 64, min(m * 64 + 64, Sq))
            s = q[b, h, rows] @ kk.T * scale
            ok = (keys[None, :] < kv_len) & (
                ~torch.tensor(causal) | (keys[None, :] <= q_offset + rows[:, None]))
            p = torch.where(ok, torch.exp(s - lse[b, h, rows, None]), 0.)
            ds = p * (do[b, h, rows] @ vv.T - delta[b, h, rows, None])
            dv[b, h // group, keys] += p.T @ do[b, h, rows]
            dk[b, h // group, keys] += ds.T @ q[b, h, rows] * scale
            shares.setdefault((b, h, m), []).append((n, ds @ kk * scale))
    for (b, h, m), got in shares.items():
        last = kernel.bwd_last_key_tile(m, kv_len, causal, q_offset)
        assert sorted(n for n, _ in got) == list(range(last + 1))
        rows = torch.arange(m * 64, min(m * 64 + 64, Sq))
        for _, share in sorted(got, key=lambda x: -x[0]):
            dq[b, h, rows] += share
    return dq, dk, dv


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,kv_len,q_offset", [
    (1, 4, 2, 200, 300, 32, True, 300, 100),
    (2, 2, 1, 130, 70, 64, False, 60, 0),
    (1, 7, 1, 129, 129, 32, True, 129, 0)])
def test_bwd_tiling_matches_plain_version(B, Hq, Hkv, Sq, Sk, D, causal,
                                          kv_len, q_offset):
    """The wgmma path's tiling, visits and summation order, emulated on
    the CPU in fp32, give ``attention_bwd_ref``'s gradient (which the tests
    above hold to jax.grad of chunked_attention) within 2e-5 of each
    gradient's max."""
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(9, (B, Hq, Sq, D), (B, Hkv, Sk, D)))
    do = torch.from_numpy(np.random.default_rng(10).normal(
        0, 1, (B, Hq, Sq, D)).astype(np.float32))
    kw = {"causal": causal, "kv_len": kv_len, "q_offset": q_offset}
    out = attention_ref(q, k, v, **kw)
    lse = lse_ref(q, k, **kw)
    refs = attention_bwd_ref(q, k, v, out, do, lse, **kw)
    got = _tiled_bwd(q, k, v, out, do, lse, causal, kv_len, q_offset)
    for g, r in zip(got, refs):
        assert float((g - r).abs().max()) <= 2e-5 * float(r.abs().max())


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
