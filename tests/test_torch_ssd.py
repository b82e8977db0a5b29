"""The port's SSD scan (plain versions on CPU tensors) against the JAX
package: its naive oracle, its Pallas kernel in interpret mode, and the
model's chunked XLA twin with an initial state.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: 1e-5 of the reference's max |y|, as tests/test_kernels.py.
The bf16 case rounds the same inputs to bf16 on both sides, and both
upcast them to fp32, so only the order of the fp32 sums differs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ssd import ssd_ref as jax_ssd_ref
from repro.kernels.ssd import ssd_scan as jax_ssd_scan
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import (kernel, ops, ssd, ssd_chunked,
                                     ssd_chunked_bwd, ssd_ref, ssd_scan_bwd)

# (B, T, H, P, G, N, chunk): the shapes of tests/test_kernels.py
SHAPES = [
    (1, 32, 2, 8, 1, 8, 8),
    (2, 64, 4, 16, 2, 16, 16),
    (1, 50, 4, 8, 1, 8, 16),            # unaligned T: a ragged last chunk
]
TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, T, H, P, G, N, state=False):
    rng = np.random.default_rng(seed)
    out = {"x": rng.normal(0, 1, (B, T, H, P)),
           "dt": np.abs(rng.normal(0.05, 0.02, (B, T, H))),
           "a": -np.abs(rng.normal(1.0, 0.3, (H,))),
           "B_": rng.normal(0, 1, (B, T, G, N)),
           "C_": rng.normal(0, 1, (B, T, G, N))}
    if state:
        out["state0"] = rng.normal(0, 1, (B, H, P, N))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _jax(inp, dtype=jnp.float32):
    """x, B_, C_ in ``dtype``; dt and a stay float32."""
    return [jnp.asarray(inp[k], dtype if k in ("x", "B_", "C_")
                        else jnp.float32)
            for k in ("x", "dt", "a", "B_", "C_")]


def _torch(inp, dtype=torch.float32):
    return [torch.from_numpy(inp[k]).to(dtype if k in ("x", "B_", "C_")
                                        else torch.float32)
            for k in ("x", "dt", "a", "B_", "C_")]


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SHAPES)
def test_ssd_ref_matches_jax_oracle(B, T, H, P, G, N, chunk):
    inp = _inputs(2, B, T, H, P, G, N)
    _close(ssd_ref(*_torch(inp)).numpy(), jax_ssd_ref(*_jax(inp)))


@pytest.mark.parametrize("B,T,H,P,G,N,chunk,dtype", [
    *(s + ("float32",) for s in SHAPES),
    SHAPES[1] + ("bfloat16",),
])
def test_ssd_chunked_matches_pallas_kernel_interpret(B, T, H, P, G, N, chunk,
                                                     dtype):
    jdt, tdt = DTYPES[dtype]
    inp = _inputs(2, B, T, H, P, G, N)
    ref = jax_ssd_scan(*_jax(inp, jdt), chunk=chunk, interpret=True)
    y, state = ssd_chunked(*_torch(inp, tdt), chunk)
    assert y.dtype == torch.float32 and state.shape == (B, H, P, N)
    _close(y.numpy(), ref)
    # and against the naive recurrence, on the same rounded inputs
    _close(y.numpy(), ssd_ref(*_torch(inp, tdt)).numpy())


@pytest.mark.parametrize("T,chunk", [(48, 16), (50, 16), (7, 16)])
def test_ssd_chunked_with_state0_matches_jax_model_twin(T, chunk):
    B, H, P, G, N = 2, 4, 8, 2, 8
    inp = _inputs(3, B, T, H, P, G, N, state=True)
    ref_y, ref_state = jax_ssd_chunked(*_jax(inp), chunk,
                                       state0=jnp.asarray(inp["state0"]))
    y, state = ssd_chunked(*_torch(inp), chunk,
                           state0=torch.from_numpy(inp["state0"]))
    _close(y.numpy(), ref_y)
    _close(state.numpy(), ref_state)


def test_ops_ssd_on_cpu_takes_the_plain_version():
    inp = _inputs(4, 1, 20, 2, 8, 1, 8, state=True)
    args = _torch(inp)
    state0 = torch.from_numpy(inp["state0"])
    before = kernel.LAUNCHES
    y, state = ssd(*args, chunk=8, state0=state0)
    y2, state2 = ssd_chunked(*args, 8, state0=state0)
    assert kernel.LAUNCHES == before == 0
    assert torch.equal(y, y2) and torch.equal(state, state2)


def test_kernel_wrapper_rejects_cpu_tensors():
    inp = _inputs(5, 1, 8, 2, 8, 1, 8)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.ssd_scan(*_torch(inp), chunk=8)


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "chunked"),
                                        (torch.float32, "fp32")])
@pytest.mark.parametrize("T,chunk,L,n_chunks", [
    (15, 128, 15, 1),       # a serve prompt: one chunk, no state passing
    (128, 128, 128, 1),     # exactly one chunk
    (129, 128, 128, 2),     # a second chunk of one row
    (4096, 128, 128, 32),   # 32 chunks
    (50, 16, 16, 4),        # chunk 16, ragged
    (32, 8, 8, 4),          # chunk 8 < the mma tile
])
def test_plan_picks_the_path_by_dtype(dtype, path, T, chunk, L, n_chunks):
    """bf16 takes the chunked tensor-core path, its chunk padded to the
    mma tile and the state passing launched only past one chunk; float32
    takes the one-launch CUDA-core kernel, its chunk padded to a float4.
    The card's profile of a call is held to ``kernels`` (the gpu tests,
    chip_smoke.py)."""
    pl = kernel.plan(dtype, T, chunk)
    tile = 16 if path == "chunked" else 4
    assert (pl.path, pl.L, pl.n_chunks) == (path, L, n_chunks)
    assert pl.Lp % tile == 0 and 0 <= pl.Lp - L < tile
    if path == "fp32":
        assert pl.kernels == ("ssd_fwd_fp32",)
    else:
        assert pl.kernels == (("ssd_chunk_cb", "ssd_chunk_state")
                              + ("ssd_state_passing",) * (n_chunks > 1)
                              + ("ssd_chunk_scan",))


def _split(v: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """An fp32 tensor as ``terms`` bf16 terms whose sum approximates it:
    hi = bf16(v), lo = bf16(v - hi), ..."""
    out, rest = [], v
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def _mm_split(a: torch.Tensor, b: torch.Tensor, terms: int,
              split_a: bool) -> torch.Tensor:
    """a @ b with fp32 accumulation, the fp32 operand (a if ``split_a``,
    else b) split into bf16 terms and each term multiplied: what the
    chunked path issues as mma.sync bf16 products."""
    if split_a:
        return sum(t @ b for t in _split(a, terms))
    return sum(a @ t for t in _split(b, terms))


def _emulate_chunked(x, dt, a, B_, C_, chunk, state0, terms):
    """The chunked path's arithmetic in plain PyTorch, for G 1: C B^T on
    the bf16 inputs as they are; att, the carried state and w B split into
    ``terms`` = (att, state, wB) bf16 terms; every sum in fp32."""
    t_att, t_state, t_wb = terms
    Bb, T, H, P = x.shape
    N = B_.shape[3]
    L = min(chunk, T)
    x, B_, C_ = x.float(), B_.float(), C_.float()
    y = torch.zeros(Bb, T, H, P)
    state = state0.clone()
    for t0 in range(0, T, L):
        sl = slice(t0, min(t0 + L, T))
        for b in range(Bb):
            Bc, Cc = B_[b, sl, 0], C_[b, sl, 0]                 # (l, N)
            cb = Cc @ Bc.T                                       # exact products
            for h in range(H):
                xc, dtc = x[b, sl, h], dt[b, sl, h]
                css = torch.cumsum(dtc * a[h], 0)
                seg = css[-1]
                diff = css[:, None] - css[None, :]
                mask = torch.tril(torch.ones_like(diff, dtype=torch.bool))
                att = torch.where(mask, cb * torch.exp(
                    diff.masked_fill(~mask, float("-inf"))) * dtc[None], 0.)
                s_in = state[b, h]                               # (P, N)
                y[b, sl, h] = (torch.exp(css)[:, None]
                               * _mm_split(Cc, s_in.T, t_state, False)
                               + _mm_split(att, xc, t_att, True))
                wB = torch.exp(seg - css)[:, None] * dtc[:, None] * Bc
                state[b, h] = (torch.exp(seg) * s_in
                               + _mm_split(xc.T, wB, t_wb, False))
    return y, state


@pytest.mark.parametrize("terms,meets_bar", [
    ((3, 2, 3), True),          # the kernel's: att and w B in three terms
    ((2, 2, 2), True),          # hi + lo throughout
    ((1, 1, 1), False),         # one bf16 term
], ids=["kernel", "hi+lo", "one term"])
def test_chunked_path_arithmetic_needs_the_split(terms, meets_bar):
    """At the model's widths (L 128, P 64, N 128) over 4 chunks, the
    chunked path's products with the fp32 operand (att, the carried state,
    w B) split into bf16 terms hold y and the final state to the JAX
    model's ssd_chunked within 1e-5 of max, the bar of
    tests/test_kernels.py; one bf16 term does not."""
    B, T, H, P, G, N, chunk = 1, 512, 2, 64, 1, 128, 128
    inp = _inputs(6, B, T, H, P, G, N, state=True)
    jx = _jax(inp, jnp.bfloat16)
    ref_y, ref_state = jax_ssd_chunked(*jx, chunk,
                                       state0=jnp.asarray(inp["state0"]))
    x, dt, a, B_, C_ = _torch(inp, torch.bfloat16)
    y, state = _emulate_chunked(x, dt, a, B_, C_, chunk,
                                torch.from_numpy(inp["state0"]), terms)
    err = max(float(np.abs(np.asarray(out) - np.asarray(ref)).max()
                    / np.abs(np.asarray(ref)).max())
              for out, ref in ((y.numpy(), ref_y), (state.numpy(), ref_state)))
    assert (err <= TOL) == meets_bar, err


@pytest.mark.parametrize("T,chunk,state", [(20, 16, False), (50, 16, True),
                                           (129, 128, True)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_chunked_at_state_64_matches_jax_model_twin(T, chunk, state,
                                                        dtype):
    """zamba2-1.2b's state dim, N 64, against the JAX model's ssd_chunked
    (and, from a zero state, the JAX naive oracle)."""
    jdt, tdt = DTYPES[dtype]
    B, H, P, G, N = 2, 4, 16, 1, 64
    inp = _inputs(7, B, T, H, P, G, N, state=state)
    s0 = inp.get("state0")
    ref_y, ref_state = jax_ssd_chunked(
        *_jax(inp, jdt), chunk, state0=None if s0 is None else jnp.asarray(s0))
    y, st = ssd_chunked(*_torch(inp, tdt), chunk,
                        state0=None if s0 is None else torch.from_numpy(s0))
    assert 64 in kernel.STATE_DIMS
    _close(y.numpy(), ref_y)
    _close(st.numpy(), ref_state)
    if s0 is None:
        _close(y.numpy(), jax_ssd_ref(*_jax(inp, jdt)))


@pytest.mark.parametrize("terms", [(3, 2, 3), (2, 2, 2)],
                         ids=["kernel", "hi+lo"])
def test_chunked_path_arithmetic_at_state_64(terms):
    """The same emulation at zamba2-1.2b's widths (L 128, P 64, N 64) over
    4 chunks: the kernel's bf16-term splits hold y and the final state to
    the JAX model's ssd_chunked within 1e-5 of max."""
    B, T, H, P, G, N, chunk = 1, 512, 2, 64, 1, 64, 128
    inp = _inputs(8, B, T, H, P, G, N, state=True)
    ref_y, ref_state = jax_ssd_chunked(*_jax(inp, jnp.bfloat16), chunk,
                                       state0=jnp.asarray(inp["state0"]))
    x, dt, a, B_, C_ = _torch(inp, torch.bfloat16)
    y, state = _emulate_chunked(x, dt, a, B_, C_, chunk,
                                torch.from_numpy(inp["state0"]), terms)
    err = max(float(np.abs(np.asarray(out) - np.asarray(ref)).max()
                    / np.abs(np.asarray(ref)).max())
              for out, ref in ((y.numpy(), ref_y), (state.numpy(), ref_state)))
    assert err <= TOL, err


def test_plain_scan_is_differentiated_on_the_cpu():
    """On the CPU the SSD entry is the plain scan, which autograd
    differentiates (on the card ``_SSDScan`` takes the hand-written
    backward kernel)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
    dt = torch.rand(1, 16, 2, generator=g) * 0.1
    a = -torch.rand(2, generator=g)
    B_ = torch.randn(1, 16, 1, 8, generator=g)
    C_ = torch.randn(1, 16, 1, 8, generator=g)
    y, state = ssd(x, dt, a, B_, C_, chunk=8)
    (y.sum() + state.sum()).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


# ---------------------------------------------------------------------------
# The backward: the plain version against autograd and against jax.vjp, the
# backward kernel's plan, and the autograd function's plumbing
# ---------------------------------------------------------------------------
#: (B, T, H, P, G, N, chunk, state0, dstate): one chunk and several, ragged
#: T, G 1 and G > 1, state0 given and absent, dstate zero and nonzero
BWD_CASES = [
    (1, 16, 2, 8, 1, 8, 16, False, False),      # one whole chunk
    (2, 13, 4, 8, 2, 8, 16, True, True),        # one ragged chunk, G 2
    (2, 50, 4, 8, 2, 8, 16, True, True),        # 4 chunks, the last of 2
    (1, 48, 6, 4, 3, 5, 16, False, True),       # 3 whole chunks, G 3
    (2, 37, 4, 3, 1, 4, 8, True, False),        # 5 chunks, ragged, G 1
]
GRAD_NAMES = ("dx", "ddt", "da", "dB", "dC", "dstate0")


def _bwd_inputs(seed, B, T, H, P, G, N, state, dstate):
    inp = _inputs(seed, B, T, H, P, G, N, state=state)
    rng = np.random.default_rng(seed + 1)
    inp["dy"] = rng.normal(0, 1, (B, T, H, P)).astype(np.float32)
    if dstate:
        inp["dstate"] = rng.normal(0, 1, (B, H, P, N)).astype(np.float32)
    return inp


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("B,T,H,P,G,N,chunk,state,dstate", BWD_CASES)
def test_ssd_chunked_bwd_matches_autograd_in_float64(B, T, H, P, G, N, chunk,
                                                     state, dstate):
    """The explicit formulas against autograd of the port's plain scan:
    every gradient within 1e-12 of its max, in float64."""
    inp = _bwd_inputs(11, B, T, H, P, G, N, state, dstate)
    t = {k: torch.from_numpy(v).double() for k, v in inp.items()}
    leaves = [t[k].requires_grad_(True) for k in ("x", "dt", "a", "B_", "C_")]
    s0 = t["state0"].requires_grad_(True) if state else None
    y, fin = ssd_chunked(*leaves, chunk, state0=s0)
    outs, cots = [y], [t["dy"]]
    if dstate:
        outs.append(fin)
        cots.append(t["dstate"])
    ref = torch.autograd.grad(outs, leaves + ([s0] if state else []), cots)
    got = ssd_chunked_bwd(*(x.detach() for x in leaves), chunk,
                          None if s0 is None else s0.detach(), t["dy"],
                          t.get("dstate"))
    assert all(g.dtype == torch.float64 for g in got)
    for name, g, r in zip(GRAD_NAMES, got, ref):
        assert _rel(g, r) <= 1e-12, name


@pytest.mark.parametrize("B,T,H,P,G,N,chunk,state,dstate", BWD_CASES)
def test_ssd_chunked_bwd_matches_jax_vjp(B, T, H, P, G, N, chunk, state,
                                         dstate):
    """The plain backward in fp32 against ``jax.vjp`` of the JAX
    package's ``ssd_chunked`` (the gradient its training takes, by XLA's
    autodiff) on the same inputs: every gradient within 1e-5 of its max.
    A zero dstate is a zero cotangent on the JAX side and None here."""
    inp = _bwd_inputs(12, B, T, H, P, G, N, state, dstate)
    args = _jax(inp)
    if state:
        args.append(jnp.asarray(inp["state0"]))

    def f(x, dt, a, B_, C_, *s0):
        return jax_ssd_chunked(x, dt, a, B_, C_, chunk,
                               state0=s0[0] if s0 else None)
    (_, fin), vjp = jax.vjp(f, *args)
    ds = (jnp.asarray(inp["dstate"]) if dstate
          else jnp.zeros_like(fin))
    ref = vjp((jnp.asarray(inp["dy"]), ds))
    t = _torch(inp)
    got = ssd_chunked_bwd(
        *t, chunk, torch.from_numpy(inp["state0"]) if state else None,
        torch.from_numpy(inp["dy"]),
        torch.from_numpy(inp["dstate"]) if dstate else None)
    for name, g, r in zip(GRAD_NAMES, got, ref):
        assert _rel(g.numpy(), r) <= TOL, name


def _mm_split2(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b with both operands fp32, each split into ``terms`` bf16
    terms, and the term pairs (i, j) with i + j < terms multiplied."""
    ta, tb = _split(a, terms), _split(b, terms)
    return sum(ta[i] @ tb[j] for i in range(terms) for j in range(terms)
               if i + j < terms)


def _emulate_chunked_bwd(x, dt, a, B_, C_, chunk, state0, dy, dstate, terms,
                         slices):
    """The mma path's arithmetic in plain PyTorch (float32, bf16 x, B, C):
    C B^T on the inputs as they are; exp(css) dy, s_in, ds, dy, A1 and the
    A2 sum in ``terms`` bf16 terms; every sum fp32; dB and dC summed over a
    slice's heads in head order (the A2 sum times B and C once a slice),
    then over the ``slices`` slices.  The states entering the chunks are
    fp32, as the forward keeps them."""
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    hps = rep // slices
    L = min(chunk, T)
    nc = -(-T // L)
    x, B_, C_ = x.float(), B_.float(), C_.float()

    def mm(a_, b_, split_a):
        return _mm_split(a_, b_, terms, split_a)
    sls = [slice(c * L, min((c + 1) * L, T)) for c in range(nc)]
    cs = {}
    for c, sl in enumerate(sls):
        css = torch.cumsum(dt[:, sl] * a, 1)                    # (B, l, H)
        cs[c] = (css, css[:, -1])
    s_in, st = [], state0.clone()
    for c, sl in enumerate(sls):
        s_in.append(st.clone())
        css, seg = cs[c]
        wB = ((torch.exp(seg[:, None] - css) * dt[:, sl])[..., None]
              * B_[:, sl].repeat_interleave(rep, 2))
        st = (torch.exp(seg)[..., None, None] * st
              + torch.einsum("blhp,blhn->bhpn", x[:, sl], wB))
    dx = torch.zeros(Bb, T, H, P)
    ddt = torch.zeros(Bb, T, H)
    da = torch.zeros(H)
    dB = torch.zeros(Bb, T, G, N)
    dC = torch.zeros(Bb, T, G, N)
    dS = {}
    share = {}
    for c, sl in enumerate(sls):                                # dstate
        css, _ = cs[c]
        for b in range(Bb):
            for g in range(G):
                Cc = C_[b, sl, g]
                for s in range(slices):
                    acc = 0
                    for h in range(g * rep + s * hps, g * rep + (s + 1) * hps):
                        ey = torch.exp(css[b, :, h])[:, None] * dy[b, sl, h]
                        dS[c, b, h] = mm(ey.T, Cc, True)
                        inter = _mm_split2(ey, s_in[c][b, h], terms)
                        share[c, b, h] = (Cc * inter).sum(-1)
                        acc = acc + inter
                    dC[b, sl, g] += acc
    ds, cur = {}, dstate.clone()                                # state pass
    for c in reversed(range(nc)):
        for b in range(Bb):
            for h in range(H):
                ds[c, b, h] = cur[b, h].clone()
                cur[b, h] = torch.exp(cs[c][1][b, h]) * cur[b, h] + dS[c, b, h]
    for c, sl in enumerate(sls):                                # the chunks
        n = sl.stop - sl.start
        mask = torch.tril(torch.ones(n, n, dtype=torch.bool))
        for b in range(Bb):
            for g in range(G):
                Bc, Cc = B_[b, sl, g], C_[b, sl, g]
                cb = Cc @ Bc.T                                  # exact products
                for s in range(slices):
                    dbi, a2s = 0, torch.zeros(n, n)
                    for h in range(g * rep + s * hps, g * rep + (s + 1) * hps):
                        css, seg = cs[c][0][b, :, h], cs[c][1][b, h]
                        dtc, xc, dyc = dt[b, sl, h], x[b, sl, h], dy[b, sl, h]
                        dsc, w = ds[c, b, h], torch.exp(seg - css)
                        wdt = w * dtc
                        u = mm(Bc, dsc.T, False)                # ds B_m
                        v = w * (xc * u).sum(-1)
                        dbi = dbi + wdt[:, None] * mm(xc, dsc, False)
                        dyx = mm(dyc, xc.T, True)
                        diff = (css[:, None] - css[None, :]).masked_fill(
                            ~mask, float("-inf"))
                        E = torch.exp(diff)
                        a1, a2 = cb * E * dtc[None], dyx * E * dtc[None]
                        Z = dyx * cb * E
                        dx[b, sl, h] = (wdt[:, None] * u
                                        + _mm_split2(a1.T, dyc, terms))
                        a2s = a2s + a2
                        colz = Z.sum(0)
                        dcss = (share[c, b, h] + (Z * dtc[None]).sum(1)
                                - dtc * (colz + v))
                        dcss[-1] += ((dtc * v).sum() + torch.exp(seg)
                                     * (dsc * s_in[c][b, h]).sum())
                        dda = torch.flip(torch.cumsum(torch.flip(dcss, [0]),
                                                      0), [0])
                        ddt[b, sl, h] = colz + v + a[h] * dda
                        da[h] += (dtc * dda).sum()
                    dB[b, sl, g] += dbi + mm(a2s.T, Cc, True)
                    dC[b, sl, g] += mm(a2s, Bc, True)
    return dx, ddt, da, dB, dC, cur


@pytest.mark.parametrize("N,terms,meets_bar", [
    (128, kernel.BWD_TERMS, True),     # mamba2-1.3b's widths
    (64, kernel.BWD_TERMS, True),      # zamba2-1.2b's
    (128, 1, False),                   # one bf16 term
], ids=["mamba2", "zamba2", "one term"])
def test_chunked_bwd_arithmetic_needs_the_split(N, terms, meets_bar):
    """The mma path's arithmetic (``_emulate_chunked_bwd``) at the models'
    widths (L 128, P 64) over 4 chunks, with state0 and a final-state
    gradient, 4 heads a slice as ``bwd_slices`` gives them, against
    ``jax.vjp`` of the JAX package's ``ssd_chunked`` in float32 on the same
    bf16-rounded x, B, C: with the kernel's bf16 terms every gradient is
    within 1e-5 of its max; with one term it is not."""
    B, T, H, P, G, chunk = 1, 512, 4, 64, 1, 128
    inp = _bwd_inputs(21, B, T, H, P, G, N, True, True)
    x, dt, a, B_, C_ = _torch(inp, torch.bfloat16)
    args = [jnp.asarray(t.float().numpy()) for t in (x, dt, a, B_, C_)]

    def f(x_, dt_, a_, B__, C__, s0):
        return jax_ssd_chunked(x_, dt_, a_, B__, C__, chunk, state0=s0)
    _, vjp = jax.vjp(f, *args, jnp.asarray(inp["state0"]))
    ref = vjp((jnp.asarray(inp["dy"]), jnp.asarray(inp["dstate"])))
    slices = kernel.bwd_slices(B, H, G, T // chunk)
    assert H // (G * slices) == 4
    got = _emulate_chunked_bwd(x, dt, a, B_, C_, chunk,
                               torch.from_numpy(inp["state0"]),
                               torch.from_numpy(inp["dy"]),
                               torch.from_numpy(inp["dstate"]), terms, slices)
    errs = {name: _rel(g.numpy(), r) for name, g, r in zip(GRAD_NAMES, got,
                                                           ref)}
    assert (max(errs.values()) <= TOL) == meets_bar, errs
    if not meets_bar:
        assert min(errs.values()) > TOL, errs


def test_ssd_chunked_bwd_keeps_the_compute_type():
    """bf16 x, B, C are upcast as ``ssd_chunked`` upcasts them: fp32
    gradients, equal to those of the fp32 upcasts."""
    inp = _bwd_inputs(13, 1, 20, 2, 8, 1, 8, False, True)
    x, dt, a, B_, C_ = _torch(inp, torch.bfloat16)
    dy, ds = torch.from_numpy(inp["dy"]), torch.from_numpy(inp["dstate"])
    got = ssd_chunked_bwd(x, dt, a, B_, C_, 8, None, dy, ds)
    up = ssd_chunked_bwd(x.float(), dt, a, B_.float(), C_.float(), 8, None,
                         dy, ds)
    for g, u in zip(got, up):
        assert g.dtype == torch.float32 and torch.equal(g, u)


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "mma"),
                                        (torch.float32, "cuda_core")])
@pytest.mark.parametrize("T,chunk,L,Lp,n_chunks", [
    (13, 128, 13, 16, 1),       # one short chunk, padded to a strip
    (128, 128, 128, 128, 1),
    (129, 128, 128, 128, 2),    # a second chunk of one row
    (50, 16, 16, 16, 4),
    (4096, 128, 128, 128, 32),  # mamba2's training sequence
])
def test_bwd_plan(dtype, path, T, chunk, L, Lp, n_chunks):
    """bf16 takes the tensor-core path, float32 the CUDA-core path; a
    chunk's rows are padded to the 16-row strips; a call launches its
    path's kernels."""
    pl = kernel.bwd_plan(dtype, T, chunk)
    assert (pl.path, pl.L, pl.Lp, pl.n_chunks) == (path, L, Lp, n_chunks)
    assert pl.kernels == kernel.BWD_KERNELS[path] == {
        "cuda_core": ("ssd_bwd_dstate", "ssd_bwd_state_passing",
                      "ssd_bwd_chunk", "ssd_bwd_group_sum",
                      "ssd_bwd_da_sum"),
        "mma": ("ssd_bwd_dstate_mma", "ssd_bwd_state_passing",
                "ssd_bwd_inter", "ssd_bwd_chunk_mma", "ssd_bwd_dda",
                "ssd_bwd_group_sum", "ssd_bwd_da_sum")}[path]
    with pytest.raises(ValueError, match="dtype"):
        kernel.bwd_plan(torch.float16, T, chunk)


@pytest.mark.parametrize("dtype,parts", [(torch.float32, 64),
                                         (torch.bfloat16, 2)],
                         ids=["cuda_core", "mma"])
def test_bwd_scratch(dtype, parts):
    """The scratch of mamba2's training call (B 4, T 4,096, H 64, P 64,
    N 128): the CUDA-core path's per-head dB and dC partials are 537 MB
    each, the mma path's per-slice partials (2 slices of 32 heads: 256
    blocks) 16.8 MB; the chunk state gradients 268 MB on both."""
    pl = kernel.bwd_plan(dtype, 4096, 128)
    n = kernel.bwd_scratch(4, 4096, 64, 64, 128, pl)
    assert kernel.bwd_slices(4, 64, 1, 32) == 2
    want = {"dbh": 4 * 4096 * parts * 128, "dch": 4 * 4096 * parts * 128,
            "dsc": 4 * 32 * 64 * 64 * 128, "segs": 4 * 32 * 64,
            "dcss": 4 * 32 * 64 * 128, "da_part": 4 * 32 * 64}
    if pl.path == "mma":        # v and the dcss share by halves of P, N
        want.update(dcss=2 * 4 * 32 * 64 * 128, vv=2 * 4 * 32 * 64 * 128,
                    dsin=4 * 32 * 64, colz=4 * 32 * 64 * 128,
                    rowq=4 * 32 * 64 * 128)
    assert n == want
    assert 4 * n["dbh"] == {"cuda_core": 536_870_912,
                            "mma": 16_777_216}[pl.path]
    assert 4 * n["dsc"] == 268_435_456


@pytest.mark.parametrize("B,H,G,n_chunks,S", [
    (4, 64, 1, 32, 2),      # mamba2's training call: 256 blocks of 32 heads
    (2, 64, 1, 3, 16),      # a short call: 96 blocks, 4 heads each
    (2, 16, 2, 2, 2),       # G 2
    (1, 6, 3, 3, 1),        # two heads a group: one slice
])
def test_bwd_slices(B, H, G, n_chunks, S):
    """The mma path's slices divide the heads of a group and give 256
    blocks, or a quarter of one a head on a smaller call."""
    assert kernel.bwd_slices(B, H, G, n_chunks) == S
    assert (H // G) % S == 0


def test_bwd_terms_match_the_source():
    """The emulation below uses the source's number of bf16 terms."""
    src = kernel.BWD_SOURCE.read_text()
    assert f"constexpr int kTerms = {kernel.BWD_TERMS};" in src


def test_bwd_wrapper_rejects_cpu_tensors():
    inp = _bwd_inputs(14, 1, 8, 2, 8, 1, 8, False, False)
    x, dt, a, B_, C_ = _torch(inp)
    dy = torch.from_numpy(inp["dy"])
    states = torch.zeros(1, 1, 2, 8, 8)
    with pytest.raises(ValueError, match="ssd_scan_bwd: x is on cpu"):
        ssd_scan_bwd(x, dt, a, B_, C_, dy, states, chunk=8)


def test_cpu_tensors_never_reach_the_autograd_function(monkeypatch):
    """A CPU tensor that wants a gradient takes the plain scan, whatever
    autograd does: ``_SSDScan`` and the kernels are never reached."""
    def refuse(*_, **__):
        raise AssertionError("reached the card's path")
    monkeypatch.setattr(ops._SSDScan, "apply", refuse)
    monkeypatch.setattr(ops, "ssd_scan", refuse)
    monkeypatch.setattr(ops, "ssd_scan_bwd", refuse)
    inp = _bwd_inputs(15, 1, 20, 2, 8, 1, 8, True, False)
    leaves = [t.requires_grad_(True) for t in _torch(inp)]
    s0 = torch.from_numpy(inp["state0"]).requires_grad_(True)
    y, state = ssd(*leaves, chunk=8, state0=s0)
    grads = torch.autograd.grad(y.sum() + state.sum(), leaves + [s0])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def _plain_scan(x, dt, a, B_, C_, *, chunk, state0=None,
                return_states=False):
    """``kernel.ssd_scan`` in plain torch on the CPU, with its chunk
    states: the rehearsal's stand-in for the forward kernel."""
    y, fin = ssd_chunked(x, dt, a, B_, C_, chunk, state0=state0)
    L = min(chunk, x.shape[1])
    states = [state0 if state0 is not None else torch.zeros_like(fin)]
    for c in range(1, -(-x.shape[1] // L)):
        states.append(ssd_chunked(x[:, :c * L], dt[:, :c * L], a,
                                  B_[:, :c * L], C_[:, :c * L], chunk,
                                  state0=state0)[1])
    return (y, fin, torch.stack(states, 1)) if return_states else (y, fin)


@pytest.mark.parametrize("state,use_y,use_state", [
    (True, True, True), (False, True, False), (True, False, True),
    (False, True, True)])
def test_autograd_function_routes_the_gradients(monkeypatch, state, use_y,
                                                use_state):
    """``_SSDScan`` on the CPU with the kernel entries replaced by the
    plain versions (``ssd_chunked`` with its chunk states, and
    ``ssd_chunked_bwd``): the gradients it returns equal autograd of the
    plain scan, whichever outputs reach the loss (an unused output's
    gradient arrives as None), and a None state0 gets none."""
    calls = {}

    def plain_bwd(x, dt, a, B_, C_, dy, states, *, chunk, dstate,
                  state0_grad):
        calls["dstate"], calls["state0_grad"] = dstate, state0_grad
        out = ssd_chunked_bwd(x, dt, a, B_, C_, chunk, states[:, 0], dy,
                              dstate)
        return out[:5] + ((out[5],) if state0_grad else (None,))
    monkeypatch.setattr(ops, "ssd_scan", _plain_scan)
    monkeypatch.setattr(ops, "ssd_scan_bwd", plain_bwd)
    inp = _bwd_inputs(16, 2, 40, 4, 8, 2, 8, state, True)
    ins = [t.requires_grad_(True) for t in _torch(inp)]
    s0 = (torch.from_numpy(inp["state0"]).requires_grad_(True) if state
          else None)
    wrt = ins + ([s0] if state else [])
    dy, ds = torch.from_numpy(inp["dy"]), torch.from_numpy(inp["dstate"])

    def loss(y, fin):
        return ((y * dy).sum() if use_y else 0) + (
            (fin * ds).sum() if use_state else 0)
    got = torch.autograd.grad(loss(*ops._SSDScan.apply(*ins, s0, 16)), wrt)
    # without y, C_ does not reach the loss: autograd has no gradient for
    # it, the kernel's is zeros
    ref = torch.autograd.grad(loss(*ssd_chunked(*ins, 16, state0=s0)), wrt,
                              allow_unused=True)
    assert (calls["dstate"] is None) == (not use_state)
    assert calls["state0_grad"] == state
    for g, r in zip(got, ref):
        if r is None:
            assert not use_y and not bool(g.abs().max())
        else:
            assert _rel(g.detach().numpy(), r.numpy()) <= TOL
