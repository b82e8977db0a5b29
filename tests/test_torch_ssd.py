"""The port's SSD scan (plain versions on CPU tensors) against the JAX
package: its naive oracle, its Pallas kernel in interpret mode, and the
model's chunked XLA twin with an initial state.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: 1e-5 of the reference's max |y|, as tests/test_kernels.py.
The bf16 case rounds the same inputs to bf16 on both sides, and both
upcast them to fp32, so only the order of the fp32 sums differs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ssd import ssd_ref as jax_ssd_ref
from repro.kernels.ssd import ssd_scan as jax_ssd_scan
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import kernel, ssd, ssd_chunked, ssd_ref

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
