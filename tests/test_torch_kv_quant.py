"""The port's int8 KV cache (``models/kv_quant.py``) against the JAX
package on the CPU, mirroring tests/test_kv_quant.py.

Codes and scales must equal the JAX package's: both divide in float32 and
round half to even.  Attention over the quantized cache is held to the
float cache's attention at the reference test's bar (0.05) and to the
JAX package's attention over the same cache at the flash kernel's float32
bar (2e-5).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import kv_quant as jax_kv
from repro_torch.kernels.flash_attention import mha
from repro_torch.models.kv_quant import (append_quant_cache,
                                         attention_over_quant_cache,
                                         dequantize_kv, init_quant_cache,
                                         quantize_kv)


@pytest.mark.parametrize("seed,scale", [(0, 0.01), (1, 1.0), (2, 3.7),
                                        (3, 100.0)])
def test_quant_roundtrip_bounded(seed, scale):
    """tests/test_kv_quant.py's bound: error <= absmax / 254 per row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, scale, (2, 8, 4, 32)).astype(np.float32)
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    deq = dequantize_kv(q, s, torch.float32).numpy()
    row_max = np.abs(x).max(axis=-1, keepdims=True)
    assert np.all(np.abs(deq - x) <= row_max / 254.0 + 1e-7)


@pytest.mark.parametrize("seed", range(4))
def test_codes_and_scales_equal_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10 ** (seed - 1), (3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                         # a zero row: scale 1
    # rows whose values sit on a rounding half: absmax 127 gives scale 1,
    # and 2.5, -0.5, 3.5 must round to even as jnp.round does
    x[1, 1, 1] = 0.0
    x[1, 1, 1, :4] = [127.0, 2.5, -0.5, 3.5]
    jq, js = jax_kv.quantize_kv(jnp.asarray(x))
    q, s = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 0, 0, 0] == 1.0
    assert q[1, 1, 1, :4].tolist() == [127, 2, 0, 4]
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            dequantize_kv(q, s, dt).float().numpy(),
            np.asarray(jax_kv.dequantize_kv(jq, js, jdt), np.float32))


def test_quant_cache_attention_close_to_fp():
    """tests/test_kv_quant.py's case: int8 K/V keep decode attention within
    0.05 of the float cache's."""
    rng = np.random.default_rng(0)
    Bn, Hq, Hkv, D, T = 2, 4, 2, 32, 64
    q = rng.normal(0, 1, (Bn, 1, Hq, D)).astype(np.float32)
    k = rng.normal(0, 1, (Bn, T, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (Bn, T, Hkv, D)).astype(np.float32)
    cache = init_quant_cache(Bn, T + 8, Hkv, D, device="cpu")
    cache = append_quant_cache(cache, torch.from_numpy(k), torch.from_numpy(v),
                               0)
    out_q = attention_over_quant_cache(torch.from_numpy(q), cache, kv_len=T,
                                       chunk=16)
    out_f = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                causal=False)
    assert float((out_q - out_f).abs().max()) < 0.05
    jcache = jax_kv.append_quant_cache(jax_kv.init_quant_cache(Bn, T + 8, Hkv,
                                                               D),
                                       jnp.asarray(k), jnp.asarray(v), 0)
    for key in cache:
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]))
    ref = jax_kv.attention_over_quant_cache(jnp.asarray(q), jcache, kv_len=T,
                                            chunk=16)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_quant_cache_causal_prefill_matches_jax():
    """A causal prefill of 9 queries at offset 3 over a 12-row cache."""
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (1, 9, 4, 32)).astype(np.float32)
    k = rng.normal(0, 1, (1, 12, 2, 32)).astype(np.float32)
    v = rng.normal(0, 1, (1, 12, 2, 32)).astype(np.float32)
    cache = append_quant_cache(init_quant_cache(1, 16, 2, 32, device="cpu"),
                               torch.from_numpy(k), torch.from_numpy(v), 0)
    jcache = jax_kv.append_quant_cache(jax_kv.init_quant_cache(1, 16, 2, 32),
                                       jnp.asarray(k), jnp.asarray(v), 0)
    out = attention_over_quant_cache(torch.from_numpy(q), cache, kv_len=12,
                                     causal=True, q_offset=3)
    ref = jax_kv.attention_over_quant_cache(jnp.asarray(q), jcache, kv_len=12,
                                            causal=True, q_offset=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_quant_cache_incremental_append():
    rng = np.random.default_rng(1)
    Bn, Hkv, D, T = 1, 2, 16, 12
    k = torch.from_numpy(rng.normal(0, 1, (Bn, T, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (Bn, T, Hkv, D)).astype(np.float32))
    all_at_once = append_quant_cache(
        init_quant_cache(Bn, T, Hkv, D, device="cpu"), k, v, 0)
    step_by_step = init_quant_cache(Bn, T, Hkv, D, device="cpu")
    for t in range(T):
        step_by_step = append_quant_cache(step_by_step, k[:, t:t + 1],
                                          v[:, t:t + 1], t)
    for key in all_at_once:
        assert torch.equal(all_at_once[key], step_by_step[key])
    with pytest.raises(ValueError, match="cannot take"):
        append_quant_cache(step_by_step, k[:, :2], v[:, :2], T - 1)


def test_memory_footprint_quarter():
    """tests/test_kv_quant.py's bound, and the same bytes as the JAX
    package's cache."""
    Bn, T, H, D = 1, 1024, 4, 128
    fp = Bn * T * H * D * 2 * 2                       # bf16 k+v
    c = init_quant_cache(Bn, T, H, D, device="cpu")
    q8 = sum(t.numel() * t.element_size() for t in c.values())
    assert q8 < fp * 0.6
    assert q8 == sum(np.asarray(a).nbytes
                     for a in jax_kv.init_quant_cache(Bn, T, H, D).values())
