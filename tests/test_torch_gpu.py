"""Tests of the port that need a CUDA card; they skip elsewhere.

Run on the card with:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

This file imports no JAX, and ``--noconftest`` skips the suite's conftest
(whose fixtures clear JAX caches), so it runs where JAX is not installed.
Each test decides inside its body whether a card is present.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.kernels._launches import launched_kernels
from repro_torch.kernels.flash_attention import attention_ref, kernel, mha
from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_ref, ssd_scan
from repro_torch.launch.serve import Request, ServeLoop

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: SSD: 1e-5 of the reference's max |y| (tests/test_kernels.py), in bf16
#: too: both sides upcast the same bf16 values, so only the order of the
#: fp32 sums differs.
SSD_TOL = 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,kv_len,q_offset", [
    (1, 2, 2, 64, 64, 32, True, None, 0),
    (2, 4, 2, 128, 128, 64, True, None, 0),     # GQA
    (1, 4, 1, 96, 160, 32, False, None, 0),     # MQA, unaligned, bidir
    (1, 2, 2, 1, 256, 64, False, None, 0),      # decode shape
    (1, 2, 2, 8, 128, 32, False, 50, 0),        # kv_len mask
    (2, 4, 2, 1, 64, 64, True, 40, 39),         # decode at an offset
    (2, 4, 2, 33, 70, 128, True, 70, 37),       # D 128, 4-row tiles
    # tensor-core prefill (bf16; float32 takes the CUDA-core path)
    (2, 4, 4, 15, 27, 64, True, 15, 0),         # Sq 15: one ragged warp
    (1, 2, 2, 33, 33, 64, True, None, 0),       # Sq 33: ragged 64-row tile
    (1, 2, 1, 100, 100, 64, True, None, 0),     # Sq 100: ragged 128-row tile
    (1, 2, 2, 100, 150, 64, False, 130, 0),     # Sk 150, kv_len < Sk, bidir
    (2, 4, 4, 70, 200, 64, True, 181, 111),     # chunk at an offset, ragged
    (2, 8, 2, 48, 160, 32, True, 148, 100),     # chunk, D 32, GQA
    (1, 8, 1, 40, 256, 128, True, 240, 200),    # chunk, D 128, MQA
    (1, 4, 2, 130, 300, 128, True, 290, 160),   # chunk, D 128, 3 q tiles
    # split decode
    (2, 4, 2, 1, 64, 64, True, 1, 0),           # kv_len 1
    (1, 2, 2, 1, 4096, 64, True, 4096, 300),    # causal cut: empty splits
    (1, 2, 2, 1, 4096, 64, True, 4096, 4095),   # Sk 4096: splits merged
    (2, 8, 1, 1, 4096, 128, True, 3000, 2999),  # MQA, D 128, splits
    (1, 16, 2, 1, 1000, 32, False, None, 0),    # GQA 8, D 32, bidir
    (1, 24, 2, 1, 500, 64, True, 500, 499),     # GQA 12: two head chunks
])
def test_kernel_matches_plain_version(dtype, B, Hq, Hkv, Sq, Sk, D, causal,
                                      kv_len, q_offset):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, Hq, Sq, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dtype)
    before = kernel.LAUNCHES
    out = kernel.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                 q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    ref = attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                        q_offset=q_offset)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("Sq", [8, 1], ids=["prefill", "decode"])
def test_keys_past_kv_len_do_not_matter(dtype, Sq):
    """The kv_len=50 case: keys past kv_len holding 1e3 leave the output
    bit for bit as it was, on the prefill paths and the decode path."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(1, 2, Sq, 32, generator=g, device="cuda").to(dtype)
    k = torch.randn(1, 2, 128, 32, generator=g, device="cuda").to(dtype)
    v = torch.randn(1, 2, 128, 32, generator=g, device="cuda").to(dtype)
    out = kernel.flash_attention(q, k, v, causal=False, kv_len=50)
    k2 = k.clone()
    k2[:, :, 50:] = 1e3
    out2 = kernel.flash_attention(q, k2, v, causal=False, kv_len=50)
    ref = attention_ref(q, k, v, causal=False, kv_len=50)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.equal(out, out2)


@pytest.mark.gpu
def test_split_decode_in_a_cuda_graph():
    """A decode of several splits (scratch and merge) replays in a CUDA
    graph, as chip_smoke.py times it, and agrees with the eager call."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(2, 4, 1, 64, generator=g, device="cuda").bfloat16()
    k = torch.randn(2, 4, 8192, 64, generator=g, device="cuda").bfloat16()
    v = torch.randn(2, 4, 8192, 64, generator=g, device="cuda").bfloat16()
    path, splits = kernel.plan(q.dtype, 2, 4, 4, 1, 8192,
                               kernel.sm_count(q.device.index))
    assert path == "decode_split" and splits > 1
    eager = kernel.flash_attention(q, k, v, causal=True, kv_len=8000,
                                   q_offset=7999)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel.flash_attention(q, k, v, causal=True, kv_len=8000,
                               q_offset=7999)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel.flash_attention(q, k, v, causal=True, kv_len=8000,
                                     q_offset=7999)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    q = torch.zeros(1, 2, 4, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 4, 32, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        kernel.flash_attention(q, q, q)


@pytest.mark.gpu
def test_mha_on_cache_views_matches_plain_version():
    """The model's call: (B, S, H, D) strided views of a stacked cache."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(4, 1, 32, 64, generator=g, device="cuda").bfloat16()
    kc = torch.randn(3, 4, 28, 32, 64, generator=g, device="cuda").bfloat16()
    vc = torch.randn(3, 4, 28, 32, 64, generator=g, device="cuda").bfloat16()
    out = mha(q, kc[2], vc[2], causal=True, kv_len=20, q_offset=19)
    ref = attention_ref(q.transpose(1, 2), kc[2].transpose(1, 2),
                        vc[2].transpose(1, 2), causal=True, kv_len=20,
                        q_offset=19).transpose(1, 2)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_full_width_serve_goes_through_the_kernel():
    _need_card()
    cfg = get_config("stablelm-1.6b")
    loop = ServeLoop(cfg)
    gen = torch.Generator().manual_seed(0)
    reqs = [Request(rid=i, prompt=torch.randint(0, cfg.vocab, (n,),
                                                generator=gen).numpy(),
                    max_new=4) for i, n in enumerate((5, 12))]
    before = kernel.LAUNCHES
    done = loop.run_batch(reqs)
    assert kernel.LAUNCHES - before == cfg.n_layers * (1 + 4)
    for r in done:
        assert len(r.out) == 4 and all(0 <= t < cfg.vocab for t in r.out)


def _ssd_inputs(B, T, H, P, G, N, dtype, state=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = rnd(B, T, H, P).to(dtype)
    dt = (0.05 + 0.02 * rnd(B, T, H)).abs()
    a = -(1.0 + 0.3 * rnd(H)).abs()
    B_, C_ = rnd(B, T, G, N).to(dtype), rnd(B, T, G, N).to(dtype)
    return x, dt, a, B_, C_, (rnd(B, H, P, N) if state else None)


def _ssd_close(out, ref):
    scale = ref.abs().max()
    assert bool(((out - ref).abs() <= SSD_TOL * scale).all()), \
        float((out - ref).abs().max() / scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,P,G,N,chunk,state", [
    (1, 32, 2, 8, 1, 8, 8, False),
    (2, 64, 4, 16, 2, 16, 16, False),
    (1, 50, 4, 8, 1, 8, 16, False),        # unaligned T: ragged last chunk
    (2, 50, 4, 16, 2, 16, 16, True),       # initial state
    (2, 13, 8, 64, 1, 128, 128, True),     # serve widths, one chunk
    (1, 300, 4, 64, 1, 128, 128, False),   # carry over 3 chunks, ragged
    (1, 4096, 8, 64, 1, 128, 128, False),  # serve widths, 32 chunks
    (2, 1000, 8, 64, 1, 128, 128, True),   # 8 chunks, ragged, state0
    (1, 300, 8, 64, 4, 128, 128, True),    # G 4 across 3 chunks
])
def test_ssd_kernel_matches_plain_version(dtype, B, T, H, P, G, N, chunk,
                                          state):
    _need_card()
    x, dt, a, B_, C_, s0 = _ssd_inputs(B, T, H, P, G, N, dtype, state)
    before = ssd_mod.kernel.LAUNCHES
    y, st = ssd_scan(x, dt, a, B_, C_, chunk=chunk, state0=s0)
    torch.cuda.synchronize()
    assert ssd_mod.kernel.LAUNCHES == before + 1
    pl = ssd_mod.kernel.plan(dtype, T, chunk)
    assert ssd_mod.kernel.LAST_PATH == pl.path
    launched = launched_kernels(
        lambda: ssd_scan(x, dt, a, B_, C_, chunk=chunk, state0=s0))
    assert sorted(launched) == sorted(pl.kernels), launched
    ref_y, ref_st = ssd_chunked(x, dt, a, B_, C_, chunk, state0=s0)
    _ssd_close(y, ref_y)
    _ssd_close(st, ref_st)
    if s0 is None and T <= 64:
        _ssd_close(y, ssd_ref(x, dt, a, B_, C_))


@pytest.mark.gpu
def test_ssd_kernel_reads_strided_views():
    """The model's call: x, B_, C_ as views of one (B, T, conv_ch) conv
    output, through ``ops.ssd``."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    H, P, N = 8, 64, 128
    conv = torch.randn(2, 20, H * P + 2 * N, generator=g,
                       device="cuda").bfloat16()
    x = conv[..., :H * P].unflatten(-1, (H, P))
    B_ = conv[..., H * P:H * P + N].unflatten(-1, (1, N))
    C_ = conv[..., H * P + N:].unflatten(-1, (1, N))
    dt = torch.rand(2, 20, H, generator=g, device="cuda")
    a = -torch.rand(H, generator=g, device="cuda") - 0.5
    y, st = ssd(x, dt, a, B_, C_, chunk=16)
    ref_y, ref_st = ssd_chunked(x.contiguous(), dt, a, B_.contiguous(),
                                C_.contiguous(), 16)
    _ssd_close(y, ref_y)
    _ssd_close(st, ref_st)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_kernel_reads_unaligned_views(dtype):
    """Views whose rows do not start on 16 bytes (an odd offset and row
    stride) take the element-by-element loads of the chunked path; a
    state0 that does not start on 16 bytes is read as well."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    H, P, N, T = 4, 64, 128, 200
    conv = torch.randn(2, T, 1 + H * P + 2 * N, generator=g,
                       device="cuda").to(dtype)[..., 1:]
    x = conv[..., :H * P].unflatten(-1, (H, P))
    B_ = conv[..., H * P:H * P + N].unflatten(-1, (1, N))
    C_ = conv[..., H * P + N:].unflatten(-1, (1, N))
    dt = (0.05 + 0.02 * torch.randn(2, T, H, generator=g, device="cuda")).abs()
    a = -(1.0 + 0.3 * torch.randn(H, generator=g, device="cuda")).abs()
    s0 = torch.randn(2 * H * P * N + 1, generator=g,
                     device="cuda")[1:].view(2, H, P, N)
    y, st = ssd_scan(x, dt, a, B_, C_, chunk=128, state0=s0)
    ref_y, ref_st = ssd_chunked(x, dt, a, B_, C_, 128, state0=s0)
    _ssd_close(y, ref_y)
    _ssd_close(st, ref_st)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "chunked"),
                                        (torch.float32, "fp32")],
                         ids=["bfloat16", "float32"])
def test_ssd_path_by_dtype(dtype, path):
    """bf16 x/B/C take the chunked tensor-core path, float32 the CUDA-core
    kernel: the wrapper records the path, and the driver records its
    kernels, once each."""
    _need_card()
    x, dt, a, B_, C_, s0 = _ssd_inputs(1, 40, 2, 16, 1, 16, dtype, True)
    ssd_scan(x, dt, a, B_, C_, chunk=16, state0=s0)
    assert ssd_mod.kernel.LAST_PATH == path
    launched = launched_kernels(
        lambda: ssd_scan(x, dt, a, B_, C_, chunk=16, state0=s0))
    expected = (["ssd_chunk_cb", "ssd_chunk_state", "ssd_state_passing",
                 "ssd_chunk_scan"] if path == "chunked" else ["ssd_fwd_fp32"])
    assert sorted(launched) == sorted(expected), launched


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ok", [(torch.float32, True),
                                      (torch.bfloat16, False)],
                         ids=["float32", "bfloat16"])
def test_ssd_grid_limit_by_path(dtype, ok):
    """B x H past the grid's 65535 rows: the fp32 path's grid is (H, B)
    and takes it; the chunked path's is (chunks, B x H) and refuses it."""
    _need_card()
    x, dt, a, B_, C_, _ = _ssd_inputs(1100, 8, 64, 8, 1, 8, dtype)
    if not ok:
        with pytest.raises(ValueError, match="chunked path"):
            ssd_scan(x, dt, a, B_, C_, chunk=8)
        return
    y, st = ssd_scan(x, dt, a, B_, C_, chunk=8)
    ref_y, ref_st = ssd_chunked(x, dt, a, B_, C_, 8)
    _ssd_close(y, ref_y)
    _ssd_close(st, ref_st)


@pytest.mark.gpu
def test_ssd_chunked_path_in_a_cuda_graph():
    """The chunked path (scratch, four launches) replays in a CUDA graph,
    as chip_smoke.py times it, and agrees with the eager call."""
    _need_card()
    x, dt, a, B_, C_, s0 = _ssd_inputs(2, 1000, 8, 64, 1, 128,
                                       torch.bfloat16, True, seed=6)
    eager = ssd_scan(x, dt, a, B_, C_, chunk=128, state0=s0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_scan(x, dt, a, B_, C_, chunk=128, state0=s0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, st = ssd_scan(x, dt, a, B_, C_, chunk=128, state0=s0)
    graph.replay()
    torch.cuda.synchronize()
    assert ssd_mod.kernel.LAST_PATH == "chunked"
    assert torch.equal(y, eager[0]) and torch.equal(st, eager[1])


@pytest.mark.gpu
def test_ssd_kernel_rejects_what_it_does_not_take():
    _need_card()
    x, dt, a, B_, C_, _ = _ssd_inputs(1, 8, 2, 32, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan(x, dt, a, B_, C_, chunk=8)
    x, dt, a, B_, C_, _ = _ssd_inputs(1, 200, 2, 8, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="chunk length"):
        ssd_scan(x, dt, a, B_, C_, chunk=256)
    with pytest.raises(ValueError, match="dtypes"):
        ssd_scan(x.half(), dt, a, B_.half(), C_.half(), chunk=8)


@pytest.mark.gpu
def test_full_width_mamba2_serve_goes_through_the_ssd_kernel():
    _need_card()
    cfg = get_config("mamba2-1.3b")
    loop = ServeLoop(cfg)
    gen = torch.Generator().manual_seed(0)
    reqs = [Request(rid=i, prompt=torch.randint(0, cfg.vocab, (n,),
                                                generator=gen).numpy(),
                    max_new=4) for i, n in enumerate((5, 12))]
    before, flash_before = ssd_mod.kernel.LAUNCHES, kernel.LAUNCHES
    done = loop.run_batch(reqs)
    assert ssd_mod.kernel.LAUNCHES - before == cfg.n_layers
    assert kernel.LAUNCHES == flash_before
    for r in done:
        assert len(r.out) == 4 and all(0 <= t < cfg.vocab for t in r.out)


# ---------------------------------------------------------------------------
# The estimator path: float64 on the card, held to the same calls on the CPU
# ---------------------------------------------------------------------------
#: card against CPU on the float64 estimator path (tests/test_tick_engine.py)
EST_TOL = 1e-12


def _est_close(card, cpu):
    import numpy as np
    np.testing.assert_allclose(np.asarray(card, np.float64),
                               np.asarray(cpu, np.float64),
                               rtol=EST_TOL, atol=EST_TOL)


def _est_tasks(T=300, seed=0):
    """Ragged tasks from a seed: size-correlated ones, flat ones and
    one-sample ones."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes, runs = [], []
    for _ in range(T):
        n = int(rng.integers(1, 11))
        s = np.geomspace(1.0, 256.0, n) * rng.uniform(0.5, 2.0)
        if rng.random() < 0.7:
            r = rng.uniform(0.1, 5.0) * s + rng.uniform(1, 50) \
                + rng.normal(0, 0.5, n)
        else:
            r = rng.uniform(20, 200) + rng.normal(0, 2.0, n)
        sizes.append(s)
        runs.append(r)
    return sizes, runs


def _est_stream(T, S=2000, seed=1):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.integers(0, T, S), rng.uniform(1.0, 256.0, S),
            rng.uniform(5.0, 2000.0, S))


def _same_models(card, cpu):
    from repro_torch.core import blr
    assert card.median.device.type == "cuda"
    assert torch.equal(card.correlated.cpu(), cpu.correlated)
    for f in blr.POSTERIOR_FIELDS:
        _est_close(blr._np(getattr(card.post, f)),
                   blr._np(getattr(cpu.post, f)))
    _est_close(blr._np(card.median), blr._np(cpu.median))
    _est_close(blr._np(card.spread), blr._np(cpu.spread))
    _est_close(blr._np(card.stats.moments), blr._np(cpu.stats.moments))


@pytest.mark.gpu
def test_fit_task_batch_card_matches_cpu():
    _need_card()
    from repro_torch.core import blr
    sizes, runs = _est_tasks()
    card = blr.fit_task_batch(sizes, runs)          # the default: the card
    cpu = blr.fit_task_batch(sizes, runs, device="cpu")
    assert card.post.mu.dtype == torch.float64
    _same_models(card, cpu)
    for x in (128.0, [float(v) for v in range(1, 301)]):
        for a, b in zip(blr.predict_task_batch(card, x),
                        blr.predict_task_batch(cpu, x)):
            _est_close(blr._np(a), blr._np(b))


@pytest.mark.gpu
def test_update_task_batch_stream_card_matches_cpu():
    _need_card()
    from repro_torch.core import blr
    sizes, runs = _est_tasks()
    idx, xs, ys = _est_stream(len(sizes))
    card = blr.update_task_batch_stream(
        blr.fit_task_batch(sizes, runs, device="cuda"), idx, xs, ys)
    cpu = blr.update_task_batch_stream(
        blr.fit_task_batch(sizes, runs, device="cpu"), idx, xs, ys)
    _same_models(card, cpu)
    # the moments are summed in stream order on both: equal bit for bit
    assert torch.equal(card.stats.moments.cpu(), cpu.stats.moments)


@pytest.mark.gpu
def test_update_stream_never_waits_on_the_card():
    """The update path syncs nowhere: any synchronising call (a blocking
    copy, ``.item()``, ``nonzero``) raises under sync debug mode "error"."""
    _need_card()
    from repro_torch.core import blr
    sizes, runs = _est_tasks()
    idx, xs, ys = _est_stream(len(sizes))
    model = blr.fit_task_batch(sizes, runs, device="cuda")
    mu0 = model.post.mu.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new = blr.update_task_batch_stream(model, idx, xs, ys)
        new = blr.update_task_batch(new, 7, 100.0, 321.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(model.post.mu, mu0)          # the input is unchanged
    cpu = blr.update_task_batch_stream(
        blr.fit_task_batch(sizes, runs, device="cpu"), idx, xs, ys)
    cpu = blr.update_task_batch(cpu, 7, 100.0, 321.0)
    _same_models(new, cpu)


@pytest.mark.gpu
def test_predict_matrix_and_observe_batch_card_match_cpu():
    _need_card()
    import numpy as np
    from repro_torch.core import LotaruEstimator, fit_task
    from repro_torch.core.estimator import FittedTask
    from repro_torch.core.profiler import BenchResult

    def build(device):
        rng = np.random.default_rng(0)
        local = BenchResult("local-cpu", 450.0, 90.0, 18.0, 420.0, 400.0,
                            0.0)
        benches = {f"n{j}": BenchResult(
            f"n{j}", *(float(v) for v in rng.uniform(100, 900, 5)), 0.0)
            for j in range(16)}
        est = LotaruEstimator(local, benches, device=device)
        sizes, runs = _est_tasks(200, seed=2)
        for i, (s, r) in enumerate(zip(sizes, runs)):
            est.tasks[f"t{i}"] = FittedTask(
                model=fit_task(s, r, device=device),
                w=float(rng.uniform(0, 1)), sizes=s, runtimes=r)
        return est

    card, cpu = build("cuda"), build("cpu")
    nodes = list(card.target_benches)
    for a, b in zip(card.predict_matrix(nodes, 128.0),
                    cpu.predict_matrix(nodes, 128.0)):
        _est_close(a, b)
    idx, xs, ys = _est_stream(200, 500, seed=3)
    names = card.task_names()
    obs = [(names[i], nodes[i % 16], float(x), float(y))
           for i, x, y in zip(idx, xs, ys)]
    _est_close(card.observe_batch(obs), cpu.observe_batch(obs))
    assert card._dirty_rows == cpu._dirty_rows
    for a, b in zip(card.predict_matrix(nodes, 128.0),
                    cpu.predict_matrix(nodes, 128.0)):
        _est_close(a, b)
    for n in names[:20]:
        _est_close(card.predict(n, nodes[3], 50.0),
                   cpu.predict(n, nodes[3], 50.0))


@pytest.mark.gpu
def test_inv_ex_first_and_warm_call():
    """The first ``inv_ex`` of a fresh process (library set-up included)
    and the warm ones, timed in a child process; each agrees with the CPU,
    and none waits on the card."""
    _need_card()
    import json
    import subprocess
    import sys
    code = (
        "import json, time, numpy as np, torch\n"
        "rng = np.random.default_rng(0)\n"
        "a = rng.normal(size=(1000, 2, 2))\n"
        "a = a @ a.transpose(0, 2, 1) + np.eye(2)\n"
        "ac = torch.tensor(a, device='cuda')\n"
        "torch.cuda.synchronize()\n"
        "ms = []\n"
        "for k in range(6):\n"
        "    t0 = time.perf_counter()\n"
        "    if k == 0:\n"
        "        torch.cuda.set_sync_debug_mode('error')\n"
        "    inv = torch.linalg.inv_ex(ac).inverse\n"
        "    torch.cuda.set_sync_debug_mode('default')\n"
        "    torch.cuda.synchronize()\n"
        "    ms.append((time.perf_counter() - t0) * 1e3)\n"
        "ref = torch.linalg.inv_ex(torch.tensor(a)).inverse\n"
        "err = float(((inv.cpu() - ref).abs() / (ref.abs() + 1e-12)).max())\n"
        "print(json.dumps({'first_ms': ms[0], 'warm_ms': sorted(ms[1:])[2],"
        " 'rel_err': err}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"inv_ex on (1000, 2, 2) float64: first {got['first_ms']:.3f} ms, "
          f"warm {got['warm_ms']:.4f} ms")
    assert got["rel_err"] <= EST_TOL
    assert got["warm_ms"] <= got["first_ms"]


# ---------------------------------------------------------------------------
# The fused tick (core/state.py, core/tick.py) and the online executor
# ---------------------------------------------------------------------------
def _tick_estimator(device, wf="chipseq", **kw):
    """A paper workflow fitted from the port's simulator (seed 0)."""
    import numpy as np
    from repro_torch.core import (LotaruEstimator, get_node,
                                  profile_cluster, profile_node,
                                  target_nodes)
    from repro_torch.sched.simulator import ClusterSimulator
    from repro_torch.sched.workflows import INPUTS, WORKFLOWS
    local = get_node("local-cpu")
    est = LotaruEstimator(profile_node(local, np.random.default_rng(7)),
                          profile_cluster(target_nodes(), seed=13),
                          device=device, **kw)
    by = {t.name: t for t in WORKFLOWS[wf]}
    sim = ClusterSimulator(seed=0)
    est.fit_tasks(list(by), INPUTS[(wf, 1)], lambda n, s, cf: sim.run_task(
        by[n], local, s, cpu_factor=cf))
    return est, [nt.name for nt in target_nodes()], INPUTS[(wf, 1)]


def _tick_batches(names, nodes, size, ticks=6, seed=3):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[(names[int(rng.integers(0, len(names)))],
              nodes[int(rng.integers(0, len(nodes)))],
              size * float(rng.uniform(0.5, 1.5)),
              float(rng.uniform(5.0, 80.0)))
             for _ in range(int(rng.integers(1, 9)))] for _ in range(ticks)]


def _tick_leaves(state):
    from repro_torch.core import blr
    m = state.model
    return ([m.stats.moments, m.correlated, m.median, m.spread,
             state.bias_counts, state.bias_log_sum, state.bias_log_sq]
            + [getattr(m.post, f) for f in blr.POSTERIOR_FIELDS])


@pytest.mark.gpu
@pytest.mark.parametrize("cuda_graph", [False, True], ids=["eager", "graph"])
def test_tick_engine_card_matches_cpu(cuda_graph):
    _need_card()
    from repro_torch.core.tick import TickEngine
    kw = {"bias_decay": 0.9, "bias_empirical_bayes": True}
    card, nodes, size = _tick_estimator("cuda", **kw)
    cpu, _, _ = _tick_estimator("cpu", **kw)
    ec = TickEngine(card, nodes, size=size, cuda_graph=cuda_graph)
    eh = TickEngine(cpu, nodes, size=size)
    assert ec.state.factors.device.type == "cuda"
    for batch in _tick_batches(card.task_names(), nodes, size):
        _est_close(ec.observe_batch(batch), eh.observe_batch(batch))
        for a, b in zip(ec.predict_matrix(nodes, size),
                        eh.predict_matrix(nodes, size)):
            _est_close(a, b)
        _est_close(ec._bias.log_sum, eh._bias.log_sum)
        for n in card.task_names()[:4]:
            _est_close(ec.predict_interval_node(n, nodes[1], size),
                       eh.predict_interval_node(n, nodes[1], size))
    for a, b in zip(_tick_leaves(ec.state), _tick_leaves(eh.state)):
        _est_close(a.cpu().double(), b.double())
    ec.finalize()
    eh.finalize()
    for a, b in zip(card.predict_matrix(nodes, size),
                    cpu.predict_matrix(nodes, size)):
        _est_close(a, b)


@pytest.mark.gpu
def test_tick_padding_and_scatter_order_on_the_card():
    """On the card: valid = 0 rows change no bit, and two runs of the
    same tick (a pair hit many times) give the same bits — the wave
    scatter is order-exact where an atomic scatter would not be."""
    _need_card()
    import numpy as np
    from repro_torch.core.state import build_state
    from repro_torch.core.tick import tick_step
    est, nodes, size = _tick_estimator("cuda", bias_decay=0.8,
                                       bias_empirical_bayes=True)
    rng = np.random.default_rng(9)
    B = 512
    obs = np.zeros((B, 8))
    obs[:, 0] = rng.choice([1, 4, 7], B)
    obs[:, 1] = rng.choice([0, 2], B)
    obs[:, 2] = size * rng.uniform(0.5, 1.5, B)
    obs[:, 3] = rng.uniform(1.0, 1e4, B)
    obs[:, 4] = obs[:, 3]
    obs[:, 5:7] = [30.0, 1.0]
    obs[:, 7] = 1.0
    junk = obs[rng.integers(0, B, 100)].copy()
    junk[:, 7] = 0.0
    padded = np.insert(obs, rng.integers(0, B, 100), junk, axis=0)
    runs = []
    for batch in (obs, obs, padded):
        for host_deadjust in (True, False):
            state, _ = build_state(est, nodes)
            state, mean, std, _ = tick_step(state, batch, size,
                                            host_deadjust)
            runs.append(_tick_leaves(state) + [mean, std])
    for k in (2, 4):
        for a, b in zip(runs[0], runs[k]):
            assert torch.equal(a, b)
        for a, b in zip(runs[1], runs[k + 1]):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("cuda_graph", [False, True], ids=["eager", "graph"])
def test_observe_batch_waits_on_the_card_once(cuda_graph):
    """``TickEngine.observe_batch`` syncs only in its one copy of the
    tick's outputs (``_fetch``): everything else raises under sync debug
    mode "error".  A graph tick is captured before the mode is set (a
    capture synchronises), then replayed under it."""
    _need_card()
    from repro_torch.core.tick import TickEngine
    est, nodes, size = _tick_estimator("cuda")
    engine = TickEngine(est, nodes, size=size, cuda_graph=cuda_graph)
    batch = _tick_batches(est.task_names(), nodes, size, 1)[0]
    engine.observe_batch(batch)             # capture (graph) or warm-up
    fetch = engine._fetch
    calls = []

    def relaxed(out):
        calls.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return fetch(out)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    engine._fetch = relaxed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.observe_batch(batch)
        engine.predict_matrix(nodes, size)
        engine.predict_interval_node(est.task_names()[0], nodes[0], size)
        engine.bias_tail_mass(est.task_names()[0], nodes[0], 1.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert calls == [1]


@pytest.mark.gpu
def test_cuda_graph_tick_equals_eager_bit_for_bit():
    """Ragged ticks, padded to the graph's batch: every output and every
    leaf equals eager's, tick after tick."""
    _need_card()
    import numpy as np
    from repro_torch.core.tick import TickEngine
    kw = {"bias_decay": 0.9, "bias_empirical_bayes": True}
    a, nodes, size = _tick_estimator("cuda", **kw)
    b, _, _ = _tick_estimator("cuda", **kw)
    eager = TickEngine(a, nodes, size=size, cuda_graph=False)
    graph = TickEngine(b, nodes, size=size)      # the default on a card
    batches = _tick_batches(a.task_names(), nodes, size, ticks=10, seed=5)
    batches += batches[:3]                  # replays of captured keys
    for batch in batches:
        assert eager.observe_batch(batch) == graph.observe_batch(batch)
        for x, y in zip(eager.predict_matrix(nodes, size),
                        graph.predict_matrix(nodes, size)):
            assert np.array_equal(x, y)
        for x, y in zip(_tick_leaves(eager.state), _tick_leaves(graph.state)):
            assert torch.equal(x, y)
    assert graph.cuda_graph and 1 <= len(graph._graphs) < len(batches)
    # every key is a padded batch and two wave counts, powers of two
    assert all(n & (n - 1) == 0 for key in graph._graphs for n in key)


@pytest.mark.gpu
def test_online_executor_card_matches_cpu():
    """The chipseq loop with faults, fused and legacy, on the card and on
    the CPU: the same assignments and counters, times within 1e-12."""
    _need_card()
    import numpy as np
    from repro_torch.core import target_nodes
    from repro_torch.online import OnlineExecutor, fanout_chain_dag
    from repro_torch.sched.simulator import (ClusterSimulator,
                                             FaultInjector, GridEngine)
    from repro_torch.sched.workflows import WORKFLOWS

    def run(device, fused):
        est, _, size = _tick_estimator(device, bias_empirical_bayes=True)
        by = {t.name: t for t in WORKFLOWS["chipseq"]}
        tasks, task_name = fanout_chain_dag(list(by), 2)
        truth = ClusterSimulator(seed=2000)
        tab = {(tid, nt.name): truth.run_task(by[task_name[tid]], nt, size)
               for tid in tasks for nt in target_nodes()}
        grid = GridEngine.from_types(nodes_per_type=2)
        tr = OnlineExecutor(
            est, tasks, task_name, size, grid,
            lambda tid, node: tab[(tid, grid.type_of(node).name)],
            risk_k=0.5, spec_tail=0.6, rel_k=1.0, max_attempts=6,
            strict=False, faults=FaultInjector(p_fail=0.08, seed=31),
            fused=fused).run()
        return (sorted((r.id, r.node) for r in tr.records),
                (tr.replans, tr.surprises, tr.completed, tr.failures,
                 tr.retries, tr.speculations),
                np.array(sorted((r.id, r.start, r.end, r.pred_mean)
                                for r in tr.records))[:, 1:].astype(float))

    cpu = run("cpu", False)
    for fused in (False, True):
        card = run("cuda", fused)
        assert card[:2] == cpu[:2]
        _est_close(card[2], cpu[2])


# ---------------------------------------------------------------------------
# The multi-workflow fleet (online/fleet.py, launch/mesh.py) and LotaruML
# ---------------------------------------------------------------------------
def _fleet_states(device, t_counts=(5, 13, 8, 13)):
    """Stackable states: the chipseq estimator's first rows, one a
    workflow, with bias decay and empirical-Bayes pooling."""
    from repro_torch.core import build_state
    from repro_torch.core.estimator import LotaruEstimator
    states = []
    for t in t_counts:
        est, nodes, size = _tick_estimator(device, bias_decay=0.9,
                                           bias_empirical_bayes=True)
        sub = LotaruEstimator(est.local_bench, est.target_benches,
                              bias_decay=0.9, bias_empirical_bayes=True,
                              device=device)
        for name in est.task_names()[:t]:
            sub.tasks[name] = est.tasks[name]
        states.append(build_state(sub, nodes)[0])
    return states, size


def _fleet_obs(t_counts, n_nodes, size, seed, batch=16):
    import numpy as np
    rng = np.random.default_rng(seed)
    obs = np.zeros((len(t_counts), batch, 8))
    for w, t in enumerate(t_counts):
        k = int(rng.integers(batch // 2, batch + 1))
        obs[w, :k, 0] = rng.integers(0, t, k)
        obs[w, :k, 1] = rng.integers(0, n_nodes, k)
        obs[w, :k, 2] = size * rng.uniform(0.5, 1.5, k)
        obs[w, :k, 3] = rng.uniform(5.0, 500.0, k)
        obs[w, :k, 5:7] = [60.0, 3.0]
        obs[w, :k, 7] = 1.0
    return obs


@pytest.mark.gpu
def test_fleet_card_matches_cpu_and_per_workflow_ticks():
    """Four workflows, four ticks: the fleet on the card against the
    fleet on the CPU and against per-workflow ``tick_step`` on the card;
    the (1, 1) mesh of the card is bit-exact."""
    _need_card()
    import numpy as np
    from repro_torch.core.tick import tick_step
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.online.fleet import (fleet_predict, fleet_slice,
                                          fleet_tick_step, shard_fleet,
                                          stack_states)
    t_counts = (5, 13, 8, 13)
    card_states, size = _fleet_states("cuda", t_counts)
    loops, _ = _fleet_states("cuda", t_counts)
    cpu_states, _ = _fleet_states("cpu", t_counts)
    card, cpu = stack_states(card_states), stack_states(cpu_states)
    assert card.state.factors.device.type == "cuda"
    sizes = np.array([size, 0.5 * size, size, 2.0 * size])
    mesh = make_fleet_mesh(device="cuda:0")
    assert mesh.shape == {"wf": 1, "task": 1}
    sharded = shard_fleet(card, mesh)
    N = card.state.factors.shape[2]
    for tick in range(4):
        obs = _fleet_obs(t_counts, N, size, tick)
        card, cm, cs = fleet_tick_step(card, obs, sizes)
        cpu, hm, hs = fleet_tick_step(cpu, obs, sizes)
        sharded, sm, ss = fleet_tick_step(sharded, obs, sizes)
        assert torch.equal(sm, cm) and torch.equal(ss, cs)
        _est_close(cm.cpu(), hm)
        _est_close(cs.cpu(), hs)
        for w in range(len(t_counts)):
            loops[w], m, s, _ = tick_step(loops[w], obs[w], sizes[w],
                                          host_deadjust=False)
            _est_close(fleet_slice(cm, card, w), m.cpu())
            _est_close(fleet_slice(cs, card, w), s.cpu())
    for a, b in zip(fleet_predict(card, sizes), fleet_predict(cpu, sizes)):
        _est_close(a.cpu(), b)


def _ml_estimator(device, n_cells=40, n_nodes=8, seed=0):
    """``_toy_ml``-style cells (even cells with a throttled run)."""
    import numpy as np
    from repro_torch.core import LotaruML
    from repro_torch.core.profiler import BenchResult
    rng = np.random.default_rng(seed)
    local = BenchResult("local-cpu", 450.0, 90.0, 18.0, 420.0, 420.0, 0.0)
    benches = {f"n{j}": BenchResult(
        f"n{j}", 200.0, float(rng.uniform(500, 5000)),
        float(rng.uniform(100, 900)), 300.0, 300.0,
        float(rng.uniform(0, 60))) for j in range(n_nodes)}
    est = LotaruML(local, benches, bias_decay=0.9,
                   bias_empirical_bayes=True, device=device)
    for i in range(n_cells):
        slope = float(rng.uniform(1e-4, 1e-3))
        noise = rng.normal(0, 1e-3, 6)
        cell = {"arch": f"a{i}", "shape": "s", "roofline": {
            "step_tokens": 2048 * (i % 8 + 1),
            "compute_s": float(rng.uniform(0.1, 2)),
            "memory_s": float(rng.uniform(0.1, 2)),
            "collective_s": float(rng.uniform(0.0, 1)),
            "flops_per_device": float(rng.uniform(1e12, 5e13)),
            "bytes_per_device": float(rng.uniform(1e10, 1e12)),
            "coll_bytes_per_device": float(rng.uniform(1e8, 1e10))}}
        it = iter(noise)
        est.fit_cell(
            cell, lambda c, f, s=slope, it=it: s * f
            * c["roofline"]["step_tokens"] + 0.5 + next(it),
            run_local_throttled=(lambda c, f, s=slope: s * f * c["roofline"][
                "step_tokens"] * 1.25 + 0.6) if i % 2 == 0 else None)
    return est


def _ml_stream(est, S, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    names, nodes = est.cell_names(), list(est.target_benches) + ["local-cpu"]
    return [(names[int(rng.integers(0, len(names)))],
             nodes[int(rng.integers(0, len(nodes)))],
             float(rng.uniform(2000.0, 16000.0)), float(rng.uniform(1.0, 9.0)))
            for _ in range(S)]


@pytest.mark.gpu
def test_lotaru_ml_card_matches_cpu():
    _need_card()
    card, cpu = _ml_estimator("cuda"), _ml_estimator("cpu")
    nodes = list(card.target_benches) + ["local-cpu"]
    for a, b in zip(card.predict_matrix(nodes), cpu.predict_matrix(nodes)):
        _est_close(a, b)
    for a, b in zip(card.predict_matrix_scalar(nodes),
                    cpu.predict_matrix_scalar(nodes)):
        _est_close(a, b)
    for tick in range(3):
        batch = _ml_stream(card, 300, tick)
        _est_close(card.observe_batch(batch), cpu.observe_batch(batch))
        assert card._dirty_rows == cpu._dirty_rows
        for a, b in zip(card.predict_matrix(nodes),
                        cpu.predict_matrix(nodes)):
            _est_close(a, b)
        _est_close(card.bias.log_sum, cpu.bias.log_sum)
    for n in card.cell_names()[:10]:
        _est_close(card.predict(n, "n3"), cpu.predict(n, "n3"))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [16, 1024])
def test_lotaru_ml_observe_batch_waits_on_the_card_twice(S):
    """``LotaruML.observe_batch`` syncs only in its two copies back
    (``_fetch``), whatever the batch: everything else raises under sync
    debug mode "error"."""
    _need_card()
    est = _ml_estimator("cuda")
    nodes = list(est.target_benches)
    est.predict_matrix(nodes)
    est.observe_batch(_ml_stream(est, 8, 99))        # warm-up
    fetch = est._fetch
    calls = []

    def relaxed(t):
        calls.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return fetch(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    est._fetch = relaxed
    batch = _ml_stream(est, S, 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        est.observe_batch(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert calls == [1, 1]
