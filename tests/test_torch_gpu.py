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
