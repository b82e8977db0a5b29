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
from repro_torch.kernels.flash_attention import attention_ref, kernel, mha
from repro_torch.launch.serve import Request, ServeLoop

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
