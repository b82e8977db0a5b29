"""The port's serving loop on the CPU, mirroring tests/test_serve.py, and
held to the JAX ServeLoop's greedy tokens for the same weights."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeLoop


def test_serve_loop_generates():
    cfg = smoke_config("stablelm-1.6b")
    loop = ServeLoop(cfg, max_batch=2, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 6), max_new=4)
            for i in range(2)]
    done = loop.run_batch(reqs)
    for r in done:
        assert len(r.out) == 4
        assert all(0 <= t < cfg.vocab for t in r.out)
    assert loop.prefills == 1 and len(loop.step_times) == 4


def test_serve_straggler_envelope_counts():
    cfg = smoke_config("stablelm-1.6b")
    # impossible envelope: every step counts as a straggler breach
    loop = ServeLoop(cfg, max_batch=1, envelope=(0.0, 1e-9), straggler_k=1.0,
                     device="cpu")
    rng = np.random.default_rng(1)
    loop.run_batch([Request(rid=0, prompt=rng.integers(0, cfg.vocab, 4),
                            max_new=5)])
    assert loop.straggler_steps >= 3


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b"])
def test_greedy_tokens_match_jax_serve_loop(arch):
    """Same carried-across weights, float32 activations, ragged prompts
    (left-padded with token 0, which the SSM runs into its state as the
    JAX loop does): the greedy tokens of both loops are equal."""
    jcfg = jax_smoke_config(arch).with_(dtype=jnp.float32)
    cfg = smoke_config(arch).with_(dtype=torch.float32)
    jloop = JaxServeLoop(jcfg, max_batch=3)
    loop = ServeLoop(cfg, max_batch=3, device="cpu")
    loop.params = params_from_jax(jax.tree.map(np.asarray, jloop.params), cfg,
                                  device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 3)]
    jdone = jloop.run_batch([JaxRequest(rid=i, prompt=p, max_new=6)
                             for i, p in enumerate(prompts)])
    done = loop.run_batch([Request(rid=i, prompt=p, max_new=6)
                           for i, p in enumerate(prompts)])
    for a, b in zip(done, jdone):
        assert a.out == b.out, (a.rid, a.out, b.out)


def test_main_serves_on_cpu(capsys):
    summary = serve.main(["--smoke", "--device", "cpu", "--requests", "5",
                          "--max-new", "2"])
    assert summary["requests"] == 5 and summary["tokens"] == 10
    assert summary["prefills"] == 2 and summary["decode_steps"] == 4
    assert "served 5 requests, 10 tokens" in capsys.readouterr().out
    # the batches main forms are those make_requests and batched give
    # (chip_smoke.py checks the kernel at their shapes before serving)
    queue = serve.make_requests(summary["loop"].cfg.vocab, 5, 2)
    assert summary["loop"].batch_shapes == [
        (len(b), max(len(r.prompt) for r in b), 2)
        for b in serve.batched(queue)]
    assert [len(b) for b in serve.batched(queue)] == [4, 1]


def test_no_card_raises_instead_of_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    cfg = smoke_config("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServeLoop(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--arch", "mamba2-1.3b", "--smoke"])


@pytest.mark.parametrize("max_len", [None, 64])
def test_serve_loop_takes_max_len_like_the_jax_package(max_len):
    """``max_len`` is stored, as ``repro.launch.serve.ServeLoop`` stores
    it (default 128); the caches stay sized from each batch."""
    cfg = smoke_config("stablelm-1.6b")
    kw = {} if max_len is None else {"max_len": max_len}
    loop = ServeLoop(cfg, max_batch=1, device="cpu", **kw)
    jloop = JaxServeLoop(jax_smoke_config("stablelm-1.6b"), max_batch=1,
                         **kw)
    assert loop.max_len == jloop.max_len == (128 if max_len is None
                                             else max_len)
    rng = np.random.default_rng(2)
    done = loop.run_batch([Request(rid=0, prompt=rng.integers(0, cfg.vocab,
                                                              5),
                                   max_new=3)])
    assert len(done[0].out) == 3 and loop.batch_shapes == [(1, 5, 3)]
