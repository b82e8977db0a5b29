"""Batched serving loop: prefill/decode over a request queue.

Counterpart of ``repro.launch.serve``: requests arrive with prompts, are
batched up to ``max_batch``, left-padded with token 0 (pad tokens are
attended, or run into the SSM state, as in the JAX package), run through
``prefill_step`` and stepped with ``decode_step`` against caches sized for
the batch (KV caches, or conv-window and SSM-state caches).  Per-step wall
time, which ends in ``torch.cuda.synchronize()`` on the card, is checked
against a predictive envelope (mean + k*sigma) when one is given; a breach
counts a straggler step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model

MAX_BATCH = 4


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int = 16
    out: list = field(default_factory=list)


class ServeLoop:
    def __init__(self, cfg, *, max_batch: int = MAX_BATCH,
                 max_len: int = 128, envelope=None,
                 straggler_k: float = 3.0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.params = self.model.init(0, device=self.device)
        self.max_batch = max_batch
        # stored as the JAX package stores it; caches are sized from each
        # batch (prompt + new tokens), as there
        self.max_len = max_len
        self.prefill = make_prefill_step(self.model)
        self.decode = make_decode_step(self.model)
        self.envelope = envelope            # (mean_s, sigma_s) or None
        self.straggler_k = straggler_k
        self.straggler_steps = 0
        self.prefills = 0
        self.step_times: list[float] = []
        self.batch_shapes: list[tuple[int, int, int]] = []   # (B, T, steps)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def run_batch(self, requests: list[Request]) -> list[Request]:
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests exceed max_batch="
                             f"{self.max_batch}")
        B = len(requests)
        T = max(len(r.prompt) for r in requests)
        toks = np.zeros((B, T), np.int64)
        for i, r in enumerate(requests):
            toks[i, T - len(r.prompt):] = r.prompt      # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        n_steps = max(r.max_new for r in requests)
        self.batch_shapes.append((B, T, n_steps))
        caches = self.model.init_caches(B, max_len=T + n_steps,
                                        device=self.device)
        logits, caches = self.prefill(self.params, batch, caches)
        self.prefills += 1
        tok = torch.argmax(logits[:, -1], dim=-1)
        for step in range(n_steps):
            t0 = time.perf_counter()
            tok, logits, caches = self.decode(
                self.params, {"tokens": tok[:, None]}, caches, T + step)
            self._sync()
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if self.envelope is not None and step > 0:
                mean, sigma = self.envelope
                if dt > mean + self.straggler_k * sigma:
                    self.straggler_steps += 1
            host = tok.tolist()
            for i, r in enumerate(requests):
                if step < r.max_new:
                    r.out.append(host[i])
        return requests


def make_requests(vocab: int, n: int, max_new: int):
    """``n`` requests with random prompts of 4-16 tokens (numpy seed 0), as
    ``main`` serves them."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, rng.integers(4, 17)),
                    max_new=max_new)
            for i in range(n)]


def batched(queue: list[Request], max_batch: int = MAX_BATCH):
    """The batches ``main`` forms from ``queue``, in order."""
    return [queue[i:i + max_batch] for i in range(0, len(queue), max_batch)]


def main(argv=None) -> dict:
    """Serve ``--requests`` random prompts of 4-16 tokens; returns a summary
    (``requests``, ``tokens``, ``seconds``, ``median_step_ms``,
    ``prefills``, ``decode_steps``, the finished requests ``done`` and the
    ``loop``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    loop = ServeLoop(cfg, device=args.device)
    queue = make_requests(cfg.vocab, args.requests, args.max_new)
    t0 = time.time()
    done = []
    for batch in batched(queue, loop.max_batch):
        done.extend(loop.run_batch(batch))
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    med_ms = 1e3 * float(np.median(loop.step_times))
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s); median decode step {med_ms:.1f} ms")
    return {"requests": len(done), "tokens": toks, "seconds": dt,
            "median_step_ms": med_ms, "prefills": loop.prefills,
            "decode_steps": len(loop.step_times), "done": done, "loop": loop}


if __name__ == "__main__":
    main()
