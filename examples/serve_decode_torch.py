"""Serving example on the PyTorch port: prefill a prompt batch, then step
the decode loop with a KV cache; on the card the hand-written flash
kernel is held to the plain version (``attention_ref``) on the first
step, at tests/test_kernels.py's bars (2e-5 float32, 2e-2 bf16).

    PYTHONPATH=src python examples/serve_decode_torch.py
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

Runs on the CUDA card unless ``--device cpu`` (it raises without a
card); on the CPU attention takes the plain version and there is no
kernel to check.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.launch.shapes import concrete_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
B, T_PROMPT, T_GEN = 4, 24, 16


def kernel_error(dtype, device="cuda") -> float:
    """Max |flash kernel - attention_ref| on a causal GQA case (B 2, 4
    query heads over 2 kv heads, 64 positions, head dim 32) in
    ``dtype``, both sides on the same inputs."""
    g = torch.Generator(device=device).manual_seed(1)
    q = torch.randn(2, 4, 64, 32, generator=g, device=device).to(dtype)
    k = torch.randn(2, 2, 64, 32, generator=g, device=device).to(dtype)
    v = torch.randn(2, 2, 64, 32, generator=g, device=device).to(dtype)
    out = flash_attention(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    return float((out.float() - ref.float()).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the model (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # head dim 32: the flash kernel's smallest
    cfg = smoke_config("stablelm-1.6b").with_(n_layers=4, d_model=128,
                                              d_ff=256, head_dim=32)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    batch = concrete_batch(cfg, "prefill", B, T_PROMPT, device=dev)
    caches = model.init_caches(B, max_len=T_PROMPT + T_GEN, device=dev)

    with torch.inference_mode():
        logits, caches = model.prefill(params, batch, caches)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out_tokens = [tok]
        for step in range(T_GEN - 1):
            logits, caches = model.decode(params, {"tokens": tok}, caches,
                                          T_PROMPT + step)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            out_tokens.append(tok)
            if step == 0 and dev.type == "cuda":
                for dtype, tol in TOL.items():
                    err = kernel_error(dtype)
                    print(f"flash kernel vs attention_ref ({dtype}): max "
                          f"err {err:.2e} (bar {tol:g})")
                    if not err <= tol:
                        raise SystemExit(f"flash kernel off the plain "
                                         f"version by {err:.2e} in {dtype}")

    gen = torch.cat(out_tokens, dim=1)
    print(f"prompt batch {B} x {T_PROMPT} tokens -> generated {gen.shape[1]} "
          f"tokens per sequence")
    print("sample generations:", gen[:2].cpu().tolist())
    print("serve_decode OK")


if __name__ == "__main__":
    main()
