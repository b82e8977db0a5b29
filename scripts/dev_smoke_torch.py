"""Dev loop of the PyTorch port: run every smoke config (or the archs
named) through loss, prefill and decode.

    PYTHONPATH=src python scripts/dev_smoke_torch.py [--device cpu] [arch ...]

Runs on the CUDA card unless ``--device cpu`` (it raises without a
card).  On the card the attention head dim is at least 32, the flash
kernel's smallest.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import list_archs, smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

B, T = 2, 24


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", default=list_archs())
    ap.add_argument("--device", default="cuda",
                    help="device of the models (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for arch in args.archs:
        cfg = smoke_config(arch)
        if dev.type == "cuda":
            cfg = cfg.with_(head_dim=max(cfg.resolved_head_dim(), 32))
        model = build_model(cfg)
        params = model.init(0, device=dev)
        n_params = sum(x.numel() for x in leaves(params))
        gen = torch.Generator(device=dev).manual_seed(0)
        tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen,
                               device=dev, dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.family == "vlm":
            nv = 8
            batch["vision_embeds"] = torch.full((B, nv, cfg.d_model), 0.1,
                                                dtype=torch.bfloat16,
                                                device=dev)
            pos = torch.arange(T + nv, dtype=torch.int32, device=dev)
            batch["positions"] = pos[None, :, None].expand(B, T + nv, 3)
        if cfg.family == "encdec":
            batch["src_embeds"] = 0.1 * torch.randn(
                B, 16, cfg.d_model, generator=gen, device=dev)

        with torch.no_grad():
            loss, _ = model.loss(params, batch)
            assert torch.isfinite(loss), (arch, loss)
            caches = model.init_caches(B, max_len=T + 8, cross_len=16,
                                       device=dev)
            logits, caches = model.prefill(params, batch, caches)
            assert bool(torch.isfinite(logits.float()).all()), arch
            dbatch = {"tokens": torch.argmax(logits[:, -1], -1)[:, None]
                      .to(torch.int32)}
            if cfg.family == "vlm":
                dbatch["positions"] = torch.full((B, 1, 3), T + 8,
                                                 dtype=torch.int32,
                                                 device=dev)
            logits2, caches = model.decode(params, dbatch, caches, T)
            assert bool(torch.isfinite(logits2.float()).all()), arch
        print(f"OK {arch:28s} loss={float(loss):.3f} params={n_params:,}")
    print("ALL OK")


if __name__ == "__main__":
    main()
