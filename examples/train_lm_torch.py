"""End-to-end training on the PyTorch port: a ~100M-parameter dense LM with
the full stack — synthetic deterministic data, AdamW (cosine schedule),
chunked cross-entropy, full remat, async checkpoints, restart safety.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

The twin of examples/train_lm.py.  On the card (``--device cuda``, the
default; it raises without one) every attention runs through the flash
kernels, forward and backward.  Checkpoints go to
``build/train_lm_torch`` under the repository unless ``--ckpt`` says
otherwise; a second run resumes from the last one.  The loss should fall
well below ln(vocab) ~ 9.0 within a few hundred steps.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_lm_torch"))
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda)")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        arch="demo-100m", family="dense",
        n_layers=14, d_model=640, n_heads=10, n_kv_heads=10, d_ff=2560,
        vocab=8_192, head_dim=64, norm="rmsnorm", act="swiglu",
        attn_chunk=128, xent_chunk=128, remat="full")
    n = cfg.param_count()
    print(f"arch demo-100m: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ {args.seq}x{args.batch} on {args.device}")
    t0 = time.time()
    rep = train(cfg, steps=args.steps, seq=args.seq, global_batch=args.batch,
                ckpt_dir=args.ckpt, ckpt_every=50,
                opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=30,
                                    total_steps=args.steps),
                verbose=True, log_every=10, device=args.device)
    dt = time.time() - t0
    if not rep.steps_run:
        print(f"nothing to do: the checkpoint in {args.ckpt} is at step "
              f"{rep.final_step}")
        return
    print(f"\nfinal loss {rep.losses[-1]:.4f} (start {rep.losses[0]:.4f}) "
          f"in {dt/60:.1f} min; {1e3*dt/rep.steps_run:.0f} ms/step")
    assert rep.losses[-1] < rep.losses[0], "loss did not improve"


if __name__ == "__main__":
    main()
