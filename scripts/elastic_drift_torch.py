"""How far training on a mesh drifts from one process, step by step.

    PYTHONPATH=src python scripts/elastic_drift_torch.py [--lr 1e-3]

Runs the model and schedule of examples/elastic_recovery_torch.py for 20
uninterrupted steps on one process and on (1, 2), (2, 2) and (4, 2)
("data", "model") meshes of ``gloo`` processes on the CPU, and prints each
mesh's relative loss gap to the one-process run at every step.

On the (1, 2) mesh the batch is not split: every gradient is the
one-process gradient bit for bit, and only the global norm's sum runs in
another order (each slice's sum, then an all-reduce), so the clipping
scale may differ in its last bits.  Its gap is what the trajectory makes
of a rounding difference; the (2, 2) and (4, 2) meshes add the dp sums'
rounding to it.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_rules, spawn  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

STEPS, SEQ, BATCH = 20, 32, 8
MESHES = ((1, 2), (2, 2), (4, 2))


def config():
    import torch
    return smoke_config("qwen2-7b").with_(n_layers=4, d_model=64, d_ff=128,
                                          dtype=torch.float32)


def _run(lr, mesh=None, device="cpu"):
    opt = AdamWConfig(lr=lr, warmup_steps=20, total_steps=STEPS)
    return train(config(), steps=STEPS, seq=SEQ, global_batch=BATCH,
                 mesh=mesh, rules=None if mesh is None else make_rules(mesh),
                 opt_cfg=opt, seed=0, device=device).losses


def _rank(rank, device, shape, lr, out):
    losses = _run(lr, make_mesh(shape, ("data", "model"), device=device))
    if rank == 0:
        Path(out).write_text(json.dumps(losses))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args()
    one = _run(args.lr)
    rows = {"1 (again)": _run(args.lr)}
    with tempfile.TemporaryDirectory() as tmp:
        for shape in MESHES:
            out = Path(tmp) / f"{shape[0]}x{shape[1]}.json"
            spawn(_rank, shape[0] * shape[1], (shape, args.lr, out),
                  rendezvous=Path(tmp) / f"rdv_{shape[0]}x{shape[1]}",
                  device="cpu", timeout_s=600)
            rows[str(shape)] = json.loads(out.read_text())
    print(f"peak lr {args.lr:g}: relative loss gap to one process, by step")
    print("step " + "".join(f"{k:>12}" for k in rows))
    for s in range(STEPS):
        print(f"{s:4d} " + "".join(
            f"{abs(v[s] - one[s]) / abs(one[s]):12.2e}"
            for v in rows.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
