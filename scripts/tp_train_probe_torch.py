"""One train step of a config at full width on a mesh of two gloo
processes sharing the CUDA card, with the port's sources at ``--src``:
what a rank holds, gathers and moves.

    PYTHONPATH=src python scripts/tp_train_probe_torch.py \\
        [--src DIR] [--arch A] [--layers N] [--mesh 1x2] [--out DIR]

Each rank draws the global parameters from seed 0 and keeps its slice of
``param_specs`` (fp32 weights and AdamW state), takes one step of
``--batch`` x ``--seq`` tokens in one microbatch (bf16 activations, the
config's remat) and writes ``rank<r>.json`` under ``--out``: its step ms
(host clock to a synchronise), peak memory, the parameter bytes it holds,
each collective kind's payload bytes and calls (``sharding.BYTES`` /
``CALLS``), the flash and SSD launches and the loss.  The parent prints
one line a rank and the card's nvidia-smi line.  ``--src`` is the ``src``
directory of a tree of the port (default: this checkout's), so that two
trees (say a commit and its parent, unpacked with ``git archive`` into a
directory ``.gitignore`` lists) are compared in one call on one card:
run it for each, in turns.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", default=os.fspath(ROOT / "src"))
    p.add_argument("--arch", default="stablelm-1.6b")
    p.add_argument("--layers", type=int, default=0,
                   help="layers (0: the config's)")
    p.add_argument("--mesh", default="1x2", help="(data)x(model)")
    p.add_argument("--seq", type=int, default=4096)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--out", default=os.fspath(ROOT / "chiprun_out"
                                              / "tp_train_probe"))
    return p.parse_args(argv)


ARGS = parse_args()
# the port under test first, in this process and in the spawned ranks
# (they import this module, and take this process's sys.path)
sys.path.insert(0, os.path.abspath(ARGS.src))


def worker(rank, device, args, out_dir):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_defs_to_specs
    from repro_torch.optim import AdamWConfig, state_defs
    from repro_torch.optim.adamw import leaves

    shape = tuple(int(x) for x in args.mesh.split("x"))
    mesh = make_mesh(shape, ("data", "model"), device=device)
    rules = make_rules(mesh)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    sdefs = state_defs(model.param_defs, opt)
    psh = sharding.tree_shardings(model.param_specs(rules), mesh)
    ssh = sharding.tree_shardings(tree_defs_to_specs(sdefs, rules), mesh)
    gen = torch.Generator(device=device).manual_seed(0)
    params = sharding.init_local(model.param_defs, gen, device, psh)
    state = sharding.init_local(sdefs, None, device, ssh)
    batch = sharding.local_batch(
        SyntheticLMData(cfg, seq=args.seq, global_batch=args.batch, seed=0,
                        device=device).batch(0), mesh, rules)
    step = make_train_step(model, opt, rules=rules, mesh=mesh)
    held = sum(x.numel() * x.element_size() for x in leaves(params))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    ssd_kernel.LAUNCHES = ssd_kernel.BWD_LAUNCHES = 0
    sharding.reset_counts()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    row = {"src": args.src, "rank": rank, "coords": list(mesh.coords),
           "arch": args.arch, "n_layers": cfg.n_layers, "mesh": args.mesh,
           "step_ms": 1e3 * (time.perf_counter() - t0),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "param_bytes": held, "bytes": dict(sharding.BYTES),
           "calls": dict(sharding.CALLS),
           "launches": {"flash_fwd": kernel.LAUNCHES,
                        "flash_bwd": kernel.BWD_LAUNCHES,
                        "ssd_fwd": ssd_kernel.LAUNCHES,
                        "ssd_bwd": ssd_kernel.BWD_LAUNCHES},
           "loss": loss}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(row))


def main() -> int:
    import shutil
    import torch
    if not torch.cuda.is_available():
        print("tp_train_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import spawn
    # absolute: the rendezvous is a file:// URL
    out = Path(ARGS.out).resolve()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    shape = tuple(int(x) for x in ARGS.mesh.split("x"))
    t0 = time.perf_counter()
    spawn(worker, shape[0] * shape[1], (ARGS, out),
          rendezvous=out / "rendezvous", backend="gloo", device="cuda",
          timeout_s=600)
    print(f"tp_train_probe: {ARGS.arch} ({ARGS.layers or 'all'} layers) on "
          f"{ARGS.mesh}, {ARGS.batch} x {ARGS.seq} tokens, port at "
          f"{ARGS.src}; {smi}; the spawn {time.perf_counter() - t0:.1f} s",
          flush=True)
    for r in range(shape[0] * shape[1]):
        print(json.dumps(json.loads((out / f"rank{r}.json").read_text())),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
