"""Fault tolerance end to end on the PyTorch port: train on a mesh of
processes, inject a failure, restart from the checkpoint onto a *smaller*
(elastic) mesh, and check that training continues with the same numbers.

    PYTHONPATH=src python examples/elastic_recovery_torch.py

The twin of examples/elastic_recovery.py, at its learning rate
(``train``'s default: peak 1e-3, 20 warmup steps).  Phase 1 trains on a
(4, 2) ("data", "model") mesh of 8 ``gloo`` processes on the CPU and fails
at step 12; phase 2 resumes from its last checkpoint (step 9) on a (2, 2)
mesh of 4 processes and finishes step 20 (steps 0-19).  Each rank holds
its slices of the parameters and AdamW state; the checkpoint holds whole
arrays, so the smaller mesh reads its own slices from it.  Checked, and
the script exits 1 where a check fails:

* restore: the state the (2, 2) ranks restore, gathered, and the state
  the one-process ``restore`` reads both equal bit for bit the (4, 2)
  mesh's own step-9 state, gathered from a run of steps 0-9 with no
  checkpoint;
* resume: the (2, 2) run's losses equal, at 1e-4 relative (the models'
  fp32 bar, float32 activations), those of one process resumed from the
  same checkpoint.

The gap to one process that trained all 20 steps is printed, not held to
that bar: at this learning rate the trajectory turns a rounding
difference into a loss gap of about 1e-2 by step 19.  A (1, 2) mesh,
whose gradients are the one-process gradients bit for bit and whose only
difference is the order of the global norm's sum, drifts as far as the
(2, 2) and (4, 2) meshes do (scripts/elastic_drift_torch.py prints each
mesh's gap at every step).
"""
import json
import math
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_rules, spawn  # noqa: E402
from repro_torch.launch.train import InjectedFailure, train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_defs_to_specs  # noqa: E402
from repro_torch.optim import AdamWConfig, state_defs  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

STEPS, SEQ, BATCH, EVERY, FAIL, TOL = 20, 32, 8, 5, 12, 1e-4
RESUME = FAIL - FAIL % EVERY           # the step after the last checkpoint
#: ``train``'s default for a run of STEPS steps, named so that a run cut
#: short keeps the same schedule
OPT = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=STEPS)


def config():
    return smoke_config("qwen2-7b").with_(n_layers=4, d_model=64, d_ff=128,
                                          dtype=torch.float32)


def _shardings(mesh):
    model = build_model(config())
    rules = make_rules(mesh)
    return sharding.tree_shardings(
        {"params": model.param_specs(rules),
         "opt": tree_defs_to_specs(state_defs(model.param_defs, OPT),
                                   rules)}, mesh)


def _gathered(state, mesh):
    return [sharding.gather(x, sh).clone()
            for x, sh in zip(leaves(state), leaves(_shardings(mesh)))]


def _run(mesh, ckpt, fail_at, steps=STEPS):
    return train(config(), steps=steps, seq=SEQ, global_batch=BATCH,
                 ckpt_dir=ckpt, ckpt_every=EVERY, mesh=mesh,
                 rules=make_rules(mesh), opt_cfg=OPT, fail_at_step=fail_at,
                 seed=0)


def phase1(rank, device, ckpt, out, state_out):
    """One rank of the (4, 2) mesh: steps 0-9 with no checkpoint (the
    state the checkpoint must hold, gathered), then the run that fails."""
    mesh = make_mesh((4, 2), ("data", "model"), device=device)
    rep = _run(mesh, None, None, steps=RESUME)
    state = _gathered({"params": rep.params, "opt": rep.opt_state}, mesh)
    report = {"mesh": mesh.shape}
    try:
        _run(mesh, ckpt, FAIL)
    except InjectedFailure as e:
        report["failure"] = str(e)
    if rank == 0:
        torch.save(state, state_out)
        Path(out).write_text(json.dumps(report))


def phase2(rank, device, ckpt, out, state_in):
    """One rank of the (2, 2) mesh: its restored slices, gathered, against
    the (4, 2) state, then the resumed run."""
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    restored, _ = restore(ckpt, device=device, shardings=_shardings(mesh))
    got = _gathered(restored, mesh)
    want = torch.load(state_in)
    same = len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    rep = _run(mesh, ckpt, None)
    if rank == 0:
        Path(out).write_text(json.dumps(
            {"mesh": mesh.shape, "restored_bit_for_bit": same,
             "losses": rep.losses, "steps_run": rep.steps_run,
             "final_step": rep.final_step}))


def _gap(xs, ys):
    return max(abs(x - y) / abs(y) for x, y in zip(xs, ys))


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt, kept, state9 = tmp / "ckpt", tmp / "ckpt_9", tmp / "state9.pt"
        print("phase 1: training on mesh {'data': 4, 'model': 2} "
              "(8 gloo processes) ...", flush=True)
        spawn(phase1, 8, (ckpt, tmp / "a.json", state9),
              rendezvous=tmp / "rdv_a", device="cpu", timeout_s=600)
        a = json.loads((tmp / "a.json").read_text())
        print(f"  !! {a['failure']}")
        shutil.copytree(ckpt, kept)    # phase 2 writes checkpoints after it
        print("phase 2: elastic restart on mesh {'data': 2, 'model': 2} "
              "(4 processes; parameters and AdamW state re-sharded from "
              "the checkpoint's whole arrays) ...", flush=True)
        spawn(phase2, 4, (ckpt, tmp / "b.json", state9),
              rendezvous=tmp / "rdv_b", device="cpu", timeout_s=600)
        b = json.loads((tmp / "b.json").read_text())
        whole, manifest = restore(kept, device="cpu")
        want = torch.load(state9)
        one_restore = manifest["step"] == RESUME - 1 and all(
            a.dtype == w.dtype and torch.equal(a, w)
            for a, w in zip(leaves(whole), want))
        resumed = train(config(), steps=STEPS, seq=SEQ, global_batch=BATCH,
                        ckpt_dir=kept, opt_cfg=OPT, seed=0, device="cpu")
    start = STEPS - b["steps_run"]
    print(f"  resumed at step {start}, finished at {b['final_step']}; "
          f"final loss {b['losses'][-1]:.4f}")
    print(f"  the (2, 2) ranks' restored state equals the (4, 2) mesh's "
          f"step-{RESUME - 1} state bit for bit: {b['restored_bit_for_bit']}"
          f"; so does the one-process restore: {one_restore}")
    straight = train(config(), steps=STEPS, seq=SEQ, global_batch=BATCH,
                     opt_cfg=OPT, seed=0, device="cpu")
    gap_resumed = _gap(b["losses"], resumed.losses)
    gap_straight = _gap(b["losses"], straight.losses[start:])
    print(f"  losses of steps {start}-{STEPS - 1}, worst relative gap: "
          f"{gap_resumed:.2e} to one process resumed from the same "
          f"checkpoint (tol {TOL:g}); {gap_straight:.2e} to one "
          "uninterrupted process (the trajectory's drift from the rounding "
          "of steps 0-9, not held to the tolerance: "
          "scripts/elastic_drift_torch.py)")
    ok = (b["final_step"] == STEPS - 1 and start == RESUME
          and resumed.steps_run == b["steps_run"]
          and b["restored_bit_for_bit"] and one_restore
          and math.isfinite(b["losses"][-1]) and gap_resumed <= TOL)
    print("elastic recovery OK" if ok else "elastic recovery FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
