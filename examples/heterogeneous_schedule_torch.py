"""Lotaru -> HEFT, end to end, on the PyTorch port: profile the cluster,
learn task models from downsampled local runs, predict every (task, node)
runtime + uncertainty, and gang-schedule a fan-out physical workflow
across the heterogeneous fleet.  Also schedules the ML workload cells
from the dry-run artifacts if present (the accelerator plane,
``LotaruML``).

    PYTHONPATH=src python examples/heterogeneous_schedule_torch.py
    PYTHONPATH=src python examples/heterogeneous_schedule_torch.py --device cpu

The estimators' posteriors and matrices live on ``--device`` (default
``cuda``; it raises without a card).
"""
import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (LotaruEstimator, LotaruML,  # noqa: E402
                              get_node, profile_cluster, profile_node,
                              target_nodes, young_daly_interval)
from repro_torch.sched.heft import SchedTask, heft_schedule  # noqa: E402
from repro_torch.sched.simulator import (ClusterSimulator,  # noqa: E402
                                         load_dryrun_cells)
from repro_torch.sched.workflows import INPUTS, WORKFLOWS  # noqa: E402

ART = ROOT / "experiments" / "artifacts" / "dryrun"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the estimators (default cuda)")
    args = ap.parse_args(argv)

    sim = ClusterSimulator(seed=0)
    local = get_node("local-cpu")
    local_bench = profile_node(local, np.random.default_rng(7))
    tbenches = profile_cluster(target_nodes(), seed=13)

    # ---- genomics-plane workflow scheduling -------------------------------
    wf = WORKFLOWS["chipseq"]
    by_name = {t.name: t for t in wf}
    size = INPUTS[("chipseq", 1)]
    est = LotaruEstimator(local_bench, tbenches, device=args.device)
    est.fit_tasks(list(by_name), size,
                  lambda n, s, cf: sim.run_task(by_name[n], local, s,
                                                cpu_factor=cf))

    n_samples = 6
    tasks, cost, unc = {}, {}, {}
    chain = [t.name for t in wf]
    nodes = [f"{nt.name}/{i}" for nt in target_nodes() for i in range(2)]
    ntype = {n: n.rsplit("/", 1)[0] for n in nodes}
    for s in range(n_samples):
        prev = None
        for name in chain:
            tid = f"s{s}.{name}"
            tasks[tid] = SchedTask(id=tid)
            if prev:
                tasks[tid].pred.append(prev)
                tasks[prev].succ.append(tid)
            prev = tid
            cost[tid] = {}
            unc[tid] = {}
            for n in nodes:
                m, sd = est.predict(name, ntype[n], size)
                cost[tid][n] = m
                unc[tid][n] = sd

    sched = heft_schedule(tasks, cost, nodes, uncertainty=unc, risk_k=1.0)
    print(f"chipseq-1 x {n_samples} samples over {len(nodes)} nodes: "
          f"predicted makespan {sched['makespan']/60:.1f} min")
    per_node = {}
    for tid, n in sched["assignment"].items():
        per_node[n] = per_node.get(n, 0) + 1
    for n in sorted(per_node):
        print(f"  {n:12s} {per_node[n]:3d} tasks")

    # ---- ML plane: schedule (arch x shape) cells over pod slices ----------
    cells = [c for c in load_dryrun_cells(ART) if c["mesh"] == "pod16x16"
             and c["shape"] == "train_4k"]
    if not cells:
        print("\n(no dry-run artifacts under experiments/artifacts/dryrun: "
              "the ML-plane demo needs them)")
        return
    ml = LotaruML(local_bench, tbenches, device=args.device)
    for c in cells:
        ml.fit_cell(c, lambda cell, f: sim.run_cell(cell, local, f),
                    run_local_throttled=lambda cell, f: sim.run_cell(
                        cell, local, f, cpu_factor=0.8))
    print("\nML cells — predicted step time per pod type (s) "
          "+ Young/Daly checkpoint interval @ MTBF 6h:")
    for c in cells[:6]:
        name = f"{c['arch']}__{c['shape']}"
        preds = {nt.name: ml.predict(name, nt.name)[0]
                 for nt in target_nodes()}
        best = min(preds, key=preds.get)
        mean, std = ml.predict(name, best)
        yd = young_daly_interval(mean, mtbf_s=6 * 3600,
                                 checkpoint_cost_s=30.0)
        print(f"  {name:45s} best={best} {preds[best]:7.3f}s  "
              f"ckpt_every={yd:6.0f}s  straggler_thr={mean+3*std:7.3f}s")


if __name__ == "__main__":
    main()
