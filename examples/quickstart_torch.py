"""Quickstart on the PyTorch port: Lotaru's four phases in ~50 lines.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The local microbenchmarks' matmul and memory probes and the estimator's
posteriors run on ``--device`` (default ``cuda``; it raises without a
card).
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (LotaruEstimator, get_node,  # noqa: E402
                              profile_cluster, profile_local, profile_node,
                              target_nodes)
from repro_torch.sched.simulator import ClusterSimulator  # noqa: E402
from repro_torch.sched.workflows import INPUTS, WORKFLOWS  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the probes and the estimator "
                         "(default cuda)")
    args = ap.parse_args(argv)

    # ---- phase 1: infrastructure profiling --------------------------------
    print("phase 1: profiling this machine (real microbenchmarks) ...")
    local_bench = profile_local(fast=True, device=args.device)
    print(f"  local: {local_bench.cpu_events_s:.0f} cpu ev/s, "
          f"{local_bench.matmul_gflops:.1f} GFLOP/s, "
          f"{local_bench.mem_gbps:.1f} GB/s mem, "
          f"{local_bench.io_read_mbps:.0f} MB/s io")
    target_benches = profile_cluster(target_nodes(), seed=13)
    for b in target_benches.values():
        print(f"  {b.node}: {b.matmul_gflops/1e3:.0f} TFLOP/s, "
              f"{b.mem_gbps:.0f} GB/s HBM, {b.link_gbps:.0f} GB/s link")

    # ---- phases 2+3: downsampled local runs + Bayesian regression ---------
    sim = ClusterSimulator(seed=0)
    local = get_node("local-cpu")
    wf = WORKFLOWS["eager"]
    by_name = {t.name: t for t in wf}
    size = INPUTS[("eager", 1)]
    est = LotaruEstimator(profile_node(local, np.random.default_rng(7)),
                          target_benches, device=args.device)
    print(f"\nphases 2+3: downsampling eager-1 input ({size} GB) and "
          f"running locally (normal + 20% CPU-throttled) ...")
    est.fit_tasks([t.name for t in wf], size,
                  lambda name, s, cf: sim.run_task(by_name[name], local, s,
                                                   cpu_factor=cf))

    # ---- phase 4: adjusted predictions for every (task, node) pair --------
    print("\nphase 4: (task x node) predictions with Bayesian uncertainty:")
    print(f"{'task':18s} {'node':9s} {'pred':>9s} {'±σ':>8s} {'w':>5s}")
    for name in ("bwa", "fastqc", "markduplicates", "bcftools_stats"):
        for node in target_nodes()[:3]:
            mean, std = est.predict(name, node.name, size)
            print(f"{name:18s} {node.name:9s} {mean:8.1f}s {std:7.1f}s "
                  f"{est.tasks[name].w:5.2f}")
    print("\ndone — these estimates feed the HEFT scheduler "
          "(examples/heterogeneous_schedule_torch.py)")


if __name__ == "__main__":
    main()
