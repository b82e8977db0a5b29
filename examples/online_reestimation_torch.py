"""Online re-estimation quickstart on the PyTorch port: fit locally,
execute, watch the median prediction error drop as observations stream in
— and the per-(task, node) bias layer squeeze out the systematic residual
the factor cannot see.

    PYTHONPATH=src python examples/online_reestimation_torch.py
    PYTHONPATH=src python examples/online_reestimation_torch.py --device cpu

The estimator's posteriors and matrices live on ``--device`` (default
``cuda``; it raises without a card).

The flow is the full closed loop of the online subsystem:

  1. fit Lotaru from downsampled local runs (the paper's phases 1-3);
  2. HEFT-plan a fan-out eager workflow over the heterogeneous cluster;
  3. execute on grid-engine-style nodes; every simulation tick's finished
     tasks are fed back in ONE ``LotaruEstimator.observe_batch`` scan
     (incremental conjugate update, O(d²) per row — no refit);
  4. each residual updates a conjugate per-(task, node) multiplicative
     bias posterior: predictions are scaled by its point estimate and
     their intervals widened by its remaining uncertainty;
  5. when a runtime falls outside its predictive interval, the
     not-yet-started frontier is re-planned with the refreshed estimates —
     and a still-running task on a node whose bias has drifted high gets
     a speculative copy on the best idle node (first finish wins).

Two baselines run the same scenario: the static plan with frozen
predictions, and the PR-2 online loop with the bias layer disabled
(``bias_correction=False``).  A fourth, risk-aware arm closes the loop
the paper only gestures at: empirical-Bayes pooling of the bias noise
scale, HEFT placement on the effective cost mean + risk_k * widened
sigma, and speculative admission from the bias posterior's tail mass.
"""
import numpy as np

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (LotaruEstimator, get_node,  # noqa: E402
                              profile_cluster, profile_node, target_nodes)
from repro_torch.online import OnlineExecutor, fanout_chain_dag  # noqa: E402
from repro_torch.sched.simulator import (ClusterSimulator,  # noqa: E402
                                         GridEngine)
from repro_torch.sched.workflows import INPUTS, WORKFLOWS  # noqa: E402

WORKFLOW = "eager"
N_SAMPLES = 8          # physical inputs fanned through the abstract chain


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the estimator (default cuda)")
    ap.add_argument("--workflow", default=WORKFLOW, choices=list(WORKFLOWS))
    ap.add_argument("--samples", type=int, default=N_SAMPLES)
    ap.add_argument("--nodes-per-type", type=int, default=2)
    args = ap.parse_args(argv)
    wf, n_samples = args.workflow, args.samples
    local = get_node("local-cpu")
    local_bench = profile_node(local, np.random.default_rng(7))
    tbenches = profile_cluster(target_nodes(), seed=13)
    size = INPUTS[(wf, 1)]
    by_name = {t.name: t for t in WORKFLOWS[wf]}
    tasks, task_name = fanout_chain_dag(list(by_name), n_samples)

    # ground truth: an independent simulator seed, so realised runtimes
    # carry noise + systematic per-(task, node) efficiency the initial
    # factor adjustment cannot see — exactly what the bias layer learns
    truth = ClusterSimulator(seed=2000)
    truth_tab = {(tid, nt.name): truth.run_task(by_name[task_name[tid]],
                                                nt, size)
                 for tid in tasks for nt in target_nodes()}

    estimators = {}

    def make_executor(online, bias_correction=True, risk=False):
        sim = ClusterSimulator(seed=0)
        est = LotaruEstimator(local_bench, tbenches,
                              bias_correction=bias_correction,
                              bias_empirical_bayes=risk, device=args.device)
        est.fit_tasks(list(by_name), size,
                      lambda n, s, cf: sim.run_task(by_name[n], local, s,
                                                    cpu_factor=cf))
        grid = GridEngine.from_types(nodes_per_type=args.nodes_per_type)
        estimators[(online, bias_correction, risk)] = est
        return OnlineExecutor(
            est, tasks, task_name, size, grid,
            lambda tid, node: truth_tab[(tid, grid.type_of(node).name)],
            online=online, confidence=0.9, speculate=True,
            risk_k=1.0 if risk else 0.0, spec_tail=0.8 if risk else None)

    static = make_executor(online=False).run()
    pr2 = make_executor(online=True, bias_correction=False).run()
    online = make_executor(online=True).run()
    risk = make_executor(online=True, risk=True).run()

    print(f"{wf} x {n_samples} samples "
          f"({len(tasks)} task instances) on the heterogeneous cluster\n")
    print(f"{'':14s} {'makespan':>10s} {'final MPE':>10s} "
          f"{'replans':>8s} {'surprises':>10s} {'spec/won':>9s}")
    for label, tr in (("static", static), ("online (PR2)", pr2),
                      ("online+bias", online), ("bias+risk", risk)):
        print(f"{label:14s} {tr.makespan:10.0f} {tr.final_mpe():10.3f} "
              f"{tr.replans:8d} {tr.surprises:10d} "
              f"{tr.speculations:4d}/{tr.spec_wins:d}")

    print("\ncumulative MPE trajectory (every 10th completion):")
    ts, to = static.cumulative_mpe(), online.cumulative_mpe()
    print("  completion:", "".join(f"{k:8d}" for k in
                                   range(0, len(ts), 10)))
    print("  static    :", "".join(f"{v:8.3f}" for v in ts[::10]))
    print("  online    :", "".join(f"{v:8.3f}" for v in to[::10]))

    est = estimators[(True, True, False)]
    bias = est._ensure_bias()
    obs_pairs = int((bias.counts > 0).sum())
    b = bias.matrix()
    print(f"\nlearned per-(task, node) bias: {obs_pairs} pairs observed, "
          f"range [{b[bias.counts > 0].min(initial=1.0):.2f}, "
          f"{b[bias.counts > 0].max(initial=1.0):.2f}] "
          f"(unobserved pairs stay at exactly 1.0)")
    # the same-tick batches the executor actually absorbed
    ticks = online.observations.by_tick()
    batched = sum(1 for _, g in ticks if len(g) > 1)
    print(f"observation stream: {len(online.observations)} completions in "
          f"{len(ticks)} ticks ({batched} multi-completion ticks fed "
          "observe_batch as one scan)")

    gain = (static.final_mpe() - online.final_mpe()) / static.final_mpe()
    gain2 = (pr2.final_mpe() - online.final_mpe()) / pr2.final_mpe()
    print(f"\nonline estimation cut the median prediction error by "
          f"{100 * gain:.0f}% vs the static plan "
          f"({100 * gain2:.0f}% of it from the bias layer).")

    bias_risk = estimators[(True, True, True)]._ensure_bias()
    print(f"risk-aware arm: makespan {risk.makespan:.0f} vs "
          f"{online.makespan:.0f} (bias), EB-pooled sigma_r = "
          f"{bias_risk.effective_sigma_r():.3f} "
          f"(configured {bias_risk.sigma_r}), "
          f"{risk.speculations} tail-mass speculations")


if __name__ == "__main__":
    main()
