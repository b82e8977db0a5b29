"""Evaluation protocol for the Lotaru reproduction (paper §5).

For each (workflow, dataset): downsample the input geometrically, run every
task locally (normal + CPU-throttled) in the simulator, fit Lotaru and the
three baselines on exactly the same local observations, then score
predictions of the *full-size* task runtimes:

  * homogeneous  (§5.2): target = the local machine type;
  * model adjustment (§5.3): estimated vs actual factor per task/node;
  * heterogeneous (§5.4): all five target node types.

err_t = |predicted - actual| / actual  (paper eq. 7); MPE = median err.

Lotaru's estimates come from the port's estimator on ``device`` (``None``:
the CUDA card).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import (BASELINES, LotaruEstimator, get_node,
                              profile_cluster, profile_node, target_nodes)
from .simulator import ClusterSimulator
from .workflows import INPUTS, WORKFLOWS


@dataclass
class EvalResult:
    errors: dict          # approach -> workflow -> node -> [per-task err]

    def mpe(self, approach: str, workflow: str | None = None,
            node: str | None = None) -> float:
        errs = []
        for wf, nodes in self.errors[approach].items():
            if workflow and wf != workflow:
                continue
            for nd, es in nodes.items():
                if node and nd != node:
                    continue
                errs.extend(es)
        return float(np.median(errs)) if errs else float("nan")

    def all_errors(self, approach: str, workflow: str | None = None,
                   node: str | None = None) -> np.ndarray:
        errs = []
        for wf, nodes in self.errors[approach].items():
            if workflow and wf != workflow:
                continue
            for nd, es in nodes.items():
                if node and nd != node:
                    continue
                errs.extend(es)
        return np.asarray(errs)


APPROACHES = ("lotaru", "naive", "online_m", "online_p")


def run_evaluation(seed: int = 0, n_partitions: int = 10,
                   heterogeneous: bool = True,
                   workflows: dict | None = None,
                   inputs: dict | None = None, *, device=None,
                   dtype=None) -> EvalResult:
    workflows = workflows or WORKFLOWS
    inputs = inputs or INPUTS
    sim = ClusterSimulator(seed=seed)
    truth_sim = ClusterSimulator(seed=seed + 1000)   # independent noise
    local = get_node("local-cpu")
    local_bench = profile_node(local, np.random.default_rng(seed + 7))
    targets = target_nodes() if heterogeneous else [local]
    tbenches = profile_cluster(target_nodes(), seed=seed + 13)

    errors: dict = {a: {} for a in APPROACHES}
    for (wf_name, ds), size in inputs.items():
        wf_key = f"{wf_name}-{ds}"
        tasks = workflows[wf_name]
        by_name = {t.name: t for t in tasks}

        est = LotaruEstimator(local_bench, tbenches, device=device,
                              dtype=dtype)
        est.fit_tasks([t.name for t in tasks], size,
                      lambda name, s, cf: sim.run_task(by_name[name], local,
                                                       s, cpu_factor=cf),
                      n_partitions=n_partitions)

        # baselines see the identical local observations
        fitted_baselines = {}
        for bname, cls in BASELINES.items():
            fitted_baselines[bname] = {}
            for t in tasks:
                ft = est.tasks[t.name]
                fitted_baselines[bname][t.name] = cls().fit(ft.sizes,
                                                            ft.runtimes)

        for a in APPROACHES:
            errors[a].setdefault(wf_key, {})
        # one batched call for the full (task x node) Lotaru estimate matrix
        # (local node gets factor 1, matching predict_local)
        node_names = [n.name for n in targets]
        task_idx = {name: i for i, name in enumerate(est.task_names())}
        mean_mat, _ = est.predict_matrix(node_names, size)
        for nj, node in enumerate(targets):
            actual = {t.name: truth_sim.run_task(t, node, size)
                      for t in tasks}
            for a in APPROACHES:
                errs = []
                for t in tasks:
                    if a == "lotaru":
                        pred = mean_mat[task_idx[t.name], nj]
                    else:
                        pred = float(np.asarray(
                            fitted_baselines[a][t.name].predict(size)).reshape(-1)[0])
                    errs.append(abs(pred - actual[t.name]) / actual[t.name])
                errors[a][wf_key][node.name] = errs
    return EvalResult(errors=errors)


def factor_table(seed: int = 0, workflow: str = "eager", ds: int = 1, *,
                 device=None):
    """Paper Tables 4+5: estimated vs actual adjustment factors."""
    sim = ClusterSimulator(seed=seed)
    local = get_node("local-cpu")
    local_bench = profile_node(local, np.random.default_rng(seed + 7))
    tbenches = profile_cluster(target_nodes(), seed=seed + 13)
    tasks = WORKFLOWS[workflow]
    by_name = {t.name: t for t in tasks}
    size = INPUTS[(workflow, ds)]

    est = LotaruEstimator(local_bench, tbenches, device=device)
    est.fit_tasks([t.name for t in tasks], size,
                  lambda name, s, cf: sim.run_task(by_name[name], local, s,
                                                   cpu_factor=cf))
    rows = []
    for t in tasks:
        row = {"task": t.name, "w": est.tasks[t.name].w}
        for node in target_nodes():
            est_f = est.factor(t.name, node.name)
            act_f = sim.actual_factor(t, local, node, size)
            row[node.name] = {"estimated": est_f, "actual": act_f,
                              "diff": abs(est_f - act_f)}
        rows.append(row)
    return rows
