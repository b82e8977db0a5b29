"""The port's scheduler side (``repro_torch.sched``,
``repro_torch.data.synthetic``) held to the JAX package's, bit for bit.

HEFT, the simulator and the DAG generator are host-side numpy in both
packages, so the bar is equality: the port's ``heft_schedule`` must
reproduce the five md5 pins of ``tests/test_comm_sched.py`` (the
comm-free scheduler of the paper workflows), ``synthetic_dag`` must give
the same DAG for the same seed, and the simulator the same runtimes.
"""
import hashlib
import json

import numpy as np
import pytest

from repro.core.nodes import target_nodes as j_target_nodes
from repro.data.synthetic import synthetic_dag as j_synthetic_dag
from repro.online import fanout_chain_dag
from repro.sched import heft as JH
from repro.sched.simulator import ClusterSimulator as JSim
from repro.sched.workflows import INPUTS as J_INPUTS
from repro.sched.workflows import WORKFLOWS as J_WORKFLOWS
from repro_torch.core.nodes import get_node, target_nodes
from repro_torch.data.synthetic import SyntheticDAG, synthetic_dag
from repro_torch.sched import (INPUTS, WORKFLOWS, CommCosts, SchedTask,
                               Topology, heft_schedule, heft_schedule_array,
                               heft_schedule_reference, upward_rank_array)
from repro_torch.sched.simulator import ClusterSimulator

#: the pins of tests/test_comm_sched.py (md5 over the sorted-key JSON of
#: assignment, repr(start), repr(finish), repr(makespan), order)
PRE_PR_SIGNATURES = {
    "eager": "8024573fdd6272adef1ffb0ab8a3c28f",
    "methylseq": "667b97a37431ca0874210f4a47ae2b67",
    "chipseq": "f7a350bf693aec0b132f3f4bdcda1fa6",
    "atacseq": "1a2188c0479acdfc1d4a40c051a0a882",
    "bacass": "a226f5af6dd7c3c7d38d2a19279da62d",
}


def _signature(s: dict) -> str:
    blob = json.dumps({
        "assignment": s["assignment"],
        "start": {k: repr(v) for k, v in s["start"].items()},
        "finish": {k: repr(v) for k, v in s["finish"].items()},
        "makespan": repr(s["makespan"]),
        "order": s["order"],
    }, sort_keys=True)
    return hashlib.md5(blob.encode()).hexdigest()


def _chain_dag(chain, n_samples):
    """``repro.online.fanout_chain_dag``'s DAG, carried over as plain data
    into the port's ``SchedTask``s."""
    jtasks, task_name = fanout_chain_dag(chain, n_samples)
    tasks = {tid: SchedTask(id=tid, succ=list(t.succ), pred=list(t.pred))
             for tid, t in jtasks.items()}
    return tasks, task_name


def _pin_schedule(wf: str) -> dict:
    """The scenario of the pins, built from the port: 3 chain instances,
    noise-free simulator runtimes, 2 nodes per type."""
    sim = ClusterSimulator(seed=0)
    size = INPUTS[(wf, 1)]
    by_name = {t.name: t for t in WORKFLOWS[wf]}
    tasks, task_name = _chain_dag(list(by_name), 3)
    nodes = [f"{nt.name}/{i}" for nt in target_nodes() for i in range(2)]
    ntype = {f"{nt.name}/{i}": nt
             for nt in target_nodes() for i in range(2)}
    cost = {tid: {n: sim.expected_task_runtime(by_name[task_name[tid]],
                                               ntype[n], size)
                  for n in nodes} for tid in tasks}
    return heft_schedule(tasks, cost, nodes)


@pytest.mark.parametrize("wf", list(PRE_PR_SIGNATURES))
def test_heft_reproduces_the_md5_pins(wf):
    assert _signature(_pin_schedule(wf)) == PRE_PR_SIGNATURES[wf]


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_synthetic_dag_is_bit_identical(seed):
    kw = dict(width=9, depth=12, fanout=2.5, seed=seed)
    jd, pd = j_synthetic_dag(**kw), synthetic_dag(**kw)
    assert pd.to_dict() == jd.to_dict()
    assert pd.succ == jd.succ and pd.pred == jd.pred
    assert pd.data_gb == jd.data_gb
    np.testing.assert_array_equal(pd.work, jd.work)
    back = SyntheticDAG.from_dict(jd.to_dict())
    assert back.to_dict() == jd.to_dict()


def test_array_heft_on_a_synthetic_dag_matches_jax():
    dag = synthetic_dag(width=30, depth=20, fanout=2.0, seed=3)
    speeds = np.random.default_rng(0).uniform(0.5, 3.0, 12)
    cost = dag.cost_matrix(speeds)
    unc = 0.1 * cost
    spg = np.random.default_rng(1).uniform(0.0, 0.2, (12, 12))
    np.fill_diagonal(spg, 0.0)
    comm = CommCosts(dag.pred, dag.edge_dict(), spg)
    j_comm = JH.CommCosts(dag.pred, dag.edge_dict(), spg)
    for kw, jkw in (({}, {}), ({"uncertainty": unc, "risk_k": 1.0},
                               {"uncertainty": unc, "risk_k": 1.0}),
                    ({"comm": comm}, {"comm": j_comm})):
        p = heft_schedule_array(dag.succ, dag.pred, cost, **kw)
        j = JH.heft_schedule_array(dag.succ, dag.pred, cost, **jkw)
        for k in ("assignment", "start", "finish", "order"):
            np.testing.assert_array_equal(p[k], j[k])
        assert p["makespan"] == j["makespan"]
    np.testing.assert_array_equal(
        upward_rank_array(dag.succ, dag.pred, cost.mean(axis=1)),
        JH.upward_rank_array(dag.succ, dag.pred, cost.mean(axis=1)))


@pytest.mark.parametrize("wf", ["eager", "bacass"])
def test_dict_heft_with_comm_matches_the_reference(wf):
    sim = ClusterSimulator(seed=7)
    size = INPUTS[(wf, 1)]
    by_name = {t.name: t for t in WORKFLOWS[wf]}
    tasks, task_name = _chain_dag(list(by_name), 3)
    nodes = [f"{nt.name}/{i}" for nt in target_nodes() for i in range(2)]
    ntype = {f"{nt.name}/{i}": nt for nt in target_nodes() for i in range(2)}
    cost = {tid: {n: sim.expected_task_runtime(by_name[task_name[tid]],
                                               ntype[n], size)
                  for n in nodes} for tid in tasks}
    topo = Topology.blocks(nodes, 2, intra_gbps=10.0, cross_gbps=0.1)
    edge_gb = {(p, t): 2.0 for t in tasks for p in tasks[t].pred}
    fast = heft_schedule(tasks, cost, nodes, edge_gb=edge_gb,
                         secs_per_gb=topo.secs_per_gb(nodes))
    ref = heft_schedule_reference(tasks, cost, nodes, edge_gb=edge_gb,
                                  secs_per_gb=topo.secs_per_gb(nodes))
    assert fast["assignment"] == ref["assignment"]
    assert fast["makespan"] == ref["makespan"]


def test_simulator_runs_match_jax():
    jsim, psim = JSim(seed=11), ClusterSimulator(seed=11)
    local = get_node("local-cpu")
    pairs = [(wf, t, nt) for wf in WORKFLOWS
             for t in WORKFLOWS[wf][:4] for nt in [local] + target_nodes()]
    for wf, t, nt in pairs:
        jt = {x.name: x for x in J_WORKFLOWS[wf]}[t.name]
        size = INPUTS[(wf, 1)]
        for cf in (1.0, 0.8):
            assert psim.run_task(t, nt, size, cpu_factor=cf) == \
                jsim.run_task(jt, nt, size, cpu_factor=cf)
        assert psim.expected_task_runtime(t, nt, size) == \
            jsim.expected_task_runtime(jt, nt, size)
        assert psim.actual_factor(t, local, nt, size) == \
            jsim.actual_factor(jt, local, nt, size)


def test_workflow_tables_match_jax():
    assert INPUTS == J_INPUTS
    assert {w: [vars(t) for t in ts] for w, ts in WORKFLOWS.items()} == \
        {w: [vars(t) for t in ts] for w, ts in J_WORKFLOWS.items()}
    assert [n.name for n in target_nodes()] == \
        [n.name for n in j_target_nodes()]
