"""The port's online executor (``repro_torch.online``) held to the JAX
package's on the CPU.

Both packages run the same scenario — the reference tests' sizes
(``tests/test_tick_engine.py``: 2 samples, 2 nodes per type, risk_k 0.5,
spec_tail 0.6) from simulators with the same seeds — and the traces must
agree: the same task -> node assignments and counters, and start/end
times and dispatch-time predictions to <= 1e-12.  The port's own
properties mirror the reference's tests: fused equals legacy, the
incremental re-plan alone is bitwise, traces round-trip, and tracing is
read-only.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import LotaruEstimator as JEstimator
from repro.core import get_node, profile_cluster, profile_node, target_nodes
from repro.online import OnlineExecutor as JExecutor
from repro.online import fanout_chain_dag as j_fanout_chain_dag
from repro.sched.simulator import ClusterSimulator as JSim
from repro.sched.simulator import FaultInjector as JFaults
from repro.sched.simulator import GridEngine as JGrid
from repro.sched.workflows import INPUTS, WORKFLOWS
from repro_torch.core import LotaruEstimator as PEstimator
from repro_torch.core.profiler import BenchResult as PBench
from repro_torch.obs import EventLog
from repro_torch.online import (ExecutionTrace, ObservationBuffer,
                                OnlineExecutor, fanout_chain_dag,
                                run_static_and_online)
from repro_torch.sched.simulator import ClusterSimulator as PSim
from repro_torch.sched.simulator import FaultInjector as PFaults
from repro_torch.sched.simulator import GridEngine as PGrid
from repro_torch.sched.workflows import WORKFLOWS as P_WORKFLOWS

TOL = 1e-12
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_x64", prev)
    jax.clear_caches()


@pytest.fixture(scope="module")
def cluster():
    local = get_node("local-cpu")
    local_bench = profile_node(local, np.random.default_rng(7))
    tbenches = profile_cluster(target_nodes(), seed=13)
    return local, local_bench, tbenches


def _run(cluster, wf, *, port, fused, with_faults, n_samples=2,
         nodes_per_type=2, seed=0, tracer=None, incremental_replan=None):
    """``tests/test_tick_engine.py::_run_workflow`` in either package."""
    local, local_bench, tbenches = cluster
    size = INPUTS[(wf, 1)]
    wfs = P_WORKFLOWS if port else WORKFLOWS
    Sim, Faults, Grid = ((PSim, PFaults, PGrid) if port
                         else (JSim, JFaults, JGrid))
    by_name = {t.name: t for t in wfs[wf]}
    tasks, task_name = (fanout_chain_dag if port else j_fanout_chain_dag)(
        list(by_name), n_samples)
    truth = Sim(seed=seed + 2000)
    truth_tab = {(tid, nt.name): truth.run_task(by_name[task_name[tid]],
                                                nt, size)
                 for tid in tasks for nt in target_nodes()}
    sim = Sim(seed=seed)
    if port:
        est = PEstimator(PBench(**local_bench.to_dict()),
                         {k: PBench(**v.to_dict())
                          for k, v in tbenches.items()},
                         bias_correction=True, bias_empirical_bayes=True,
                         device="cpu")
    else:
        est = JEstimator(local_bench, tbenches, bias_correction=True,
                         bias_empirical_bayes=True)
    est.fit_tasks(list(by_name), size,
                  lambda n, s, cf: sim.run_task(by_name[n], local, s,
                                                cpu_factor=cf))
    grid = Grid.from_types(nodes_per_type=nodes_per_type)
    faults = Faults(p_fail=0.08, seed=seed + 31) if with_faults else None
    if incremental_replan is None:
        incremental_replan = fused if fused else False
    ex = (OnlineExecutor if port else JExecutor)(
        est, tasks, task_name, size, grid,
        lambda tid, node: truth_tab[(tid, grid.type_of(node).name)],
        online=True, confidence=0.9, risk_k=0.5, spec_tail=0.6,
        faults=faults, rel_k=1.0 if with_faults else None,
        max_attempts=6, strict=False, fused=fused,
        incremental_replan=incremental_replan, tracer=tracer)
    return ex.run()


def _sig(trace):
    recs = sorted((r.id, r.node, r.start, r.end, r.pred_mean, r.pred_std)
                  for r in trace.records)
    return recs, (trace.makespan, trace.replans, trace.surprises,
                  trace.completed, trace.failures, trace.retries,
                  trace.speculations, trace.spec_wins, trace.lost_nodes,
                  trace.stranded, trace.total)


def _traces_agree(a, b):
    recs_a, tail_a = _sig(a)
    recs_b, tail_b = _sig(b)
    assert tail_a[1:] == tail_b[1:]              # counters identical
    assert tail_a[0] == pytest.approx(tail_b[0], rel=TOL, abs=TOL)
    assert len(recs_a) == len(recs_b)
    for x, y in zip(recs_a, recs_b):
        assert x[:2] == y[:2]                    # same task -> node
        np.testing.assert_allclose(x[2:], y[2:], rtol=TOL, atol=TOL)
    assert [(c.id, c.node, c.reason) for c in a.censored] == \
        [(c.id, c.node, c.reason) for c in b.censored]
    np.testing.assert_allclose([c.lost_at for c in a.censored],
                               [c.lost_at for c in b.censored],
                               rtol=TOL, atol=TOL)
    oa, ob = a.observations.to_dict(), b.observations.to_dict()
    assert [(o["task"], o["node"]) for o in oa["observations"]] == \
        [(o["task"], o["node"]) for o in ob["observations"]]
    for key in ("size", "runtime", "local_runtime", "time"):
        np.testing.assert_allclose([o[key] for o in oa["observations"]],
                                   [o[key] for o in ob["observations"]],
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the port against the JAX package: five workflows x faults, fused
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wf", list(WORKFLOWS))
@pytest.mark.parametrize("with_faults", [False, True],
                         ids=["faults_off", "faults_on"])
def test_fused_executor_matches_jax(cluster, wf, with_faults):
    ref = _run(cluster, wf, port=False, fused=True, with_faults=with_faults)
    got = _run(cluster, wf, port=True, fused=True, with_faults=with_faults)
    _traces_agree(got, ref)


@pytest.mark.parametrize("wf", list(WORKFLOWS))
@pytest.mark.parametrize("with_faults", [False, True],
                         ids=["faults_off", "faults_on"])
def test_fused_executor_matches_port_legacy(cluster, wf, with_faults):
    """The port's mirror of ``test_fused_executor_matches_legacy``."""
    legacy = _run(cluster, wf, port=True, fused=False,
                  with_faults=with_faults)
    fused = _run(cluster, wf, port=True, fused=True,
                 with_faults=with_faults)
    _traces_agree(fused, legacy)


def test_incremental_replan_alone_is_bitwise(cluster):
    base = _run(cluster, "methylseq", port=True, fused=False,
                with_faults=False)
    inc = _run(cluster, "methylseq", port=True, fused=False,
               with_faults=False, incremental_replan=True)
    assert _sig(inc) == _sig(base)


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
def test_tracing_is_read_only(cluster, fused):
    plain = _run(cluster, "chipseq", port=True, fused=fused,
                 with_faults=True)
    log = EventLog()
    traced = _run(cluster, "chipseq", port=True, fused=fused,
                  with_faults=True, tracer=log)
    assert _sig(traced) == _sig(plain)
    counters = log.counters()
    assert counters["finish"] == traced.completed
    assert counters["run_end"] == 1
    if fused:
        assert counters["span:tick_step"] >= 1
    else:
        assert counters["span:update_stream"] >= 1


def test_execution_trace_round_trips(cluster, tmp_path):
    trace = _run(cluster, "eager", port=True, fused=True, with_faults=True)
    assert trace.censored and len(trace.observations)
    d = json.loads(json.dumps(trace.to_dict()))
    back = ExecutionTrace.from_dict(d)
    assert back.to_dict() == trace.to_dict()
    assert _sig(back) == _sig(trace)
    np.testing.assert_array_equal(back.cumulative_mpe(),
                                  trace.cumulative_mpe())
    # the JAX package reads the port's trace file, and back
    from repro.online import ExecutionTrace as JTrace
    assert JTrace.from_dict(d).to_dict() == d
    buf = ObservationBuffer.from_dict(d["observations"])
    assert [len(g) for _, g in buf.by_tick()] == \
        [len(g) for _, g in trace.observations.by_tick()]
    with pytest.raises(ValueError, match="newer"):
        ExecutionTrace.from_dict({**d, "version": 99})


def test_static_and_online_runs(cluster):
    local, local_bench, tbenches = cluster
    wf = "bacass"
    size = INPUTS[(wf, 1)]
    by_name = {t.name: t for t in P_WORKFLOWS[wf]}
    tasks, task_name = fanout_chain_dag(list(by_name), 2)
    truth = PSim(seed=2000)
    tab = {(tid, nt.name): truth.run_task(by_name[task_name[tid]], nt, size)
           for tid in tasks for nt in target_nodes()}

    def make(online):
        sim = PSim(seed=0)
        est = PEstimator(PBench(**local_bench.to_dict()),
                         {k: PBench(**v.to_dict())
                          for k, v in tbenches.items()}, device="cpu")
        est.fit_tasks(list(by_name), size, lambda n, s, cf: sim.run_task(
            by_name[n], local, s, cpu_factor=cf))
        grid = PGrid.from_types(nodes_per_type=1)
        return OnlineExecutor(est, tasks, task_name, size, grid,
                              lambda tid, node: tab[(tid, grid.type_of(
                                  node).name)], online=online)

    static, online = run_static_and_online(make)
    assert static.completed == online.completed == len(tasks)
    assert static.replans == 0 and len(static.observations) == 0
    assert len(online.observations) == len(tasks)


def test_online_example_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "online_reestimation_torch.py"),
         "--device", "cpu", "--workflow", "bacass", "--samples", "2",
         "--nodes-per-type", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "online" in proc.stdout and "makespan" in proc.stdout
