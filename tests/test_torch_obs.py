"""The port's observability plane (``repro_torch.obs``) held to the JAX
package's ``repro.obs``: the same event stream through both packages
gives the same JSONL file, Chrome events, calibration summary, metrics,
``report_dict`` and ``render_report`` text; the port's streaming median
and the CLI twin ``scripts/report_trace_torch.py`` agree with theirs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.obs as J
import repro_torch.obs as P
from repro_torch.core import LotaruEstimator
from repro_torch.core import get_node, profile_cluster, profile_node
from repro_torch.core import target_nodes
from repro_torch.online import OnlineExecutor, fanout_chain_dag
from repro_torch.sched.simulator import (ClusterSimulator, FaultInjector,
                                         GridEngine)
from repro_torch.sched.workflows import INPUTS, WORKFLOWS

ROOT = Path(__file__).resolve().parents[1]


def _port_events(fused: bool) -> list:
    """A traced fault-injected run of the port's executor on the CPU
    (chipseq, 3 samples, an outage on one node)."""
    local = get_node("local-cpu")
    local_bench = profile_node(local, np.random.default_rng(7))
    tbenches = profile_cluster(target_nodes(), seed=13)
    size = INPUTS[("chipseq", 1)]
    by_name = {t.name: t for t in WORKFLOWS["chipseq"]}
    tasks, task_name = fanout_chain_dag(list(by_name), 3)
    truth = ClusterSimulator(seed=2000)
    tab = {(tid, nt.name): truth.run_task(by_name[task_name[tid]], nt, size)
           for tid in tasks for nt in target_nodes()}
    sim = ClusterSimulator(seed=0)
    est = LotaruEstimator(local_bench, tbenches, bias_empirical_bayes=True,
                          device="cpu")
    est.fit_tasks(list(by_name), size, lambda n, s, cf: sim.run_task(
        by_name[n], local, s, cpu_factor=cf))
    grid = GridEngine.from_types(nodes_per_type=2)
    log = P.EventLog()
    OnlineExecutor(est, tasks, task_name, size, grid,
                   lambda tid, node: tab[(tid, grid.type_of(node).name)],
                   risk_k=0.5, spec_tail=0.8, rel_k=0.5, strict=False,
                   faults=FaultInjector(p_fail=0.15, seed=3,
                                        outages={"tpu-v2/0": (20.0, 120.0)}),
                   tracer=log, fused=fused).run()
    return log.events


@pytest.fixture(scope="module", params=["legacy", "fused"])
def streams(request):
    """The same events as the port's ``Event``s and as the JAX package's."""
    pev = _port_events(request.param == "fused")
    jev = [J.Event.from_json(e.to_json()) for e in pev]
    return pev, jev


def test_event_taxonomy_matches_jax():
    assert P.EVENT_KINDS == J.EVENT_KINDS
    assert P.TRACE_FORMAT_VERSION == J.TRACE_FORMAT_VERSION
    assert sorted(P.__all__) == sorted(J.__all__)


def test_jsonl_and_chrome_export_match_jax(streams, tmp_path):
    pev, jev = streams
    assert {e.kind for e in pev} <= P.EVENT_KINDS
    plog, jlog = P.EventLog(), J.EventLog()
    plog.events, jlog.events = list(pev), list(jev)
    a = plog.to_jsonl(tmp_path / "port.jsonl").read_text()
    b = jlog.to_jsonl(tmp_path / "jax.jsonl").read_text()
    assert a == b
    assert plog.counters() == jlog.counters()
    assert [e.to_json() for e in P.load_jsonl(tmp_path / "jax.jsonl")] == \
        [e.to_json() for e in J.load_jsonl(tmp_path / "port.jsonl")]
    assert P.chrome_trace_events(pev) == J.chrome_trace_events(jev)
    assert plog.to_chrome(tmp_path / "p.json").read_text() == \
        jlog.to_chrome(tmp_path / "j.json").read_text()
    assert [e.to_json() for e in plog.filter("observe")] == \
        [e.to_json() for e in jlog.filter("observe")]
    assert len(plog.spans()) == len(jlog.spans()) > 0


@pytest.mark.parametrize("min_obs", [0, 5, 20])
def test_calibration_and_reports_match_jax(streams, min_obs):
    pev, jev = streams
    dump = lambda d: json.dumps(d, sort_keys=True, default=float)  # noqa: E731
    assert dump(P.calibration_summary(pev, min_obs=min_obs)) == \
        dump(J.calibration_summary(jev, min_obs=min_obs))
    assert dump(P.MetricsRegistry.from_events(pev).to_dict()) == \
        dump(J.MetricsRegistry.from_events(jev).to_dict())
    assert dump(P.tick_latency_summary(pev)) == \
        dump(J.tick_latency_summary(jev))
    assert dump(P.report_dict(pev, min_obs=min_obs)) == \
        dump(J.report_dict(jev, min_obs=min_obs))
    assert P.render_report(pev, min_obs=min_obs) == \
        J.render_report(jev, min_obs=min_obs)


def test_calibration_primitives_match_jax():
    rng = np.random.default_rng(0)
    x = rng.lognormal(size=301)
    np.testing.assert_array_equal(P.running_median(x), J.running_median(x))
    rp, rj = P.RunningMedian(), J.RunningMedian()
    for v in x[:50]:
        rp.push(float(v))
        rj.push(float(v))
        assert rp.median() == rj.median()
    pits = rng.random(200)
    for a, b in zip(P.pit_histogram(pits, 7), J.pit_histogram(pits, 7)):
        np.testing.assert_array_equal(a, b)
    assert P.sharpness(x) == J.sharpness(x)
    assert P.pit_uniformity(pits) == J.pit_uniformity(pits)
    cov = rng.random(200) > 0.2
    assert P.empirical_coverage(cov) == J.empirical_coverage(cov)
    np.testing.assert_array_equal(P.coverage_timeline(cov),
                                  J.coverage_timeline(cov))


def test_report_trace_cli_twin(streams, tmp_path):
    pev, _ = streams
    log = P.EventLog()
    log.events = list(pev)
    trace = log.to_jsonl(tmp_path / "run.jsonl")
    outs = []
    for script in ("report_trace.py", "report_trace_torch.py"):
        out = tmp_path / f"{script}.json"
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / script), str(trace),
             "--json", str(out), "--min-obs", "5"],
            capture_output=True, text=True, cwd=ROOT, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": str(ROOT / "src")})
        assert proc.returncode == 0, proc.stderr
        outs.append((proc.stdout.replace(str(out), "OUT"),
                     json.loads(out.read_text())))
    assert outs[0] == outs[1]
