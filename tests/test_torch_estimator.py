"""The port's estimator (``repro_torch.core.estimator``) and evaluation
(``repro_torch.sched.evaluation``) held to the JAX package's on the CPU.

Each test fits the same workflow in both packages from simulators with
the same seeds, then compares what the scheduler consumes at <= 1e-12
(x64, as ``tests/test_tick_engine.py``): the (task x node) matrices before
and after ``observe_batch``, the scalar predictions, intervals and PIT
values, the bias state, and schema-v6 files written by one package and
read by the other.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import LotaruEstimator as JEstimator
from repro.core import get_node, profile_cluster, profile_node, target_nodes
from repro.sched.evaluation import run_evaluation as j_run_evaluation
from repro.sched.simulator import ClusterSimulator as JSim
from repro.sched.workflows import INPUTS, WORKFLOWS
from repro_torch import convert
from repro_torch.core import LotaruEstimator as PEstimator
from repro_torch.core import blr as P
from repro_torch.core import estimator as pest
from repro_torch.core import profile_local
from repro_torch.core.profiler import BenchResult as PBench
from repro_torch.sched.evaluation import run_evaluation as p_run_evaluation
from repro_torch.sched.simulator import ClusterSimulator as PSim
from repro_torch.sched.workflows import WORKFLOWS as P_WORKFLOWS

TOL = 1e-12


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


def _port_benches(local_bench, tbenches):
    return (PBench(**local_bench.to_dict()),
            {k: PBench(**v.to_dict()) for k, v in tbenches.items()})


def _fitted_pair(cluster, wf, *, seed=0, **kw):
    """The same workflow fitted in both packages: simulators with the same
    seed, so both see the same local runs."""
    local, local_bench, tbenches = cluster
    size = INPUTS[(wf, 1)]
    names = [t.name for t in WORKFLOWS[wf]]
    j_by = {t.name: t for t in WORKFLOWS[wf]}
    p_by = {t.name: t for t in P_WORKFLOWS[wf]}
    jsim, psim = JSim(seed=seed), PSim(seed=seed)
    je = JEstimator(local_bench, tbenches, **kw)
    je.fit_tasks(names, size, lambda n, s, cf: jsim.run_task(
        j_by[n], local, s, cpu_factor=cf))
    plocal, ptb = _port_benches(local_bench, tbenches)
    pe = PEstimator(plocal, ptb, device="cpu", **kw)
    pe.fit_tasks(names, size, lambda n, s, cf: psim.run_task(
        p_by[n], local, s, cpu_factor=cf))
    return je, pe, names, size


def _arr(x):
    """Values of a torch tensor or a JAX array, as float64 numpy."""
    return P._np(x) if isinstance(x, torch.Tensor) else np.asarray(x,
                                                                   np.float64)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _same_gates(je, pe):
    for n in je.tasks:
        assert pe.tasks[n].model.correlated == je.tasks[n].model.correlated
        assert pe.tasks[n].w == je.tasks[n].w


def _observations(names, nodes, size, seed, k):
    rng = np.random.default_rng(seed)
    return [(names[int(rng.integers(0, len(names)))],
             nodes[int(rng.integers(0, len(nodes)))],
             size * float(rng.uniform(0.3, 1.5)),
             float(rng.uniform(5.0, 4000.0)))
            for _ in range(k)]


@pytest.mark.parametrize("wf", list(WORKFLOWS))
def test_fit_predict_and_matrix_match_jax(cluster, wf):
    je, pe, names, size = _fitted_pair(cluster, wf)
    _same_gates(je, pe)
    nodes = [cluster[1].node] + [nt.name for nt in target_nodes()]
    assert pe.task_names() == je.task_names()
    _close(pe.factor_matrix(nodes), je.factor_matrix(nodes))
    jm, js = je.predict_matrix(nodes, size)
    pm, ps = pe.predict_matrix(nodes, size)
    _close(pm, jm)
    _close(ps, js)
    jm, js = je.predict_matrix(nodes[1:], np.linspace(1.0, size, len(names)))
    pm, ps = pe.predict_matrix(nodes[1:], np.linspace(1.0, size, len(names)))
    _close(pm, jm)
    _close(ps, js)
    for n in names:
        _close(pe.predict_local(n, size), je.predict_local(n, size))
        for node in nodes:
            assert pe.factor(n, node) == je.factor(n, node)
            _close(pe.predict(n, node, size), je.predict(n, node, size))


@pytest.mark.parametrize("wf", list(WORKFLOWS))
def test_observe_batch_and_dirty_rows_match_jax(cluster, wf):
    je, pe, names, size = _fitted_pair(cluster, wf,
                                       bias_empirical_bayes=True)
    nodes = [nt.name for nt in target_nodes()]
    je.predict_matrix(nodes, size)
    pe.predict_matrix(nodes, size)
    for tick in range(4):
        batch = _observations(names, nodes, size, 10 * tick + 1, 3 + tick)
        _close(pe.observe_batch(batch), je.observe_batch(batch))
        jm, js = je.predict_matrix(nodes, size)
        pm, ps = pe.predict_matrix(nodes, size)
        _close(pm, jm)
        _close(ps, js)
        _same_gates(je, pe)
    np.testing.assert_array_equal(pe.bias.counts, je.bias.counts)
    _close(pe.bias.log_sum, je.bias.log_sum)
    for n in names[:4]:
        for node in nodes[:3]:
            _close(pe.predict(n, node, size), je.predict(n, node, size))
            assert pe.bias_point(n, node) == pytest.approx(
                je.bias_point(n, node), rel=TOL, abs=TOL)
            lo_j, hi_j = je.predict_interval_node(n, node, size, 0.9)
            lo_p, hi_p = pe.predict_interval_node(n, node, size, 0.9)
            assert lo_p == pytest.approx(lo_j, rel=TOL, abs=TOL)
            assert hi_p == pytest.approx(hi_j, rel=TOL, abs=TOL)
            for rt in (30.0, 300.0, 3000.0):
                assert pe.predict_pit_node(n, node, size, rt) == \
                    pytest.approx(je.predict_pit_node(n, node, size, rt),
                                  rel=TOL, abs=TOL)


def test_dirty_rows_recompute_only_dirty_rows(cluster, monkeypatch):
    je, pe, names, size = _fitted_pair(cluster, "chipseq")
    nodes = [nt.name for nt in target_nodes()]
    pe.predict_matrix(nodes, size)
    je.predict_matrix(nodes, size)
    seen = []
    core = pest._scaled_matrix_core

    def spy(model, factors, sz):
        seen.append(int(model.median.shape[0]))
        return core(model, factors, sz)

    monkeypatch.setattr(pest, "_scaled_matrix_core", spy)
    batch = [(names[3], nodes[0], size, 500.0),
             (names[7], nodes[2], size, 80.0),
             (names[3], nodes[4], size, 700.0)]
    pe.observe_batch(batch)
    je.observe_batch(batch)
    assert sorted(pe._dirty_rows) == [3, 7]
    pm, ps = pe.predict_matrix(nodes, size)
    assert seen == [2]                   # two rows, not the whole matrix
    jm, js = je.predict_matrix(nodes, size)
    _close(pm, jm)
    _close(ps, js)
    pe.predict_matrix(nodes, size)       # clean: no recompute
    assert seen == [2]
    fresh = PEstimator(pe.local_bench, pe.target_benches, device="cpu")
    fresh.tasks = pe.tasks
    fresh.bias, fresh._bias_col = pe.bias, pe._bias_col
    fresh._batch_cache = pe._batch_cache
    fm, fs = fresh.predict_matrix(nodes, size)
    assert seen == [2, len(names)]
    _close(pm, fm, 1e-15)
    _close(ps, fs, 1e-15)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_schema_v6_files_load_across_packages(cluster, tmp_path, direction):
    je, pe, names, size = _fitted_pair(cluster, "eager")
    nodes = [nt.name for nt in target_nodes()]
    batch = _observations(names, nodes, size, 5, 9)
    je.observe_batch(batch)
    pe.observe_batch(batch)
    pe.record_attempt(nodes[1], False)
    je.record_attempt(nodes[1], False)
    path = tmp_path / "est.json"
    if direction == "jax_to_port":
        je.save(path)
        src, back = je, PEstimator.load(path, device="cpu")
        assert back.device.type == "cpu"
    else:
        pe.save(path)
        src, back = pe, JEstimator.load(path)
    # the v6 state block primes the batch cache bit for bit
    _, m_src, _ = src._batched()
    _, m_back, _ = back._batched()
    for f in P.POSTERIOR_FIELDS:
        np.testing.assert_array_equal(_arr(getattr(m_back.post, f)),
                                      _arr(getattr(m_src.post, f)))
    np.testing.assert_array_equal(_arr(m_back.stats.moments),
                                  _arr(m_src.stats.moments))
    ms, ss = src.predict_matrix(nodes, size)
    mb, sb = back.predict_matrix(nodes, size)
    _close(mb, ms)
    _close(sb, ss)
    for n in names:
        _close(back.predict(n, nodes[1], size), src.predict(n, nodes[1], size))
    assert back.reliability_factor(nodes[1]) == src.reliability_factor(
        nodes[1])
    # both resume the online loop the same way
    more = _observations(names, nodes, size, 6, 5)
    _close(back.observe_batch(more), src.observe_batch(more))
    _close(back.predict_matrix(nodes, size)[0], src.predict_matrix(nodes,
                                                                   size)[0])


def test_run_evaluation_matches_jax():
    inputs = {("bacass", 1): INPUTS[("bacass", 1)],
              ("methylseq", 2): INPUTS[("methylseq", 2)]}
    jr = j_run_evaluation(seed=3, n_partitions=6, inputs=inputs)
    pr = p_run_evaluation(seed=3, n_partitions=6, inputs=inputs,
                          device="cpu")
    for a in jr.errors:
        _close(pr.all_errors(a), jr.all_errors(a))
        assert pr.mpe(a) == pytest.approx(jr.mpe(a), rel=TOL, abs=TOL)
        for wf in ("bacass-1", "methylseq-2"):
            assert pr.mpe(a, wf) == pytest.approx(jr.mpe(a, wf), rel=TOL,
                                                  abs=TOL)


def test_convert_loads_a_jax_fitted_state(cluster):
    je, _, names, size = _fitted_pair(cluster, "atacseq")
    _, jm, _ = je._batched()
    post = {f: np.asarray(getattr(jm.post, f)) for f in P.POSTERIOR_FIELDS}
    log = jm.stats.log
    pm = convert.batched_task_model_from_numpy(
        np.asarray(jm.correlated), post, np.asarray(jm.median),
        np.asarray(jm.spread), np.asarray(jm.stats.moments),
        (log.x, log.y, log.count), device="cpu")
    for f in P.POSTERIOR_FIELDS:
        np.testing.assert_array_equal(P._np(getattr(pm.post, f)), post[f])
    from repro.core import blr as J
    _close(P.predict_task_batch(pm, size)[0].numpy(),
           J.predict_task_batch(jm, size)[0])
    rng = np.random.default_rng(2)
    idx = rng.integers(0, len(names), 20)
    xs, ys = rng.uniform(1, size, 20), rng.uniform(10, 900, 20)
    pm2 = P.update_task_batch_stream(pm, idx, xs, ys)
    jm2 = J.update_task_batch_stream(jm, idx, xs, ys)
    _close(P._np(pm2.post.mu), jm2.post.mu)
    np.testing.assert_array_equal(pm2.correlated.numpy(),
                                  np.asarray(jm2.correlated))
    ft = je.tasks[names[0]].model
    tm = convert.task_model_from_numpy(
        ft.correlated, ft.median, ft.spread,
        None if ft.post is None else
        {f: np.asarray(getattr(ft.post, f)) for f in P.POSTERIOR_FIELDS},
        device="cpu")
    _close(tm.predict(size), ft.predict(size))
    single = convert.posterior_from_numpy(*(post[f][0]
                                            for f in P.POSTERIOR_FIELDS),
                                          device="cpu")
    assert single.mu.shape == (2,)
    with pytest.raises(ValueError, match="together"):
        convert.batched_task_model_from_numpy(
            np.asarray(jm.correlated), post, np.asarray(jm.median),
            np.asarray(jm.spread), np.asarray(jm.stats.moments),
            device="cpu")


def test_profile_local_on_the_cpu_keeps_the_schema():
    b = profile_local(device="cpu")
    d = b.to_dict()
    assert list(d) == ["node", "cpu_events_s", "matmul_gflops", "mem_gbps",
                       "io_read_mbps", "io_write_mbps", "link_gbps"]
    for k in ("cpu_events_s", "matmul_gflops", "mem_gbps", "io_read_mbps",
              "io_write_mbps"):
        assert np.isfinite(d[k]) and d[k] > 0, k
    assert d["link_gbps"] == 0.0


def test_estimator_defaults_to_the_card(cluster):
    plocal, ptb = _port_benches(cluster[1], cluster[2])
    if torch.cuda.is_available():
        assert PEstimator(plocal, ptb).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            PEstimator(plocal, ptb)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            profile_local()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            p_run_evaluation(seed=0, inputs={("bacass", 1): 3.64})
