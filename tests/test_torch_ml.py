"""The port's ``LotaruML`` (``repro_torch.core.estimator``) held to the
JAX package's on the CPU.

Both packages fit the same ``_toy_ml``-style cells (``tests/
test_batched_predict.py``: half with a throttled second run, so both the
dual-run and the ratio branch run) from the same deterministic local
runs; every number a scheduler reads — the decomposed ``predict``, the
(cell x node) matrix, the scalar-factor ablation, the straggler
threshold, and after ``observe``/``observe_batch`` the de-adjusted
runtimes, the bias posterior and the dirty-row matrix — must agree to
<= 1e-12 under x64 (``tests/test_tick_engine.py``'s bar).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import LotaruML as JML
from repro.core import young_daly_interval as j_young_daly
from repro.core.profiler import BenchResult as JBench
from repro_torch.core import LotaruML as PML
from repro_torch.core import young_daly_interval as p_young_daly
from repro_torch.core.profiler import BenchResult as PBench

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


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _benches(seed, n_nodes=3):
    """(local, {name: target}) bench fields, ``_toy_ml``'s ranges."""
    rng = np.random.default_rng(seed)
    local = dict(node="local-cpu", cpu_events_s=450.0, matmul_gflops=90.0,
                 mem_gbps=18.0, io_read_mbps=420.0, io_write_mbps=420.0,
                 link_gbps=0.0)
    targets = {f"n{j}": dict(node=f"n{j}", cpu_events_s=200.0,
                             matmul_gflops=float(rng.uniform(500, 5000)),
                             mem_gbps=float(rng.uniform(100, 900)),
                             io_read_mbps=300.0, io_write_mbps=300.0,
                             link_gbps=float(rng.uniform(0, 60)))
               for j in range(n_nodes)}
    return local, targets


def _cells(seed, n_cells):
    """``_toy_ml``'s cells, each with its slope and whether it has a
    throttled run (even cells)."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for i in range(n_cells):
        cell = {"arch": f"a{i}", "shape": "s", "roofline": {
            "step_tokens": 2048 * (i + 1),
            "compute_s": float(rng.uniform(0.1, 2)),
            "memory_s": float(rng.uniform(0.1, 2)),
            "collective_s": float(rng.uniform(0.0, 1)),
            "flops_per_device": float(rng.uniform(1e12, 5e13)),
            "bytes_per_device": float(rng.uniform(1e10, 1e12)),
            "coll_bytes_per_device": float(rng.uniform(1e8, 1e10))}}
        out.append((cell, float(rng.uniform(1e-4, 1e-3)), i % 2 == 0))
    return out


def _fit(est, cells):
    for i, (cell, slope, throttled) in enumerate(cells):
        def run(c, f, slope=slope, i=i):
            # deterministic "noise": the same on both packages
            return (slope * f * c["roofline"]["step_tokens"] + 0.5
                    + 1e-3 * np.sin(1e3 * f + i))

        def slow(c, f, slope=slope):
            return slope * f * c["roofline"]["step_tokens"] * 1.25 + 0.6

        est.fit_cell(cell, run, run_local_throttled=slow if throttled
                     else None)
    return est


def _pair(seed=0, n_cells=6, n_nodes=3, **kw):
    local, targets = _benches(seed, n_nodes)
    cells = _cells(seed, n_cells)
    je = _fit(JML(JBench(**local), {k: JBench(**v)
                                    for k, v in targets.items()}, **kw),
              cells)
    pe = _fit(PML(PBench(**local), {k: PBench(**v)
                                    for k, v in targets.items()},
                  device="cpu", **kw), cells)
    return je, pe


def _nodes(est):
    return list(est.target_benches) + [est.local_bench.node]


def test_fit_cell_matches_jax():
    je, pe = _pair()
    assert pe.cell_names() == je.cell_names()
    for n in je.cell_names():
        jc, pc = je.cells[n], pe.cells[n]
        assert pc.weights == pytest.approx(jc.weights, rel=TOL, abs=TOL)
        assert (pc.w_compute is None) == (jc.w_compute is None)
        if jc.w_compute is not None:
            assert pc.w_compute == pytest.approx(jc.w_compute, rel=TOL)
        assert pc.model.correlated == jc.model.correlated
        assert pc.full_tokens == jc.full_tokens
        _close(pc.tokens, jc.tokens)
        _close(pc.runtimes, jc.runtimes)
    assert {pe.cells[n].w_compute is None for n in pe.cell_names()} == \
        {True, False}                       # both branches are exercised


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_predictors_match_jax(bias):
    je, pe = _pair(bias_correction=bias)
    nodes = _nodes(je)
    for tokens in (None, 3000.0):
        jm, js = je.predict_matrix(nodes, tokens)
        pm, ps = pe.predict_matrix(nodes, tokens)
        _close(pm, jm)
        _close(ps, js)
        pm2, none = pe.predict_matrix(nodes, tokens, with_std=False)
        assert none is None
        _close(pm2, pm)
        for a, b in zip(pe.predict_matrix_scalar(nodes, tokens),
                        je.predict_matrix_scalar(nodes, tokens)):
            _close(a, b)
    per_cell = np.linspace(1000.0, 9000.0, len(je.cells))
    for a, b in zip(pe.predict_matrix(nodes, per_cell),
                    je.predict_matrix(nodes, per_cell)):
        _close(a, b)
    M, S = pe.predict_matrix(nodes)
    for i, cn in enumerate(je.cell_names()):
        for j, nd in enumerate(nodes):
            _close(pe.predict(cn, nd), je.predict(cn, nd))
            _close(pe.predict(cn, nd, 1500.0), je.predict(cn, nd, 1500.0))
            _close(pe.predict_scalar(cn, nd), je.predict_scalar(cn, nd))
            assert pe.straggler_threshold(cn, nd) == pytest.approx(
                je.straggler_threshold(cn, nd), rel=TOL, abs=TOL)
            # the port's own scalar oracle of its matrix
            _close((M[i, j], S[i, j]), pe.predict(cn, nd))


def _ticks(est, seed, ticks=4, most=6):
    rng = np.random.default_rng(seed)
    names, nodes = est.cell_names(), _nodes(est)
    out = []
    for _ in range(ticks):
        k = int(rng.integers(2, most + 1))
        batch = [(names[int(rng.integers(0, len(names)))],
                  nodes[int(rng.integers(0, len(nodes)))],
                  float(rng.uniform(1000.0, 9000.0)),
                  float(rng.uniform(0.5, 8.0))) for _ in range(k)]
        batch.append(batch[0][:2] + (batch[0][2] * 1.1,
                                     batch[0][3] * 0.9))   # a repeat
        out.append(batch)
    return out


@pytest.mark.parametrize("decay,eb", [(1.0, False), (0.8, True)],
                         ids=["plain", "decay_eb"])
def test_observe_batch_and_dirty_matrix_match_jax(decay, eb):
    je, pe = _pair(seed=1, bias_decay=decay, bias_empirical_bayes=eb)
    nodes = _nodes(je)
    for a, b in zip(pe.predict_matrix(nodes), je.predict_matrix(nodes)):
        _close(a, b)
    for batch in _ticks(je, 5):
        _close(pe.observe_batch(batch), je.observe_batch(batch))
        assert pe._dirty_rows == je._dirty_rows
        for a, b in zip(pe.predict_matrix(nodes), je.predict_matrix(nodes)):
            _close(a, b)
        for f in ("counts", "log_sum", "log_sq"):
            _close(getattr(pe.bias, f), getattr(je.bias, f))
    name = je.cell_names()[1]
    _close(pe.observe(name, "n0", 2500.0, 3.0),
           je.observe(name, "n0", 2500.0, 3.0))
    for n in je.cell_names():
        jc, pc = je.cells[n], pe.cells[n]
        _close(pc.tokens, jc.tokens)
        _close(pc.runtimes, jc.runtimes)
        assert pc.model.correlated == jc.model.correlated
        for nd in nodes:
            _close(pe.predict(n, nd), je.predict(n, nd))
            assert pe.bias_point(n, nd) == pytest.approx(
                je.bias_point(n, nd), rel=TOL, abs=TOL)
    for a, b in zip(pe.predict_matrix(nodes), je.predict_matrix(nodes)):
        _close(a, b)


def test_observe_batch_reads_back_twice_whatever_the_batch():
    _, pe = _pair(seed=2)
    for b in (_ticks(pe, 7, ticks=1, most=2)[0],
              _ticks(pe, 8, ticks=1, most=60)[0]):
        before = pe.fetches
        pe.observe_batch(b)
        assert pe.fetches - before == 2
    _, pn = _pair(seed=2, bias_correction=False)
    pn.observe_batch(_ticks(pn, 9, ticks=1, most=30)[0])
    assert pn.fetches == 2


def test_observe_rejects_a_zero_local_mean_like_jax():
    local, targets = _benches(3, 1)
    cell = {"arch": "z", "shape": "s", "roofline": {
        "step_tokens": 4096, "compute_s": 1.0, "memory_s": 0.5,
        "collective_s": 0.1, "flops_per_device": 1e13,
        "bytes_per_device": 1e11, "coll_bytes_per_device": 1e9}}
    errs = []
    for ml, bench in ((JML, JBench), (PML, PBench)):
        kw = {"device": "cpu"} if ml is PML else {}
        est = ml(bench(**local), {k: bench(**v) for k, v in targets.items()},
                 **kw)
        est.fit_cell(cell, lambda c, f: 1e-3 * f * 4096 - 0.5)
        name = est.cell_names()[0]
        before = est.cells[name].tokens.copy()
        with pytest.raises(ValueError, match="local predictive mean is ~0"
                           ) as e:
            est.observe_batch([(name, "n0", 4000.0, 3.0),
                               (name, "n0", 100.0, 1.0)])
        np.testing.assert_array_equal(est.cells[name].tokens, before)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_young_daly_interval_matches_jax():
    for step, mtbf, cost in ((0.5, 6 * 3600.0, 30.0), (3000.0, 600.0, 2.0),
                             (1e-3, 1e7, 1e-2)):
        assert p_young_daly(step, mtbf, cost) == j_young_daly(step, mtbf,
                                                              cost)


def test_lotaru_ml_decomposed_beats_scalar():
    """``tests/test_system.py``'s property, through the port."""
    from repro_torch.core import (get_node, profile_cluster, profile_node,
                                  target_nodes)
    from repro_torch.sched.simulator import ClusterSimulator
    sim = ClusterSimulator(seed=0)
    truth = ClusterSimulator(seed=99)
    local = get_node("local-cpu")
    est = PML(profile_node(local, np.random.default_rng(7)),
              profile_cluster(target_nodes(), seed=13), device="cpu")
    cells = []
    for i, (fl, by, co) in enumerate([(5e13, 8e12, 2e11), (1e12, 9e12, 1e11),
                                      (2e13, 2e12, 9e11)]):
        cells.append({"arch": f"synt{i}", "shape": "train", "family": "dense",
                      "roofline": {"chips": 256, "flops_per_device": fl,
                                   "bytes_per_device": by,
                                   "coll_bytes_per_device": co,
                                   "step_tokens": 1_000_000,
                                   "compute_s": fl / 197e12,
                                   "memory_s": by / 819e9,
                                   "collective_s": co / 50e9}})
    errs_d, errs_s = [], []
    for c in cells:
        est.fit_cell(c, lambda cell, f: sim.run_cell(cell, local, f),
                     run_local_throttled=lambda cell, f: sim.run_cell(
                         cell, local, f, cpu_factor=0.8))
        name = f"{c['arch']}__{c['shape']}"
        for node in target_nodes():
            actual = truth.run_cell(c, node)
            pd, _ = est.predict(name, node.name)
            ps, _ = est.predict_scalar(name, node.name)
            errs_d.append(abs(pd - actual) / actual)
            errs_s.append(abs(ps - actual) / actual)
    assert np.median(errs_d) < np.median(errs_s)
    assert np.median(errs_d) < 0.8


def test_lotaru_ml_defaults_to_the_card():
    local, targets = _benches(0, 1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PML(PBench(**local), {k: PBench(**v) for k, v in targets.items()})


def _run(script, *args):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _table(out, first):
    """The lines of ``out`` from the one starting with ``first`` to the
    next empty line."""
    lines = out.splitlines()
    k = next(i for i, ln in enumerate(lines) if ln.startswith(first))
    end = next((i for i in range(k, len(lines)) if not lines[i]),
               len(lines))
    return lines[k:end]


@pytest.mark.parametrize("script,first", [
    ("quickstart", "phase 4"), ("heterogeneous_schedule", "chipseq-1")])
def test_example_twin_prints_what_the_reference_prints(script, first):
    """Each example twin runs with ``--device cpu`` and prints the
    reference example's predictions and plan (the profile of the machine
    running it, in quickstart's phase 1, is a live measurement and is
    left out)."""
    port = _run(f"{script}_torch.py", "--device", "cpu")
    ref = _run(f"{script}.py")
    assert _table(port, first) == _table(ref, first)
