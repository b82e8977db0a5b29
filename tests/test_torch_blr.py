"""The port's Bayesian regression (``repro_torch.core.blr``) held to the JAX
package's (``repro.core.blr``) on the CPU.

Both packages get the same numpy inputs, made from a seed.  The bar is the
reference's own: <= 1e-12 relative/absolute under x64
(``tests/test_tick_engine.py``), switched on by a module fixture that clears
JAX's caches on both edges; and rtol 1e-4 in float32
(``tests/test_batched_predict.py``).  The Pearson gate (0.8) is compared as
an outcome: the outcomes must be equal on every input, and the numbers are
compared where both packages took the same branch.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.core import blr as J
from repro_torch.core import blr as P

TOL = 1e-12
F32_RTOL = 1e-4
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_x64", prev)
    jax.clear_caches()


@contextlib.contextmanager
def _x32():
    jax.config.update("jax_enable_x64", False)
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)
        jax.clear_caches()


def _gate_task(n=10, r=0.8, seed=5):
    """Samples whose Pearson correlation is ``r`` up to rounding: the task
    sits on the gate."""
    rng = np.random.default_rng(seed)
    x = np.geomspace(1.0, 64.0, n)
    zx = (x - x.mean()) / x.std()
    e = rng.normal(size=n)
    e -= e.mean()
    e -= (e @ zx) / (zx @ zx) * zx
    ze = e / e.std()
    return x, 40.0 + 9.0 * (r * zx + np.sqrt(1.0 - r * r) * ze)


def _tasks(seed=0):
    """Ragged tasks: size-correlated ones, flat ones (median fallback),
    one-sample and two-sample tasks, and one on the 0.8 gate."""
    rng = np.random.default_rng(seed)
    sizes, runs = [], []
    for n in (10, 1, 6, 2, 10, 3, 8, 10):
        s = np.geomspace(1.0, 256.0, n) * rng.uniform(0.5, 2.0)
        if rng.random() < 0.6:
            r = rng.uniform(0.1, 5.0) * s + rng.uniform(1, 50) \
                + rng.normal(0, 0.5, n)
        else:
            r = rng.uniform(20, 200) + rng.normal(0, 2.0, n)
        sizes.append(s)
        runs.append(r)
    gx, gy = _gate_task()
    sizes.append(gx)
    runs.append(gy)
    return sizes, runs


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(P._np(port) if isinstance(port, torch.Tensor)
                               else np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), rtol=tol,
                               atol=tol)


def _same_model(pm, jm, tol=TOL):
    corr = pm.correlated.numpy()
    assert np.array_equal(corr, np.asarray(jm.correlated))
    for f in P.POSTERIOR_FIELDS:
        _close(getattr(pm.post, f), getattr(jm.post, f), tol)
    _close(pm.median, jm.median, tol)
    _close(pm.spread, jm.spread, tol)
    if jm.stats is not None:
        _close(pm.stats.moments, jm.stats.moments, tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_task_batch_matches_jax(seed):
    sizes, runs = _tasks(seed)
    jm = J.fit_task_batch(sizes, runs)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    assert pm.post.mu.dtype == torch.float64
    assert pm.post.mu.device.type == "cpu"
    _same_model(pm, jm)
    # the ragged solve is the per-task solve
    for i, (s, r) in enumerate(zip(sizes, runs)):
        tm = P.fit_task(s, r, **CPU)
        assert tm.correlated == bool(pm.correlated[i])
        if tm.correlated:
            _close(tm.post.mu, pm.post.mu[i])


def test_fit_task_batch_covers_every_branch():
    """The inputs reach the one-sample, flat-fallback and BLR branches,
    and the gate task sits within 1e-12 of the 0.8 threshold."""
    sizes, runs = _tasks(0)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    corr = pm.correlated.numpy()
    assert not corr[1]                          # one sample
    assert corr.any() and not corr.all()
    gx, gy = _gate_task()
    assert abs(P.pearson(gx, gy) - P.CORRELATION_THRESHOLD) < 1e-12


@pytest.mark.parametrize("r", [0.8, 0.8 - 1e-15, 0.8 + 1e-15, 0.5, 0.95])
def test_gate_outcomes_equal_near_threshold(r):
    gx, gy = _gate_task(r=r)
    sizes, runs = [gx, gx[:5]], [gy, gy[:5]]
    jm = J.fit_task_batch(sizes, runs)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    _same_model(pm, jm)
    # the gate re-evaluated from streamed moments, after updates on the line
    idx = np.array([0, 1, 0, 1])
    xs = np.array([gx[3], gx[1], gx[7], gx[2]])
    ys = np.array([gy[3], gy[1], gy[7], gy[2]])
    jm2 = J.update_task_batch_stream(jm, idx, xs, ys)
    pm2 = P.update_task_batch_stream(pm, idx, xs, ys)
    _same_model(pm2, jm2)


def test_predict_task_batch_matches_jax():
    sizes, runs = _tasks(0)
    jm = J.fit_task_batch(sizes, runs)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    x_t = np.random.default_rng(9).uniform(1.0, 600.0, len(sizes))
    for x in (300.0, x_t):
        jmean, jstd = J.predict_task_batch(jm, x)
        pmean, pstd = P.predict_task_batch(pm, x)
        _close(pmean, jmean)
        _close(pstd, jstd)
        jmean, jstd = J.predict_batch(jm.post, x)
        pmean, pstd = P.predict_batch(pm.post, x)
        _close(pmean, jmean)
        _close(pstd, jstd)


def test_predict_batch_grid_matches_jax():
    sizes, runs = _tasks(1)
    jm = J.fit_task_batch(sizes, runs)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    grid = np.geomspace(0.5, 1000.0, 17)
    for jf, pf, jarg, parg in (
            (J.predict_batch_grid, P.predict_batch_grid, jm.post, pm.post),
            (J.predict_task_batch_grid, P.predict_task_batch_grid, jm, pm)):
        jmean, jstd = jf(jarg, grid)
        pmean, pstd = pf(parg, grid)
        assert tuple(pmean.shape) == (len(sizes), len(grid))
        _close(pmean, jmean)
        _close(pstd, jstd)


@pytest.mark.parametrize("confidence", [0.5, 0.9])
def test_predict_interval_matches_jax(confidence):
    sizes, runs = _tasks(2)
    jm = J.fit_task_batch(sizes, runs)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    jlo, jhi = J.predict_interval(jm.post, 120.0, confidence)
    plo, phi = P.predict_interval(pm.post, 120.0, confidence)
    _close(plo, jlo)
    _close(phi, jhi)
    jpost = J.fit(sizes[0], runs[0])
    ppost = P.fit(sizes[0], runs[0], **CPU)
    for x in (77.0, np.array([3.0, 50.0, 400.0])):
        jlo, jhi = J.predict_interval(jpost, x, confidence)
        plo, phi = P.predict_interval(ppost, x, confidence)
        _close(plo, jlo)
        _close(phi, jhi)
    assert isinstance(P.predict_interval(ppost, 77.0)[0], np.float64)


def test_predict_cdf_matches_jax():
    sizes, runs = _tasks(0)
    jpost = J.fit(sizes[0], runs[0])
    ppost = P.fit(sizes[0], runs[0], **CPU)
    jmean, _ = J.predict(jpost, 100.0)
    for y in (0.5 * float(jmean), float(jmean), 1.3 * float(jmean)):
        assert P.predict_cdf(ppost, 100.0, y) == pytest.approx(
            J.predict_cdf(jpost, 100.0, y), rel=TOL, abs=TOL)


def test_scalar_fit_predict_and_task_model_match_jax():
    sizes, runs = _tasks(0)
    for s, r in zip(sizes, runs):
        jt = J.fit_task(s, r)
        pt = P.fit_task(s, r, **CPU)
        assert pt.correlated == jt.correlated
        assert pt.median == jt.median and pt.spread == jt.spread
        for x in (5.0, np.array([1.0, 30.0, 900.0])):
            jmean, jstd = jt.predict(x)
            pmean, pstd = pt.predict(x)
            _close(pmean, jmean)
            _close(pstd, jstd)
        if len(s) >= 2:
            jp = J.fit(s, r)
            pp = P.fit(s, r, **CPU)
            for f in P.POSTERIOR_FIELDS:
                _close(getattr(pp, f), getattr(jp, f))
            _close(pp.dof, jp.dof)
            _close(pp.sigma2_mean, jp.sigma2_mean)
            jmean, jstd = J.predict(jp, 42.0)
            pmean, pstd = P.predict(pp, 42.0)
            assert pmean.ndim == 0
            _close(pmean, jmean)
            _close(pstd, jstd)


def test_pearson_matches_jax():
    sizes, runs = _tasks(1)
    for s, r in zip(sizes, runs):
        assert P.pearson(s, r) == J.pearson(s, r)
    X = np.zeros((3, 6))
    Y = np.random.default_rng(1).normal(size=(3, 6))
    M = np.ones_like(X)
    M[2, 4:] = 0
    assert np.array_equal(P.pearson_batch(X, Y, M), J.pearson_batch(X, Y, M))


def _stream(T, S, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, T, S)
    xs = rng.uniform(1.0, 300.0, S)
    ys = 2.0 * xs + rng.normal(0, 20.0, S) + 30.0
    return idx, xs, ys


def test_update_task_batch_matches_jax():
    sizes, runs = _tasks(0)
    jm = J.fit_task_batch(sizes, runs)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    idx, xs, ys = _stream(len(sizes), 12, 3)
    for i, x, y in zip(idx, xs, ys):
        jm = J.update_task_batch(jm, int(i), float(x), float(y))
        pm = P.update_task_batch(pm, int(i), float(x), float(y))
        _same_model(pm, jm)
    assert np.array_equal(pm.stats.log.count, jm.stats.log.count)
    assert np.array_equal(pm.stats.log.y, jm.stats.log.y)


@pytest.mark.parametrize("S", [1, 40, 300])
def test_update_task_batch_stream_matches_jax(S):
    sizes, runs = _tasks(1)
    jm = J.fit_task_batch(sizes, runs)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    idx, xs, ys = _stream(len(sizes), S, S)
    jm2 = J.update_task_batch_stream(jm, idx, xs, ys)
    pm2 = P.update_task_batch_stream(pm, idx, xs, ys)
    _same_model(pm2, jm2)
    # moments are folded in stream order, as the scan adds them
    assert np.array_equal(P._np(pm2.stats.moments),
                          np.asarray(jm2.stats.moments))
    # the stream equals one-at-a-time updates, and a refit on the history
    pm3 = P.fit_task_batch(sizes, runs, **CPU)
    for i, x, y in zip(idx, xs, ys):
        pm3 = P.update_task_batch(pm3, int(i), float(x), float(y))
    _same_model(pm3, jm2)
    hist_s = [np.concatenate([s, xs[idx == t]]) for t, s in enumerate(sizes)]
    hist_r = [np.concatenate([r, ys[idx == t]]) for t, r in enumerate(runs)]
    refit = P.fit_task_batch(hist_s, hist_r, **CPU)
    assert np.array_equal(refit.correlated.numpy(), pm2.correlated.numpy())
    for f in ("mu", "V", "a", "b"):
        _close(getattr(pm2.post, f), getattr(refit.post, f), 1e-9)


def test_update_leaves_the_input_posterior_unchanged():
    sizes, runs = _tasks(0)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    before = {f: getattr(pm.post, f).clone() for f in P.POSTERIOR_FIELDS}
    before.update(correlated=pm.correlated.clone(),
                  median=pm.median.clone(), spread=pm.spread.clone(),
                  moments=pm.stats.moments.clone())

    def unchanged():
        for f in P.POSTERIOR_FIELDS:
            assert torch.equal(getattr(pm.post, f), before[f])
        for f in ("correlated", "median", "spread"):
            assert torch.equal(getattr(pm, f), before[f])
        assert torch.equal(pm.stats.moments, before["moments"])

    new = P.update_task_batch(pm, 2, 100.0, 250.0)
    unchanged()
    assert not torch.equal(new.stats.moments, before["moments"])
    idx, xs, ys = _stream(len(sizes), 30, 4)
    new2 = P.update_task_batch_stream(new, idx, xs, ys)
    assert not torch.equal(new2.post.mu, new.post.mu)
    unchanged()


def test_update_without_stats_raises():
    sizes, runs = _tasks(0)
    stacked = P.stack_task_models([P.fit_task(s, r, **CPU)
                                   for s, r in zip(sizes, runs)], **CPU)
    with pytest.raises(ValueError, match="sufficient statistics"):
        P.update_task_batch(stacked, 0, 1.0, 2.0)


def test_stack_slice_unstack_match_jax():
    sizes, runs = _tasks(2)
    jms = [J.fit_task(s, r) for s, r in zip(sizes, runs)]
    pms = [P.fit_task(s, r, **CPU) for s, r in zip(sizes, runs)]
    jst = J.stack_task_models(jms)
    pst = P.stack_task_models(pms, **CPU)
    _same_model(pst, jst)
    pm = P.fit_task_batch(sizes, runs, **CPU)
    jm = J.fit_task_batch(sizes, runs)
    for pt, jt in zip(P.unstack_task_models(pm), J.unstack_task_models(jm)):
        assert pt.correlated == jt.correlated
        assert pt.median == jt.median and pt.spread == jt.spread
        for f in P.POSTERIOR_FIELDS:
            _close(getattr(pt.post, f), getattr(jt.post, f))
    one = P.slice_task_model(pm, 3)
    assert torch.equal(one.post.V, pm.post.V[3])
    sub = pm.rows([4, 0])
    assert torch.equal(sub.post.mu, pm.post.mu[[4, 0]])
    assert torch.equal(sub.median, pm.median[[4, 0]])


def _bias_pair(seed):
    rng = np.random.default_rng(seed)
    kw = dict(tau0=0.4, sigma_r=0.3, decay=0.9, empirical_bayes=True)
    jb, pb = J.BiasModel(5, 4, **kw), P.BiasModel(5, 4, **kw)
    for _ in range(4):
        rows = rng.integers(0, 5, 7)
        cols = rng.integers(0, 4, 7)
        lr = rng.normal(0, 0.3, 7)
        jb.update(rows, cols, lr)
        pb.update(rows, cols, lr)
    return jb, pb


def test_bias_model_round_trips_across_packages():
    jb, pb = _bias_pair(0)
    assert pb.to_dict() == jb.to_dict()
    for a, b in ((P.BiasModel.from_dict(jb.to_dict()), jb),
                 (J.BiasModel.from_dict(pb.to_dict()), pb)):
        assert a.to_dict() == b.to_dict()
        np.testing.assert_array_equal(a.matrix(), b.matrix())
        mean = np.full(a.shape, 10.0)
        std = np.full(a.shape, 2.0)
        np.testing.assert_array_equal(a.widen_std(mean, std),
                                      b.widen_std(mean, std))
        assert a.effective_sigma_r() == b.effective_sigma_r()
        assert a.tail_mass(1, 2, 1.1) == b.tail_mass(1, 2, 1.1)
        assert a.fold_scalar(0, 1, 5.0, 1.0) == b.fold_scalar(0, 1, 5.0, 1.0)


def test_reliability_model_round_trips_across_packages():
    kw = dict(a0=6.0, b0=2.0)
    jr, pr = J.ReliabilityModel(**kw), P.ReliabilityModel(**kw)
    for node, ok in (("a", True), ("b", False), ("a", False), ("c", True)):
        jr.record(node, ok)
        pr.record(node, ok)
    assert pr.to_dict() == jr.to_dict()
    back = J.ReliabilityModel.from_dict(pr.to_dict())
    again = P.ReliabilityModel.from_dict(jr.to_dict())
    nodes = ["a", "b", "c", "d"]
    np.testing.assert_array_equal(back.factors(nodes, 1.0),
                                  pr.factors(nodes, 1.0))
    np.testing.assert_array_equal(again.factors(nodes, 2.0),
                                  jr.factors(nodes, 2.0))


def test_float32_matches_jax_non_x64():
    sizes, runs = _tasks(0)
    idx, xs, ys = _stream(len(sizes), 25, 7)
    grid = np.geomspace(1.0, 500.0, 9)
    with _x32():
        jm = J.fit_task_batch(sizes, runs)
        assert jm.post.mu.dtype == np.float32
        jmean, jstd = J.predict_task_batch_grid(jm, grid)
        jm2 = J.update_task_batch_stream(jm, idx, xs, ys)
        jmean2, jstd2 = J.predict_task_batch(jm2, 150.0)
        jm2_corr = np.asarray(jm2.correlated)
        jm2_mom = np.asarray(jm2.stats.moments)
    pm = P.fit_task_batch(sizes, runs, device="cpu", dtype=torch.float32)
    assert pm.post.mu.dtype == torch.float32
    assert np.array_equal(pm.correlated.numpy(), np.asarray(jm.correlated))
    pmean, pstd = P.predict_task_batch_grid(pm, grid)
    _close(pmean, jmean, F32_RTOL)
    _close(pstd, jstd, F32_RTOL)
    pm2 = P.update_task_batch_stream(pm, idx, xs, ys)
    assert np.array_equal(pm2.correlated.numpy(), jm2_corr)
    _close(pm2.stats.moments, jm2_mom, F32_RTOL)
    pmean2, pstd2 = P.predict_task_batch(pm2, 150.0)
    _close(pmean2, jmean2, F32_RTOL)
    _close(pstd2, jstd2, F32_RTOL)


def test_entry_points_default_to_the_card():
    sizes, runs = _tasks(0)
    if torch.cuda.is_available():
        assert P.fit_task_batch(sizes, runs).median.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            P.fit_task_batch(sizes, runs)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            P.fit(sizes[0], runs[0])
