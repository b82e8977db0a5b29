"""The port's fused tick (``repro_torch.core.state`` / ``core.tick``) held
to the JAX package's on the CPU.

Both packages fit the same workflow from simulators with the same seeds
(as ``tests/test_torch_estimator.py``), then every number the executor
consumes — the estimate matrices, ``observe_batch``'s local runtimes,
intervals, PIT values, bias points and tail masses, and the estimator
after ``finalize`` — must agree to <= 1e-12 (``tests/test_tick_engine.py``'s
bar, under x64).  The port's own properties are held bitwise: padding
rows are inert, the bias scatter sums a pair's terms in input order, and
the tick updates the state's leaves in place.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import LotaruEstimator as JEstimator
from repro.core import get_node, profile_cluster, profile_node, target_nodes
from repro.core.state import build_state as j_build_state
from repro.core.tick import TickEngine as JTickEngine
from repro.core.tick import predict_state as j_predict_state
from repro.core.tick import tick_step as j_tick_step
from repro.sched.simulator import ClusterSimulator as JSim
from repro.sched.workflows import INPUTS, WORKFLOWS
from repro_torch.core import LotaruEstimator as PEstimator
from repro_torch.core import blr as P
from repro_torch.core import state as pstate
from repro_torch.core import tick as ptick
from repro_torch.core.profiler import BenchResult as PBench
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


def _fitted_pair(cluster, wf, *, seed=0, **kw):
    local, local_bench, tbenches = cluster
    size = INPUTS[(wf, 1)]
    names = [t.name for t in WORKFLOWS[wf]]
    j_by = {t.name: t for t in WORKFLOWS[wf]}
    p_by = {t.name: t for t in P_WORKFLOWS[wf]}
    jsim, psim = JSim(seed=seed), PSim(seed=seed)
    je = JEstimator(local_bench, tbenches, **kw)
    je.fit_tasks(names, size, lambda n, s, cf: jsim.run_task(
        j_by[n], local, s, cpu_factor=cf))
    pe = PEstimator(PBench(**local_bench.to_dict()),
                    {k: PBench(**v.to_dict()) for k, v in tbenches.items()},
                    device="cpu", **kw)
    pe.fit_tasks(names, size, lambda n, s, cf: psim.run_task(
        p_by[n], local, s, cpu_factor=cf))
    return je, pe, names, size


def _arr(x):
    return (P._np(x) if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float64))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_arr(a), _arr(b), rtol=tol, atol=tol)


def _batches(names, nodes, size, seed, ticks=6, most=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ticks):
        k = int(rng.integers(1, most + 1))
        out.append([(names[int(rng.integers(0, len(names)))],
                     nodes[int(rng.integers(0, len(nodes)))],
                     size * float(rng.uniform(0.5, 1.5)),
                     float(rng.uniform(5.0, 80.0))) for _ in range(k)])
    return out


def _engines_agree(je, pe, names, nodes, size, batches):
    """Drive a JAX and a port TickEngine through the same ticks and hold
    every per-tick surface to TOL; then finalize both and compare the
    estimators they write back into."""
    jt = JTickEngine(je, nodes, size=size)
    pt = ptick.TickEngine(pe, nodes, size=size)
    for a, b in zip(pt.predict_matrix(nodes, size),
                    jt.predict_matrix(nodes, size)):
        _close(a, b)
    for batch in batches:
        _close(pt.observe_batch(batch), jt.observe_batch(batch))
        for a, b in zip(pt.predict_matrix(nodes, size),
                        jt.predict_matrix(nodes, size)):
            _close(a, b)
        for n in names[:4]:
            for node in nodes[:3]:
                _close(pt.predict_interval_node(n, node, size, 0.9),
                       jt.predict_interval_node(n, node, size, 0.9))
                for rt in (30.0, 300.0):
                    assert pt.predict_pit_node(n, node, size, rt) == \
                        pytest.approx(jt.predict_pit_node(n, node, size, rt),
                                      rel=TOL, abs=TOL)
                assert pt.bias_point(n, node) == pytest.approx(
                    jt.bias_point(n, node), rel=TOL, abs=TOL)
                assert pt.bias_tail_mass(n, node, 1.1) == pytest.approx(
                    jt.bias_tail_mass(n, node, 1.1), rel=TOL, abs=TOL)
    jt.finalize()
    pt.finalize()
    for n in names:
        assert pe.tasks[n].model.correlated == je.tasks[n].model.correlated
        for node in nodes:
            _close(pe.predict(n, node, size), je.predict(n, node, size))
    _close(pe.bias.counts, je.bias.counts)
    _close(pe.bias.log_sum, je.bias.log_sum)
    _close(pe.bias.log_sq, je.bias.log_sq)
    for a, b in zip(pe.predict_matrix(nodes, size),
                    je.predict_matrix(nodes, size)):
        _close(a, b)
    return pt


# ---------------------------------------------------------------------------
# the engine, surface by surface, on all five workflows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wf", list(WORKFLOWS))
def test_tick_engine_matches_jax(cluster, wf):
    je, pe, names, size = _fitted_pair(cluster, wf,
                                       bias_empirical_bayes=True)
    nodes = [nt.name for nt in target_nodes()]
    pt = _engines_agree(je, pe, names, nodes, size,
                        _batches(names, nodes, size, 3))
    assert pt.fetches == 1 + 6          # one device->host copy a tick


@pytest.mark.parametrize("decay", [1.0, 0.8])
@pytest.mark.parametrize("eb", [False, True], ids=["fixed_sigma", "eb"])
def test_tick_engine_decay_and_empirical_bayes_match_jax(cluster, decay, eb):
    je, pe, names, size = _fitted_pair(cluster, "chipseq", bias_decay=decay,
                                       bias_empirical_bayes=eb)
    nodes = [nt.name for nt in target_nodes()]
    _engines_agree(je, pe, names, nodes, size,
                   _batches(names, nodes, size, 11, ticks=8, most=6))


def test_tick_engine_matches_port_legacy_observe_batch(cluster):
    """The port's mirror of ``test_tick_engine_matches_legacy_observe_batch``:
    the engine against the port's own estimator path."""
    _, pa, names, size = _fitted_pair(cluster, "eager",
                                      bias_empirical_bayes=True)
    _, pb, _, _ = _fitted_pair(cluster, "eager", bias_empirical_bayes=True)
    nodes = [nt.name for nt in target_nodes()]
    engine = ptick.TickEngine(pb, nodes, size=size)
    assert all(engine._F[i, j] == pb.factor(n, node)
               for i, n in enumerate(names) for j, node in enumerate(nodes))
    for batch in _batches(names, nodes, size, 5):
        _close(engine.observe_batch(batch), pa.observe_batch(batch))
        for a, b in zip(engine.predict_matrix(nodes, size),
                        pa.predict_matrix(nodes, size)):
            _close(a, b)
        for n in names[:3]:
            _close(engine.predict_interval_node(n, nodes[1], size),
                   pa.predict_interval_node(n, nodes[1], size))
    engine.finalize()
    for n in names:
        for node in nodes:
            _close(pb.predict(n, node, size), pa.predict(n, node, size))


# ---------------------------------------------------------------------------
# tick_step on packed rows, both de-adjust modes
# ---------------------------------------------------------------------------
def _packed(size):
    obs = np.zeros((6, 8))
    obs[0] = [0, 0, size, 25.0, 25.0, 25.0, 1.0, 1.0]
    obs[1] = [1, 1, size, 40.0, 40.0, 40.0, 1.0, 0.0]   # masked row
    obs[2] = [0, 0, 0.7 * size, 35.0, 30.0, 27.0, 2.0, 1.0]
    obs[3] = [2, 3, size, 50.0, 45.0, 45.0, 1.5, 1.0]
    obs[4] = [0, 2, 1.2 * size, 31.0, 29.0, 26.0, 2.5, 1.0]
    obs[5] = [2, 3, size, 0.0, 1.0, 45.0, 1.5, 1.0]     # no residual
    return obs


def _states_close(ps, js):
    _close(ps.model.stats.moments, js.model.stats.moments)
    for f in P.POSTERIOR_FIELDS:
        _close(getattr(ps.model.post, f), getattr(js.model.post, f))
    assert np.array_equal(ps.model.correlated.numpy(),
                          np.asarray(js.model.correlated))
    _close(ps.model.median, js.model.median)
    _close(ps.model.spread, js.model.spread)
    for f in ("factors", "bias_counts", "bias_log_sum", "bias_log_sq",
              "rel_succ", "rel_fail"):
        _close(getattr(ps, f), getattr(js, f))
    assert np.array_equal(ps.node_cols.numpy(), np.asarray(js.node_cols))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("host_deadjust", [True, False],
                         ids=["host_deadjust", "device_deadjust"])
def test_tick_step_matches_jax(cluster, host_deadjust, bias):
    je, pe, names, size = _fitted_pair(cluster, "bacass",
                                       bias_correction=bias, bias_decay=0.9,
                                       bias_empirical_bayes=True)
    nodes = [nt.name for nt in target_nodes()]
    js, jnames = j_build_state(je, nodes)
    ps, pnames = pstate.build_state(pe, nodes)
    assert vars(pnames) == vars(jnames)
    assert vars(ps.meta) == vars(js.meta)
    _states_close(ps, js)
    for a, b in zip(ptick.predict_state(ps, size),
                    j_predict_state(js, size)):
        _close(a, b)
    for _ in range(2):              # a second tick reads the first's bias
        js, jm, jsd, jy = j_tick_step(js, _packed(size), size,
                                      host_deadjust=host_deadjust)
        ps, pm, psd, py = ptick.tick_step(ps, _packed(size), size,
                                          host_deadjust=host_deadjust)
        _close(pm, jm)
        _close(psd, jsd)
        _close(py, jy)
        _states_close(ps, js)


def test_tick_step_updates_in_place_and_matches_predict_matrix(cluster):
    """The port's counterpart of donation: the returned state holds the
    input's tensors, updated in place; the masked row stays as it was."""
    _, pe, _, size = _fitted_pair(cluster, "bacass")
    nodes = [nt.name for nt in target_nodes()]
    state, _ = pstate.build_state(pe, nodes)
    for a, b in zip(ptick.predict_state(state, size),
                    pe.predict_matrix(nodes, size)):
        _close(a, b)
    moments = state.model.stats.moments
    before = moments.clone()
    new, mean, _, _ = ptick.tick_step(state, _packed(size)[:2], size,
                                      host_deadjust=True)
    assert new.model.stats.moments is moments
    assert new.bias_counts is state.bias_counts
    assert torch.isfinite(mean).all()
    assert not torch.equal(moments[0], before[0])   # live row absorbed
    assert torch.equal(moments[1], before[1])       # masked row untouched
    # the estimator's own tensors are not the state's
    _, model, _ = pe._batched()
    assert model.stats.moments.data_ptr() != moments.data_ptr()


def _leaves(state):
    m = state.model
    out = [m.stats.moments, m.correlated, m.median, m.spread,
           state.bias_counts, state.bias_log_sum, state.bias_log_sq]
    return out + [getattr(m.post, f) for f in P.POSTERIOR_FIELDS]


@pytest.mark.parametrize("host_deadjust", [True, False],
                         ids=["host_deadjust", "device_deadjust"])
def test_padded_rows_leave_every_leaf_bitwise(cluster, host_deadjust):
    """Invalid rows interleaved anywhere — on rows and pairs the valid
    rows also hit — change no bit of any leaf or output."""
    _, pe, _, size = _fitted_pair(cluster, "chipseq", bias_decay=0.8,
                                  bias_empirical_bayes=True)
    nodes = [nt.name for nt in target_nodes()]
    obs = _packed(size)
    obs = obs[obs[:, 7] > 0]
    rng = np.random.default_rng(4)
    junk = np.column_stack([obs[rng.integers(0, len(obs), 7), :7],
                            np.zeros(7)])
    junk[:, 3] *= 3.0
    padded = np.insert(obs, [0, 1, 1, 3, 4, 4, 4], junk, axis=0)
    assert padded.shape[0] == len(obs) + 7
    outs = []
    for batch in (obs, padded):
        state, _ = pstate.build_state(pe, nodes)
        for _ in range(2):
            state, mean, std, y = ptick.tick_step(state, batch, size,
                                                  host_deadjust)
        outs.append((state, mean, std, y[batch[:, 7] > 0]))
    (a, ma, sa, ya), (b, mb, sb, yb) = outs
    for x, z in zip(_leaves(a) + [ma, sa, ya], _leaves(b) + [mb, sb, yb]):
        assert torch.equal(x, z)


@pytest.mark.parametrize("pad", ["bucket", "plus_five"])
def test_padded_waves_leave_every_leaf_bitwise(cluster, pad):
    """Wave counts past the last occurrence rank (the CUDA graph's
    ``_bucket_waves``) change no bit of any leaf or output."""
    _, pe, _, size = _fitted_pair(cluster, "chipseq", bias_decay=0.8,
                                  bias_empirical_bayes=True)
    nodes = [nt.name for nt in target_nodes()]
    packed, wm, wb = ptick.pack_waves(_packed(size), len(nodes))
    more = {"bucket": ptick._bucket_waves, "plus_five": lambda n: n + 5}[pad]
    assert (more(wm), more(wb)) != (wm, wb)
    size_t = torch.tensor(size, dtype=torch.float64)
    outs = []
    for waves in ((wm, wb), (more(wm), more(wb))):
        state, _ = pstate.build_state(pe, nodes)
        for _ in range(2):
            state, mean, std, y = ptick._tick_core(
                state, torch.tensor(packed), size_t, True, waves)
        outs.append(_leaves(state) + [mean, std, y])
    for x, z in zip(*outs):
        assert torch.equal(x, z)


def test_bucket_waves_rounds_up_to_a_power_of_two():
    got = [ptick._bucket_waves(n) for n in (0, 1, 2, 3, 4, 5, 11, 16, 17)]
    assert got == [1, 1, 2, 4, 4, 8, 16, 16, 32]


def test_bias_scatter_sums_a_pair_in_input_order(cluster):
    """A pair hit many times in one tick: the port's wave scatter equals a
    sequential host scatter (``np.add.at``) bit for bit, like the JAX
    package's ``.at[].add``."""
    _, pe, _, size = _fitted_pair(cluster, "chipseq")
    nodes = [nt.name for nt in target_nodes()]
    state, _ = pstate.build_state(pe, nodes)
    rng = np.random.default_rng(9)
    B = 40
    obs = np.zeros((B, 8))
    obs[:, 0] = rng.choice([1, 4], B)
    obs[:, 1] = rng.choice([0, 2], B)
    obs[:, 2] = size * rng.uniform(0.5, 1.5, B)
    obs[:, 3] = rng.uniform(1.0, 1e4, B)
    obs[:, 4] = obs[:, 3]
    obs[:, 5:7] = [30.0, 1.0]
    obs[:, 7] = rng.random(B) > 0.2
    counts0 = state.bias_log_sum.numpy().copy()
    packed, wm, wb = ptick.pack_waves(obs, len(nodes))
    assert wm > 10 and wb > 5
    new, _, _, _ = ptick.tick_step(state, obs, size, True)
    # the residuals the tick took, against the post-update means
    post = new.model.post
    rows = obs[:, 0].astype(int)
    mean_b, _ = P._predict_core(*(getattr(post, f)[rows]
                                  for f in P.POSTERIOR_FIELDS),
                                torch.tensor(obs[:, 2:3]))
    m_post = np.where(new.model.correlated.numpy()[rows],
                      np.maximum(mean_b.numpy()[:, 0], 0.0),
                      new.model.median.numpy()[rows])
    f = state.factors.numpy()[rows, obs[:, 1].astype(int)]
    ok = obs[:, 7] > 0
    lr = np.log(obs[ok, 3] / (f[ok] * m_post[ok]))
    cols = new.node_cols.numpy()[obs[ok, 1].astype(int)]
    expect = counts0.copy()
    np.add.at(expect, (rows[ok], cols), lr)
    assert np.array_equal(new.bias_log_sum.numpy(), expect)


def test_cuda_graph_is_for_the_card_only(cluster):
    _, pe, _, size = _fitted_pair(cluster, "bacass")
    nodes = [nt.name for nt in target_nodes()]
    assert not ptick.TickEngine(pe, nodes, size=size).cuda_graph
    with pytest.raises(ValueError, match="CUDA"):
        ptick.TickEngine(pe, nodes, size=size, cuda_graph=True)


def test_wave_ranks_count_earlier_valid_occurrences():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 5, 200)
    valid = rng.random(200) > 0.3
    rank = ptick._wave_ranks(keys, valid)
    seen = {}
    for k, (key, ok) in enumerate(zip(keys, valid)):
        if ok:
            assert rank[k] == seen.get(key, 0)
            seen[key] = seen.get(key, 0) + 1
        else:
            assert rank[k] == -1
    assert ptick._wave_ranks(keys[:0], valid[:0]).shape == (0,)


def test_build_state_views_and_write_back_match_jax(cluster):
    from repro.core.state import bias_view as j_bias_view
    from repro.core.state import reliability_view as j_rel_view
    je, pe, names, size = _fitted_pair(cluster, "methylseq")
    nodes = [nt.name for nt in target_nodes()]
    batch = _batches(names, nodes, size, 2, ticks=1, most=5)[0]
    je.observe_batch(batch)
    pe.observe_batch(batch)
    for est in (je, pe):
        est.record_attempt("n1", True)
        est.record_attempt("n2", False)
    js, _ = j_build_state(je, nodes, rel_nodes=("n1", "n2", "n3"))
    ps, _ = pstate.build_state(pe, nodes, rel_nodes=("n1", "n2", "n3"))
    _states_close(ps, js)
    jb, pb = j_bias_view(js), pstate.bias_view(ps)
    for f in ("counts", "log_sum", "log_sq"):
        _close(getattr(pb, f), getattr(jb, f))
    assert (pb.tau0, pb.sigma_r, pb.decay) == (jb.tau0, jb.sigma_r, jb.decay)
    _, pnames = pstate.build_state(pe, nodes, rel_nodes=("n1", "n2", "n3"))
    assert pstate.reliability_view(ps, pnames).to_dict() == \
        j_rel_view(js, pnames).to_dict()
    with pytest.raises(ValueError, match="repeat"):
        pstate.build_state(pe, nodes + nodes[:1])
    pstate.write_back(ps, pnames, pe)
    for a, b in zip(pe.predict_matrix(nodes, size),
                    je.predict_matrix(nodes, size)):
        _close(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_log_batch_helpers_equal_the_scalar_ones(seed):
    """``SampleLog.extend`` gives the arrays of one ``append`` a sample,
    and ``median_spread_rows`` the numbers of ``median_spread`` bit for
    bit (odd and even counts, repeated values, capacity growth)."""
    rng = np.random.default_rng(seed)
    T, C = 12, 3
    count = rng.integers(1, C + 1, T)
    x = np.zeros((T, C))
    y = np.where(np.arange(C)[None, :] < count[:, None],
                 rng.choice([1.0, 2.5, 7.0, 0.1], (T, C)), 0.0)
    a = P.SampleLog(x.copy(), y.copy(), count.copy())
    b = a.copy()
    rows = rng.integers(0, T, 40)
    xs, ys = rng.uniform(1, 9, 40), np.round(rng.uniform(1, 9, 40), 1)
    for i, xv, yv in zip(rows, xs, ys):
        a.append(int(i), xv, yv)
    b.extend(rows, xs, ys)
    assert np.array_equal(a.count, b.count)
    assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)
    med, spr = b.median_spread_rows(np.arange(T))
    for i in range(T):
        m, s = a.median_spread(i)
        assert (med[i], spr[i]) == (m, s)
