"""The port's multi-workflow fleet (``repro_torch.online.fleet``) and its
mesh (``repro_torch.launch.mesh``) on the CPU.

Mirrors ``tests/test_fleet.py``: the batched fleet tick over padded,
stacked ``EstimatorState``s must equal per-workflow ``tick_step`` loops
cell for cell (a deterministic case and a hypothesis property), and
``fleet_predict`` must equal ``predict_state``.  Then the port is held to
the JAX package's ``fleet_tick_step``/``fleet_predict`` on the same
states and observations at 1e-12 under x64.  The (1, 1) mesh is held
bit-exact within the port only: the reference's own
``test_single_device_mesh_degrades_bit_exact`` fails (ROADMAP Queue C).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import LotaruEstimator as JEstimator
from repro.core.profiler import BenchResult as JBench
from repro.core.state import build_state as j_build_state
from repro.online.fleet import fleet_predict as j_fleet_predict
from repro.online.fleet import fleet_slice as j_fleet_slice
from repro.online.fleet import fleet_tick_step as j_fleet_tick_step
from repro.online.fleet import stack_states as j_stack_states
from repro_torch.core import LotaruEstimator, build_state
from repro_torch.core.blr import POSTERIOR_FIELDS
from repro_torch.core.profiler import BenchResult
from repro_torch.core.tick import predict_state, tick_step
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh
from repro_torch.online.fleet import (FleetState, fleet_predict,
                                      fleet_pspecs, fleet_slice,
                                      fleet_tick_step, pad_obs, pad_state,
                                      shard_fleet, stack_states)

TOL = 1e-12
NODES = ["n0", "n1", "n2"]


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


def _bench(cls, name, cpu, io):
    return cls(node=name, cpu_events_s=cpu, matmul_gflops=100.0,
               mem_gbps=20.0, io_read_mbps=io, io_write_mbps=io,
               link_gbps=0.0)


def _make_est(n_tasks, seed, jax_package=False, decay=0.97, **kw):
    """``tests/test_fleet.py``'s estimator, from either package."""
    cls, bench = ((JEstimator, JBench) if jax_package
                  else (LotaruEstimator, BenchResult))
    if not jax_package:
        kw["device"] = "cpu"
    rng = np.random.default_rng(seed)
    local = _bench(bench, "local-cpu", 450.0, 420.0)
    benches = {n: _bench(bench, n, float(rng.uniform(500, 800)),
                         float(rng.uniform(300, 600))) for n in NODES}
    est = cls(local, benches, bias_correction=True, bias_decay=decay,
              bias_empirical_bayes=True, **kw)
    slopes = {f"t{i}": float(rng.uniform(1.0, 4.0))
              for i in range(n_tasks)}
    est.fit_tasks(list(slopes), 64.0,
                  lambda n, s, cf: slopes[n] * s / cf + 5.0,
                  n_partitions=8)
    return est


class _History:
    """A host-side raw history per task row: the median/MAD each packed
    row carries (any consistent values work — every side sees the same
    rows)."""

    def __init__(self):
        self.y = {}

    def med_spr(self, r, y):
        ys = self.y.setdefault(r, [])
        ys.append(y)
        med = float(np.median(ys))
        return med, float(1.4826 * np.median(np.abs(np.subtract(ys, med)))
                          + 1e-12)


def _rand_obs(hist, factors, t_count, size, rng, batch):
    """Packed device-de-adjust observation rows for one workflow."""
    k = int(rng.integers(0, batch + 1))
    out = []
    for _ in range(k):
        r = int(rng.integers(0, t_count))
        c = int(rng.integers(0, len(NODES)))
        y_raw = float(rng.uniform(5.0, 60.0))
        med, spr = hist.med_spr(r, y_raw / max(factors[r, c], 1e-12))
        out.append([r, c, size, y_raw, 0.0, med, spr, 1.0])
    return np.asarray(out, np.float64).reshape(k, 8)


def _fleet_vs_loops(t_counts, seeds, sizes, n_ticks, rng):
    """The invariant: fleet_tick_step == per-workflow tick_step loops."""
    states = [build_state(_make_est(t, s), NODES)[0]
              for t, s in zip(t_counts, seeds)]
    loop_states = [build_state(_make_est(t, s), NODES)[0]
                   for t, s in zip(t_counts, seeds)]
    hists = [_History() for _ in t_counts]
    factors = [s.factors.numpy() for s in states]
    fleet = stack_states(states)
    batch = 3
    for _ in range(n_ticks):
        per_wf = [_rand_obs(hists[i], factors[i], t_counts[i], sizes[i],
                            rng, batch) for i in range(len(states))]
        obs = np.stack([pad_obs(o, batch) for o in per_wf])
        fleet, fmean, fstd = fleet_tick_step(
            fleet, obs, np.asarray(sizes, np.float64))
        for i, o in enumerate(per_wf):
            loop_states[i], m, s, _y = tick_step(
                loop_states[i], pad_obs(o, batch), float(sizes[i]),
                host_deadjust=False)
            _close(fleet_slice(fmean, fleet, i), m)
            _close(fleet_slice(fstd, fleet, i), s)


def test_fleet_matches_per_workflow_loops_deterministic():
    rng = np.random.default_rng(0)
    _fleet_vs_loops(t_counts=[4, 6, 5], seeds=[10, 11, 12],
                    sizes=[32.0, 48.0, 24.0], n_ticks=4, rng=rng)


def test_fleet_matches_per_workflow_loops_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=10, deadline=None)
    @given(st.lists(st.integers(min_value=2, max_value=7),
                    min_size=1, max_size=4),
           st.integers(min_value=0, max_value=2 ** 31 - 1))
    def prop(t_counts, seed):
        rng = np.random.default_rng(seed)
        seeds = [seed % 1000 + i for i in range(len(t_counts))]
        sizes = [float(rng.uniform(16.0, 64.0)) for _ in t_counts]
        _fleet_vs_loops(t_counts, seeds, sizes, n_ticks=2, rng=rng)

    prop()


def test_fleet_predict_matches_predict_state():
    pairs = [build_state(_make_est(4, seed=1), NODES),
             build_state(_make_est(6, seed=2), NODES)]
    fleet = stack_states([p[0] for p in pairs])
    sizes = np.array([32.0, 40.0])
    pm, ps = fleet_predict(fleet, sizes)
    assert pm.shape == (2, 6, 3)
    for i, (st_i, _n) in enumerate(pairs):
        m, s = predict_state(st_i, float(sizes[i]))
        _close(fleet_slice(pm, fleet, i), m)
        _close(fleet_slice(ps, fleet, i), s)


@pytest.mark.parametrize("decay", [0.97, 1.0])
def test_fleet_matches_jax(decay):
    """The port's fleet and the JAX package's on the same fitted states
    and the same observations: every tick's matrices and the final
    leaves to 1e-12."""
    t_counts, seeds, sizes = [4, 6, 5, 2], [20, 21, 22, 23], \
        np.array([32.0, 48.0, 24.0, 56.0])
    j_states = [j_build_state(_make_est(t, s, True, decay), NODES)[0]
                for t, s in zip(t_counts, seeds)]
    p_states = [build_state(_make_est(t, s, decay=decay), NODES)[0]
                for t, s in zip(t_counts, seeds)]
    jf, pf = j_stack_states(j_states), stack_states(p_states)
    for a, b in zip(fleet_predict(pf, sizes), j_fleet_predict(jf, sizes)):
        _close(a, b)
    hists = [_History() for _ in t_counts]
    factors = [s.factors.numpy() for s in p_states]
    rng = np.random.default_rng(5)
    batch = 5
    for _ in range(4):
        obs = np.stack([pad_obs(_rand_obs(hists[i], factors[i], t, sizes[i],
                                          rng, batch), batch)
                        for i, t in enumerate(t_counts)])
        jf, jm, js = j_fleet_tick_step(jf, obs, sizes)
        pf, pm, ps = fleet_tick_step(pf, obs, sizes)
        _close(pm, jm)
        _close(ps, js)
        for w in range(len(t_counts)):
            _close(fleet_slice(pm, pf, w), j_fleet_slice(jm, jf, w))
    pst, jst = pf.state, jf.state
    _close(pst.model.stats.moments, jst.model.stats.moments)
    for f in POSTERIOR_FIELDS:
        _close(getattr(pst.model.post, f), getattr(jst.model.post, f))
    assert np.array_equal(pst.model.correlated.numpy(),
                          np.asarray(jst.model.correlated))
    for f in ("bias_counts", "bias_log_sum", "bias_log_sq", "factors"):
        _close(getattr(pst, f), getattr(jst, f))
    assert np.array_equal(pst.node_cols.numpy(), np.asarray(jst.node_cols))
    assert np.array_equal(pf.t_count.numpy(), np.asarray(jf.t_count))
    assert np.array_equal(pf.n_count.numpy(), np.asarray(jf.n_count))


def _bias_leaves(fleet, w):
    st = fleet.state
    return [st.bias_counts[w], st.bias_log_sum[w], st.bias_log_sq[w],
            st.model.stats.moments[w]]


def test_sigma_r_and_decay_are_per_workflow():
    """Two workflows with bias decay and empirical-Bayes pooling observe
    one tick together; then only the first observes.  The second's bias
    leaves and moments stay bitwise as they were, and its matrices stay
    those of its own state ticked alone: the pooled sigma_r and the decay
    trigger never reach across workflows."""
    a, b = _make_est(4, seed=30, decay=0.5), _make_est(4, seed=31, decay=0.5)
    fleet = stack_states([build_state(e, NODES)[0] for e in (a, b)])
    lone = build_state(b, NODES)[0]
    rng = np.random.default_rng(3)
    hist = _History()
    sizes = np.array([32.0, 32.0])

    def rows(pairs):
        return np.asarray([[r, c, 32.0, float(rng.uniform(5, 60)), 0.0,
                            *hist.med_spr(r, 20.0), 1.0] for r, c in pairs])

    both = [rows([(0, 0), (0, 0), (1, 2)]), rows([(2, 1), (2, 1), (3, 0)])]
    fleet, _, _ = fleet_tick_step(fleet, np.stack(both), sizes)
    lone, _, _, _ = tick_step(lone, both[1], 32.0, host_deadjust=False)
    before = [t.clone() for t in _bias_leaves(fleet, 1)]
    assert float(before[0].max()) >= 2.0       # the second has evidence
    for _ in range(3):
        obs = np.stack([pad_obs(rows([(0, 0), (1, 2), (0, 0)]), 3),
                        pad_obs([], 3)])
        fleet, mean, std = fleet_tick_step(fleet, obs, sizes)
        for x, y in zip(_bias_leaves(fleet, 1), before):
            assert torch.equal(x, y)
        m, s = predict_state(lone, 32.0)
        _close(mean[1], m)
        _close(std[1], s)
    assert not torch.equal(fleet.state.bias_counts[0],
                           fleet.state.bias_counts[1])


def test_fleet_tick_is_one_batched_pass():
    """The ops a fleet tick dispatches do not grow with W: W = 2 and W = 8
    with the same observations per workflow (so the same wave counts)
    dispatch the same number of operators."""
    from torch.profiler import ProfilerActivity, profile

    def ops(W):
        fleet = stack_states([build_state(_make_est(4, seed=40 + w), NODES)[0]
                              for w in range(W)])
        rows = np.asarray([[r, c, 32.0, 10.0 + r, 0.0, 10.0, 1.0, 1.0]
                           for r, c in ((0, 0), (1, 1), (0, 0), (2, 2))])
        obs = np.stack([rows] * W)
        fleet_tick_step(fleet, obs, np.full(W, 32.0))     # warm
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fleet_tick_step(fleet, obs, np.full(W, 32.0))
        return sum(e.count for e in prof.key_averages()
                   if e.key.startswith("aten::"))

    assert ops(2) == ops(8) > 0


def test_pad_state_real_cells_unchanged_and_validation():
    state, _names = build_state(_make_est(3, seed=5), NODES)
    padded = pad_state(state, 8, 5)
    assert padded.model.median.shape == (8,)
    assert padded.factors.shape == (8, 5)
    assert padded.bias_counts.shape == (8, 5)
    assert torch.equal(padded.factors[:3, :3], state.factors)
    assert torch.equal(padded.model.stats.moments[:3],
                       state.model.stats.moments)
    for f in POSTERIOR_FIELDS:
        assert torch.equal(getattr(padded.model.post, f)[:3],
                           getattr(state.model.post, f))
    assert padded.model.stats.log is None
    assert torch.all(padded.node_cols[3:] == -1)
    assert torch.all(padded.factors[3:, :] == 1.0)
    assert torch.equal(padded.model.post.V[3:],
                       torch.eye(2, dtype=torch.float64).expand(5, 2, 2))
    assert torch.all(padded.model.post.a[3:] == 1.5)
    assert not padded.model.correlated[3:].any()
    with pytest.raises(ValueError, match="cannot shrink"):
        pad_state(state, 2, 5)


def test_stack_states_rejects_mismatched_hyperparams():
    a = build_state(_make_est(3, seed=6), NODES)[0]
    b = build_state(_make_est(2, seed=7, decay=0.5), NODES)[0]
    with pytest.raises(ValueError, match="StateMeta"):
        stack_states([a, b])
    c, _ = build_state(_make_est(3, seed=8), NODES, rel_nodes=("n0",))
    with pytest.raises(ValueError, match="reliability slot"):
        stack_states([a, c])
    with pytest.raises(ValueError, match="at least one"):
        stack_states([])


def test_single_device_mesh_is_bit_exact():
    fleet = stack_states([build_state(_make_est(4, seed=s), NODES)[0]
                          for s in (3, 4)])
    sizes = np.array([32.0, 32.0])
    pm, ps = fleet_predict(fleet, sizes)
    mesh = make_fleet_mesh(device="cpu")
    assert mesh.axis_names == ("wf", "task")
    assert mesh.shape == {"wf": 1, "task": 1}
    assert mesh.devices.shape == (1, 1)
    sharded = shard_fleet(fleet, mesh)
    assert sharded.state.factors.data_ptr() != fleet.state.factors.data_ptr()
    pm2, ps2 = fleet_predict(sharded, sizes)
    assert torch.equal(pm2, pm) and torch.equal(ps2, ps)
    obs = np.stack([pad_obs([[0, 1, 32.0, 30.0, 0, 20.0, 1.0, 1.0]], 2)] * 2)
    _, m1, s1 = fleet_tick_step(fleet, obs, sizes)
    _, m2, s2 = fleet_tick_step(sharded, obs, sizes)
    assert torch.equal(m1, m2) and torch.equal(s1, s2)
    specs = fleet_pspecs(fleet, mesh)
    assert isinstance(specs, FleetState)
    assert specs.state.factors == ("wf", "task")
    assert specs.state.node_cols == ("wf",)


def test_multi_device_mesh_raises():
    fleet = stack_states([build_state(_make_est(3, seed=7), NODES)[0]
                          for _ in range(3)])
    cpu = torch.device("cpu")
    two = FleetMesh(devices=np.array([[cpu], [cpu]], dtype=object))
    with pytest.raises(ValueError, match="not divisible"):
        shard_fleet(fleet, two)                    # W = 3 over wf = 2
    even = stack_states([build_state(_make_est(3, seed=7), NODES)[0]] * 2)
    with pytest.raises(NotImplementedError, match="more than one device"):
        shard_fleet(even, two)
    with pytest.raises(ValueError, match="devices"):
        make_fleet_mesh(wf=2, device="cpu")


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fleet_mesh()
