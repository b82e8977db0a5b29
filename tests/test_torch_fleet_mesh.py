"""The multi-workflow fleet spread over a ("wf", "task") mesh of processes
(``repro_torch.online.fleet.shard_fleet`` on ``launch.mesh.make_fleet_mesh``
in a process group), on the CPU.

One module-scoped spawn of four gloo processes (``launch.mesh.spawn``, a
``file://`` rendezvous, joined within 180 s) forms the (2, 2), (4, 1) and
(1, 4) meshes in turn.  On each, every rank builds the same four-workflow
fleet from numpy seeds (W 4 of 3-8 tasks padded to T 8, N 3; empirical
Bayes on and off, bias decay 0.97 and 1.0), keeps its slice, predicts
before any tick and runs four ticks of the same global observations.  In
the second tick every observation lies in task rows 0-1, so every "task"
rank but the first gets none: each must still take part in the tick's
all-reduces and return.  Each rank's slices are held at 1e-12 (as |a - b|
<= 1e-12 (1 + |b|), the estimator's bar) to the JAX package's unsharded
``fleet_predict`` / ``fleet_tick_step`` under x64 and to the port's
unsharded fleet; the reference's own ``shard_fleet`` does not run under
JAX 0.9.0 (ROADMAP Queue C), so the unsharded fleet is what GSPMD's
layout promises to equal.

The workers import no JAX (the children import this module); the JAX
side runs in the test process.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import LotaruEstimator, build_state
from repro_torch.core.blr import POSTERIOR_FIELDS
from repro_torch.core.profiler import BenchResult
from repro_torch.core.tick import _stacked_tick_core, pack_waves
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Mesh, make_fleet_mesh, make_mesh, spawn
from repro_torch.online.fleet import (fleet_gather, fleet_predict,
                                      fleet_pspecs, fleet_slice,
                                      fleet_tick_step, shard_fleet,
                                      stack_states)

TOL = 1e-12
NODES = ["n0", "n1", "n2"]
T_COUNTS, SEEDS = (3, 8, 5, 6), (50, 51, 52, 53)
SIZES = np.array([32.0, 48.0, 24.0, 56.0])
W, T, N = len(T_COUNTS), max(T_COUNTS), len(NODES)
#: case -> (empirical Bayes, bias decay)
CASES = {"eb-decay": (True, 0.97), "eb": (True, 1.0),
         "fixed-decay": (False, 0.97), "fixed": (False, 1.0)}
MESHES = ((2, 2), (4, 1), (1, 4))
TICKS, BATCH = 4, 6
#: the tick whose observations all lie in task rows [0, LOW_ROWS): every
#: "task" rank of (2, 2) and (1, 4) but the first gets none
LOW_TICK, LOW_ROWS = 1, 2


def _bench(cls, name, cpu, io):
    return cls(node=name, cpu_events_s=cpu, matmul_gflops=100.0,
               mem_gbps=20.0, io_read_mbps=io, io_write_mbps=io,
               link_gbps=0.0)


def _make_est(n_tasks, seed, case, jax_package=False):
    """``tests/test_fleet.py``'s estimator with the case's bias settings,
    from either package."""
    if jax_package:
        from repro.core import LotaruEstimator as cls
        from repro.core.profiler import BenchResult as bench
        kw = {}
    else:
        cls, bench, kw = LotaruEstimator, BenchResult, {"device": "cpu"}
    eb, decay = CASES[case]
    rng = np.random.default_rng(seed)
    local = _bench(bench, "local-cpu", 450.0, 420.0)
    benches = {n: _bench(bench, n, float(rng.uniform(500, 800)),
                         float(rng.uniform(300, 600))) for n in NODES}
    est = cls(local, benches, bias_correction=True, bias_decay=decay,
              bias_empirical_bayes=eb, **kw)
    slopes = {f"t{i}": float(rng.uniform(1.0, 4.0))
              for i in range(n_tasks)}
    est.fit_tasks(list(slopes), 64.0,
                  lambda n, s, cf: slopes[n] * s / cf + 5.0,
                  n_partitions=8)
    return est


def _port_fleet(case, t_counts=T_COUNTS):
    return stack_states([build_state(_make_est(t, s, case), NODES)[0]
                         for t, s in zip(t_counts, SEEDS)])


def _obs(tick):
    """One tick's (W, BATCH, 8) rows from numpy seed ``tick``: 0 to BATCH
    valid rows a workflow (workflow 2 none in tick 0), the rest padding;
    in LOW_TICK every row lies below LOW_ROWS."""
    rng = np.random.default_rng(100 + tick)
    obs = np.zeros((W, BATCH, 8))
    for w, t in enumerate(T_COUNTS):
        k = 0 if (tick, w) == (0, 2) else int(rng.integers(1, BATCH + 1))
        top = min(t, LOW_ROWS) if tick == LOW_TICK else t
        obs[w, :k, 0] = rng.integers(0, top, k)
        obs[w, :k, 1] = rng.integers(0, N, k)
        obs[w, :k, 2] = SIZES[w] * rng.uniform(0.5, 1.5, k)
        obs[w, :k, 3] = rng.uniform(5.0, 60.0, k)
        obs[w, :k, 5] = rng.uniform(10.0, 40.0, k)
        obs[w, :k, 6] = rng.uniform(0.5, 3.0, k)
        obs[w, :k, 7] = 1.0
    return obs


def _leaves(fleet):
    """Every tensor leaf of a fleet, by name (bools as they are)."""
    st, m = fleet.state, fleet.state.model
    out = {"moments": m.stats.moments, "correlated": m.correlated,
           "median": m.median, "spread": m.spread,
           **{f: getattr(m.post, f) for f in POSTERIOR_FIELDS}}
    for f in ("factors", "node_cols", "bias_counts", "bias_log_sum",
              "bias_log_sq", "rel_succ", "rel_fail"):
        out[f] = getattr(st, f)
    out["t_count"], out["n_count"] = fleet.t_count, fleet.n_count
    return out


def _run(fleet, ticks):
    """predict before any tick, then the ticks: the (mean, std) of each
    and, for each tick, the bias counts before it."""
    outs = [fleet_predict(fleet, SIZES)]
    before = []
    for k in range(ticks):
        before.append(fleet.state.bias_counts.clone())
        fleet, m, s = fleet_tick_step(fleet, _obs(k), SIZES)
        outs.append((m, s))
    return fleet, outs, before


def _fleet_worker(rank, device, out_dir):
    results = {}
    for shape in MESHES:
        mesh = make_fleet_mesh(wf=shape[0], task=shape[1], device=device)
        for case in CASES:
            sharded = shard_fleet(_port_fleet(case), mesh)
            first = {k: v.clone() for k, v in _leaves(sharded).items()}
            sharding.reset_counts()
            outs = [fleet_predict(sharded, SIZES)]
            calls, before = [sum(sharding.CALLS.values())], []
            for k in range(TICKS):
                before.append(sharded.state.bias_counts.clone())
                sharding.reset_counts()
                sharded, m, s = fleet_tick_step(sharded, _obs(k), SIZES)
                calls.append(sum(sharding.CALLS.values()))
                outs.append((m, s))
            results[shape, case] = {
                "coords": mesh.coords, "first": first,
                "outs": outs, "before": before,
                "calls": calls, "leaves": _leaves(sharded),
                "gathered": (fleet_gather(m, sharded),
                             fleet_gather(s, sharded)),
                "slices": [torch.from_numpy(fleet_slice(m, sharded, w))
                           for w in range(W)]}
        errors = []
        if shape == (2, 2):
            three = stack_states([build_state(
                _make_est(t, s, "eb"), NODES)[0]
                for t, s in zip(T_COUNTS[:3], SEEDS)])
            for make in (lambda: shard_fleet(three, mesh),
                         lambda: make_fleet_mesh(wf=3, task=2,
                                                 device=device),
                         lambda: make_fleet_mesh(task=3, device=device)):
                try:
                    make()
                    errors.append("")
                except ValueError as e:
                    errors.append(str(e))
        if shape == (1, 4):
            try:
                shard_fleet(_port_fleet("eb", (3, 6, 5, 6)), mesh)
                errors.append("")
            except ValueError as e:
                errors.append(str(e))
        results[shape, "errors"] = errors
    torch.save(results, out_dir / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of the four-process run."""
    out = tmp_path_factory.mktemp("fleet_mesh")
    spawn(_fleet_worker, 4, (out,), rendezvous=out / "rendezvous",
          backend="gloo", device="cpu", timeout_s=180)
    return [torch.load(out / f"rank{r}.pt") for r in range(4)]


def _as_np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


@pytest.fixture(scope="module")
def port_refs():
    """The port's unsharded fleet: (first leaves, outputs, final leaves,
    the bias counts before each tick, each leaf's spec) of each case."""
    refs = {}
    for case in CASES:
        fleet = _port_fleet(case)
        first = {k: v.clone() for k, v in _leaves(fleet).items()}
        specs = _leaves(fleet_pspecs(fleet, _mesh((1, 1), (0, 0))))
        fleet, outs, before = _run(fleet, TICKS)
        refs[case] = (first, outs, _leaves(fleet), before, specs)
    return refs


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's unsharded fleet under x64: the outputs and the
    final leaves of each case, as numpy arrays."""
    import jax

    from repro.core.state import build_state as j_build_state
    from repro.online.fleet import fleet_predict as j_fleet_predict
    from repro.online.fleet import fleet_tick_step as j_fleet_tick_step
    from repro.online.fleet import stack_states as j_stack_states
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    try:
        refs = {}
        for case in CASES:
            fleet = j_stack_states([
                j_build_state(_make_est(t, s, case, True), NODES)[0]
                for t, s in zip(T_COUNTS, SEEDS)])
            outs = [tuple(map(np.asarray, j_fleet_predict(fleet, SIZES)))]
            for k in range(TICKS):
                fleet, m, s = j_fleet_tick_step(fleet, _obs(k), SIZES)
                outs.append((np.asarray(m), np.asarray(s)))
            refs[case] = (outs, {k: np.asarray(v)
                                 for k, v in _leaves(fleet).items()})
        return refs
    finally:
        jax.config.update("jax_enable_x64", prev)
        jax.clear_caches()


def _mesh(shape, coords):
    """The rank's mesh, for ``Sharding.slices`` (no group needed)."""
    return Mesh(("wf", "task"), shape, tuple(coords))


def _slice(x, spec, mesh):
    return x[sharding.Sharding(mesh, spec).slices(x.shape)]


def _close(a, b, what):
    a, b = _as_np(a), _as_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.max(np.abs(a - b) / (1.0 + np.abs(b)), initial=0.0))
    assert err <= TOL, (what, err)


def _held_to(rank, shape, case, outs, leaves, specs):
    """Every output and final leaf of one rank against the slices of an
    unsharded fleet's."""
    r = rank[shape, case]
    mesh = _mesh(shape, r["coords"])
    spec3 = ("wf", "task")
    for k, ((m, s), (rm, rs)) in enumerate(zip(r["outs"], outs)):
        _close(m, _slice(_as_np(rm), spec3, mesh), (shape, case, k, "mean"))
        _close(s, _slice(_as_np(rs), spec3, mesh), (shape, case, k, "std"))
    for name, leaf in r["leaves"].items():
        _close(leaf, _slice(_as_np(leaves[name]), specs[name], mesh),
               (shape, case, name))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_fleet_matches_the_ports_unsharded_fleet(ranks, port_refs,
                                                         shape, case):
    _first, outs, leaves, _before, specs = port_refs[case]
    for rank in ranks:
        _held_to(rank, shape, case, outs, leaves, specs)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_fleet_matches_the_jax_unsharded_fleet(ranks, jax_refs,
                                                       port_refs, shape,
                                                       case):
    outs, leaves = jax_refs[case]
    specs = port_refs[case][4]
    for rank in ranks:
        _held_to(rank, shape, case, outs, leaves, specs)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_keeps_its_slice(ranks, port_refs, shape):
    """After ``shard_fleet`` each rank's leaves are the ``Sharding.slices``
    of the global ones, bit for bit, and distinct ranks hold distinct
    blocks."""
    seen = set()
    for case in CASES:
        first, specs = port_refs[case][0], port_refs[case][4]
        for rank in ranks:
            r = rank[shape, case]
            mesh = _mesh(shape, r["coords"])
            for name, leaf in r["first"].items():
                assert torch.equal(leaf, _slice(first[name], specs[name],
                                                mesh)), (shape, case, name)
            assert r["first"]["factors"].shape == (W // shape[0],
                                                   T // shape[1], N)
            seen.add(tuple(r["coords"]))
    assert len(seen) == 4


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gather_and_slice_on_every_rank(ranks, port_refs, shape):
    """``fleet_gather`` gives every rank the whole (W, T, N) matrices and
    ``fleet_slice`` each workflow's real cells, as the unsharded fleet."""
    for case in CASES:
        m, s = port_refs[case][1][-1]
        for rank in ranks:
            r = rank[shape, case]
            _close(r["gathered"][0], m, (shape, case, "gather mean"))
            _close(r["gathered"][1], s, (shape, case, "gather std"))
            for w in range(W):
                ref = m[w, :T_COUNTS[w], :N]
                _close(r["slices"][w], ref, (shape, case, w))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_task_rank_without_observations_still_reduces(ranks, port_refs,
                                                        shape):
    """In LOW_TICK every observation lies in the first "task" rank's rows.
    The other ranks still take part in the tick's three all-reduces, and
    with bias decay their bias counts decay with their workflows (the
    decay trigger is a flag over "task"), as the unsharded fleet's do."""
    obs = _obs(LOW_TICK)
    assert np.all(obs[obs[..., 7] > 0, 0] < LOW_ROWS)
    assert LOW_ROWS <= T // shape[1]
    before = port_refs["eb-decay"][3]
    idle = [r[shape, "eb-decay"] for r in ranks
            if r[shape, "eb-decay"]["coords"][1] > 0]
    assert len(idle) == 4 - shape[0]
    decayed = 0
    for r in idle:
        mesh = _mesh(shape, r["coords"])
        b0, b1 = r["before"][LOW_TICK], r["before"][LOW_TICK + 1]
        assert torch.all(b1 <= b0)                # nothing observed
        decayed += int(not torch.equal(b0, b1))
        for got, ref in ((b0, before[LOW_TICK]),
                         (b1, before[LOW_TICK + 1])):
            _close(got, _slice(ref, ("wf", "task"), mesh), "bias counts")
        assert r["calls"][1 + LOW_TICK] == 3
    assert decayed > 0


def test_reductions_go_over_task_only(ranks):
    """All-reduces a call (predict, then each tick): none where the mesh's
    "task" axis is one rank; else one for each ``sigma_r`` (tick start and
    the fold; empirical Bayes only) and one for the decay flag."""
    for shape in MESHES:
        for case, (eb, decay) in CASES.items():
            per_tick = (2 * eb + (decay != 1.0)) if shape[1] > 1 else 0
            per_predict = int(eb) if shape[1] > 1 else 0
            for rank in ranks:
                assert rank[shape, case]["calls"] == \
                    [per_predict] + [per_tick] * TICKS, (shape, case)


def test_divisibility_errors_on_a_process_mesh(ranks):
    for rank in ranks:
        w3, mesh32, task3 = rank[(2, 2), "errors"]
        assert "W=3 not divisible by mesh wf axis (2)" in w3
        assert "needs 6 processes, the world has 4" in mesh32
        assert "4 processes not divisible by task=3" in task3
        t6, = rank[(1, 4), "errors"]
        assert "T=6 not divisible by mesh task axis (4)" in t6


def test_one_process_mesh_is_the_unsharded_fleet_bit_for_bit():
    """A fleet on a ``Mesh`` of one process takes the sharded code path
    (observation routing, the sizes' slice, ``sum_over`` over a "task" of
    one rank) and equals the unsharded fleet bit for bit, with no
    collective."""
    mesh = make_mesh((1, 1), ("wf", "task"), device="cpu")
    for case in CASES:
        whole = _port_fleet(case)
        sharded = shard_fleet(_port_fleet(case), mesh)
        assert sharded.mesh is mesh
        sharding.reset_counts()
        a, outs_a, _ = _run(whole, TICKS)
        b, outs_b, _ = _run(sharded, TICKS)
        assert not sharding.CALLS
        for (ma, sa), (mb, sb) in zip(outs_a, outs_b):
            assert torch.equal(ma, mb) and torch.equal(sa, sb), case
        for name, leaf in _leaves(a).items():
            assert torch.equal(leaf, _leaves(b)[name]), (case, name)
        assert fleet_gather(outs_b[-1][0], b) is outs_b[-1][0]


def test_default_hook_is_the_one_process_tick():
    """The tick core's reduction hook at its default adds nothing: a hook
    that records its calls and returns its tensors gives the same bits,
    the same operators, and is called the same number of times, in the
    same order, whatever the observations (the sequence depends on the
    fleet's ``StateMeta`` alone)."""
    from torch.profiler import ProfilerActivity, profile

    def tick(fleet, obs, reduce=None):
        st = fleet.state
        packed, wm, wb = pack_waves(obs, N, T)
        kw = {} if reduce is None else {"reduce": reduce}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, m, s, _ = _stacked_tick_core(
                st, torch.from_numpy(packed), torch.from_numpy(SIZES),
                False, (wm, wb), **kw)
        ops = sum(e.count for e in prof.key_averages()
                  if e.key.startswith("aten::"))
        return m, s, ops

    calls = []

    def spy(*tensors):
        calls.append(tuple(t.dtype for t in tensors))
        return tensors

    a, b = _port_fleet("eb-decay"), _port_fleet("eb-decay")
    for k in range(TICKS):
        del calls[:]
        ma, sa, na = tick(a, _obs(k))
        mb, sb, nb = tick(b, _obs(k), spy)
        assert torch.equal(ma, mb) and torch.equal(sa, sb)
        assert na == nb
        assert calls == [(torch.float64, torch.float64, torch.bool),
                         (torch.bool,),
                         (torch.float64, torch.float64, torch.bool)]
    for name, leaf in _leaves(a).items():
        assert torch.equal(leaf, _leaves(b)[name]), name


def test_sum_over_sums_and_ors_over_one_axis_of_one_rank():
    """Over an axis of one rank ``sum_over`` returns its tensors as they
    are and launches nothing (the multi-rank sums run in the spawn)."""
    mesh = make_mesh((1, 1), ("wf", "task"), device="cpu")
    ts = (torch.ones(2, 1, 1, dtype=torch.float64),
          torch.tensor([True, False]))
    sharding.reset_counts()
    out = sharding.sum_over(ts, "task", mesh)
    assert all(a is b for a, b in zip(out, ts))
    assert not sharding.CALLS
