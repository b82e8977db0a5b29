"""HEFT (Topcuoglu et al.) + Lotaru-informed variants.

The paper's motivation (§2.2): HEFT-class schedulers need runtime estimates
for every (task, node) pair, which Lotaru supplies online.  We implement:

  * ``heft_schedule``     — classic HEFT over a (task x node) estimate matrix
  * uncertainty-aware variant: ranks use mean + k*sigma (Bayesian predictive
    std from Lotaru), penalising placements whose runtime is *uncertain* —
    the paper's "advanced scheduling methods" consumer.
  * data-aware variant — per-edge data volumes priced by a per-node-pair
    transfer matrix (``CommCosts``): the canonical algorithm's compute
    PLUS communication ranking/placement.  The transfer term vanishes on
    same-node placement and is discounted within a zone (the matrix comes
    from ``repro_torch.sched.simulator.Topology``); ``comm=None`` is bit-exact
    with the compute-only schedule.
  * straggler mitigation — runtime > mean + k*sigma triggers speculative
    re-execution on the fastest idle node.
  * elastic rescheduling — on node loss/join, unfinished tasks re-ranked.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SchedTask:
    id: str
    succ: list[str] = field(default_factory=list)
    pred: list[str] = field(default_factory=list)


class CommCosts:
    """Per-edge data volumes priced by a per-node-pair transfer matrix.

    ``edge_gb`` maps index edges ``(p, s)`` (or is a dense (T, T) array,
    ``data[p, s]``) to the data volume task ``p`` ships to ``s``;
    ``secs_per_gb`` is the (N, N) node-pair transfer price in seconds
    per GB with an all-zero diagonal — moving data to yourself is free,
    which is exactly how the transfer term vanishes on same-node
    placement (a ``Topology`` additionally discounts same-zone pairs).

    The EFT inner loop charges the *placement-dependent* term
    ``finish[p] + gb * secs_per_gb[node(p), n]`` per candidate node
    ``n``, vectorised over the node axis (O(E·N) total — the schedule
    stays O(T·N) for the bounded-degree DAGs the generator emits).  The
    upward rank uses the classic placement-free average,
    ``gb * mean(secs_per_gb)``.
    """

    def __init__(self, pred: list[list[int]], edge_gb,
                 secs_per_gb: np.ndarray):
        spg = np.asarray(secs_per_gb, np.float64)
        if spg.ndim != 2 or spg.shape[0] != spg.shape[1]:
            raise ValueError(f"secs_per_gb must be square (N, N), got "
                             f"shape {spg.shape}")
        if (spg < 0).any():
            raise ValueError("secs_per_gb has negative entries")
        if np.diag(spg).any():
            raise ValueError("secs_per_gb diagonal must be zero: same-node "
                             "transfers are free by definition")
        self.secs_per_gb = spg
        self.mean_secs_per_gb = float(spg.mean())
        T = len(pred)
        dense = None
        if isinstance(edge_gb, np.ndarray):
            dense = np.asarray(edge_gb, np.float64)
            if dense.shape != (T, T):
                raise ValueError(f"dense edge_gb must be (T, T) = ({T}, "
                                 f"{T}), got {dense.shape}")
        self.pred_idx: list[np.ndarray] = []
        self.pred_gb: list[np.ndarray] = []
        for t in range(T):
            pi = np.asarray(pred[t], np.int64)
            if dense is not None:
                gb = dense[pi, t] if len(pi) else np.zeros(0)
            else:
                gb = np.array([float(edge_gb.get((int(p), t), 0.0))
                               for p in pi])
            if (gb < 0).any():
                raise ValueError(f"edge data size is negative on an edge "
                                 f"into task {t}")
            self.pred_idx.append(pi)
            self.pred_gb.append(np.asarray(gb, np.float64))

    def edge_comm(self, succ: list[list[int]]) -> list[list[float]]:
        """Average (placement-free) comm cost per edge, aligned with
        ``succ`` — what the upward rank consumes."""
        gb_in: dict[tuple[int, int], float] = {}
        for t, (pi, gb) in enumerate(zip(self.pred_idx, self.pred_gb)):
            for p, g in zip(pi, gb):
                gb_in[(int(p), t)] = float(g)
        return [[gb_in.get((t, s), 0.0) * self.mean_secs_per_gb
                 for s in succ[t]] for t in range(len(succ))]

    def ready_floor(self, t: int, finish: np.ndarray,
                    assignment: np.ndarray) -> np.ndarray | None:
        """(N,) data-arrival floor of task ``t`` over candidate nodes,
        given its already-placed predecessors; None for a root."""
        pi = self.pred_idx[t]
        if not len(pi):
            return None
        arr = (finish[pi][:, None]
               + self.pred_gb[t][:, None] * self.secs_per_gb[assignment[pi]])
        return arr.max(axis=0)


def _upward_rank(tasks: dict[str, SchedTask], cost: dict[str, dict[str, float]],
                 comm: float = 0.0,
                 edge_comm: dict[tuple[str, str], float] | None = None
                 ) -> dict[str, float]:
    mean_cost = {t: float(np.mean(list(cost[t].values()))) for t in tasks}
    rank: dict[str, float] = {}

    def rec(tid: str) -> float:
        if tid in rank:
            return rank[tid]
        t = tasks[tid]
        if edge_comm is None:
            best_succ = max((comm + rec(s) for s in t.succ), default=0.0)
        else:
            best_succ = max((comm + edge_comm.get((tid, s), 0.0) + rec(s)
                             for s in t.succ), default=0.0)
        rank[tid] = mean_cost[tid] + best_succ
        return rank[tid]

    for tid in tasks:
        rec(tid)
    return rank


def _topo_order(succ: list[list[int]], pred: list[list[int]]) -> list[int]:
    """Kahn's algorithm; iterative, so 10k-deep chains don't blow the
    Python recursion limit like the recursive reference rank does."""
    indeg = [len(p) for p in pred]
    queue = [i for i, d in enumerate(indeg) if d == 0]
    topo: list[int] = []
    head = 0
    while head < len(queue):
        t = queue[head]
        head += 1
        topo.append(t)
        for s in succ[t]:
            indeg[s] -= 1
            if indeg[s] == 0:
                queue.append(s)
    if len(topo) != len(succ):
        raise ValueError("task graph contains a cycle")
    return topo


def upward_rank_array(succ: list[list[int]], pred: list[list[int]],
                      mean_cost: np.ndarray, comm: float = 0.0,
                      edge_comm: list[list[float]] | None = None
                      ) -> np.ndarray:
    """Iterative upward rank over index-based adjacency; (T,) array.

    ``edge_comm`` (aligned with ``succ``) adds a per-edge average
    communication cost on top of the uniform ``comm`` scalar — the
    classic HEFT rank's ``mean_cost + max(c̄(t, s) + rank(s))`` with
    ``c̄`` the placement-free mean transfer price (see
    ``CommCosts.edge_comm``).  ``edge_comm=None`` is bit-exact with the
    compute-only rank."""
    topo = _topo_order(succ, pred)
    rank = np.zeros(len(succ))
    for t in reversed(topo):
        best = 0.0
        if edge_comm is None:
            for s in succ[t]:
                best = max(best, comm + rank[s])
        else:
            for c, s in zip(edge_comm[t], succ[t]):
                best = max(best, comm + c + rank[s])
        rank[t] = mean_cost[t] + best
    return rank


def upward_rank_incremental(succ: list[list[int]], pred: list[list[int]],
                            mean_cost: np.ndarray, prev_rank: np.ndarray,
                            dirty, comm: float = 0.0,
                            topo: list[int] | None = None,
                            edge_comm: list[list[float]] | None = None
                            ) -> np.ndarray:
    """Refresh an upward rank after a sparse cost change — bitwise equal
    to recomputing ``upward_rank_array`` from scratch (test-enforced
    oracle, see ``tests/test_scheduler.py``).

    ``dirty`` indexes the tasks whose ``mean_cost`` changed since
    ``prev_rank`` was computed.  A task's rank depends only on its own
    cost and its successors' ranks, so the stale entries are exactly
    ``dirty`` plus its ancestor closure — everything else is carried
    over.  The online executor's re-plan path uses this: a tick dirties
    only the observed rows' instances, so the re-rank touches the
    affected ancestor chains instead of the whole DAG (``topo`` can be
    passed in to amortise the one remaining O(T) pass).

    ``edge_comm`` must be the SAME per-edge average comm costs
    ``prev_rank`` was computed under — edge prices are part of the rank,
    so a bandwidth/topology change (e.g. a node dying re-prices the mean
    transfer rate) invalidates ``prev_rank`` wholesale and requires a
    fresh ``upward_rank_array``, not an incremental patch (the executor
    keys its rank cache on the transfer matrix for exactly this
    reason)."""
    if topo is None:
        topo = _topo_order(succ, pred)
    affected = {int(d) for d in np.asarray(dirty).ravel()}
    stack = list(affected)
    while stack:
        t = stack.pop()
        for p in pred[t]:
            if p not in affected:
                affected.add(p)
                stack.append(p)
    rank = np.array(prev_rank, np.float64, copy=True)
    for t in reversed(topo):
        if t not in affected:
            continue
        best = 0.0
        if edge_comm is None:
            for s in succ[t]:
                best = max(best, comm + rank[s])
        else:
            for c, s in zip(edge_comm[t], succ[t]):
                best = max(best, comm + c + rank[s])
        rank[t] = mean_cost[t] + best
    return rank


def heft_schedule_array(succ: list[list[int]], pred: list[list[int]],
                        cost: np.ndarray,
                        uncertainty: np.ndarray | None = None,
                        risk_k: float = 0.0,
                        node_ready: np.ndarray | None = None,
                        task_ready: np.ndarray | None = None,
                        rank: np.ndarray | None = None,
                        comm: CommCosts | None = None) -> dict:
    """HEFT over a (T, N) cost matrix — the ndarray fast path.

    ``succ`` / ``pred`` are index-based adjacency lists; ``cost[t, n]`` the
    estimated runtime of task t on node n (``uncertainty`` likewise, used
    when risk_k > 0: effective cost = mean + risk_k * sigma).  The
    effective cost drives the schedule END TO END — both the upward rank
    (task priority) and the EFT placement inner loop — so under
    ``risk_k > 0`` uncertain tasks are ranked more urgent (their risk
    inflates every successor chain through them) *and* uncertain
    placements are penalised.  The EFT inner loop is vectorised over the
    node axis.  ``node_ready`` (N,) / ``task_ready`` (T,) or (T, N) are
    earliest-availability floors for mid-execution re-planning: node j is
    busy until node_ready[j], task t's external predecessors (already
    done or running) finish at task_ready[t] — the (T, N) form carries
    per-candidate-node floors (an external predecessor's output still
    has to be *copied* to wherever t lands, so its floor is
    node-dependent under ``comm``).  Returns index-based arrays:
    {assignment (T,) int, start (T,), finish (T,), makespan,
    order (T,) int}.

    ``comm`` (a ``CommCosts``) makes the schedule data-aware: the rank
    gains the per-edge average transfer cost and the EFT inner loop the
    placement-dependent arrival floor ``finish[p] + gb·spg[node(p), n]``,
    vectorised over (preds × nodes) so the solve stays O(T·N + E·N).
    The term vanishes when t lands on its predecessor's node (zero
    diagonal) and shrinks within a zone (the ``Topology`` discount).
    ``comm=None`` is bit-exact with the compute-only schedule
    (trace-signature-tested on the five paper workflows).

    ``rank`` short-circuits the internal upward-rank pass with a
    caller-maintained priority vector (e.g. an incrementally refreshed
    ``upward_rank_incremental`` slice) — it must equal what
    ``upward_rank_array`` would compute over this subgraph (same
    ``edge_comm`` pricing when ``comm`` is set) for the schedule to be
    unchanged."""
    cost = np.asarray(cost, np.float64)
    T, N = cost.shape
    if comm is not None and comm.secs_per_gb.shape[0] != N:
        raise ValueError(f"comm prices {comm.secs_per_gb.shape[0]} nodes "
                         f"but cost has {N} columns")
    eff = cost
    if uncertainty is not None and risk_k > 0:
        eff = cost + risk_k * np.asarray(uncertainty, np.float64)
    if rank is None:
        rank = upward_rank_array(
            succ, pred, eff.mean(axis=1),
            edge_comm=comm.edge_comm(succ) if comm is not None else None)
    else:
        rank = np.asarray(rank, np.float64)
    order = np.argsort(-rank, kind="stable")
    node_free = (np.zeros(N) if node_ready is None
                 else np.asarray(node_ready, np.float64).copy())
    floors = (np.zeros(T) if task_ready is None
              else np.asarray(task_ready, np.float64))
    floors_2d = floors.ndim == 2
    start = np.zeros(T)
    finish = np.zeros(T)
    assignment = np.zeros(T, np.int64)
    for t in order:
        if comm is None and not floors_2d:
            ready = floors[t]
            for p in pred[t]:
                if finish[p] > ready:
                    ready = finish[p]
        elif comm is None:
            ready = floors[t]                      # (N,) external floors
            for p in pred[t]:
                ready = np.maximum(ready, finish[p])
        else:
            # data-aware arrival: each placed predecessor's output reaches
            # candidate node n at finish[p] + gb * spg[node(p), n] — free
            # on node(p) itself, discounted within its zone
            ready = floors[t]                      # scalar or (N,)
            arr = comm.ready_floor(t, finish, assignment)
            if arr is not None:
                ready = np.maximum(ready, arr)
        st = np.maximum(node_free, ready)          # (N,)
        ft = st + eff[t]
        j = int(np.argmin(ft))
        assignment[t] = j
        start[t] = st[j] if np.ndim(st) else float(st)
        finish[t] = ft[j]
        node_free[j] = ft[j]
    return {"assignment": assignment, "start": start, "finish": finish,
            "makespan": float(finish.max()) if T else 0.0, "order": order}


def heft_schedule(tasks: dict[str, SchedTask],
                  cost: dict[str, dict[str, float]],
                  nodes: list[str],
                  uncertainty: dict[str, dict[str, float]] | None = None,
                  risk_k: float = 0.0,
                  edge_gb: dict[tuple[str, str], float] | None = None,
                  secs_per_gb: np.ndarray | None = None) -> dict:
    """cost[task][node] = estimated runtime; uncertainty likewise (sigma).

    risk_k > 0 gives the uncertainty-aware variant: effective cost =
    mean + risk_k * sigma, applied to both the upward rank and the EFT
    placement.  Returns {assignment, start, finish, makespan, order}.
    Thin dict wrapper over ``heft_schedule_array``.

    Contract: ``uncertainty`` participates ONLY when ``risk_k > 0``.
    With ``risk_k == 0`` the dict is never indexed (so it may be sparse
    or partial) and the schedule is identical to not passing it at all —
    a ``UserWarning`` flags the combination, since silently dropping a
    supplied sigma surprised real callers.

    ``edge_gb`` maps ``(producer_id, consumer_id)`` to the GB shipped
    along that edge; ``secs_per_gb`` is the (N, N) node-pair transfer
    price aligned with ``nodes`` (see ``Topology.secs_per_gb``).  Both
    must be supplied for data-aware placement — edge sizes without a
    bandwidth matrix cannot be priced, and by the same
    silently-dropped-input contract as ``uncertainty`` the combination
    warns (once per call site) and schedules compute-only."""
    ids = list(tasks)
    if uncertainty is not None and risk_k == 0:
        warnings.warn(
            "heft_schedule: uncertainty was provided but risk_k == 0, so "
            "it is ignored — pass risk_k > 0 for uncertainty-aware "
            "ranking/placement (effective cost = mean + risk_k * sigma)",
            UserWarning, stacklevel=2)
    if edge_gb is not None and secs_per_gb is None:
        warnings.warn(
            "heft_schedule: edge data sizes (edge_gb) were provided but no "
            "bandwidth matrix (secs_per_gb) is configured, so transfer "
            "costs are ignored — pass a Topology-derived secs_per_gb for "
            "data-aware ranking/placement",
            UserWarning, stacklevel=2)
    if not ids:
        return {"assignment": {}, "start": {}, "finish": {},
                "makespan": 0.0, "order": []}
    idx = {tid: i for i, tid in enumerate(ids)}
    C = np.array([[cost[t][n] for n in nodes] for t in ids])
    # only materialise sigma when it will be used: a sparse/partial
    # uncertainty dict with risk_k == 0 must not be indexed (reference
    # semantics)
    U = (np.array([[uncertainty[t][n] for n in nodes] for t in ids])
         if uncertainty is not None and risk_k > 0 else None)
    succ = [[idx[s] for s in tasks[t].succ] for t in ids]
    pred = [[idx[p] for p in tasks[t].pred] for t in ids]
    comm = None
    if edge_gb is not None and secs_per_gb is not None:
        comm = CommCosts(pred,
                         {(idx[p], idx[s]): g
                          for (p, s), g in edge_gb.items()
                          if p in idx and s in idx},
                         secs_per_gb)
    r = heft_schedule_array(succ, pred, C, U, risk_k, comm=comm)
    return {"assignment": {ids[i]: nodes[r["assignment"][i]]
                           for i in range(len(ids))},
            "start": {ids[i]: float(r["start"][i]) for i in range(len(ids))},
            "finish": {ids[i]: float(r["finish"][i]) for i in range(len(ids))},
            "makespan": r["makespan"],
            "order": [ids[i] for i in r["order"]]}


def heft_schedule_reference(tasks: dict[str, SchedTask],
                            cost: dict[str, dict[str, float]],
                            nodes: list[str],
                            uncertainty: dict[str, dict[str, float]] | None = None,
                            risk_k: float = 0.0,
                            edge_gb: dict[tuple[str, str], float] | None = None,
                            secs_per_gb: np.ndarray | None = None) -> dict:
    """The original pure-Python dict-of-dicts HEFT, kept as the equivalence
    oracle for tests and the baseline for benchmarks/bench_predict.py.
    Like the fast path, the risk-adjusted effective cost drives both the
    upward rank and the EFT placement.

    ``edge_gb`` / ``secs_per_gb`` mirror ``heft_schedule``'s data-aware
    knobs with the same semantics, independently implemented over dicts:
    the rank charges the placement-free average price per edge, the EFT
    loop the placement-dependent ``finish[p] + gb * spg[node(p)][n]``
    arrival floor.  The property suite in ``tests/test_comm_sched.py``
    holds the array path to this oracle bit-for-bit, comm on and off."""
    def eff(tid: str, node: str) -> float:
        c = cost[tid][node]
        if uncertainty is not None and risk_k > 0:
            c = c + risk_k * uncertainty[tid][node]
        return c

    if uncertainty is not None and risk_k > 0:
        eff_cost = {t: {n: eff(t, n) for n in nodes} for t in tasks}
    else:
        eff_cost = cost
    spg = None
    edge_comm = None
    if edge_gb is not None and secs_per_gb is not None:
        spg = np.asarray(secs_per_gb, np.float64)
        mean_spg = float(spg.mean())
        edge_comm = {(p, s): float(g) * mean_spg
                     for (p, s), g in edge_gb.items()}
    rank = _upward_rank(tasks, eff_cost, edge_comm=edge_comm)
    order = sorted(tasks, key=lambda t: -rank[t])
    nidx = {n: i for i, n in enumerate(nodes)}
    node_free = {n: 0.0 for n in nodes}
    finish: dict[str, float] = {}
    start: dict[str, float] = {}
    assignment: dict[str, str] = {}
    for tid in order:
        best, best_ft, best_st = None, float("inf"), 0.0
        for n in nodes:
            if spg is None:
                ready = max((finish[p] for p in tasks[tid].pred),
                            default=0.0)
            else:
                ready = 0.0
                for p in tasks[tid].pred:
                    gb = float(edge_gb.get((p, tid), 0.0))
                    arr = finish[p] + gb * spg[nidx[assignment[p]], nidx[n]]
                    if arr > ready:
                        ready = arr
            st = max(node_free[n], ready)
            ft = st + eff(tid, n)
            if ft < best_ft:
                best, best_ft, best_st = n, ft, st
        assignment[tid] = best
        start[tid] = best_st
        finish[tid] = best_ft
        node_free[best] = best_ft
    return {"assignment": assignment, "start": start, "finish": finish,
            "makespan": max(finish.values()) if finish else 0.0,
            "order": order}


def realized_makespan(succ: list[list[int]], pred: list[list[int]],
                      dur: np.ndarray, assignment: np.ndarray,
                      order: np.ndarray,
                      comm: CommCosts | None = None) -> float:
    """Replay a fixed placement under *true* per-task durations and
    transfer prices — the neutral judge for the data-locality bench.

    A plan's quality is not its own optimistic makespan: a comm-blind
    schedule claims transfers are free, so comparing planners by their
    self-reported makespans would reward the blindness.  This evaluator
    executes both plans (``assignment`` + dispatch ``order`` from any
    ``heft_schedule_array`` result) in list-scheduling order and charges
    every edge the REAL arrival delay ``finish[p] + gb·spg[node(p),
    node(t)]``, so the cross-rack copy the blind planner ignored shows
    up in its realized number."""
    dur = np.asarray(dur, np.float64)
    T = len(dur)
    node_free: dict[int, float] = {}
    finish = np.zeros(T)
    for t in order:
        t = int(t)
        j = int(assignment[t])
        ready = 0.0
        if comm is None:
            for p in pred[t]:
                if finish[p] > ready:
                    ready = finish[p]
        else:
            pi, gbs = comm.pred_idx[t], comm.pred_gb[t]
            for p, gb in zip(pi, gbs):
                arr = finish[p] + float(gb) * comm.secs_per_gb[
                    int(assignment[p]), j]
                if arr > ready:
                    ready = arr
        st = max(node_free.get(j, 0.0), ready)
        finish[t] = st + dur[t]
        node_free[j] = finish[t]
    return float(finish.max()) if T else 0.0


def round_robin_schedule(tasks: dict[str, SchedTask], nodes: list[str]) -> dict:
    """FIFO/fair baseline (what resource managers do without estimates)."""
    assignment = {tid: nodes[i % len(nodes)]
                  for i, tid in enumerate(sorted(tasks))}
    return {"assignment": assignment}


# ---------------------------------------------------------------------------
# Straggler mitigation + elastic rescheduling (simulation-level)
# ---------------------------------------------------------------------------
def detect_stragglers(records: list[dict], predictions: dict[str, tuple],
                      k: float = 3.0) -> list[str]:
    """records: [{id, node, duration}]; predictions[id] = (mean, sigma).
    Returns ids whose measured duration exceeds mean + k*sigma."""
    out = []
    for r in records:
        mean, sigma = predictions.get(r["id"], (None, None))
        if mean is None:
            continue
        if r["duration"] > mean + k * max(sigma, 1e-9):
            out.append(r["id"])
    return out


def simulate_with_stragglers(tasks, cost, nodes, true_runtime,
                             predictions, straggler_k: float = 3.0,
                             speculative: bool = True):
    """Execute a HEFT schedule where true runtimes may include stragglers;
    speculative copies launch on the fastest other node when the predicted
    envelope (mean + k*sigma) is exceeded.  Returns makespans with and
    without mitigation (list-scheduling approximation)."""
    sched = heft_schedule(tasks, cost, nodes)
    node_free = {n: 0.0 for n in nodes}
    finish: dict[str, float] = {}
    rank = _upward_rank(tasks, cost)
    mitigated = 0
    for tid in sorted(tasks, key=lambda t: -rank[t]):
        ready = max((finish[p] for p in tasks[tid].pred), default=0.0)
        node = sched["assignment"][tid]
        st = max(node_free[node], ready)
        dur = true_runtime(tid, node)
        mean, sigma = predictions[tid]
        envelope = mean + straggler_k * max(sigma, 1e-9)
        if speculative and dur > envelope:
            # launch a copy at the envelope time on the best other node,
            # preferring a different node TYPE (the "type/i" prefix) —
            # compare the type segment exactly: a prefix test would
            # falsely exclude distinct nodes sharing a name prefix
            # (e.g. "n1" knocking out "n10")
            ntype = node.split("/")[0]
            others = [n for n in nodes if n.split("/")[0] != ntype]
            others = others or [n for n in nodes if n != node]
            alt = min(others, key=lambda n: cost[tid][n]) if others else node
            alt_st = max(node_free[alt], st + envelope)
            alt_ft = alt_st + true_runtime(tid, alt)
            orig_ft = st + dur
            if alt_ft < orig_ft:
                mitigated += 1
                finish[tid] = alt_ft
                node_free[alt] = alt_ft
                # the original is killed the moment the straggler is
                # detected (envelope exceeded), freeing its node then —
                # not when either attempt would have finished
                node_free[node] = st + envelope
                continue
        finish[tid] = st + dur
        node_free[node] = st + dur
    return {"makespan": max(finish.values()) if finish else 0.0,
            "mitigated": mitigated}


def reschedule_elastic(tasks, cost, nodes_alive, done: set[str]) -> dict:
    """Re-run HEFT over the unfinished subgraph on surviving nodes."""
    remaining = {tid: t for tid, t in tasks.items() if tid not in done}
    pruned = {}
    for tid, t in remaining.items():
        pruned[tid] = SchedTask(id=tid,
                                succ=[s for s in t.succ if s in remaining],
                                pred=[p for p in t.pred if p in remaining])
    cost_sub = {tid: {n: cost[tid][n] for n in nodes_alive}
                for tid in pruned}
    return heft_schedule(pruned, cost_sub, nodes_alive)
