"""Event-driven online execution engine (run → observe → re-predict →
re-schedule).

The closed loop the paper motivates but never builds: a HEFT plan from the
locally-fitted estimates is executed on grid-engine-style nodes; every
finished task's realised runtime is fed back through
``LotaruEstimator.observe`` (incremental conjugate update, O(d²)); and when
a runtime falls outside its predictive interval — the model was *surprised*
— the not-yet-started frontier is re-planned with ``heft_schedule_array``
over the refreshed estimate matrix, with node/task availability floors so
running work is never disturbed.

The same loop with ``online=False`` executes the static plan with frozen
predictions, which is the baseline every benchmark compares against.

Risk-aware mode (``risk_k > 0``) closes the paper's last open loop: the
"robust uncertainty estimates" its Bayesian predictor produces actually
*drive placement*.  Every plan and re-plan schedules on the effective
cost ``mean + risk_k * sigma`` where sigma is the bias-widened predictive
std, and speculative-copy admission can be gated on the bias posterior's
tail mass (``spec_tail``) instead of its point estimate.
"""
from __future__ import annotations

import heapq
from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.obs.calibration import running_median
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sched.heft import (CommCosts, SchedTask, _topo_order,
                              heft_schedule_array, upward_rank_array,
                              upward_rank_incremental)
from repro_torch.sched.simulator import GridEngine

from .buffer import ObservationBuffer

#: ExecutionTrace.to_dict / from_dict on-disk format
TRACE_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class TaskRun:
    """One completed task instance with the prediction it was dispatched
    under (the dispatch-time belief, not hindsight)."""
    id: str
    name: str             # abstract task name (estimator row)
    node: str             # node instance ("type/i")
    node_type: str
    start: float
    end: float
    runtime: float
    pred_mean: float
    pred_std: float

    @property
    def error(self) -> float:
        """Paper eq. 7: |predicted - actual| / actual."""
        return abs(self.pred_mean - self.runtime) / max(self.runtime, 1e-12)


@dataclass(frozen=True)
class CensoredRun:
    """A killed or crashed attempt: the task did NOT finish, so its
    elapsed time is only a *lower bound* on the true runtime — it is
    kept out of the runtime posterior (a censored observation would bias
    it low) but logged here and fed to the reliability model as a failed
    attempt."""
    id: str
    name: str             # abstract task name (estimator row)
    node: str             # node instance the attempt died on
    node_type: str
    start: float
    lost_at: float        # when the failure manifested / the node died
    reason: str           # "attempt" (task-level failure) | "node" (crash)

    @property
    def elapsed(self) -> float:
        """Runtime lower bound: how long the attempt ran before dying."""
        return self.lost_at - self.start


@dataclass
class ExecutionTrace:
    records: list[TaskRun] = field(default_factory=list)
    makespan: float = 0.0
    replans: int = 0
    surprises: int = 0
    speculations: int = 0      # straggler copies launched (bias coupling)
    spec_wins: int = 0         # copies that finished before the original
    failures: int = 0          # attempts lost to faults (task- or node-level)
    retries: int = 0           # re-queued attempts (after backoff)
    lost_nodes: int = 0        # node-down events (crashes + outage starts)
    stranded: int = 0          # tasks abandoned (non-strict mode only)
    completed: int = 0         # tasks that finished
    total: int = 0             # tasks in the DAG
    censored: list[CensoredRun] = field(default_factory=list)
    observations: ObservationBuffer = field(default_factory=ObservationBuffer)

    def completed_fraction(self) -> float:
        """Fraction of DAG tasks that actually finished (1.0 in strict
        mode, which raises rather than strand work)."""
        return self.completed / self.total if self.total else 1.0

    def errors(self) -> np.ndarray:
        """Per-task prediction errors in completion order."""
        return np.array([r.error for r in self.records])

    def cumulative_mpe(self) -> np.ndarray:
        """Running median prediction error after each completion — the
        online trajectory (should fall as observations stream in).
        Incremental two-heap running median: O(n log n) total where the
        prefix re-median was O(n²) — equivalence with the naive form is
        property-tested."""
        return running_median(r.error for r in self.records)

    def final_mpe(self) -> float:
        errs = self.errors()
        return float(np.median(errs)) if len(errs) else float("nan")

    # ---- versioned machine-readable form ----------------------------------
    def to_dict(self) -> dict:
        """JSON-ready dict of the full trace (schema
        ``TRACE_SCHEMA_VERSION``): every counter, every completed
        ``TaskRun``, every ``CensoredRun``, and the observation stream.
        ``from_dict`` round-trips bit-exactly, so bench artifacts and CI
        uploads are machine-readable instead of ad-hoc prints."""
        return {
            "version": TRACE_SCHEMA_VERSION,
            "makespan": self.makespan,
            "replans": self.replans,
            "surprises": self.surprises,
            "speculations": self.speculations,
            "spec_wins": self.spec_wins,
            "failures": self.failures,
            "retries": self.retries,
            "lost_nodes": self.lost_nodes,
            "stranded": self.stranded,
            "completed": self.completed,
            "total": self.total,
            "records": [asdict(r) for r in self.records],
            "censored": [asdict(c) for c in self.censored],
            "observations": self.observations.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionTrace":
        version = d.get("version", 1)
        if version > TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"trace schema v{version} is newer than this reader "
                f"(v{TRACE_SCHEMA_VERSION})")
        return cls(
            records=[TaskRun(**r) for r in d["records"]],
            makespan=float(d["makespan"]),
            replans=int(d["replans"]),
            surprises=int(d["surprises"]),
            speculations=int(d["speculations"]),
            spec_wins=int(d["spec_wins"]),
            failures=int(d.get("failures", 0)),
            retries=int(d.get("retries", 0)),
            lost_nodes=int(d.get("lost_nodes", 0)),
            stranded=int(d.get("stranded", 0)),
            completed=int(d.get("completed", 0)),
            total=int(d.get("total", 0)),
            censored=[CensoredRun(**c) for c in d.get("censored", [])],
            observations=ObservationBuffer.from_dict(d["observations"]),
        )


class OnlineExecutor:
    """Discrete-event loop interleaving execution with estimation.

    Parameters
    ----------
    estimator : LotaruEstimator-like (``predict_matrix``, ``observe``,
        ``predict_interval_node``, ``task_names``)
    tasks : dict[str, SchedTask] — instance-level DAG
    task_name : dict[str, str] — instance id → abstract estimator task
    size : float — the workflow's input size (shared by all instances)
    grid : GridEngine — concrete node instances of heterogeneous types
    runtime_fn : (task_id, node_name) → float — ground-truth runtime
    online : False freezes the initial predictions (static baseline)
    confidence : predictive-interval mass for the surprise gate
    risk_k : uncertainty-aware HEFT knob — every (re-)plan schedules on
        the effective cost ``mean + risk_k·sigma``, where sigma is the
        estimator's *bias-widened* predictive std (``predict_matrix``
        with ``with_std=True``), end to end: the upward rank, the EFT
        placement, and the speculative alternate-node pick all consume
        it.  Because ``observe`` feeds the bias posterior, every
        re-plan after a surprise prices placements by the *current*
        posterior widths — pairs whose bias is still unsettled look
        expensive until evidence narrows them.
    replan_cooldown : minimum completions between two re-plans
    speculate : couple the bias posterior to straggler mitigation — a
        still-running task that has outrun its dispatch-time envelope
        (mean + spec_k·sigma) on a node whose learned (task, node) bias
        has drifted past ``bias_drift`` gets a speculative copy on the
        best idle node; whichever attempt finishes first wins, the loser
        is killed and its node freed at that moment
    spec_k : envelope multiplier for the overdue check
    bias_drift : bias drift threshold that marks a node as systematically
        slow for the task (pairs look undrifted until observed)
    spec_tail : admission statistic for the drift check.  ``None``
        (default) compares the bias *point estimate* against
        ``bias_drift`` (the PR 3 behaviour, needs ``bias_point``); a
        float in (0, 1) instead requires the bias posterior's tail mass
        ``P(bias > bias_drift)`` to reach it (needs ``bias_tail_mass``).
        Values above 0.5 are strictly more conservative than the point
        estimate — a single noisy residual can move the posterior mean
        across the drift line, but not drag most of its mass across —
        so tail-mass admission launches fewer, better-justified copies.
    faults : ``FaultInjector`` describing node crashes, transient
        outages and per-attempt failure probabilities — or ``None``
        (default), which keeps the fault-free loop bit-exact.  With an
        injector attached the loop becomes fault-tolerant: lost running
        attempts are detected the moment their node dies (or their
        deterministic failure time fires), recorded as *censored*
        observations (elapsed time is a runtime lower bound — logged in
        ``trace.censored`` and fed to the reliability posterior, never
        to the runtime posterior), and re-queued with capped exponential
        backoff under a per-task attempt budget; orphaned queue entries
        on a dead node trigger a frontier re-plan, as does a node
        rejoining after an outage.
    max_attempts : per-task attempt budget.  A task whose every attempt
        fails raises a ``RuntimeError`` naming the task once the budget
        is exhausted (strict mode) or is stranded (``strict=False``).
    backoff_base / backoff_cap : retry delay after the k-th failure is
        ``min(backoff_base * 2**(k-1), backoff_cap)`` — capped
        exponential backoff, so a flapping task neither hammers the
        cluster nor waits unboundedly.
    rel_k : reliability-aware placement knob (``None`` = off, bit-exact
        with PR 4).  Every (re-)plan multiplies each node's column of
        the effective cost by the estimator's per-node reliability
        factor ``1 / (E[p_success] - rel_k·sd)`` — the Beta–Binomial
        expected time-to-success, uncertainty-widened exactly like
        ``risk_k`` widens runtimes — so flaky nodes price out of HEFT
        placements as attempt failures accrue.  Completions and
        failures feed the posterior via ``estimator.record_attempt``
        (reliability is also tracked whenever ``faults`` is set, even
        with pricing off, so the evidence is there when pricing turns
        on).
    strict : ``True`` (default) raises on exhausted attempt budgets and
        execution stalls; ``False`` strands the affected tasks (and,
        transitively, their dependents) and returns a partial trace —
        ``trace.stranded`` / ``trace.completed_fraction()`` quantify the
        damage.  The static-plan-under-faults baseline runs non-strict:
        stranding work is exactly the failure mode the fault-tolerant
        loop exists to prevent.
    edge_gb : ``(producer_id, consumer_id) -> GB`` per-edge data volumes
        over the instance DAG (e.g. ``repro_torch.sched.workflows.dag_edge_gb``)
        or ``None`` (default — the data-free loop, bit-exact with
        pre-comm behaviour).  With volumes attached AND a grid topology,
        execution becomes data-aware end to end: every launch is delayed
        by the realized staging time of inputs still in flight from
        other nodes (compute ``runtime`` stays pure — the estimator's
        runtime posterior never sees transfer time), and every (re-)plan
        prices transfers via ``CommCosts`` built from the grid's LIVE
        ``secs_per_gb`` matrix — so dead nodes are masked as data
        sources and rejoining nodes re-enter comm pricing, tick by tick.
    comm_aware : ``False`` keeps the realized staging delays (the
        cluster still pays for copies) but plans comm-blind — the
        ablation arm the data-locality bench compares against.
    tracer : a ``repro_torch.obs`` tracer (e.g. ``EventLog``) or ``None``
        (default, the zero-cost no-op path).  With a live tracer the
        whole tick becomes observable: typed events (tick, plan,
        dispatch, finish, observe — with interval coverage and PIT —
        predict, surprise, speculation, fault, retry, backoff,
        node_down/up, stranded) with sim- and wall-time stamps, plus
        wall-clock spans around the HEFT (re-)plan and the estimator's
        predict/update dispatches (the tracer is attached to the
        grid and the estimator too).  Tracing is strictly read-only:
        ``run()`` output is bit-identical with and without it
        (test-enforced, same pattern as the ``faults=None`` proof).
    """

    def __init__(self, estimator, tasks: dict[str, SchedTask],
                 task_name: dict[str, str], size: float, grid: GridEngine,
                 runtime_fn, *, online: bool = True,
                 confidence: float = 0.9, risk_k: float = 0.0,
                 replan_cooldown: int = 0, speculate: bool = True,
                 spec_k: float = 2.0, bias_drift: float = 1.15,
                 spec_tail: float | None = None,
                 faults=None, max_attempts: int = 4,
                 backoff_base: float = 1.0, backoff_cap: float = 30.0,
                 rel_k: float | None = None, strict: bool = True,
                 tracer=None, fused: bool = False,
                 incremental_replan: bool | None = None,
                 edge_gb: dict[tuple[str, str], float] | None = None,
                 comm_aware: bool = True):
        if spec_tail is not None and not 0.0 < spec_tail < 1.0:
            raise ValueError(f"spec_tail must be in (0, 1), got {spec_tail}")
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if backoff_base < 0 or backoff_cap < 0:
            raise ValueError("backoff_base/backoff_cap must be >= 0, got "
                             f"{backoff_base}/{backoff_cap}")
        self.est = estimator
        self.tasks = tasks
        self.task_name = task_name
        self.size = float(size)
        self.grid = grid
        self.runtime_fn = runtime_fn
        self.online = online
        self.confidence = confidence
        self.risk_k = risk_k
        self.replan_cooldown = replan_cooldown
        self.speculate = speculate
        self.spec_k = spec_k
        self.bias_drift = bias_drift
        self.spec_tail = spec_tail
        self.faults = faults
        self.max_attempts = max_attempts
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.rel_k = rel_k
        self.strict = strict
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            # one log observes the whole stack: grid membership churn and
            # the estimator's predict/update spans land in the same trace
            grid.tracer = self.tracer
            if hasattr(estimator, "set_tracer"):
                estimator.set_tracer(self.tracer)
        # track attempt outcomes in the reliability posterior whenever a
        # fault process exists or reliability pricing is on (and the
        # estimator has the availability plane at all)
        self._track_rel = ((faults is not None or rel_k is not None)
                           and hasattr(estimator, "record_attempt"))
        self.node_names = grid.names()
        # stable node-type column order for the estimate matrix
        seen: dict[str, None] = {}
        for n in self.node_names:
            seen.setdefault(grid.type_of(n).name)
        self.type_names = list(seen)
        self._type_idx = {t: j for j, t in enumerate(self.type_names)}
        self._col = np.array([self._type_idx[grid.type_of(n).name]
                              for n in self.node_names])
        self._row = {}   # instance id -> estimator row
        task_rows = {nm: i for i, nm in enumerate(estimator.task_names())}
        for tid, nm in task_name.items():
            self._row[tid] = task_rows[nm]
        # fused mode: the per-tick estimator surface is served by a
        # TickEngine (one tick_step per completion batch) instead
        # of the estimator's host-orchestrated observe/predict sequence;
        # the final state is written back into the estimator at run end
        self._engine = None
        if fused and online:
            from repro_torch.core.tick import TickEngine
            self._engine = TickEngine(estimator, self.type_names,
                                      size=self.size, tracer=self.tracer)
        self._api = self._engine if self._engine is not None else estimator
        # incremental re-planning (defaults on with the fused tick):
        # upward ranks over the FULL instance graph are cached and only
        # the dirty ancestor chains re-ranked per re-plan — bitwise equal
        # to the from-scratch rank (oracle-tested), because a successor
        # of an unstarted task is always itself unstarted
        self._incremental = ((fused if incremental_replan is None
                              else incremental_replan) and online)
        self._ids = list(tasks)
        self._id_idx = {tid: i for i, tid in enumerate(self._ids)}
        # edges to ids outside the instance set (external/unsatisfiable
        # deps) are dropped, exactly like _plan's subgraph build
        self._succ_full = [[self._id_idx[s] for s in tasks[tid].succ
                            if s in self._id_idx] for tid in self._ids]
        self._pred_full = [[self._id_idx[p] for p in tasks[tid].pred
                            if p in self._id_idx] for tid in self._ids]
        self._rows_full = np.array([self._row[tid] for tid in self._ids])
        self._topo_full: list[int] | None = None
        self._rank_cache: tuple[np.ndarray, np.ndarray] | None = None
        # data-aware execution: staging delays always apply once edge
        # volumes + a topology exist; comm_aware additionally routes the
        # transfer term into planning.  _node_of tracks where each
        # started/finished task's output lives (the winning attempt's
        # node), _node_idx maps node name -> column for the 2-D floors.
        self.edge_gb = dict(edge_gb) if edge_gb is not None else None
        self._has_comm = (self.edge_gb is not None
                          and grid.topology is not None)
        self.comm_aware = comm_aware and self._has_comm
        self._node_of: dict[str, str] = {}
        self._node_idx = {n: j for j, n in enumerate(self.node_names)}
        self._edge_gb_full: dict[tuple[int, int], float] = {}
        if self.edge_gb is not None:
            for (p, s), g in self.edge_gb.items():
                if p in self._id_idx and s in self._id_idx:
                    self._edge_gb_full[(self._id_idx[p],
                                        self._id_idx[s])] = float(g)
        # the incremental rank cache is additionally keyed on the live
        # transfer matrix: membership churn re-prices the mean transfer
        # rate, which is part of the comm-aware rank, so a changed matrix
        # invalidates prev_rank wholesale (see upward_rank_incremental)
        self._rank_spg_key: bytes | None = None

    def _backoff(self, n_failures: int) -> float:
        """Retry delay after the ``n_failures``-th failure of a task:
        capped exponential, ``min(base * 2**(n-1), cap)``."""
        return min(self.backoff_base * 2.0 ** (max(n_failures, 1) - 1),
                   self.backoff_cap)

    def _rel_factors(self) -> np.ndarray:
        """(N,) per-node-instance reliability price multipliers (all-ones
        when the estimator has no availability plane)."""
        if hasattr(self._api, "reliability_factors"):
            return np.asarray(self._api.reliability_factors(
                self.node_names, self.rel_k), np.float64)
        return np.ones(len(self.node_names), np.float64)

    # ---- planning ---------------------------------------------------------
    def _estimates(self, with_std: bool = True):
        """Current (abstract-task × node-type) mean/std matrices.  After an
        ``observe`` only the dirty row is recomputed (matrix row cache).
        ``with_std=False`` returns ``(mean, None)`` and skips the bias
        widening — the mean-only fast path a risk-neutral plan takes."""
        return self._api.predict_matrix(self.type_names, self.size,
                                        with_std=with_std)

    def _incremental_rank(self, unstarted: list[str], mean, std,
                          rf, spg: np.ndarray | None = None) -> np.ndarray:
        """Upward ranks for the unstarted subgraph, refreshed from the
        cached full-instance-graph ranks instead of recomputed.

        Bitwise equal to the rank ``heft_schedule_array`` would build
        itself: a task can only start once every predecessor is done, so
        successors of unstarted tasks are themselves unstarted — the
        full-graph rank restricted to the frontier IS the subgraph rank
        (edges into the frontier never enter an *upward* rank, so this
        holds with the comm term too).  Only instances whose effective
        mean cost changed since the last plan (plus their ancestor
        chains) are re-ranked; a changed transfer matrix (membership
        churn re-pricing the mean rate) drops the cache wholesale."""
        eff_abs = mean[:, self._col]
        if rf is not None:
            eff_abs = eff_abs * rf[None, :]
        if self.risk_k > 0:
            unc_abs = std[:, self._col]
            if rf is not None:
                unc_abs = unc_abs * rf[None, :]
            eff_abs = eff_abs + self.risk_k * unc_abs
        inst_cost = eff_abs.mean(axis=1)[self._rows_full]
        edge_comm = None
        if spg is not None:
            key = spg.tobytes()
            if key != self._rank_spg_key:
                self._rank_cache = None
                self._rank_spg_key = key
            mean_spg = float(spg.mean())
            edge_comm = [[self._edge_gb_full.get((t, s), 0.0) * mean_spg
                          for s in ss]
                         for t, ss in enumerate(self._succ_full)]
        if self._rank_cache is None:
            if self._topo_full is None:
                self._topo_full = _topo_order(self._succ_full,
                                              self._pred_full)
            rank_full = upward_rank_array(self._succ_full,
                                          self._pred_full, inst_cost,
                                          edge_comm=edge_comm)
        else:
            prev_cost, prev_rank = self._rank_cache
            dirty = np.nonzero(inst_cost != prev_cost)[0]
            rank_full = upward_rank_incremental(
                self._succ_full, self._pred_full, inst_cost, prev_rank,
                dirty, topo=self._topo_full, edge_comm=edge_comm)
        self._rank_cache = (inst_cost, rank_full)
        return rank_full[[self._id_idx[tid] for tid in unstarted]]

    def _plan(self, unstarted: list[str], t_now: float,
              ext_finish: dict[str, float],
              frontier_exact: bool = True) -> dict[str, list[str]]:
        """(Re-)plan the not-yet-started frontier; returns per-node queues.

        ``ext_finish`` maps done/running predecessors to their (actual or
        expected) finish times — they become ``task_ready`` floors, and the
        grid's busy-until times become ``node_ready`` floors, so the plan
        never assumes a busy node or an unfinished input.
        ``frontier_exact`` asserts ``unstarted`` is the complete
        never-started remainder of the DAG (no stranded holes) — the
        precondition for the incremental rank reuse; callers that dropped
        stranded tasks pass False and take the from-scratch rank."""
        if not unstarted:
            return {n: [] for n in self.node_names}
        # risk-neutral plans consume only the means: skip the bias-widened
        # std entirely (with_std=False) instead of computing and dropping it
        mean, std = self._estimates(with_std=self.risk_k > 0)
        idx = {tid: i for i, tid in enumerate(unstarted)}
        succ = [[idx[s] for s in self.tasks[tid].succ if s in idx]
                for tid in unstarted]
        pred = [[idx[p] for p in self.tasks[tid].pred if p in idx]
                for tid in unstarted]
        rows = np.array([self._row[tid] for tid in unstarted])
        cost = mean[rows][:, self._col]
        unc = std[rows][:, self._col] if self.risk_k > 0 else None
        rf = self._rel_factors() if self.rel_k is not None else None
        if rf is not None:
            # availability pricing: each node-instance column is scaled
            # by its expected time-to-success multiplier, so the same
            # mean runtime on a flaky node costs more end to end (rank
            # AND placement, like risk_k)
            cost = cost * rf[None, :]
            if unc is not None:
                unc = unc * rf[None, :]
        comm = None
        spg = None
        if self.comm_aware:
            # live transfer matrix: dead nodes are re-priced as data
            # sources every plan (stateless), rejoins restore real rates
            spg = self.grid.secs_per_gb()
        if spg is not None:
            comm = CommCosts(
                pred,
                {(idx[p], idx[s]): g for (p, s), g in self.edge_gb.items()
                 if p in idx and s in idx},
                spg)
        rank = (self._incremental_rank(unstarted, mean, std, rf, spg)
                if self._incremental and frontier_exact else None)
        if comm is None:
            task_ready = np.array([
                max((ext_finish.get(p, t_now)
                     for p in self.tasks[tid].pred if p not in idx),
                    default=t_now)
                for tid in unstarted])
            task_ready = np.maximum(task_ready, t_now)
        else:
            # (T, N) floors: an external (done/running) predecessor's
            # output still has to be COPIED from where it ran to wherever
            # the frontier task lands, so its floor is node-dependent
            task_ready = np.full((len(unstarted), len(self.node_names)),
                                 t_now)
            for i, tid in enumerate(unstarted):
                for p in self.tasks[tid].pred:
                    if p in idx:
                        continue
                    base = max(ext_finish.get(p, t_now), t_now)
                    gb = self.edge_gb.get((p, tid), 0.0)
                    src = self._node_idx.get(self._node_of.get(p))
                    if src is None or gb <= 0:
                        task_ready[i] = np.maximum(task_ready[i], base)
                    else:
                        task_ready[i] = np.maximum(
                            task_ready[i], base + gb * spg[src])
        if self.tracer.enabled:
            self.tracer.emit("plan", t_sim=t_now, n_tasks=len(unstarted),
                             risk=self.risk_k > 0)
        with self.tracer.span("plan", t_sim=t_now, n_tasks=len(unstarted)):
            sched = heft_schedule_array(
                succ, pred, cost, unc, self.risk_k,
                node_ready=self.grid.ready_vector(t_now),
                task_ready=task_ready, rank=rank, comm=comm)
        queues: dict[str, list[str]] = {n: [] for n in self.node_names}
        for i in sched["order"]:
            queues[self.node_names[sched["assignment"][i]]].append(
                unstarted[int(i)])
        return queues

    # ---- the loop ---------------------------------------------------------
    def run(self) -> ExecutionTrace:
        tr = self.tracer
        if tr.enabled:
            tr.emit("run_start", t_sim=0.0, tasks=len(self.tasks),
                    nodes=len(self.node_names), online=self.online,
                    confidence=self.confidence, risk_k=self.risk_k,
                    rel_k=self.rel_k, spec_tail=self.spec_tail,
                    speculate=self.speculate,
                    faults=self.faults is not None, strict=self.strict)
        trace = ExecutionTrace()
        trace.total = len(self.tasks)
        done: dict[str, float] = {}
        expected_finish: dict[str, float] = {}
        started: set[str] = set()
        stranded: set[str] = set()         # abandoned tasks (strict=False)
        # heap entries: (time, seq, kind, a, b).  "finish"/"fail" carry
        # (task id, node) and their push seq doubles as the attempt id;
        # "down"/"up" carry (node, None); "retry" carries (task id, None).
        # Ordering is (time, seq), identical to the fault-free loop.
        heap: list[tuple[float, int, str, str, str | None]] = []
        seq = 0
        t = 0.0
        cooldown = 0
        attempt_no: dict[str, int] = {}    # attempts dispatched per task
        fail_count: dict[str, int] = {}    # attempts lost per task
        retry_at: dict[str, float] = {}    # backoff floor per task
        dead_attempts: set[int] = set()    # attempt seqs killed by churn
        if self.faults is not None:
            for ev_t, ev_node, ev_kind in self.faults.node_events():
                if ev_node in self.grid.nodes:
                    heapq.heappush(heap, (float(ev_t), seq, ev_kind,
                                          ev_node, None))
                    seq += 1
        queues = self._plan(list(self.tasks), t, {})
        mean, std = self._estimates()
        rec_idx: dict[str, int] = {}            # task id -> trace.records slot
        # active attempts: tid -> [(node, event time, attempt seq, start)]
        running: dict[str, list[tuple[str, float, int, float]]] = {}
        spec_run: dict[str, TaskRun] = {}       # pending copy's TaskRun
        speculated: set[str] = set()

        def launch(tid: str, node: str, t_now: float) -> tuple[float, float]:
            """Draw the attempt's fate and book it: a successful attempt
            finishes at start + staging + dur; a doomed one (``faults``
            decided) dies at its deterministic failure fraction of the
            runtime.  Returns ``(duration, staging wait)`` — with edge
            volumes + a topology, inputs produced on OTHER nodes must
            first be copied over (same-node inputs are free), and the
            attempt computes only after the last one lands.  The wait is
            charged to the cluster whether or not planning was comm-aware
            (that is the bench's whole comparison) but never to the
            compute ``runtime`` the estimator observes."""
            nonlocal seq
            dur = float(self.runtime_fn(tid, node))
            wait = 0.0
            if self._has_comm:
                topo = self.grid.topology
                for p in self.tasks[tid].pred:
                    gb = self.edge_gb.get((p, tid), 0.0)
                    src = self._node_of.get(p)
                    if gb <= 0 or src is None or src == node:
                        continue
                    arr = done.get(p, t_now) + gb * topo.pair_secs_per_gb(
                        src, node)
                    if arr - t_now > wait:
                        wait = arr - t_now
            k = attempt_no.get(tid, 0)
            attempt_no[tid] = k + 1
            frac = (self.faults.attempt_outcome(tid, node, k)
                    if self.faults is not None else None)
            if frac is None:
                end, kind = t_now + wait + dur, "finish"
            else:
                end, kind = t_now + wait + frac * dur, "fail"
            self.grid.occupy(node, end)
            heapq.heappush(heap, (end, seq, kind, tid, node))
            running.setdefault(tid, []).append((node, end, seq, t_now))
            seq += 1
            self._node_of[tid] = node
            return dur, wait

        def dispatch(t_now: float) -> bool:
            progressed = False
            for node in self.grid.idle(t_now):
                q = queues[node]
                pick = next(
                    (tid for tid in q
                     if all(p in done for p in self.tasks[tid].pred)
                     and retry_at.get(tid, 0.0) <= t_now + 1e-12), None)
                if pick is None:
                    continue
                q.remove(pick)
                started.add(pick)
                if tr.enabled:
                    tr.emit("dispatch", t_sim=t_now, task=pick, node=node,
                            attempt=attempt_no.get(pick, 0))
                dur, wait = launch(pick, node, t_now)
                r, c = self._row[pick], self._type_idx[
                    self.grid.type_of(node).name]
                expected_finish[pick] = t_now + wait + float(mean[r, c])
                run_rec = TaskRun(
                    id=pick, name=self.task_name[pick], node=node,
                    node_type=self.grid.type_of(node).name,
                    start=t_now, end=t_now + wait + dur, runtime=dur,
                    pred_mean=float(mean[r, c]), pred_std=float(std[r, c]))
                if pick in rec_idx:      # retry: replace the lost attempt
                    trace.records[rec_idx[pick]] = run_rec
                else:
                    rec_idx[pick] = len(trace.records)
                    trace.records.append(run_rec)
                progressed = True
            return progressed

        # ---- failure machinery (inert while faults is None) ----------
        def record_censored(tid: str, node: str, start: float,
                            t_now: float, reason: str) -> None:
            """A lost attempt's elapsed time is a censored runtime
            observation: a lower bound, never fed to the runtime
            posterior — logged for the trace and counted against the
            node's reliability posterior."""
            trace.failures += 1
            trace.censored.append(CensoredRun(
                id=tid, name=self.task_name[tid], node=node,
                node_type=self.grid.type_of(node).name,
                start=start, lost_at=t_now, reason=reason))
            if tr.enabled:
                tr.emit("fault", t_sim=t_now, task=tid, node=node,
                        reason=reason, elapsed=t_now - start)
            if self._track_rel:
                self._api.record_attempt(node, False)

        def lose_attempt(tid: str, att_seq: int, t_now: float,
                         reason: str) -> bool:
            """Kill one live attempt; True when the task has no attempts
            left and needs a retry (or stranding)."""
            atts = running.get(tid, [])
            entry = next((a for a in atts if a[2] == att_seq), None)
            if entry is None:
                return False
            atts.remove(entry)
            node = entry[0]
            record_censored(tid, node, entry[3], t_now, reason)
            sr = spec_run.get(tid)
            if sr is not None and sr.node == node:
                spec_run.pop(tid)        # the speculative copy itself died
            if atts:
                return False             # a twin attempt is still live
            running.pop(tid, None)
            started.discard(tid)         # back to the unstarted frontier
            speculated.discard(tid)      # a retry may speculate again
            return True

        def schedule_retry(tid: str, node: str, t_now: float) -> None:
            """Capped exponential backoff under the attempt budget, for a
            task whose every live attempt has been lost."""
            nonlocal seq
            fail_count[tid] = fail_count.get(tid, 0) + 1
            if attempt_no.get(tid, 0) >= self.max_attempts:
                if self.strict:
                    raise RuntimeError(
                        f"task {tid!r} exhausted its attempt budget: "
                        f"{attempt_no[tid]} attempts, {fail_count[tid]} "
                        f"lost (last on {node!r} at t={t_now:.2f}) — "
                        "raise max_attempts or fix the fault source")
                stranded.add(tid)
                if tr.enabled:
                    tr.emit("stranded", t_sim=t_now, task=tid, node=node,
                            reason="attempt budget exhausted")
                return
            delay = self._backoff(fail_count[tid])
            retry_at[tid] = t_now + delay
            heapq.heappush(heap, (t_now + delay, seq, "retry", tid, None))
            seq += 1
            trace.retries += 1
            if tr.enabled:
                tr.emit("retry", t_sim=t_now, task=tid, node=node,
                        delay=delay, fails=fail_count[tid],
                        attempts=attempt_no.get(tid, 0))
            if not self.online:
                # a static plan cannot re-plan: the retry goes back to
                # its frozen node's queue if that node is still alive —
                # otherwise the work is stranded with the node, which is
                # exactly how static plans fail under churn
                if self.grid.nodes[node].alive:
                    queues[node].append(tid)
                elif self.strict:
                    raise RuntimeError(
                        f"task {tid!r} was running on dead node {node!r} "
                        "and the static plan (online=False) cannot "
                        "re-assign it")
                else:
                    stranded.add(tid)
                    if tr.enabled:
                        tr.emit("stranded", t_sim=t_now, task=tid,
                                node=node, reason="static plan, dead node")

        def replan_frontier(t_now: float) -> None:
            """Re-plan the unstarted frontier (membership changed or a
            retry re-entered it) with fresh availability floors."""
            nonlocal queues
            if not self.online:
                return
            unstarted = [x for x in self.tasks
                         if x not in started and x not in done
                         and x not in stranded]
            if not unstarted:
                return
            ext = {**done, **{k: max(v, t_now)
                              for k, v in expected_finish.items()
                              if k not in done}}
            queues = self._plan(unstarted, t_now, ext,
                                frontier_exact=not stranded)
            trace.replans += 1

        def node_down(node: str, t_now: float) -> None:
            """A crash or outage start: mask the node, kill its running
            attempts (censored + retry), rescue orphaned queue entries
            via a frontier re-plan."""
            self.grid.fail(node, t_now)
            trace.lost_nodes += 1
            orphaned = bool(queues.get(node))
            needs_retry = []
            for tid, atts in list(running.items()):
                for entry in [a for a in atts if a[0] == node]:
                    dead_attempts.add(entry[2])
                    if lose_attempt(tid, entry[2], t_now, "node"):
                        needs_retry.append(tid)
            for tid in needs_retry:
                schedule_retry(tid, node, t_now)
            if self.online and (orphaned or needs_retry):
                replan_frontier(t_now)
            elif not self.online and orphaned and self.strict:
                raise RuntimeError(
                    f"node {node!r} died at t={t_now:.2f} with "
                    f"{len(queues[node])} queued tasks "
                    f"({', '.join(queues[node][:6])}) and the static plan "
                    "(online=False) cannot re-assign them")

        def node_up(node: str, t_now: float) -> None:
            """An outage ends: revive the node and re-plan so the
            frontier can use the recovered capacity."""
            self.grid.join(node, t_now)
            replan_frontier(t_now)

        def speculate_stragglers(t_now: float) -> None:
            """Bias-coupled straggler mitigation: the surprise gate already
            told us a node is systematically slow for a task (its bias
            posterior drifted high) — so a still-running instance of that
            pair that has outrun its dispatch-time envelope gets a copy on
            the best idle node, instead of only re-planning work that has
            not started yet.  First finish wins; the loser is killed and
            its node freed at that moment.

            Admission: the point-estimate drift check by default, or —
            when ``spec_tail`` is set — the posterior tail mass
            ``P(bias > bias_drift) >= spec_tail``, which no single noisy
            residual can satisfy."""
            bias_point = getattr(self._api, "bias_point", None)
            tail_mass = getattr(self._api, "bias_tail_mass", None)
            if self.spec_tail is not None:
                if tail_mass is None:
                    return
            elif bias_point is None:
                return
            for tid, attempts in list(running.items()):
                if tid in done or tid in speculated or len(attempts) != 1:
                    continue
                rec = trace.records[rec_idx[tid]]
                envelope = rec.pred_mean + self.spec_k * max(
                    rec.pred_std, 1e-9)
                if t_now < rec.start + envelope:
                    continue                      # not overdue yet
                if self.spec_tail is not None:
                    if tail_mass(rec.name, rec.node_type,
                                 self.bias_drift) < self.spec_tail:
                        continue    # posterior mass not behind the drift
                elif bias_point(rec.name, rec.node_type) < self.bias_drift:
                    continue                      # node not drifted for it
                node = attempts[0][0]
                idle = [n for n in self.grid.idle(t_now) if n != node]
                if not idle:
                    continue
                r = self._row[tid]
                # the copy's landing spot is priced with the same risk
                # aversion as the plan: a low-mean but still-uncertain
                # node is a bad place to park a rescue attempt
                alt = min(idle, key=lambda n: mean[
                    r, self._type_idx[self.grid.type_of(n).name]]
                    + self.risk_k * std[
                        r, self._type_idx[self.grid.type_of(n).name]])
                dur, wait = launch(tid, alt, t_now)
                end = t_now + wait + dur
                speculated.add(tid)
                c = self._type_idx[self.grid.type_of(alt).name]
                spec_run[tid] = TaskRun(
                    id=tid, name=self.task_name[tid], node=alt,
                    node_type=self.grid.type_of(alt).name,
                    start=t_now, end=end, runtime=dur,
                    pred_mean=float(mean[r, c]), pred_std=float(std[r, c]))
                expected_finish[tid] = min(expected_finish[tid],
                                           t_now + float(mean[r, c]))
                trace.speculations += 1
                if tr.enabled:
                    tr.emit("speculation", t_sim=t_now, task=tid,
                            node=node, alt=alt,
                            overdue=t_now - (rec.start + envelope))

        while len(done) + len(stranded) < len(self.tasks):
            while dispatch(t):
                pass
            if not heap:
                missing = sorted(tid for tid in self.tasks
                                 if tid not in done and tid not in stranded)
                if not self.strict:
                    stranded.update(missing)
                    if tr.enabled:
                        for mtid in missing:
                            tr.emit("stranded", t_sim=t, task=mtid,
                                    node=None, reason="execution stalled")
                    break
                details = []
                for btid in missing[:8]:
                    blockers = [p for p in self.tasks[btid].pred
                                if p not in done]
                    details.append(
                        f"{btid} <- waiting on {', '.join(sorted(blockers))}"
                        if blockers else
                        f"{btid} (ready but not dispatchable — queued on a "
                        "dead node, or no live nodes left?)")
                more = (f"\n  ... and {len(missing) - 8} more"
                        if len(missing) > 8 else "")
                raise RuntimeError(
                    f"execution stalled with {len(missing)} tasks blocked:"
                    "\n  " + "\n  ".join(details) + more)
            end, ev_seq, kind, a, b = heapq.heappop(heap)
            if tr.enabled:
                tr.emit("tick", t_sim=end, event=kind, seq=ev_seq)
            if kind == "retry":
                t = max(t, end)          # backoff expired: just dispatch
                if tr.enabled:
                    tr.emit("backoff", t_sim=t, task=a)
                continue
            if kind == "down":
                t = max(t, end)
                if self.grid.nodes[a].alive:
                    node_down(a, t)
                continue
            if kind == "up":
                t = max(t, end)
                node_up(a, t)
                continue
            tid, node = a, b
            if tid in done or ev_seq in dead_attempts:
                continue                 # stale event of a killed attempt
            t = end
            if kind == "fail":
                if lose_attempt(tid, ev_seq, t, "attempt"):
                    schedule_retry(tid, node, t)
                    replan_frontier(t)
                continue
            # batch every completion landing on this tick: multi-node
            # observations arriving together are absorbed by ONE scanned
            # estimator update instead of per-observation calls
            completions = [(tid, node, end)]
            seen = {tid}
            while (heap and heap[0][0] <= t + 1e-12
                   and heap[0][2] == "finish"):
                e2, s2, _, tid2, node2 = heapq.heappop(heap)
                if tid2 in done or tid2 in seen or s2 in dead_attempts:
                    continue             # stale, or a same-tick lost twin
                completions.append((tid2, node2, e2))
                seen.add(tid2)
            for ctid, cnode, cend in completions:
                done[ctid] = cend
                self._node_of[ctid] = cnode  # winner holds the output
                # resolve the speculative race: kill the other attempts,
                # free their nodes NOW, and let the winning run's record
                # stand (predictions are the dispatch-time belief of the
                # attempt that actually finished).  A scheduler-ordered
                # kill is NOT a node failure: it never touches the
                # reliability posterior.
                for n2, e2, s2, _ in running.pop(ctid, []):
                    if n2 != cnode:
                        self.grid.release(n2, cend)
                        dead_attempts.add(s2)
                sr = spec_run.pop(ctid, None)
                if sr is not None and sr.node == cnode:
                    trace.records[rec_idx[ctid]] = sr
                    trace.spec_wins += 1
                if self._track_rel:
                    self._api.record_attempt(cnode, True)
                if tr.enabled:
                    crec = trace.records[rec_idx[ctid]]
                    tr.emit("finish", t_sim=cend, task=ctid,
                            node=crec.node, start=crec.start,
                            runtime=crec.runtime,
                            spec_win=sr is not None and sr.node == cnode)
            cooldown = max(0, cooldown - len(completions))
            if self.online:
                # surprise gates BEFORE the update: was each realised
                # runtime outside what the dispatch-time posterior (the
                # tick-start belief) considered likely?
                batch = []
                gates = []
                pit_of = getattr(self._api, "predict_pit_node", None)
                for ctid, cnode, _ in completions:
                    run = trace.records[rec_idx[ctid]]
                    name = self.task_name[ctid]
                    ntype = self.grid.type_of(cnode).name
                    lo, hi = self._api.predict_interval_node(
                        name, ntype, self.size, self.confidence)
                    gate = not (lo <= run.runtime <= hi)
                    gates.append(gate)
                    batch.append((name, ntype, self.size, run.runtime))
                    if tr.enabled:
                        # the tick-start belief, read-only: the same
                        # interval the surprise gate consumed, plus the
                        # PIT of the realised runtime under it
                        pit = (pit_of(name, ntype, self.size, run.runtime)
                               if pit_of is not None else None)
                        tr.emit("observe", t_sim=t, task=ctid, name=name,
                                node=run.node, node_type=ntype,
                                runtime=run.runtime,
                                pred_mean=run.pred_mean,
                                pred_std=run.pred_std,
                                lo=lo, hi=hi, covered=not gate, pit=pit)
                        if gate:
                            tr.emit("surprise", t_sim=t, task=ctid,
                                    name=name, node_type=ntype,
                                    runtime=run.runtime, lo=lo, hi=hi)
                local_rts = self._api.observe_batch(batch)
                for (name, ntype, _, runtime), local_rt in zip(batch,
                                                               local_rts):
                    trace.observations.record(name, ntype, self.size,
                                              runtime, local_rt, time=t)
                mean, std = self._estimates()     # dirty-row refresh only
                trace.surprises += sum(gates)
                if tr.enabled:
                    tr.emit("predict", t_sim=t, n_obs=len(batch),
                            surprises=sum(gates))
                unstarted = [x for x in self.tasks
                             if x not in started and x not in done
                             and x not in stranded]
                if any(gates) and unstarted and cooldown == 0:
                    ext = {**done, **{k: max(v, t)
                                      for k, v in expected_finish.items()
                                      if k not in done}}
                    queues = self._plan(unstarted, t, ext,
                                        frontier_exact=not stranded)
                    trace.replans += 1
                    cooldown = self.replan_cooldown
                if self.speculate:
                    speculate_stragglers(t)
        trace.makespan = max(done.values()) if done else 0.0
        trace.completed = len(done)
        trace.stranded = len(stranded)
        if stranded:
            # placeholder records of attempts that never completed would
            # read as finished runs — keep only what actually ran to end
            trace.records = [r for r in trace.records if r.id in done]
        if tr.enabled:
            tr.emit("run_end", t_sim=trace.makespan,
                    makespan=trace.makespan, completed=trace.completed,
                    stranded=trace.stranded, replans=trace.replans,
                    surprises=trace.surprises,
                    speculations=trace.speculations,
                    spec_wins=trace.spec_wins, failures=trace.failures,
                    retries=trace.retries, mpe=trace.final_mpe())
        if self._engine is not None:
            # fold the device-resident state back into the estimator so
            # the OO surface (scalar predicts, save/load) picks up from
            # exactly where the fused ticks left off
            self._engine.finalize()
        return trace


def fanout_chain_dag(chain: list[str], n_samples: int
                     ) -> tuple[dict[str, SchedTask], dict[str, str]]:
    """Physical workflow: ``n_samples`` inputs each flowing through the
    abstract task ``chain`` (parallel across samples, sequential within).
    Returns (instance DAG, instance id → abstract task name) — the two
    structures ``OnlineExecutor`` consumes.  Instance ids are
    ``s<sample>.<task>``."""
    tasks: dict[str, SchedTask] = {}
    task_name: dict[str, str] = {}
    for s in range(n_samples):
        prev = None
        for nm in chain:
            tid = f"s{s}.{nm}"
            tasks[tid] = SchedTask(id=tid)
            task_name[tid] = nm
            if prev is not None:
                tasks[tid].pred.append(prev)
                tasks[prev].succ.append(tid)
            prev = tid
    return tasks, task_name


def run_static_and_online(make_executor) -> tuple[ExecutionTrace,
                                                  ExecutionTrace]:
    """Convenience: run the same scenario twice — frozen initial plan vs
    the full observe/re-plan loop.  ``make_executor(online)`` must build a
    fresh executor (estimator state is mutated by the online run)."""
    static = make_executor(online=False).run()
    online = make_executor(online=True).run()
    return static, online
