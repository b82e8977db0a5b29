"""Heterogeneous-cluster ground-truth simulator.

Two workload planes share the node registry:

* genomics plane — nf-core-like tasks with hidden (cpu_unit, io_unit)
  ground truth (see workflows.py).  Supports the paper's CPU-frequency
  reduction faithfully via ``cpu_factor``.
* ML plane — (arch x shape) workload cells whose hidden ground truth is the
  three-term roofline of the *actual compiled dry-run HLO*, scaled by each
  node type's rates and hidden per-family efficiency.

Also provides the discrete-event engine used by the scheduler benchmarks
(task queues per node, failures, stragglers, elastic node loss/join).
"""
from __future__ import annotations

import heapq
import json
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.core.nodes import NodeType, get_node, target_nodes
from .workflows import REF_CPU, REF_IO, TaskDef, effective_size


class ClusterSimulator:
    """Ground-truth runtimes; Lotaru never sees the units, only runtimes.

    ``systematic`` adds a fixed per-(task, node) efficiency multiplier
    (lognormal, derived from a stable hash): real tools hit different
    codepaths / cache behaviour on different machines, which is exactly why
    scalar factor adjustment has an error floor in the paper's Tables 4-6.

    ``het`` makes the run-to-run noise heteroscedastic per (task, node)
    pair: the lognormal sd becomes ``noise * (1 + het * u)`` with a
    stable-hash ``u`` in [0, 1), so some pairs are far jitterier than
    others — the regime where risk-aware (mean + k*sigma) placement beats
    risk-neutral placement.  ``het=0`` (default) keeps the homoscedastic
    behaviour bit-exactly.
    """

    def __init__(self, seed: int = 0, noise: float = 0.05,
                 systematic: float = 0.10, het: float = 0.0,
                 topology: "Topology | None" = None):
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.systematic = systematic
        self.het = het
        self.topology = topology

    # ---- data plane --------------------------------------------------------
    def transfer_time(self, gb: float, src: str, dst: str,
                      noisy: bool = True) -> float:
        """Ground-truth seconds to ship ``gb`` from node ``src`` to
        ``dst`` under the configured ``Topology`` (0 without one, or on
        the same node — the data is already there).  ``noisy`` applies
        the same lognormal run-to-run jitter as task runtimes; the
        noise-free value is what a perfectly-informed planner would
        price, so bench arms compare against ``noisy=False`` truth."""
        if self.topology is None or src == dst or gb <= 0:
            return 0.0
        t = float(gb) * self.topology.pair_secs_per_gb(src, dst)
        if noisy and t > 0:
            t *= self.rng.lognormal(0.0, self.noise)
        return float(t)

    @staticmethod
    def _pair_rng(task_name: str, node_name: str,
                  tag: str) -> np.random.Generator:
        """Deterministic per-(task, node, property) generator from a
        stable hash (crc32, not builtin ``hash`` — stable across
        processes): hidden pair properties are fixed facts of the
        cluster, not draws from the simulation stream."""
        import zlib
        h = zlib.crc32(f"{task_name}|{node_name}|{tag}".encode()) % (2 ** 31)
        return np.random.default_rng(h)

    def _sys_mult(self, task_name: str, node_name: str) -> float:
        if self.systematic <= 0:
            return 1.0
        g = self._pair_rng(task_name, node_name, "sys").normal(
            0.0, self.systematic)
        return float(np.exp(g))

    def noise_sd(self, task_name: str, node_name: str) -> float:
        """Lognormal sd of this pair's run-to-run jitter (``noise`` unless
        ``het > 0``; the per-pair factor comes from a stable hash, so it
        is a fixed property of the pair, not a draw)."""
        if self.het <= 0:
            return self.noise
        u = float(self._pair_rng(task_name, node_name, "het").random())
        return self.noise * (1.0 + self.het * u)

    # ---- genomics plane ---------------------------------------------------
    def run_task(self, task: TaskDef, node: NodeType, size_gb: float,
                 cpu_factor: float = 1.0, noisy: bool = True) -> float:
        s = effective_size(task, size_gb)
        cpu_t = (task.base * task.cpu_share + task.cpu_unit * s) \
            * (REF_CPU / node.cpu_score) / cpu_factor
        io_t = (task.base * (1 - task.cpu_share) + task.io_unit * s) \
            * (REF_IO / node.io_bw)
        t = (cpu_t + io_t) * self._sys_mult(task.name, node.name)
        if noisy:
            t *= self.rng.lognormal(0.0, self.noise_sd(task.name, node.name))
        return float(t)

    def expected_task_runtime(self, task: TaskDef, node: NodeType,
                              size_gb: float) -> float:
        return self.run_task(task, node, size_gb, noisy=False)

    def actual_factor(self, task: TaskDef, local: NodeType, target: NodeType,
                      size_gb: float) -> float:
        """True runtime ratio target/local (paper Tables 4-5)."""
        return (self.expected_task_runtime(task, target, size_gb)
                / self.expected_task_runtime(task, local, size_gb))

    # ---- ML plane ----------------------------------------------------------
    def run_cell(self, cell: dict, node: NodeType, token_fraction: float = 1.0,
                 chips: int | None = None, cpu_factor: float = 1.0,
                 noisy: bool = True) -> float:
        """Step time of a dry-run cell record on `chips` of `node`'s type.
        ``cpu_factor < 1`` throttles the compute units (the paper's reduced
        CPU-frequency probe, phase 2)."""
        r = cell["roofline"]
        base_chips = r["chips"]
        chips = chips or base_chips
        scale = token_fraction * base_chips / chips
        family = cell.get("family", "*")
        eff = node.eff(family)
        compute = r["flops_per_device"] * scale / (node.peak_flops * eff
                                                   * cpu_factor)
        memory = r["bytes_per_device"] * scale / node.hbm_bw
        coll = r["coll_bytes_per_device"] * scale / node.link_bw
        t = max(compute, memory, coll) + 0.35 * min(compute, memory, coll)
        if noisy:
            t *= self.rng.lognormal(0.0, self.noise)
        return float(t)


# ---------------------------------------------------------------------------
# Zone/rack topology (bandwidth matrix for data-aware scheduling)
# ---------------------------------------------------------------------------
class Topology:
    """Zone (rack) placement + pairwise bandwidth — the cluster-side half
    of data-aware HEFT (``repro_torch.sched.heft.CommCosts`` is the DAG-side
    half).

    ``zones`` maps node name -> zone label; ``bandwidth_gbps`` prices a
    zone *pair* in GB/s (unordered — ``(a, b)`` and ``(b, a)`` are the
    same link; the zone-keyed dict shape follows the grid-engine
    ``COMM_COSTS`` convention).  Unlisted pairs fall back to
    ``intra_gbps`` within a zone and ``cross_gbps`` across zones, so the
    common two-tier rack model needs no explicit table at all.  The
    scheduler consumes the *reciprocal*: seconds per GB, zero on the
    diagonal (same node — no copy), small within a zone, large across
    racks.
    """

    def __init__(self, zones: dict[str, str],
                 bandwidth_gbps: dict[tuple[str, str], float] | None = None,
                 intra_gbps: float = 10.0, cross_gbps: float = 1.0):
        if intra_gbps <= 0 or cross_gbps <= 0:
            raise ValueError("bandwidths must be positive (zero bandwidth "
                             "would make every transfer infinite)")
        self.zones = {str(n): str(z) for n, z in zones.items()}
        self.bandwidth_gbps: dict[frozenset, float] = {}
        for (z1, z2), g in (bandwidth_gbps or {}).items():
            if g <= 0:
                raise ValueError(f"bandwidth for zone pair ({z1}, {z2}) "
                                 f"must be positive, got {g}")
            self.bandwidth_gbps[frozenset((str(z1), str(z2)))] = float(g)
        self.intra_gbps = float(intra_gbps)
        self.cross_gbps = float(cross_gbps)

    @classmethod
    def split(cls, names: list[str], n_zones: int = 2,
              **kw) -> "Topology":
        """Deal ``names`` round-robin into ``rack0..rack{n-1}`` — the
        stock cross-rack scenario used by the bench and tests.
        Round-robin (not contiguous blocks) so every node *type* spans
        racks: with ``from_types``-style ``type/0, type/1, ...`` naming,
        a type's instances land in different zones and placement has a
        real locality choice to make."""
        if n_zones < 1:
            raise ValueError(f"n_zones must be >= 1, got {n_zones}")
        return cls({n: f"rack{i % n_zones}" for i, n in enumerate(names)},
                   **kw)

    @classmethod
    def blocks(cls, names: list[str], n_zones: int = 2,
               **kw) -> "Topology":
        """Deal ``names`` in contiguous blocks into ``rack0..rack{n-1}``.
        With ``from_types`` ordering this concentrates each node type in
        one rack — racks become heterogeneous in speed, so chasing the
        fastest hardware means leaving the rack your data is on.  The
        adversarial counterpart to ``split`` for locality benches."""
        if n_zones < 1:
            raise ValueError(f"n_zones must be >= 1, got {n_zones}")
        per = max(1, -(-len(names) // n_zones))
        return cls({n: f"rack{min(i // per, n_zones - 1)}"
                    for i, n in enumerate(names)}, **kw)

    def zone(self, name: str) -> str:
        return self.zones[name]

    def gbps(self, z1: str, z2: str) -> float:
        """Bandwidth between two zones (symmetric)."""
        key = frozenset((z1, z2))
        if key in self.bandwidth_gbps:
            return self.bandwidth_gbps[key]
        return self.intra_gbps if z1 == z2 else self.cross_gbps

    def pair_secs_per_gb(self, src: str, dst: str) -> float:
        """Transfer price for one node pair: 0 on the same node."""
        if src == dst:
            return 0.0
        return 1.0 / self.gbps(self.zones[src], self.zones[dst])

    def secs_per_gb(self, names: list[str],
                    alive: dict[str, bool] | None = None) -> np.ndarray:
        """(N, N) seconds-per-GB matrix over ``names`` — what
        ``CommCosts`` consumes.  Zero diagonal; same-zone pairs get the
        intra rate (the zone discount), cross-zone the link rate.

        ``alive`` masks dead nodes *as data sources*: a crashed node's
        outgoing rows are re-priced at the worst finite off-diagonal
        rate in the matrix, so the planner can never treat a dead
        replica as a cheap place to read an input from (placement ON
        dead nodes is already impossible via the executor's ``+inf``
        ``ready_vector``; this closes the source side).  The masking is
        stateless — recomputing after a rejoin restores the node's real
        prices automatically."""
        unknown = [n for n in names if n not in self.zones]
        if unknown:
            raise KeyError(f"nodes missing from topology zones: {unknown}")
        N = len(names)
        spg = np.zeros((N, N))
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                if i != j:
                    spg[i, j] = 1.0 / self.gbps(self.zones[a], self.zones[b])
        if alive is not None:
            dead = [i for i, n in enumerate(names) if not alive.get(n, True)]
            if dead and N > 1:
                off = spg[~np.eye(N, dtype=bool)]
                worst = float(off.max())
                for i in dead:
                    spg[i, :] = worst
                    spg[i, i] = 0.0   # CommCosts' free-diagonal invariant
        return spg

    def secs_per_gb_dict(self, names: list[str]
                         ) -> dict[str, dict[str, float]]:
        """Dict-of-dicts view of ``secs_per_gb`` for the string-keyed
        ``heft_schedule`` API and debugging."""
        spg = self.secs_per_gb(names)
        return {a: {b: float(spg[i, j]) for j, b in enumerate(names)}
                for i, a in enumerate(names)}


# ---------------------------------------------------------------------------
# Fault process (node crashes, transient outages, attempt failures)
# ---------------------------------------------------------------------------
class FaultInjector:
    """Deterministic, seeded fault process for the online execution loop.

    Three failure modes, mirroring real grid-engine churn:

    * **permanent crashes** — ``crash_at[node] = t``: the node dies at
      ``t`` and never returns; running attempts there are lost.
    * **transient outages** — ``outages[node] = (down, up)``: the node is
      lost at ``down`` (running attempts killed) and rejoins at ``up``.
    * **attempt failures** — each (task, node) pair carries a fixed
      failure probability derived from a stable hash, exactly like the
      cluster's hidden ``het``/``systematic`` pair properties:
      ``p = min(1, p_fail * (1 + p_spread * u))`` with ``u`` uniform in
      [0, 1) per pair.  Whether attempt ``k`` of a task on a node fails —
      and at what fraction of its runtime the failure manifests — is a
      deterministic function of (task, node, attempt, seed), so the same
      scenario replays bit-identically.

    The injector only *describes* faults; the ``OnlineExecutor`` applies
    them (``faults=None`` there keeps the fault-free loop bit-exact).
    """

    def __init__(self, *, crash_at: dict[str, float] | None = None,
                 outages: dict[str, tuple[float, float]] | None = None,
                 p_fail: float = 0.0, p_spread: float = 1.0, seed: int = 0):
        if not 0.0 <= p_fail <= 1.0:
            raise ValueError(f"p_fail must be in [0, 1], got {p_fail}")
        self.crash_at = {str(k): float(v)
                         for k, v in (crash_at or {}).items()}
        self.outages = {str(k): (float(v[0]), float(v[1]))
                        for k, v in (outages or {}).items()}
        for node, (down, up) in self.outages.items():
            if up <= down:
                raise ValueError(f"outage on {node!r}: up {up} <= down "
                                 f"{down}")
        self.p_fail = float(p_fail)
        self.p_spread = float(p_spread)
        self.seed = int(seed)

    def _rng(self, *parts) -> np.random.Generator:
        """Stable-hash generator (crc32, like ``ClusterSimulator._pair_rng``
        — stable across processes): fault properties are fixed facts of
        the scenario, not draws from a shared stream."""
        import zlib
        key = "|".join(str(p) for p in parts) + f"|{self.seed}"
        return np.random.default_rng(zlib.crc32(key.encode()) % (2 ** 31))

    def node_events(self) -> list[tuple[float, str, str]]:
        """Time-sorted membership events: ``(time, node, 'down'|'up')``."""
        evs = [(t, n, "down") for n, t in self.crash_at.items()]
        for n, (down, up) in self.outages.items():
            evs.append((down, n, "down"))
            evs.append((up, n, "up"))
        return sorted(evs)

    def attempt_fail_prob(self, task_id: str, node: str) -> float:
        """The pair's fixed per-attempt failure probability."""
        if self.p_fail <= 0.0:
            return 0.0
        u = float(self._rng("p", task_id, node).random())
        return min(1.0, self.p_fail * (1.0 + self.p_spread * u))

    def attempt_outcome(self, task_id: str, node: str,
                        attempt: int) -> float | None:
        """``None`` if attempt ``attempt`` of ``task_id`` on ``node``
        succeeds; otherwise the fraction of the attempt's runtime at
        which the failure manifests (in (0, 1) — the elapsed time up to
        it is a *censored* lower bound on the true runtime)."""
        p = self.attempt_fail_prob(task_id, node)
        if p <= 0.0:
            return None
        g = self._rng("draw", task_id, node, attempt)
        if float(g.random()) >= p:
            return None
        return float(g.uniform(0.05, 0.95))


# ---------------------------------------------------------------------------
# Discrete-event engine (scheduler benchmarks, straggler/failure injection)
# ---------------------------------------------------------------------------
@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    payload: dict = field(compare=False, default_factory=dict)


@dataclass
class SimNode:
    name: str
    node_type: NodeType
    busy_until: float = 0.0
    alive: bool = True
    slowdown: float = 1.0      # straggler multiplier (hidden)


class GridEngine:
    """Named-node availability registry — the minimal cluster-state API the
    online executor drives (grid-engine style: concrete node instances of
    heterogeneous types, each busy until some time).

    Deliberately dumb: it knows who is free when, nothing about tasks.
    The executor owns queues and decisions; ``EventSimulator`` remains the
    batch-mode engine for pre-computed schedules."""

    def __init__(self, nodes: list[SimNode],
                 topology: Topology | None = None):
        self.nodes = {n.name: n for n in nodes}
        self.topology = topology
        # observability: membership churn (fail/join) is emitted through
        # this tracer; NULL_TRACER is the zero-cost disabled default and
        # OnlineExecutor(tracer=...) swaps in its live EventLog
        from repro_torch.obs.trace import NULL_TRACER
        self.tracer = NULL_TRACER

    @classmethod
    def from_types(cls, nodes_per_type: int = 2,
                   types: list[NodeType] | None = None,
                   topology: Topology | None = None) -> "GridEngine":
        """Expand node types into `nodes_per_type` instances each
        (named ``<type>/<i>``, like the scheduler benchmarks)."""
        types = list(types) if types is not None else target_nodes()
        return cls([SimNode(name=f"{nt.name}/{i}", node_type=nt)
                    for nt in types for i in range(nodes_per_type)],
                   topology=topology)

    def secs_per_gb(self) -> np.ndarray | None:
        """Current (N, N) transfer-price matrix in ``names()`` order, with
        dead nodes masked as data sources (see ``Topology.secs_per_gb``) —
        ``None`` when no topology is configured (comm-blind engine).
        Recomputed from live membership on every call, so a rejoining
        node re-enters real comm pricing immediately."""
        if self.topology is None:
            return None
        return self.topology.secs_per_gb(
            self.names(), alive={n: sn.alive
                                 for n, sn in self.nodes.items()})

    def names(self) -> list[str]:
        return list(self.nodes)

    def type_of(self, name: str) -> NodeType:
        return self.nodes[name].node_type

    def occupy(self, name: str, until: float) -> None:
        self.nodes[name].busy_until = until

    def release(self, name: str, at: float) -> None:
        """Free a node earlier than its booked end — a running attempt was
        killed (e.g. a speculative-copy race resolved elsewhere)."""
        sn = self.nodes[name]
        sn.busy_until = min(sn.busy_until, at)

    def idle(self, t: float) -> list[str]:
        return [n for n, sn in self.nodes.items()
                if sn.alive and sn.busy_until <= t + 1e-12]

    def ready_vector(self, t: float) -> np.ndarray:
        """(N,) earliest availability per node (``names()`` order) — the
        ``node_ready`` floor for a mid-execution HEFT re-plan.  Dead
        nodes are masked with ``+inf``: their EFT is infinite, so a
        re-plan can never place frontier work there (``idle`` filters
        them for dispatch; this is the planning-side twin)."""
        return np.array([max(sn.busy_until, t) if sn.alive else np.inf
                         for sn in self.nodes.values()])

    # ---- elastic membership -----------------------------------------------
    def fail(self, name: str, at: float) -> None:
        """The node dies (crash or outage start) at ``at``: it stops
        accepting work (``idle``/``ready_vector`` mask it) and anything
        booked on it is void — the caller is responsible for re-queueing
        the killed attempts."""
        sn = self.nodes[name]
        sn.alive = False
        sn.busy_until = float(at)
        if self.tracer.enabled:
            self.tracer.emit("node_down", t_sim=at, node=name)

    def join(self, node: "SimNode | str", at: float = 0.0) -> None:
        """A node (re-)joins at ``at``: an existing name is revived (an
        outage ending), a new ``SimNode`` is registered (cluster grows).
        Consumers that pinned the node universe at construction (e.g. a
        running ``OnlineExecutor``) only see revivals; genuinely new
        nodes are picked up by executors built afterwards."""
        if isinstance(node, SimNode):
            node.alive = True
            node.busy_until = max(node.busy_until, float(at))
            self.nodes[node.name] = node
            if self.tracer.enabled:
                self.tracer.emit("node_up", t_sim=at, node=node.name,
                                 new=True)
            return
        sn = self.nodes[node]
        sn.alive = True
        sn.busy_until = max(sn.busy_until, float(at))
        if self.tracer.enabled:
            self.tracer.emit("node_up", t_sim=at, node=node)


class EventSimulator:
    """Executes a scheduled task DAG over concrete nodes with optional
    failure/straggler injection.  Returns per-task records + makespan."""

    def __init__(self, nodes: list[SimNode], sim: ClusterSimulator,
                 seed: int = 0):
        self.nodes = {n.name: n for n in nodes}
        self.sim = sim
        self.rng = np.random.default_rng(seed + 17)

    def run_schedule(self, tasks: list[dict], deps: dict[str, list[str]],
                     assignment: dict[str, str],
                     runtime_fn=None,
                     fail_at: dict[str, float] | None = None,
                     reassign_fn=None,
                     on_incomplete: str = "raise") -> dict:
        """tasks: [{id, task(TaskDef), size}]; deps: id -> prereq ids;
        assignment: id -> node name.  runtime_fn overrides the ground truth.
        ``fail_at``: node -> time (node dies; queued work is re-assigned via
        ``reassign_fn(task_id, dead_node) -> node``).

        When the schedule cannot complete — a dependency deadlock, or a
        failed node's work with no ``reassign_fn`` — the result would
        silently truncate ``records``; ``on_incomplete`` controls the
        signal: ``"raise"`` (default) raises ``RuntimeError`` naming the
        stranded task ids, ``"warn"`` emits a ``RuntimeWarning`` and
        returns the partial result, ``"ignore"`` returns it silently
        (the pre-fix behaviour; ``completed < total`` is then the only
        indicator)."""
        if on_incomplete not in ("raise", "warn", "ignore"):
            raise ValueError(f"on_incomplete must be 'raise', 'warn' or "
                             f"'ignore', got {on_incomplete!r}")
        fail_at = dict(fail_at or {})
        by_id = {t["id"]: t for t in tasks}
        done: dict[str, float] = {}
        records = []
        remaining = set(by_id)
        node_free = {n: 0.0 for n in self.nodes}
        t_now = 0.0
        guard = 0
        while remaining and guard < 10 * len(by_id):
            guard += 1
            ready = [tid for tid in sorted(remaining)
                     if all(d in done for d in deps.get(tid, []))]
            if not ready:
                break
            progressed = False
            for tid in ready:
                rec = by_id[tid]
                node_name = assignment[tid]
                node = self.nodes[node_name]
                # node failure: re-assign
                if node_name in fail_at and max(
                        node_free[node_name],
                        max([done[d] for d in deps.get(tid, [])], default=0.0)
                ) >= fail_at[node_name]:
                    node.alive = False
                    if reassign_fn is None:
                        continue
                    node_name = reassign_fn(tid, node_name)
                    node = self.nodes[node_name]
                start = max(node_free[node_name],
                            max([done[d] for d in deps.get(tid, [])],
                                default=0.0))
                dur = (runtime_fn(rec, node) if runtime_fn else
                       self.sim.run_task(rec["task"], node.node_type,
                                         rec["size"]))
                dur *= node.slowdown
                done[tid] = start + dur
                node_free[node_name] = start + dur
                records.append({"id": tid, "node": node_name, "start": start,
                                "duration": dur, "end": start + dur})
                remaining.discard(tid)
                progressed = True
            if not progressed:
                break
        if remaining and on_incomplete != "ignore":
            stranded = sorted(remaining)
            shown = ", ".join(stranded[:8]) + \
                (", ..." if len(stranded) > 8 else "")
            on_dead = sorted(t for t in remaining
                             if not self.nodes[assignment[t]].alive)
            why = (f"{len(on_dead)} assigned to failed nodes with no "
                   f"reassign_fn" if on_dead else "dependency deadlock")
            msg = (f"run_schedule incomplete: {len(stranded)} of "
                   f"{len(by_id)} tasks stranded ({shown}) — {why}")
            if on_incomplete == "raise":
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        makespan = max((r["end"] for r in records), default=0.0)
        return {"records": records, "makespan": makespan,
                "completed": len(records), "total": len(by_id)}


def load_dryrun_cells(art_dir: str | Path) -> list[dict]:
    """Load dry-run artifacts (the ML-plane task universe)."""
    out = []
    for p in sorted(Path(art_dir).glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("status") == "ok":
            out.append(r)
    return out
