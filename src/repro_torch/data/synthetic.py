"""Deterministic synthetic data: the LM token pipeline and workflow DAGs.

``SyntheticLMData`` gives the batches of ``repro.data.SyntheticLMData``
value for value: a batch is a pure function of (seed, step, host), drawn
from the same numpy stream, so a restored run at step N sees what an
uninterrupted run would have, and the port trains on the JAX package's
tokens.  ``synthetic_dag`` is a WfCommons-style layered workflow generator
(seeded; width/depth/fan-out/data-size distributions) that scales past 10k
tasks — the stress harness for data-aware HEFT.  Same seed and parameters
give a bit-identical DAG.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig


@dataclass(frozen=True)
class SyntheticLMData:
    """Batches of ``global_batch // host_count`` rows of ``seq`` tokens on
    ``device`` (default: the CUDA card): "tokens" and next-token "labels"
    (int32); vlm adds "vision_embeds" (B, max(2, seq // 8), d_model) bf16
    and arange "positions" (B, seq + that, 3); encdec adds "src_embeds"
    (B, seq, d_model) fp32."""
    cfg: ModelConfig
    seq: int
    global_batch: int
    seed: int = 0
    device: Any = None

    def batch(self, step: int, host_index: int = 0,
              host_count: int = 1) -> dict:
        dev = resolve_device(self.device)
        b = self.global_batch // host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_index]))
        tokens = rng.integers(0, self.cfg.vocab, (b, self.seq),
                              dtype=np.int32)
        # next-token labels over a repeating-pattern stream: learnable signal
        pattern = (np.arange(self.seq, dtype=np.int32)[None, :]
                   + rng.integers(0, 97, (b, 1), dtype=np.int32)) % 97
        tokens = (tokens % 7) * 97 // 7 + pattern % 7  # mixture, in-vocab
        tokens = tokens.astype(np.int32) % self.cfg.vocab
        labels = np.roll(tokens, -1, axis=1)
        out = {"tokens": torch.from_numpy(tokens).to(dev),
               "labels": torch.from_numpy(labels).to(dev)}
        if self.cfg.family == "vlm":
            nv = max(2, self.seq // 8)
            # rounded once from float64, as jnp.asarray rounds it
            out["vision_embeds"] = torch.from_numpy(
                rng.normal(0, 0.1, (b, nv, self.cfg.d_model))).to(
                torch.bfloat16).to(dev)
            T = self.seq + nv
            pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None, :, None],
                                  (b, T, 3))
            out["positions"] = torch.from_numpy(pos.copy()).to(dev)
        if self.cfg.family == "encdec":
            out["src_embeds"] = torch.from_numpy(
                rng.normal(0, 0.1, (b, self.seq, self.cfg.d_model)).astype(
                    np.float32)).to(dev)
        return out



# ---------------------------------------------------------------------------
# WfCommons-style synthetic workflow DAGs (scheduler stress + property tests)
# ---------------------------------------------------------------------------
DAG_SCHEMA_VERSION = 1


class SyntheticDAG:
    """An immutable task DAG with per-edge data volumes and per-task work.

    ``succ`` / ``pred`` are index-based adjacency lists (mirror-consistent
    by construction contract — validated), ``data_gb[t]`` is aligned with
    ``pred[t]`` (GB arriving along each in-edge), ``work[t]`` the task's
    abstract compute demand in reference-seconds.  The layout matches what
    ``repro_torch.sched.heft.CommCosts`` and ``heft_schedule_array`` consume
    directly, so a 10k-task instance never materialises a (T, T) matrix.
    """

    def __init__(self, succ: list[list[int]], pred: list[list[int]],
                 data_gb: list[list[float]], work,
                 params: dict | None = None):
        T = len(succ)
        if len(pred) != T:
            raise ValueError(f"succ has {T} tasks but pred has {len(pred)}")
        if len(data_gb) != T:
            raise ValueError(f"data_gb has {len(data_gb)} rows for {T} tasks")
        for t in range(T):
            if len(data_gb[t]) != len(pred[t]):
                raise ValueError(
                    f"data_gb[{t}] has {len(data_gb[t])} entries but task "
                    f"{t} has {len(pred[t])} predecessors")
            for g in data_gb[t]:
                if g < 0:
                    raise ValueError(f"data_gb: negative data size {g} on "
                                     f"an edge into task {t}")
        # mirror consistency: (p -> t) in succ[p] iff p in pred[t]
        fwd = {(p, t) for t in range(T) for p in pred[t]}
        bwd = {(t, s) for t in range(T) for s in succ[t]}
        if fwd != bwd:
            bad = sorted(fwd.symmetric_difference(bwd))[:3]
            raise ValueError(f"succ/pred adjacency is not mirror-consistent "
                             f"(first mismatches: {bad})")
        for t in range(T):
            for s in succ[t]:
                if not 0 <= s < T:
                    raise ValueError(f"edge ({t}, {s}) references a task "
                                     f"outside 0..{T - 1}")
        # cycle check (raises ValueError naming the cycle) — reuse the
        # scheduler's Kahn pass so "valid DAG" means the same thing in
        # both layers
        from repro_torch.sched.heft import _topo_order
        _topo_order(succ, pred)
        w = np.asarray(work, np.float64)
        if w.shape != (T,):
            raise ValueError(f"work must be shape ({T},), got {w.shape}")
        if (w < 0).any():
            raise ValueError("work has negative entries")
        self.succ = succ
        self.pred = pred
        self.data_gb = data_gb
        self.work = w
        self.params = dict(params or {})

    @property
    def n_tasks(self) -> int:
        return len(self.succ)

    @property
    def n_edges(self) -> int:
        return sum(len(s) for s in self.succ)

    def edge_dict(self) -> dict[tuple[int, int], float]:
        """``(producer, consumer) -> GB`` — the sparse ``CommCosts``
        input form."""
        return {(p, t): float(g)
                for t in range(self.n_tasks)
                for p, g in zip(self.pred[t], self.data_gb[t])}

    def cost_matrix(self, speeds) -> np.ndarray:
        """(T, N) runtime estimates: ``work[t] / speeds[n]`` — the
        minimal heterogeneous-cluster cost model for scheduler benches
        (``speeds`` in reference-machine multiples, all > 0)."""
        sp = np.asarray(speeds, np.float64)
        if sp.ndim != 1 or (sp <= 0).any():
            raise ValueError("speeds must be a 1-D vector of positive "
                             "node speed multipliers")
        return self.work[:, None] / sp[None, :]

    def to_dict(self) -> dict:
        """JSON-safe serialisation: edges as flat ``[producer, consumer,
        gb]`` triples (10k-task DAGs stay linear in E, never (T, T))."""
        return {"version": DAG_SCHEMA_VERSION,
                "params": dict(self.params),
                "n_tasks": self.n_tasks,
                "edges": [[p, t, float(g)]
                          for t in range(self.n_tasks)
                          for p, g in zip(self.pred[t], self.data_gb[t])],
                "work": [float(w) for w in self.work]}

    @classmethod
    def from_dict(cls, d: dict) -> "SyntheticDAG":
        if d.get("version", 0) >= 1:
            T = int(d["n_tasks"])
            succ: list[list[int]] = [[] for _ in range(T)]
            pred: list[list[int]] = [[] for _ in range(T)]
            data_gb: list[list[float]] = [[] for _ in range(T)]
            for p, t, g in d["edges"]:
                succ[int(p)].append(int(t))
                pred[int(t)].append(int(p))
                data_gb[int(t)].append(float(g))
            return cls(succ, pred, data_gb, d["work"],
                       params=d.get("params"))
        raise ValueError(f"unknown SyntheticDAG schema version "
                         f"{d.get('version')!r}")


def synthetic_dag(width: int = 8, depth: int = 10, fanout: float = 2.0,
                  data_gb_mean: float = 1.0, data_gb_sigma: float = 0.75,
                  work_mean: float = 60.0, work_sigma: float = 0.6,
                  seed: int = 0) -> SyntheticDAG:
    """Generate a layered WfCommons-style workflow DAG.

    ``depth`` layers of ~``width`` tasks each (layer sizes jitter in
    [ceil(width/2), width]); every non-root task draws ``k ~ 1 +
    Poisson(fanout - 1)`` predecessors from the previous layer, so
    ``fanout`` is the mean in-degree and E stays O(T · fanout) — the
    bounded-degree regime where the comm-aware EFT loop is O(T·N).
    Per-edge volumes are lognormal(ln ``data_gb_mean``,
    ``data_gb_sigma``) — heavy-tailed like real intermediate files —
    and per-task work lognormal(ln ``work_mean``, ``work_sigma``).

    Same (seed, params) → bit-identical DAG (structure, sizes, work):
    draws come from one ``np.random.default_rng(seed)`` stream in a
    fixed order.  Degenerate parameters raise ``ValueError`` naming the
    offending parameter.
    """
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if fanout < 1.0:
        raise ValueError(f"fanout must be >= 1.0 (mean in-degree), "
                         f"got {fanout}")
    if data_gb_mean <= 0:
        raise ValueError(f"data_gb_mean must be > 0, got {data_gb_mean}")
    if data_gb_sigma < 0:
        raise ValueError(f"data_gb_sigma must be >= 0, got {data_gb_sigma}")
    if work_mean <= 0:
        raise ValueError(f"work_mean must be > 0, got {work_mean}")
    if work_sigma < 0:
        raise ValueError(f"work_sigma must be >= 0, got {work_sigma}")
    rng = np.random.default_rng(seed)
    lo = (width + 1) // 2
    sizes = [int(rng.integers(lo, width + 1)) for _ in range(depth)]
    layers: list[list[int]] = []
    nxt = 0
    for sz in sizes:
        layers.append(list(range(nxt, nxt + sz)))
        nxt += sz
    T = nxt
    succ: list[list[int]] = [[] for _ in range(T)]
    pred: list[list[int]] = [[] for _ in range(T)]
    data_gb: list[list[float]] = [[] for _ in range(T)]
    for li in range(1, depth):
        prev = layers[li - 1]
        for t in layers[li]:
            k = min(len(prev), 1 + int(rng.poisson(fanout - 1.0)))
            ps = sorted(int(p) for p in
                        rng.choice(prev, size=k, replace=False))
            for p in ps:
                succ[p].append(t)
                pred[t].append(p)
                data_gb[t].append(float(rng.lognormal(
                    np.log(data_gb_mean), data_gb_sigma)))
    work = rng.lognormal(np.log(work_mean), work_sigma, size=T)
    params = {"width": width, "depth": depth, "fanout": fanout,
              "data_gb_mean": data_gb_mean, "data_gb_sigma": data_gb_sigma,
              "work_mean": work_mean, "work_sigma": work_sigma, "seed": seed}
    return SyntheticDAG(succ, pred, data_gb, work, params=params)
