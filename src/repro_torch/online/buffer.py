"""Observation stream for online estimation.

An ``ObservationBuffer`` is the append-only log of realised task runtimes
that the execution engine feeds back into the estimator: each entry keeps
both the runtime as measured on the target node and its de-adjusted
local-machine equivalent (what actually entered the model), so the stream
can be replayed — ``update_task_batch_stream`` over ``arrays()`` rebuilds
the estimator state reached online.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np


@dataclass(frozen=True)
class Observation:
    task: str             # abstract task name (the estimator's row)
    node: str             # node (type) the runtime was measured on
    size: float           # input size / token count
    runtime: float        # as measured on `node`
    local_runtime: float  # de-adjusted by the node factor (model units)
    time: float = 0.0     # simulation time of the completion


class ObservationBuffer:
    """Append-only stream of ``Observation``s with replay helpers."""

    #: default tick-grouping tolerance — ``add`` maintains the incremental
    #: tick index at exactly this atol, so the common ``by_tick()`` call
    #: never has to re-group the whole stream
    TICK_ATOL = 1e-12

    def __init__(self):
        self._obs: list[Observation] = []
        self._ticks: list[tuple[float, list[Observation]]] = []

    def add(self, obs: Observation) -> None:
        self._obs.append(obs)
        # grouping is against the FIRST time of the open group (not the
        # previous observation), matching the legacy one-shot scan exactly
        if self._ticks and abs(obs.time - self._ticks[-1][0]) <= \
                self.TICK_ATOL:
            self._ticks[-1][1].append(obs)
        else:
            self._ticks.append((obs.time, [obs]))

    def record(self, task: str, node: str, size: float, runtime: float,
               local_runtime: float, time: float = 0.0) -> Observation:
        obs = Observation(task=task, node=node, size=size, runtime=runtime,
                          local_runtime=local_runtime, time=time)
        self.add(obs)
        return obs

    def __len__(self) -> int:
        return len(self._obs)

    def __iter__(self):
        return iter(self._obs)

    def __getitem__(self, i):
        return self._obs[i]

    def count(self, task: str) -> int:
        return sum(1 for o in self._obs if o.task == task)

    def per_task(self) -> dict[str, list[Observation]]:
        out: dict[str, list[Observation]] = {}
        for o in self._obs:
            out.setdefault(o.task, []).append(o)
        return out

    def arrays(self, task_index: dict[str, int]):
        """(task_idx, sizes, local_runtimes) arrays in stream order — the
        exact input ``update_task_batch_stream`` needs to replay the
        stream onto a freshly fitted ``BatchedTaskModel``.

        Raises ``ValueError`` naming the offending task when an
        observation's task is missing from ``task_index`` (a replay onto
        a model fitted for a different task set would otherwise die with
        a bare ``KeyError`` deep in the comprehension)."""
        missing = sorted({o.task for o in self._obs
                          if o.task not in task_index})
        if missing:
            raise ValueError(
                f"observation task(s) {missing} not in task_index "
                f"(known: {sorted(task_index)}) — the buffer was recorded "
                "against a different task set than the model being replayed")
        idx = np.array([task_index[o.task] for o in self._obs], np.int64)
        sizes = np.array([o.size for o in self._obs], np.float64)
        local = np.array([o.local_runtime for o in self._obs], np.float64)
        return idx, sizes, local

    def to_dict(self) -> dict:
        """JSON-ready dict of the stream (order-preserving) — the
        observation half of ``ExecutionTrace.to_dict``."""
        return {"observations": [asdict(o) for o in self._obs]}

    @classmethod
    def from_dict(cls, d: dict) -> "ObservationBuffer":
        buf = cls()
        for o in d["observations"]:
            buf.add(Observation(task=str(o["task"]), node=str(o["node"]),
                                size=float(o["size"]),
                                runtime=float(o["runtime"]),
                                local_runtime=float(o["local_runtime"]),
                                time=float(o.get("time", 0.0))))
        return buf

    def by_tick(self, atol: float = TICK_ATOL) -> list[tuple[float,
                                                         list[Observation]]]:
        """Group the stream by completion time (within ``atol``): the
        same-tick batches the executor fed through ``observe_batch`` —
        replaying tick by tick reproduces the online update sequence.

        The default-``atol`` grouping is served from the index ``add``
        maintains incrementally, so calling this after every completion
        (the replay-while-running pattern) no longer re-scans the whole
        stream each time; a non-default ``atol`` falls back to the
        one-shot scan.  Returned group lists are fresh copies either way.
        """
        if atol == self.TICK_ATOL:
            return [(t, list(g)) for t, g in self._ticks]
        out: list[tuple[float, list[Observation]]] = []
        for o in self._obs:
            if out and abs(o.time - out[-1][0]) <= atol:
                out[-1][1].append(o)
            else:
                out.append((o.time, [o]))
        return out
