"""The census of collectives: every collective the port calls, by op and
by kind, with its ring-model wire bytes.

The port writes its collectives out (``launch.sharding``), and each of its
five call sites hands every call to ``record``: the kind it counts (the
port's names: "tp_sum", "all_gather", "reduce_scatter", ...), the op
under ``repro.analysis.hlo_stats``' names (``OPS``), the size of the
group it runs over, and the payload tensor (the whole tensor a rank gives
to or takes from it: ``hlo_stats``' ``max(out_bytes, in_bytes)``).
``record`` adds the payload and the call to ``BYTES`` and ``CALLS`` (by
kind, for this process) and, while a ``census()`` block is active, to its
``Census``: calls by op, wire bytes by op (``wire_bytes``: the ring model
of ``hlo_stats``, an all-reduce 2 (g - 1) / g of its payload, an
all-gather, reduce-scatter or all-to-all (g - 1) / g, a
collective-permute 1x), calls, payload and wire bytes by kind, and calls
and wire bytes by call site: (op, payload shape and dtype, kind, the
innermost frame of the port outside ``launch/sharding.py`` and this
module).  ``analysis.step_stats`` opens one for its block, so a traced
step's ``StepStats`` carries the census, on ``meta`` tensors over a fake
process group (the dry run on a mesh) as on the card.

This module imports nothing of the port, so ``launch.sharding`` and
``analysis.step_stats`` both import it without a cycle.
"""
from __future__ import annotations

import functools
import os
import sys
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import torch

#: the collective ops, as ``hlo_stats`` names them
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")

#: payload bytes and calls of each collective kind in this process
BYTES: Counter = Counter()
CALLS: Counter = Counter()

_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]
#: the files whose frames are not a call site: the recorder and the
#: collectives' wrappers
_SKIP = {str(Path(__file__).resolve()),
         str(_PORT / "launch" / "sharding.py")}


def wire_bytes(op: str, payload: int, group: int) -> float:
    """The bytes a rank puts on the wire for a collective of ``payload``
    bytes over a group of ``group`` ranks, by ``hlo_stats``' ring model."""
    if op not in OPS:
        raise ValueError(f"{op!r} is not one of {OPS}")
    if op == "all-reduce":
        return 2.0 * payload * (group - 1) / group
    if op == "collective-permute":
        return float(payload)
    return payload * (group - 1) / group


@dataclass
class Census:
    """The collectives recorded during a ``census()`` block."""
    counts: Counter = field(default_factory=Counter)        # calls by op
    wire_by_op: Counter = field(default_factory=Counter)    # float bytes
    by_kind: dict = field(default_factory=dict)
    #: (op, shape, dtype, kind, site) -> [calls, wire bytes, payload
    #: bytes of one call]
    sites: dict = field(default_factory=dict)

    def add(self, kind: str, op: str, group: int, payload: int, shape,
            dtype, site: str) -> None:
        wire = wire_bytes(op, payload, group)
        self.counts[op] += 1
        self.wire_by_op[op] += wire
        k = self.by_kind.setdefault(kind, {"calls": 0, "payload_bytes": 0,
                                           "wire_bytes": 0.0})
        k["calls"] += 1
        k["payload_bytes"] += payload
        k["wire_bytes"] += wire
        s = self.sites.setdefault((op, tuple(shape), str(dtype), kind, site),
                                  [0, 0.0, payload])
        s[0] += 1
        s[1] += wire

    @property
    def bytes_by_op(self) -> dict[str, int]:
        """Wire bytes by op, whole bytes (``HloStats``'
        ``collective_bytes_by_op``)."""
        return {op: int(v) for op, v in self.wire_by_op.items()}

    @property
    def total_bytes(self) -> int:
        """Wire bytes of all ops (``HloStats.collective_bytes``)."""
        return int(sum(self.wire_by_op.values()))

    def calls_by_kind(self) -> dict[str, int]:
        return {k: v["calls"] for k, v in self.by_kind.items()}

    def payload_by_kind(self) -> dict[str, int]:
        return {k: v["payload_bytes"] for k, v in self.by_kind.items()}

    def top_sites(self, n: int | None = None) -> list[dict]:
        """The call sites by wire bytes, most first."""
        rows = [{"op": op, "shape": list(shape), "dtype": dtype,
                 "kind": kind, "site": site, "calls": calls,
                 "payload_bytes": payload, "wire_bytes": wire}
                for (op, shape, dtype, kind, site), (calls, wire, payload)
                in self.sites.items()]
        rows.sort(key=lambda r: -r["wire_bytes"])
        return rows[:n]


_ACTIVE: list[Census] = []


@contextmanager
def census():
    """``with census() as c: ...``: ``c`` (a ``Census``) records every
    collective the block calls, in this process."""
    c = Census()
    _ACTIVE.append(c)
    try:
        yield c
    finally:
        _ACTIVE.remove(c)


@functools.lru_cache(maxsize=None)
def _where(filename: str) -> tuple[str | None, bool]:
    """(the file's path relative to the checkout, or None outside it;
    whether a frame of it may be a call site of the port)."""
    path = Path(os.path.realpath(filename))
    if not path.is_relative_to(_ROOT):
        return None, False
    return path.relative_to(_ROOT).as_posix(), (
        path.is_relative_to(_PORT) and str(path) not in _SKIP)


def _site() -> str:
    """The innermost frame of the port outside the collectives' wrappers,
    else of the checkout, else "?": "path:line"."""
    frame = sys._getframe(1)
    ours = None
    while frame is not None:
        rel, port = _where(frame.f_code.co_filename)
        if port:
            return f"{rel}:{frame.f_lineno}"
        if ours is None and rel is not None and not rel.startswith(
                _PORT.relative_to(_ROOT).as_posix() + "/"):
            ours = f"{rel}:{frame.f_lineno}"
        frame = frame.f_back
    return ours or "?"


def record(kind: str, op: str, group: int, payload: torch.Tensor) -> None:
    """Count one collective call: its ``kind``, ``op`` (one of ``OPS``),
    ``group`` (the ranks it runs over) and ``payload`` (the whole tensor
    a rank gives to or takes from it)."""
    nbytes = payload.numel() * payload.element_size()
    BYTES[kind] += nbytes
    CALLS[kind] += 1
    if _ACTIVE:
        site = _site()
        for c in _ACTIVE:
            c.add(kind, op, group, nbytes, payload.shape, payload.dtype,
                  site)
