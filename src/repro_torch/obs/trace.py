"""Structured event tracing for the online estimator loop.

The observe → re-predict → re-plan tick was a black box beyond a dozen
integer counters on ``ExecutionTrace``; this module makes it inspectable.
``OnlineExecutor``, ``GridEngine`` and both estimator planes emit typed
events through a ``Tracer`` — a two-method protocol (``emit`` for instant
events, ``span`` for wall-clock-timed regions) — and the concrete
``EventLog`` collects them append-only with both clocks attached: the
simulation time the event refers to and the wall time it was recorded at.

Tracing is strictly read-only: an attached tracer observes the loop, it
never perturbs it (``tests/test_obs.py`` proves the executor's output is
bit-identical with and without one).  With no tracer attached every site
goes through the shared ``NULL_TRACER`` singleton, whose ``emit`` is a
bare ``pass`` and whose ``span`` hands back one reusable no-op context
manager — the disabled path costs attribute lookups, nothing else.

Export formats:

* ``to_jsonl`` / ``load_jsonl`` — one JSON object per line, the stable
  machine-readable substrate every diagnostic in ``repro_torch.obs`` consumes;
* ``to_chrome`` — Chrome ``trace_event`` JSON: open it in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing`` and the run renders
  as two process tracks — host wall-clock spans (plan / predict /
  update), and the simulation clock with one thread lane per node
  showing every task attempt as a duration slice, with faults, retries
  and speculations as instant markers.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Protocol, runtime_checkable

#: trace file format version, stamped into every JSONL export
TRACE_FORMAT_VERSION = 1

#: the closed event taxonomy (see docs/architecture.md for field maps).
#: ``emit`` warns on anything else rather than raising — a trace with an
#: unknown event is more useful than an execution killed by telemetry.
EVENT_KINDS = frozenset({
    "run_start",    # loop config snapshot (tasks, nodes, knobs)
    "tick",         # one popped event-heap entry (the loop's heartbeat)
    "plan",         # a (re-)plan of the unstarted frontier
    "dispatch",     # an attempt starts on a node
    "finish",       # an attempt completes (start/end/runtime/prediction)
    "observe",      # a completion fed back to the estimator, with its
                    # dispatch-time interval, coverage flag and PIT
    "predict",      # an estimate-matrix refresh (dirty rows re-predicted)
    "surprise",     # a runtime fell outside its predictive interval
    "speculation",  # a straggler copy was launched
    "fault",        # an attempt was lost (censored observation)
    "retry",        # a lost task re-queued with its backoff delay
    "backoff",      # a backoff window expired (the retry becomes runnable)
    "node_down",    # a node crashed or entered an outage
    "node_up",      # a node rejoined after an outage
    "stranded",     # a task was abandoned (non-strict mode)
    "run_end",      # final counters (makespan, completions, ...)
    "span",         # a wall-clock-timed region (phase + dur_s)
})


@dataclass(frozen=True)
class Event:
    """One trace event: a kind from ``EVENT_KINDS``, the simulation time
    it refers to, the wall time it was recorded at (seconds since the
    log's creation), and a kind-specific payload dict."""
    kind: str
    t_sim: float
    t_wall: float
    data: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"kind": self.kind, "t_sim": self.t_sim,
                "t_wall": self.t_wall, **self.data}

    @classmethod
    def from_json(cls, d: dict) -> "Event":
        d = dict(d)
        return cls(kind=d.pop("kind"), t_sim=float(d.pop("t_sim")),
                   t_wall=float(d.pop("t_wall")), data=d)


class _NullSpan:
    """Reusable no-op context manager (one shared instance, no per-call
    allocation on the disabled path)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


@runtime_checkable
class Tracer(Protocol):
    """What an instrumented site needs: ``enabled`` to guard payload
    construction, ``emit`` for instant events, ``span`` for timed
    regions.  ``EventLog`` is the collecting implementation;
    ``NullTracer`` the zero-cost disabled one."""
    enabled: bool

    def emit(self, kind: str, t_sim: float = 0.0, **data) -> None: ...

    def span(self, phase: str, t_sim: float = 0.0, **data): ...


class NullTracer:
    """The disabled tracer: ``emit`` is a bare pass, ``span`` returns a
    shared no-op context manager.  All instrumentation sites default to
    the module-level ``NULL_TRACER`` singleton, so untraced execution
    pays only the attribute lookup."""
    enabled = False
    __slots__ = ()

    def emit(self, kind: str, t_sim: float = 0.0, **data) -> None:
        pass

    def span(self, phase: str, t_sim: float = 0.0, **data):
        return _NULL_SPAN


NULL_TRACER = NullTracer()


class EventLog:
    """Append-only typed event log (the concrete ``Tracer``).

    Wall times are seconds since construction (``perf_counter`` deltas),
    so exported traces are machine-relocatable.  The log never mutates
    anything it observes; it only appends."""
    enabled = True

    def __init__(self):
        self.events: list[Event] = []
        self._t0 = time.perf_counter()

    # ---- Tracer protocol ---------------------------------------------------
    def emit(self, kind: str, t_sim: float = 0.0, **data) -> None:
        if kind not in EVENT_KINDS:
            import warnings
            warnings.warn(f"unknown trace event kind {kind!r} (known: "
                          f"{sorted(EVENT_KINDS)})", stacklevel=2)
        self.events.append(Event(kind=kind, t_sim=float(t_sim),
                                 t_wall=time.perf_counter() - self._t0,
                                 data=data))

    @contextmanager
    def span(self, phase: str, t_sim: float = 0.0, **data):
        """Time a region: on exit one ``span`` event is emitted carrying
        ``phase``, the wall duration ``dur_s``, and any extra payload."""
        w0 = time.perf_counter()
        try:
            yield self
        finally:
            self.events.append(Event(
                kind="span", t_sim=float(t_sim),
                t_wall=w0 - self._t0,
                data={"phase": phase,
                      "dur_s": time.perf_counter() - w0, **data}))

    # ---- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def filter(self, kind: str) -> list[Event]:
        return [e for e in self.events if e.kind == kind]

    def spans(self, phase: str | None = None) -> list[Event]:
        return [e for e in self.events if e.kind == "span"
                and (phase is None or e.data.get("phase") == phase)]

    def counters(self) -> dict[str, int]:
        """Event count per kind (span events additionally broken out per
        phase as ``span:<phase>``)."""
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
            if e.kind == "span":
                k = f"span:{e.data.get('phase', '?')}"
                out[k] = out.get(k, 0) + 1
        return out

    # ---- export ------------------------------------------------------------
    def to_jsonl(self, path) -> Path:
        """One event per line; first line is a format header."""
        path = Path(path)
        with path.open("w") as f:
            f.write(json.dumps({"trace_format": TRACE_FORMAT_VERSION,
                                "events": len(self.events)}) + "\n")
            for e in self.events:
                f.write(json.dumps(e.to_json()) + "\n")
        return path

    def to_chrome(self, path) -> Path:
        """Chrome ``trace_event`` JSON (Perfetto-loadable) — see the
        module docstring for the track layout."""
        path = Path(path)
        path.write_text(json.dumps(
            {"traceEvents": chrome_trace_events(self.events),
             "displayTimeUnit": "ms"}))
        return path


def load_jsonl(path) -> list[Event]:
    """Load a ``to_jsonl`` trace back into ``Event`` objects (the header
    line is validated and skipped; headerless files still load)."""
    events: list[Event] = []
    with Path(path).open() as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if i == 0 and "trace_format" in d:
                if d["trace_format"] > TRACE_FORMAT_VERSION:
                    raise ValueError(
                        f"trace format {d['trace_format']} is newer than "
                        f"this reader (v{TRACE_FORMAT_VERSION})")
                continue
            events.append(Event.from_json(d))
    return events


def chrome_trace_events(events: Iterable[Event]) -> list[dict]:
    """Translate an event stream into Chrome ``trace_event`` dicts.

    Two processes: pid 1 is the host wall clock (every ``span`` as an
    ``X`` duration slice on one thread per phase), pid 2 is the
    simulation clock (every ``finish`` as a duration slice on its node's
    own thread lane; faults / retries / speculations / node churn as
    instant ``i`` markers).  All timestamps are microseconds, as the
    format requires.
    """
    out: list[dict] = []
    out.append({"ph": "M", "pid": 1, "name": "process_name",
                "args": {"name": "host (wall clock)"}})
    out.append({"ph": "M", "pid": 2, "name": "process_name",
                "args": {"name": "simulation (sim clock)"}})
    phase_tid: dict[str, int] = {}
    node_tid: dict[str, int] = {}

    def _phase_tid(phase: str) -> int:
        if phase not in phase_tid:
            phase_tid[phase] = len(phase_tid) + 1
            out.append({"ph": "M", "pid": 1, "tid": phase_tid[phase],
                        "name": "thread_name", "args": {"name": phase}})
        return phase_tid[phase]

    def _node_tid(node: str) -> int:
        if node not in node_tid:
            node_tid[node] = len(node_tid) + 1
            out.append({"ph": "M", "pid": 2, "tid": node_tid[node],
                        "name": "thread_name", "args": {"name": node}})
        return node_tid[node]

    for e in events:
        if e.kind == "span":
            phase = str(e.data.get("phase", "?"))
            args = {k: v for k, v in e.data.items()
                    if k not in ("phase", "dur_s")}
            out.append({"name": phase, "ph": "X", "pid": 1,
                        "tid": _phase_tid(phase),
                        "ts": e.t_wall * 1e6,
                        "dur": e.data.get("dur_s", 0.0) * 1e6,
                        "args": args})
        elif e.kind == "finish":
            node = str(e.data.get("node", "?"))
            start = float(e.data.get("start", e.t_sim))
            out.append({"name": str(e.data.get("task", "?")), "ph": "X",
                        "pid": 2, "tid": _node_tid(node),
                        "ts": start * 1e6,
                        "dur": (e.t_sim - start) * 1e6,
                        "args": {k: v for k, v in e.data.items()
                                 if k not in ("node", "start")}})
        elif e.kind in ("fault", "retry", "speculation", "surprise",
                        "node_down", "node_up", "stranded"):
            node = str(e.data.get("node", "?"))
            out.append({"name": e.kind, "ph": "i", "pid": 2,
                        "tid": _node_tid(node), "ts": e.t_sim * 1e6,
                        "s": "g", "args": dict(e.data)})
    return out
