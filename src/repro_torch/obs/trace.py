"""The disabled tracer of the estimator plane.

``LotaruEstimator`` and ``GridEngine`` emit spans and events through a
``Tracer``: ``emit`` for instant events, ``span`` for wall-clock-timed
regions.  With no tracer attached every site goes through the shared
``NULL_TRACER``, whose ``emit`` is a bare ``pass`` and whose ``span``
hands back one reusable no-op context manager.  Any object with the
``Tracer`` protocol can be attached in its place.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable


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
    regions.  ``NullTracer`` is the zero-cost disabled one; the
    collecting ``EventLog`` is not ported yet."""
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
