"""Observability of the estimator plane: the tracer protocol and its
disabled default."""
from .trace import NULL_TRACER, NullTracer, Tracer

__all__ = ["NULL_TRACER", "NullTracer", "Tracer"]
