"""Synthetic data of the port: workflow DAGs."""
from .synthetic import DAG_SCHEMA_VERSION, SyntheticDAG, synthetic_dag

__all__ = ["DAG_SCHEMA_VERSION", "SyntheticDAG", "synthetic_dag"]
