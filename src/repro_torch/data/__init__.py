"""Synthetic data of the port: the LM token pipeline and workflow DAGs."""
from .synthetic import (DAG_SCHEMA_VERSION, SyntheticDAG, SyntheticLMData,
                        synthetic_dag)

__all__ = ["DAG_SCHEMA_VERSION", "SyntheticDAG", "SyntheticLMData",
           "synthetic_dag"]
