"""Lotaru's four phases in PyTorch: infrastructure profiling,
downsampled local execution, Bayesian linear regression with Pearson
gating, per-node factor adjustment — the estimator path that feeds the
scheduler, and the fused online tick over one ``EstimatorState``
(``state``/``tick``), plus the accelerator-plane integration
(``LotaruML``) that feeds the scheduler.  Port of ``repro.core``."""
from .blr import (BatchedTaskModel, BiasModel, BLRPosterior, OnlineStats,
                  ReliabilityModel, SampleLog, TaskModel,
                  fit, fit_batch, fit_task, fit_task_batch, pearson,
                  pearson_batch, predict, predict_batch, predict_batch_grid,
                  predict_cdf, predict_interval, predict_task_batch,
                  predict_task_batch_grid, slice_task_model,
                  stack_task_models, unstack_task_models, update_task_batch,
                  update_task_batch_stream, CORRELATION_THRESHOLD)
from .adjust import (BenchArrays, cpu_weight, deviation, roofline_weights,
                     runtime_factor, runtime_factor3, stack_benches)
from .baselines import BASELINES, NaiveEstimator, OnlineM, OnlineP
from .downsample import (WorkloadPartition, downsample_workload,
                         partition_sizes, reduced_model_factor)
from .estimator import (FittedCell, FittedTask, LotaruEstimator, LotaruML,
                        SCHEMA_VERSION, young_daly_interval)
from .nodes import NODE_TYPES, NodeType, PAPER_ALIAS, get_node, target_nodes
from .profiler import BenchResult, profile_cluster, profile_local, profile_node
from .state import (EstimatorState, StateMeta, StateNames, bias_view,
                    build_state, reliability_view, write_back)
from .tick import TickEngine, predict_state, tick_step

__all__ = [
    "BatchedTaskModel", "BiasModel", "BLRPosterior", "OnlineStats",
    "ReliabilityModel", "SampleLog", "TaskModel", "fit",
    "fit_batch", "fit_task", "fit_task_batch", "pearson", "pearson_batch",
    "predict", "predict_batch", "predict_batch_grid", "predict_cdf",
    "predict_interval", "predict_task_batch", "predict_task_batch_grid",
    "slice_task_model", "stack_task_models", "unstack_task_models",
    "update_task_batch", "update_task_batch_stream", "SCHEMA_VERSION",
    "CORRELATION_THRESHOLD", "BenchArrays", "stack_benches",
    "cpu_weight", "deviation",
    "roofline_weights", "runtime_factor", "runtime_factor3", "BASELINES",
    "NaiveEstimator", "OnlineM", "OnlineP", "WorkloadPartition",
    "downsample_workload", "partition_sizes", "reduced_model_factor",
    "FittedCell", "FittedTask", "LotaruEstimator", "LotaruML",
    "young_daly_interval", "NODE_TYPES", "NodeType",
    "PAPER_ALIAS", "get_node", "target_nodes", "BenchResult",
    "profile_cluster", "profile_local", "profile_node", "EstimatorState",
    "StateMeta", "StateNames", "bias_view", "build_state",
    "reliability_view", "write_back", "TickEngine", "predict_state",
    "tick_step",
]
