"""Online estimation: the observation stream, the event-driven executor
and the multi-workflow fleet.

Port of ``repro.online``.  The loop interleaves run → observe →
re-predict → re-schedule over grid-engine-style heterogeneous nodes,
through the port's ``LotaruEstimator`` (legacy mode) or its
``TickEngine`` (``fused=True``); ``fleet`` advances W workflows' stacked
estimator states in one batched tick.
"""
from .buffer import Observation, ObservationBuffer
from .executor import (CensoredRun, ExecutionTrace, OnlineExecutor, TaskRun,
                       fanout_chain_dag, run_static_and_online)
from .fleet import (FleetState, fleet_predict, fleet_slice, fleet_tick_step,
                    pad_obs, pad_state, shard_fleet, stack_states)

__all__ = ["Observation", "ObservationBuffer", "CensoredRun",
           "ExecutionTrace", "OnlineExecutor", "TaskRun",
           "fanout_chain_dag", "run_static_and_online", "FleetState",
           "fleet_predict", "fleet_slice", "fleet_tick_step", "pad_obs",
           "pad_state", "shard_fleet", "stack_states"]
