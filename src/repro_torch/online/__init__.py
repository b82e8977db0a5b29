"""Online estimation: the observation stream and the event-driven executor.

Port of ``repro.online``.  The loop interleaves run → observe →
re-predict → re-schedule over grid-engine-style heterogeneous nodes,
through the port's ``LotaruEstimator`` (legacy mode) or its
``TickEngine`` (``fused=True``).  The multi-workflow fleet axis
(``FleetState``, ``fleet_predict``, ``fleet_tick_step``, ``pad_obs``,
``pad_state``, ``shard_fleet``, ``stack_states``, ``fleet_slice``) is not
ported yet, so its names are not exported here.
"""
from .buffer import Observation, ObservationBuffer
from .executor import (CensoredRun, ExecutionTrace, OnlineExecutor, TaskRun,
                       fanout_chain_dag, run_static_and_online)

__all__ = ["Observation", "ObservationBuffer", "CensoredRun",
           "ExecutionTrace", "OnlineExecutor", "TaskRun",
           "fanout_chain_dag", "run_static_and_online"]
