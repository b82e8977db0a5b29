from .heft import (CommCosts, SchedTask, detect_stragglers, heft_schedule,
                   heft_schedule_array, heft_schedule_reference,
                   realized_makespan, reschedule_elastic,
                   round_robin_schedule, simulate_with_stragglers,
                   upward_rank_array)
from .simulator import (ClusterSimulator, EventSimulator, FaultInjector,
                        GridEngine, SimNode, Topology, load_dryrun_cells)
from .workflows import (INPUTS, WORKFLOWS, TaskDef, all_experiments,
                        dag_edge_gb, edge_gb)

__all__ = ["CommCosts", "SchedTask", "detect_stragglers", "heft_schedule",
           "heft_schedule_array", "heft_schedule_reference",
           "realized_makespan", "reschedule_elastic",
           "round_robin_schedule", "simulate_with_stragglers",
           "upward_rank_array", "ClusterSimulator", "EventSimulator",
           "FaultInjector", "GridEngine", "SimNode", "Topology",
           "load_dryrun_cells", "INPUTS", "WORKFLOWS", "TaskDef",
           "all_experiments", "dag_edge_gb", "edge_gb"]
