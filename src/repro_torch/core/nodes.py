"""Heterogeneous node-type registry.

The paper's cluster has 6 machine types (local, A1, A2, N1, N2, C2) that
differ in CPU and I/O capability.  Our accelerator analogue is a fleet of
TPU generations differing in peak FLOP/s, HBM and interconnect bandwidth —
plus the local CPU developer node where Lotaru's downsampled runs execute.

``true_*`` fields are the simulator's hidden ground truth; Lotaru only ever
sees microbenchmark *measurements* of them (with noise).  ``family_eff``
models per-task-family efficiency differences (e.g. scatter-heavy MoE
dispatch achieves a lower fraction of peak on older generations) — this is
what makes a single scalar factor per node *imperfect*, exactly the regime
the paper studies.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class NodeType:
    name: str
    # accelerator plane (per chip)
    peak_flops: float
    hbm_bw: float
    link_bw: float
    # host plane (genomics workload analogue, per core)
    cpu_score: float          # sysbench-like events/s
    io_bw: float              # MB/s sequential
    mem_score: float
    chips_per_node: int = 4
    # hidden per-family efficiency (fraction of roofline actually achieved)
    family_eff: dict = field(default_factory=dict)

    def eff(self, family: str) -> float:
        return self.family_eff.get(family, self.family_eff.get("*", 0.55))


# The six machine types (paper Table 2 analogue).  "local" mirrors the
# paper's developer workstation; A1/A2 are old commodity nodes (TPUv2/v3
# analogue), N1/N2/C2 map to v4/v5e/v5p.
NODE_TYPES: dict[str, NodeType] = {
    "local-cpu": NodeType(
        name="local-cpu", peak_flops=0.15e12, hbm_bw=40e9, link_bw=8e9,
        cpu_score=458, io_bw=415.0, mem_score=18_700, chips_per_node=1,
        family_eff={"*": 0.50, "moe": 0.35, "ssm": 0.45}),
    "tpu-v2": NodeType(
        name="tpu-v2", peak_flops=46e12, hbm_bw=700e9, link_bw=25e9,
        cpu_score=223, io_bw=303.0, mem_score=11_000,
        family_eff={"*": 0.40, "moe": 0.25, "ssm": 0.30, "dense": 0.45}),
    "tpu-v3": NodeType(
        name="tpu-v3", peak_flops=123e12, hbm_bw=900e9, link_bw=35e9,
        cpu_score=223, io_bw=338.0, mem_score=11_000,
        family_eff={"*": 0.45, "moe": 0.30, "ssm": 0.35, "dense": 0.50}),
    "tpu-v4": NodeType(
        name="tpu-v4", peak_flops=275e12, hbm_bw=1228e9, link_bw=50e9,
        cpu_score=369, io_bw=482.0, mem_score=13_400,
        family_eff={"*": 0.52, "moe": 0.40, "ssm": 0.45, "dense": 0.58}),
    "tpu-v5e": NodeType(
        name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
        cpu_score=468, io_bw=482.0, mem_score=17_000,
        family_eff={"*": 0.55, "moe": 0.42, "ssm": 0.48, "dense": 0.62}),
    "tpu-v5p": NodeType(
        name="tpu-v5p", peak_flops=459e12, hbm_bw=2765e9, link_bw=100e9,
        cpu_score=523, io_bw=482.0, mem_score=18_900,
        family_eff={"*": 0.58, "moe": 0.45, "ssm": 0.50, "dense": 0.65}),
}

# paper-machine aliases (for the genomics plane benchmarks)
PAPER_ALIAS = {"Local": "local-cpu", "A1": "tpu-v2", "A2": "tpu-v3",
               "N1": "tpu-v4", "N2": "tpu-v5e", "C2": "tpu-v5p"}


def get_node(name: str) -> NodeType:
    return NODE_TYPES[PAPER_ALIAS.get(name, name)]


def target_nodes() -> list[NodeType]:
    return [n for k, n in NODE_TYPES.items() if k != "local-cpu"]
