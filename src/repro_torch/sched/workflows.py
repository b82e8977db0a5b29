"""Synthetic nf-core-like workflow suite (paper Table 3 analogue).

The published Lotaru traces are not available offline, so we generate a
workload suite with the same *structure*: 5 workflows with the paper's
abstract-task counts (Eager 13, Methylseq 8, Chipseq 14, Atacseq 14,
Bacass 5), two datasets each with the paper's uncompressed input sizes,
and per-task CPU/I-O mixes spanning the regimes the paper reports
(CPU-bound bwa, I/O-bound markduplicates, size-independent bcftools_stats
that exercises the median fallback, a non-linear samtools task, ...).

Each task's hidden ground truth on a node is
    t = [cpu_unit * size_gb * (ref_cpu / node.cpu_score) / cpu_factor
         + io_unit * size_gb * (ref_io / node.io_bw)] * noise
(reference machine = the paper's local workstation scores), which makes the
"actual runtime factor" between two nodes exactly the CPU/I-O-mix-weighted
ratio the paper's eq. 6 estimates.
"""
from __future__ import annotations

from dataclasses import dataclass

REF_CPU = 458.0     # local machine sysbench events/s (paper Table 2)
REF_IO = 415.0      # local machine fio MB/s


@dataclass(frozen=True)
class TaskDef:
    name: str
    workflow: str
    cpu_unit: float          # s per GB of input on the reference machine
    io_unit: float           # s per GB
    kind: str = "linear"     # linear | flat | sqrt
    base: float = 5.0        # constant seconds (dominates for kind="flat")
    out_unit: float = 0.25   # GB shipped downstream per effective input GB

    @property
    def cpu_share(self) -> float:
        return self.cpu_unit / max(self.cpu_unit + self.io_unit, 1e-9)


def _wf(workflow: str, specs: list[tuple]) -> list[TaskDef]:
    return [TaskDef(name=n, workflow=workflow, cpu_unit=c, io_unit=i,
                    kind=k, base=b) for (n, c, i, k, b) in specs]


WORKFLOWS: dict[str, list[TaskDef]] = {
    # name                      cpu_u   io_u   kind      base
    "eager": _wf("eager", [
        ("bwa",                  220.0,  14.0, "linear",  10.0),
        ("fastqc",                55.0,  28.0, "linear",   5.0),
        ("fastqc_after_clip",     52.0,  26.0, "linear",   5.0),
        ("adapter_removal",       80.0,  35.0, "linear",   8.0),
        ("samtools_flagstat",      6.0,  22.0, "linear",   2.0),
        ("samtools_filter",       18.0,  48.0, "linear",   4.0),
        ("samtools_f_a_f",         4.0,   9.0, "sqrt",     3.0),
        ("markduplicates",        25.0, 110.0, "linear",  10.0),
        ("damageprofiler",        60.0,  25.0, "linear",   6.0),
        ("preseq",                42.0,  18.0, "linear",   4.0),
        ("qualimap",              70.0,  45.0, "linear",   8.0),
        ("genotyping_hc",        180.0,  30.0, "linear",  15.0),
        ("bcftools_stats",         0.5,   0.5, "flat",    42.0),
    ]),
    "methylseq": _wf("methylseq", [
        ("fastqc",                55.0,  28.0, "linear",   5.0),
        ("trim_galore",           75.0,  40.0, "linear",   6.0),
        ("bismark_align",        260.0,  30.0, "linear",  12.0),
        ("bismark_deduplicate",   30.0,  95.0, "linear",   8.0),
        ("bismark_methxtract",    90.0,  40.0, "linear",   8.0),
        ("samtools_sort",         24.0,  60.0, "linear",   4.0),
        ("qualimap",              70.0,  45.0, "linear",   8.0),
        ("multiqc",                1.0,   1.0, "flat",    35.0),
    ]),
    "chipseq": _wf("chipseq", [
        ("fastqc",                55.0,  28.0, "linear",   5.0),
        ("trim_galore",           75.0,  40.0, "linear",   6.0),
        ("bwa_mem",              230.0,  18.0, "linear",  10.0),
        ("samtools_sort",         24.0,  60.0, "linear",   4.0),
        ("samtools_flagstat",      6.0,  22.0, "linear",   2.0),
        ("picard_markdup",        25.0, 105.0, "linear",  10.0),
        ("picard_collectmetrics", 40.0,  35.0, "linear",   6.0),
        ("preseq",                42.0,  18.0, "linear",   4.0),
        ("phantompeakqualtools", 120.0,  20.0, "linear",  10.0),
        ("deeptools_plotfpt",     35.0,  30.0, "linear",   5.0),
        ("macs2",                 90.0,  35.0, "linear",   8.0),
        ("homer_annotate",        50.0,  40.0, "linear",   6.0),
        ("subread_featurecounts", 30.0,  28.0, "sqrt",     5.0),
        ("multiqc",                1.0,   1.0, "flat",    35.0),
    ]),
    "atacseq": _wf("atacseq", [
        ("fastqc",                55.0,  28.0, "linear",   5.0),
        ("trim_galore",           75.0,  40.0, "linear",   6.0),
        ("bwa_mem",              230.0,  18.0, "linear",  10.0),
        ("samtools_sort",         24.0,  60.0, "linear",   4.0),
        ("samtools_flagstat",      6.0,  22.0, "linear",   2.0),
        ("picard_markdup",        25.0, 105.0, "linear",  10.0),
        ("picard_collectmetrics", 40.0,  35.0, "linear",   6.0),
        ("preseq",                42.0,  18.0, "linear",   4.0),
        ("deeptools_plotprofile", 35.0,  30.0, "linear",   5.0),
        ("macs2",                 90.0,  35.0, "linear",   8.0),
        ("homer_annotate",        50.0,  40.0, "linear",   6.0),
        ("subread_featurecounts", 30.0,  28.0, "sqrt",     5.0),
        ("ataqv",                 45.0,  25.0, "linear",   5.0),
        ("multiqc",                1.0,   1.0, "flat",    35.0),
    ]),
    "bacass": _wf("bacass", [
        ("fastqc",                55.0,  28.0, "linear",   5.0),
        ("skewer",                65.0,  38.0, "linear",   6.0),
        ("unicycler",            420.0,  45.0, "linear",  25.0),
        ("prokka",               150.0,  30.0, "linear",  12.0),
        ("quast",                  2.0,   2.0, "flat",    28.0),
    ]),
}

# (workflow, dataset) -> uncompressed input size in GB (paper Table 3)
INPUTS: dict[tuple[str, int], float] = {
    ("eager", 1): 8.33, ("eager", 2): 25.71,
    ("methylseq", 1): 17.03, ("methylseq", 2): 23.0,
    ("chipseq", 1): 4.81, ("chipseq", 2): 32.98,
    ("atacseq", 1): 14.09, ("atacseq", 2): 11.81,
    ("bacass", 1): 3.64, ("bacass", 2): 4.35,
}


def all_experiments() -> list[tuple[str, int, float]]:
    return [(wf, ds, size) for (wf, ds), size in INPUTS.items()]


def effective_size(task: TaskDef, size_gb: float) -> float:
    """Size transform by task kind: linear, sqrt (sub-linear tools), flat."""
    if task.kind == "flat":
        return 0.0
    if task.kind == "sqrt":
        return size_gb ** 0.5
    return size_gb


#: every edge ships at least this much (manifests, logs, QC reports) —
#: keeps flat tasks (effective size 0) from pretending their downstream
#: reads nothing at all
EDGE_BASE_GB = 0.02


def edge_gb(task: TaskDef, size_gb: float) -> float:
    """GB the task ships along EACH outgoing DAG edge for an input of
    ``size_gb``: its output volume ``out_unit * effective_size`` plus the
    ``EDGE_BASE_GB`` floor.  Output scales with the same kind-transformed
    size as runtime does — flat report tasks (multiqc, quast) ship only
    the floor, aligners ship the big BAMs — so data-aware placement
    faces the realistic mix of heavy and negligible edges."""
    return EDGE_BASE_GB + task.out_unit * effective_size(task, size_gb)


def dag_edge_gb(tasks, task_name: dict[str, str],
                by_name: dict[str, TaskDef],
                size_gb: float) -> dict[tuple[str, str], float]:
    """Per-edge data sizes for an instance DAG over this workflow.

    ``tasks`` is a ``{task_id: SchedTask}`` DAG (e.g. from
    ``fanout_chain_dag``), ``task_name`` maps instance id -> abstract
    task name, ``by_name`` maps name -> ``TaskDef``.  Returns the
    ``(producer_id, consumer_id) -> GB`` dict that ``heft_schedule`` /
    ``CommCosts`` consume; every edge out of a producer carries that
    producer's ``edge_gb`` volume."""
    out: dict[tuple[str, str], float] = {}
    for tid, t in tasks.items():
        gb = edge_gb(by_name[task_name[tid]], size_gb)
        for s in t.succ:
            out[(tid, s)] = gb
    return out
