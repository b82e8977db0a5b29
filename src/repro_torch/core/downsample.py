"""Phase 2: input downsampling (paper §3.2 / §5.1).

The paper splits one input file geometrically: s1 = X/2, s_n = s_{n-1}/2
(10 partitions; 16 for Chipseq).  Two domains here:

* genomics plane — partition sizes in GB of one input sample;
* ML-workload plane — token counts of a workload cell: the "input size" of
  a training/prefill step is its token count; downsampling produces reduced
  (seq, batch) pairs whose product follows the same geometric ladder, run
  for real on the local CPU with a reduced-but-same-family model config.

``partition_sizes`` is shared by both planes.
"""
from __future__ import annotations

from dataclasses import dataclass


def partition_sizes(original: float, n: int = 10) -> list[float]:
    """Geometric ladder: [X/2, X/4, ..., X/2^n] (paper §5.1)."""
    out = []
    s = original / 2.0
    for _ in range(n):
        out.append(s)
        s /= 2.0
    return out


@dataclass(frozen=True)
class WorkloadPartition:
    """A reduced run of a workload cell on the local machine."""
    seq: int
    batch: int

    @property
    def tokens(self) -> int:
        return self.seq * self.batch


def downsample_workload(seq: int, global_batch: int, n: int = 6,
                        min_seq: int = 32) -> list[WorkloadPartition]:
    """Geometric token ladder for an (arch x shape) cell.

    Halve batch first (keeps per-step shape identical), then sequence —
    mirroring how the paper halves file contents while keeping the format.
    """
    parts = []
    b, s = global_batch, seq
    for _ in range(n):
        if b > 1:
            b = max(1, b // 2)
        elif s > min_seq:
            s = max(min_seq, s // 2)
        else:
            break
        parts.append(WorkloadPartition(seq=s, batch=b))
    return parts


def reduced_model_factor(full_params: int, local_params: int) -> float:
    """Scale factor between the locally-runnable reduced model and the full
    config (Lotaru extrapolates runtime linearly in model FLOPs; the paper's
    linear size→runtime assumption, applied along the parameter axis)."""
    return full_params / max(local_params, 1)
