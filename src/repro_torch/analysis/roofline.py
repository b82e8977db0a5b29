"""Three-term roofline model over dry-run records (NVIDIA H100 SXM).

Counterpart of ``repro.analysis.roofline``, with one card's constants:

  compute term    = step FLOPs       / (chips * PEAK_FLOPS)
  memory term     = step HBM bytes   / (chips * HBM_BW)
  collective term = collective bytes / (chips * LINK_BW)

``step_stats`` counts FLOPs and bytes per device, so each term is the
per-device quantity over the per-card rate.

MODEL_FLOPS uses the 6·N·D convention (N params — active params for MoE —
D tokens processed) so the "useful fraction" ratio catches remat and
dispatch waste.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

# NVIDIA H100 SXM5 80GB, per card: data-sheet figures at the full 700 W
# power limit, not readings (a card set below 700 W runs slower).
PEAK_FLOPS = 989e12   # dense bf16 tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12      # HBM3 bytes/s (data sheet)
LINK_BW = 450e9       # NVLink 4 bytes/s per direction (data sheet: 900 GB/s total)
HBM_BYTES = 80e9      # HBM3 capacity, bytes (data sheet)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_total: float
    step_tokens: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time estimate: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_fraction(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-time / the roofline step time — the headline score."""
        ideal = self.model_flops_total / (self.chips * PEAK_FLOPS)
        t = self.step_time_s
        return ideal / t if t else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, bound=self.bound,
                 step_time_s=self.step_time_s,
                 useful_flop_fraction=self.useful_flop_fraction,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg, kind: str, seq: int, global_batch: int) -> tuple[float, int]:
    """(6·N_active·tokens for train, 2·N·tokens for inference), tokens."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = seq * global_batch
        return 6.0 * n_active * tokens, tokens
    if kind == "prefill":
        tokens = seq * global_batch
        return 2.0 * n_active * tokens, tokens
    # decode: one token per sequence
    tokens = global_batch
    return 2.0 * n_active * tokens, tokens
