"""Step accounting and the roofline (counterpart of ``repro.analysis``;
the lint pack is not ported yet: ROADMAP.md, Queue A item 5)."""
from .roofline import (HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS, Roofline,
                       model_flops)
from .step_stats import StepStats, step_stats

__all__ = ["HBM_BW", "HBM_BYTES", "LINK_BW", "PEAK_FLOPS", "Roofline",
           "StepStats", "model_flops", "step_stats"]
