"""Public SSD entry, in the model layout (B, T, H, P)."""
from __future__ import annotations

import torch

from .kernel import ssd_scan
from .ref import ssd_chunked


def ssd(x, dt, a, B_, C_, *, chunk: int, state0=None):
    """The chunked SSD scan: (y: (B, T, H, P) fp32, final_state:
    (B, H, P, N) fp32); shapes as ``ref.ssd_chunked``.

    A CUDA tensor launches the hand-written kernel (or raises); a CPU
    tensor takes the plain version, which autograd differentiates.
    Nothing else picks between them.  The kernel has no backward yet: on
    a CUDA tensor where a gradient is wanted this raises rather than
    return a result that autograd cannot see through.
    """
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, B_, C_, chunk, state0=state0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, B_, C_, state0)):
        raise NotImplementedError(
            "ssd: the SSD scan kernel has no backward yet, so ssm and hybrid "
            "models do not train on the card (ROADMAP.md, Queue A: the SSD "
            "backward kernel)")
    return ssd_scan(x, dt, a, B_, C_, chunk=chunk, state0=state0)
