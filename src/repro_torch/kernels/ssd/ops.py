"""Public SSD entry, in the model layout (B, T, H, P)."""
from __future__ import annotations

from .kernel import ssd_scan
from .ref import ssd_chunked


def ssd(x, dt, a, B_, C_, *, chunk: int, state0=None):
    """The chunked SSD scan: (y: (B, T, H, P) fp32, final_state:
    (B, H, P, N) fp32); shapes as ``ref.ssd_chunked``.

    A CUDA tensor launches the hand-written kernel (or raises); a CPU
    tensor takes the plain version.  Nothing else picks between them.
    """
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, B_, C_, chunk, state0=state0)
    return ssd_scan(x, dt, a, B_, C_, chunk=chunk, state0=state0)
