"""Public SSD entry, in the model layout (B, T, H, P)."""
from __future__ import annotations

import torch

from .kernel import ssd_scan, ssd_scan_bwd
from .ref import ssd_chunked


class _SSDScan(torch.autograd.Function):
    """The forward kernel, which keeps the state entering each chunk, and
    the backward kernel as its gradient.  ``chunk`` takes no gradient; a
    None gradient of the final state is read as zeros without forming
    them, and a None ``state0`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, dt, a, B_, C_, state0, chunk):
        ctx.set_materialize_grads(False)
        y, state, states = ssd_scan(x, dt, a, B_, C_, chunk=chunk,
                                    state0=state0, return_states=True)
        ctx.save_for_backward(x, dt, a, B_, C_, states)
        ctx.chunk, ctx.has_state0 = chunk, state0 is not None
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, B_, C_, states = ctx.saved_tensors
        if dy is None:      # only the final state reaches the loss
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, da, dB, dC, dstate0 = ssd_scan_bwd(
            x, dt, a, B_, C_, dy, states, chunk=ctx.chunk, dstate=dstate,
            state0_grad=ctx.has_state0 and ctx.needs_input_grad[5])
        return dx, ddt, da, dB, dC, dstate0, None


def ssd(x, dt, a, B_, C_, *, chunk: int, state0=None):
    """The chunked SSD scan: (y: (B, T, H, P) fp32, final_state:
    (B, H, P, N) fp32); shapes as ``ref.ssd_chunked``.

    A CUDA tensor launches the hand-written kernel (or raises); where a
    gradient is wanted it goes through ``_SSDScan``, whose backward is the
    hand-written backward kernel.  A CPU tensor takes the plain version,
    which autograd differentiates.  Nothing else picks between them.
    """
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, B_, C_, chunk, state0=state0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, B_, C_, state0)):
        return _SSDScan.apply(x, dt, a, B_, C_, state0, chunk)
    return ssd_scan(x, dt, a, B_, C_, chunk=chunk, state0=state0)
