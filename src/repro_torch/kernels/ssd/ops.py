"""Public SSD entry, in the model layout (B, T, H, P)."""
from __future__ import annotations

import torch

from .._meta import kernel_call
from .kernel import ssd_scan, ssd_scan_bwd
from .ref import ssd_chunked, ssd_chunked_flops


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


class _MetaSSD(torch.autograd.Function):
    """The route on ``meta`` tensors (``kernels/_meta.py``): y and the
    final state, and where a gradient is wanted the chunk states that
    ``_SSDScan`` keeps, recorded with the FLOPs of ``ssd_chunked`` forward
    and of autograd through it backward."""

    @staticmethod
    def forward(ctx, x, dt, a, B_, C_, state0, chunk):
        ctx.set_materialize_grads(False)
        Bb, T, H, P = x.shape
        N = B_.shape[3]
        ct = torch.promote_types(x.dtype, torch.float32)
        outs = [x.new_empty((Bb, T, H, P), dtype=ct),
                x.new_empty((Bb, H, P, N), dtype=ct)]
        ins = [t for t in (x, dt, a, B_, C_, state0) if t is not None]
        if any(ctx.needs_input_grad):
            n_chunks = -(-T // min(chunk, T))
            states = x.new_empty((Bb, n_chunks, H, P, N),
                                 dtype=torch.float32)
            outs.append(states)
            ctx.save_for_backward(x, dt, a, B_, C_, state0, states)
            ctx.chunk = chunk
        kernel_call(ins, outs, ssd_chunked_flops(Bb, T, H, P, N, chunk),
                    "ssd_scan")
        return outs[0], outs[1]

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, B_, C_, state0, states = ctx.saved_tensors
        wants = ctx.needs_input_grad[:6]
        grads = [torch.empty_like(t) if want else None
                 for t, want in zip((x, dt, a, B_, C_, state0), wants)]
        Bb, T, H, P = x.shape
        flops = ssd_chunked_flops(Bb, T, H, P, B_.shape[3], ctx.chunk,
                                  grads=wants, dy=dy is not None,
                                  dstate=dstate is not None)
        kernel_call([t for t in (x, dt, a, B_, C_, state0, dy, dstate,
                                 states) if t is not None],
                    [g for g in grads if g is not None], flops,
                    "ssd_scan_bwd")
        return (*grads, None)


def ssd(x, dt, a, B_, C_, *, chunk: int, state0=None):
    """The chunked SSD scan: (y: (B, T, H, P) fp32, final_state:
    (B, H, P, N) fp32); shapes as ``ref.ssd_chunked``.

    A CUDA tensor launches the hand-written kernel (or raises); where a
    gradient is wanted it goes through ``_SSDScan``, whose backward is the
    hand-written backward kernel.  A CPU tensor takes the plain version,
    which autograd differentiates.  A meta tensor (the dry run) computes
    nothing: ``_MetaSSD`` makes the outputs and records the plain
    version's FLOPs.  Nothing else picks between them.
    """
    if x.device.type == "meta":
        return _MetaSSD.apply(x, dt, a, B_, C_, state0, chunk)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, B_, C_, chunk, state0=state0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, B_, C_, state0)):
        return _SSDScan.apply(x, dt, a, B_, C_, state0, chunk)
    return ssd_scan(x, dt, a, B_, C_, chunk=chunk, state0=state0)
