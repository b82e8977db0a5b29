"""Public attention entry in the model layout (B, S, H, D)."""
from __future__ import annotations

import torch

from .._meta import kernel_call
from .kernel import aligned16, flash_attention, flash_attention_bwd
from .ref import attention_ref, attention_ref_flops


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, and the backward kernel as
    its gradient.  The mask arguments take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len, q_offset):
        out, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                   q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, kv_len, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, kv_len, q_offset = ctx.mask
        if not aligned16(dout) or dout.stride(-1) != 1:
            dout = dout.contiguous()  # the one copy: the kernel reads rows
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=causal, kv_len=kv_len,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None


class _MetaAttention(torch.autograd.Function):
    """The route on ``meta`` tensors (``kernels/_meta.py``): the output,
    and where a gradient is wanted the row lse that ``_FlashAttention``
    keeps, recorded with the FLOPs of ``attention_ref`` forward and of
    autograd through it backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        B, Hq, Sq, D = q.shape
        out = q.new_empty(q.shape)
        outs = [out]
        if any(ctx.needs_input_grad):
            lse = q.new_empty((B, Hq, Sq), dtype=torch.float32)
            outs.append(lse)
            ctx.save_for_backward(q, k, v, out, lse)
        kernel_call([q, k, v], outs,
                    attention_ref_flops(B, Hq, Sq, k.shape[2], D),
                    "flash_attention")
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = [torch.empty_like(t) if want else None
                 for t, want in zip((q, k, v), ctx.needs_input_grad)]
        B, Hq, Sq, D = q.shape
        kernel_call([q, k, v, out, dout, lse],
                    [g for g in grads if g is not None],
                    attention_ref_flops(B, Hq, Sq, k.shape[2], D,
                                        grads=ctx.needs_input_grad),
                    "flash_attention_bwd")
        return tuple(grads)


def mha(q, k, v, *, causal: bool = True, kv_len: int | None = None,
        q_offset=0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, Hq, D).
    ``q_offset``: an int, or a (B,) integer tensor of per-row offsets.

    A CUDA tensor launches the hand-written kernel (or raises); where a
    gradient is wanted it goes through ``_FlashAttention``, whose backward
    is the hand-written backward kernel.  A CPU tensor takes the plain
    version, which autograd differentiates.  A meta tensor (the dry run)
    computes nothing: ``_MetaAttention`` makes the output and records the
    plain version's FLOPs.  Nothing else picks between them.  The (B, H,
    S, D) views passed down are strided, not copied.
    """
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "meta":
        out = _MetaAttention.apply(qt, kt, vt)
    elif q.device.type == "cpu":
        out = attention_ref(qt, kt, vt, causal=causal, kv_len=kv_len,
                            q_offset=q_offset)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out = _FlashAttention.apply(qt, kt, vt, causal, kv_len, q_offset)
    else:
        out = flash_attention(qt, kt, vt, causal=causal, kv_len=kv_len,
                              q_offset=q_offset)
    return out.transpose(1, 2)
