"""Public attention entry in the model layout (B, S, H, D)."""
from __future__ import annotations

from .kernel import flash_attention
from .ref import attention_ref


def mha(q, k, v, *, causal: bool = True, kv_len: int | None = None,
        q_offset=0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, Hq, D).
    ``q_offset``: an int, or a (B,) integer tensor of per-row offsets.

    A CUDA tensor launches the hand-written kernel (or raises); a CPU
    tensor takes the plain version.  Nothing else picks between them.
    The (B, H, S, D) views passed down are strided, not copied.
    """
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        out = attention_ref(qt, kt, vt, causal=causal, kv_len=kv_len,
                            q_offset=q_offset)
    else:
        out = flash_attention(qt, kt, vt, causal=causal, kv_len=kv_len,
                              q_offset=q_offset)
    return out.transpose(1, 2)
