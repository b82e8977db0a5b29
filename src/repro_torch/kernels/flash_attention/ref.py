"""Plain PyTorch attention (fp32 scores), the flash kernel's reference."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, kv_len: int | None = None,
                  q_offset=0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D).  Materialises full scores.

    Key j is seen by query row i of batch row b iff ``j < kv_len`` and,
    when causal, ``j <= q_offset + i``; ``q_offset`` is an int or a (B,)
    integer tensor, one offset per batch row.  Rows that see no key give 0.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    kv_len = Sk if kv_len is None else kv_len
    k_pos = torch.arange(Sk, device=q.device)
    valid = (k_pos < kv_len)[None, None, None, :]               # (1, 1, 1, Sk)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)
        if isinstance(q_offset, torch.Tensor):
            q_pos = q_offset.to(q.device).reshape(-1, 1) + q_pos  # (B, Sq)
        else:
            q_pos = (q_offset + q_pos)[None]                      # (1, Sq)
        valid = valid & (k_pos <= q_pos[:, None, :, None])      # (B|1, 1, Sq, Sk)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0, torch.ones_like(denom), denom)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
