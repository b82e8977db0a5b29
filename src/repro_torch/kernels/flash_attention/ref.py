"""Plain PyTorch attention (fp32 scores), the flash kernels' reference:
the forward, each row's log-sum-exp, and the backward."""
from __future__ import annotations

import math

import torch


def _scores(q, k, causal: bool, kv_len, q_offset):
    """(scaled fp32 scores (B, Hq, Sq, Sk), valid mask (B|1, 1, Sq|1, Sk))
    of the mask ``attention_ref`` documents; k has Hq heads here."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
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
    return s, valid


def _heads(x, group: int):
    return x.repeat_interleave(group, dim=1)


def attention_ref(q, k, v, *, causal: bool = True, kv_len: int | None = None,
                  q_offset=0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D).  Materialises full scores.

    Key j is seen by query row i of batch row b iff ``j < kv_len`` and,
    when causal, ``j <= q_offset + i``; ``q_offset`` is an int or a (B,)
    integer tensor, one offset per batch row.  Rows that see no key give 0.
    """
    group = q.shape[1] // k.shape[1]
    s, valid = _scores(q, _heads(k, group), causal, kv_len, q_offset)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0, torch.ones_like(denom), denom)
    out = torch.einsum("bhqk,bhkd->bhqd", p, _heads(v, group).float())
    return out.to(q.dtype)


def attention_ref_flops(B: int, Hq: int, Sq: int, Sk: int, D: int,
                        grads=None) -> int:
    """The FLOPs of ``attention_ref``'s products at these shapes: the
    scores and the weighted sum, each 2 B Hq Sq Sk D over every key
    (masked ones too).  With ``grads`` (whether q, k and v each want a
    gradient), those of autograd through it instead: dP = dO V^T where q
    or k wants one, then dV, dQ and dK each where wanted."""
    one = 2 * B * Hq * Sq * Sk * D
    if grads is None:
        return 2 * one
    gq, gk, gv = grads
    return ((gq or gk) + gv + gq + gk) * one


def lse_ref(q, k, *, causal: bool = True, kv_len: int | None = None,
            q_offset=0) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled scores over the keys it
    sees, (B, Hq, Sq) fp32; -inf for a row that sees no key."""
    group = q.shape[1] // k.shape[1]
    s, valid = _scores(q, _heads(k, group), causal, kv_len, q_offset)
    s = torch.where(valid, s, torch.full_like(s, -torch.inf))
    return torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = True,
                      kv_len: int | None = None, q_offset=0):
    """The gradient of ``attention_ref`` by the flash-attention formulas,
    in fp32: P = exp(S - lse) on the mask, dV = P^T dO, dS = P * (dO V^T -
    rowsum(dO * O)), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D); dK and dV
    of a kv head sum its group's query heads.  ``out`` and ``lse`` are the
    forward's.  Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    s, valid = _scores(q, _heads(k, group), causal, kv_len, q_offset)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, _heads(v, group).float())
    ds = p * (dp - delta) / math.sqrt(D)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _heads(k, group).float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dk = dk.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
