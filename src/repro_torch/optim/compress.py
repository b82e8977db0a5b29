"""Gradient compression: int8 blockwise quantisation with error feedback.

Counterpart of ``repro.optim.compress``: blocks of 256 along the
flattened leaf, each with an fp32 scale of max|block| / 127; the
quantisation residual is carried to the next step, so the compressed
direction stays unbiased in the long run (1-bit Adam / EF-SGD family).
"""
from __future__ import annotations

import torch

from .adamw import _q8_decode, _q8_encode

_BLK = 256


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def compress_grads(grads, error_feedback=None):
    """Returns (quantised tree of {"q", "s"} leaves, new error feedback)."""
    if error_feedback is None:
        error_feedback = _map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                              grads)

    def one(g, e):
        corrected = g.float() + e
        q, s = _q8_encode(corrected, _BLK)
        return {"q": q, "s": s}, corrected - _q8_decode(q, s, g.shape)
    pairs = _map(one, grads, error_feedback)
    return _map(lambda pe: pe[0], pairs), _map(lambda pe: pe[1], pairs)


def decompress_grads(qtree, shapes_like):
    """fp32 gradients of ``shapes_like``'s shapes from a quantised tree."""
    def one(ref, packed):
        return _q8_decode(packed["q"], packed["s"], ref.shape)
    return _map(one, shapes_like, qtree)
