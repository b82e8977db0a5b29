"""Step functions: prefill / decode, built per model.

Counterpart of ``repro.launch.steps`` (``make_prefill_step`` and
``make_decode_step``); PyTorch runs them eagerly, with no jit.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import Model


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch, caches):
        return model.prefill(params, batch, caches)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(params, batch, caches, cache_index: int):
        logits, caches = model.decode(params, batch, caches, cache_index)
        # torch.argmax returns the first maximal index, as jnp.argmax does
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok, logits, caches
    return decode_step
