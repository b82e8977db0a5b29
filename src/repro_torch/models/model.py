"""Model factory: ModelConfig -> {init, init_caches, loss, prefill, decode}.

Counterpart of ``repro.models.model``: the decoder-only families
(``transformer.py``: dense, vlm, moe, ssm, hybrid) and the encoder-decoder
(``encdec.py``).  ``prefill``/``decode`` update the caches they are given
in place and return them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .. import resolve_device
from . import encdec as _encdec
from . import transformer as _tf
from .common import ModelConfig, tree_defs_init


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_defs: Any

    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed``, on ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tree_defs_init(self.param_defs, gen, dev)

    def cache_defs(self, batch: int, max_len: int, cross_len: int = 0,
                   cache_dtype=torch.bfloat16):
        if self.cfg.family == "encdec":
            return _encdec.encdec_cache_def(self.cfg, batch, max_len,
                                            cross_len or max_len, cache_dtype)
        return _tf.cache_def(self.cfg, batch, max_len, cache_dtype)

    def init_caches(self, batch: int, max_len: int, cross_len: int = 0, *,
                    cache_dtype=torch.bfloat16, device=None) -> dict:
        """Zeroed caches, updated in place by ``prefill`` and ``decode``.

        dense and vlm: {"blocks": {"k", "v": (L, B, Tmax, Hkv, hd)}} in
        ``cache_dtype``; ssm: {"blocks": {"conv": (L, B, k-1, conv_ch),
        "state": (L, B, H, P, N)}}, the window in ``cache_dtype`` and the
        state in float32, neither growing with ``max_len``; hybrid:
        {"blocks": {"ssm": {"conv", "state"} as (U, every, B, ...),
        "attn": {"k", "v": (U, B, Tmax, Hkv, hd)}}, "tail": {"conv",
        "state"} as (tail, B, ...)}: U super-units of ``every`` Mamba-2
        layers, each with its own KV cache for its application of the one
        shared attention block, and the tail's Mamba-2 layers (no "tail"
        where ``n_layers`` divides by ``every``); moe: {"blocks":
        {"moe_layer", "dense_{j}": {"k", "v"}}}, one cache per layer of a
        unit; encdec: {"self": {"k", "v": (dec_layers, B, Tmax, Hkv, hd)},
        "cross": the same at ``cross_len`` positions (0: ``max_len``, as
        the JAX package)}."""
        dev = resolve_device(device)
        defs = self.cache_defs(batch, max_len, cross_len, cache_dtype)
        return tree_defs_init(defs, None, dev)

    def loss(self, params, batch: dict):
        """(loss, {"xent", "aux"}): ``encdec_loss`` or ``lm_loss``."""
        if self.cfg.family == "encdec":
            return _encdec.encdec_loss(params, self.cfg, batch)
        return _tf.lm_loss(params, self.cfg, batch)

    def prefill(self, params, batch: dict, caches):
        if self.cfg.family == "encdec":
            return _encdec.encdec_prefill(params, self.cfg, batch, caches)
        return _tf.lm_prefill(params, self.cfg, batch, caches)

    def decode(self, params, batch: dict, caches, cache_index: int):
        if self.cfg.family == "encdec":
            return _encdec.encdec_decode(params, self.cfg, batch, caches,
                                         cache_index)
        return _tf.lm_decode(params, self.cfg, batch, caches, cache_index)


def build_model(cfg: ModelConfig) -> Model:
    defs = (_encdec.encdec_def(cfg) if cfg.family == "encdec"
            else _tf.lm_def(cfg))
    return Model(cfg=cfg, param_defs=defs)
