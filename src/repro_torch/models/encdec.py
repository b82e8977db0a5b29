"""Encoder-decoder backbone (seamless-m4t-large-v2).

Counterpart of ``repro.models.encdec``.  The modality frontend is a stub:
the batch carries frame embeddings ``src_embeds`` (B, T_src, d_model) for
the encoder, a stack of bidirectional self-attention layers with RoPE.
Each decoder layer is causal self-attention over its KV cache, then
cross-attention over its cross cache (non-causal, no RoPE), then the MLP.
The prefill encodes the source, fills every decoder layer's cross cache
from the encoder output (``build_cross_caches``) and runs the target
prefix; a decode step reads the cross caches as they are.  Caches are
updated in place, as in ``transformer.py``.  ``encdec_loss`` trains the
whole: the encoder and the cache-less decoder, each layer under
``_remat`` as the JAX package's, then the chunked cross-entropy.
"""
from __future__ import annotations

import torch

from .common import ModelConfig, ParamDef
from .layers import (apply_mlp, apply_norm, attention_def, cross_attention,
                     cross_attention_def, mlp_def, self_attention)
from .transformer import (_index_tree, _remat, chunked_xent, norm_def,
                          stack_defs, unembed_matrix)


def _enc_layer_def(cfg: ModelConfig) -> dict:
    return {"ln1": norm_def(cfg), "attn": attention_def(cfg),
            "ln2": norm_def(cfg), "mlp": mlp_def(cfg)}


def _dec_layer_def(cfg: ModelConfig) -> dict:
    return {"ln1": norm_def(cfg), "self_attn": attention_def(cfg),
            "ln2": norm_def(cfg), "cross_attn": cross_attention_def(cfg),
            "ln3": norm_def(cfg), "mlp": mlp_def(cfg)}


def encdec_def(cfg: ModelConfig) -> dict:
    return {
        "embed": ParamDef((cfg.vocab, cfg.d_model), dtype=cfg.param_dtype),
        "enc_blocks": stack_defs(_enc_layer_def(cfg), cfg.enc_layers),
        "dec_blocks": stack_defs(_dec_layer_def(cfg), cfg.dec_layers),
        "ln_enc": norm_def(cfg),
        "ln_dec": norm_def(cfg),
        "unembed": ParamDef((cfg.d_model, cfg.vocab), dtype=cfg.param_dtype),
    }


def encdec_cache_def(cfg: ModelConfig, batch: int, max_len: int,
                     cross_len: int, cache_dtype=torch.bfloat16) -> dict:
    """{"self", "cross": {"k", "v": (dec_layers, B, T, Hkv, hd)}}, T
    ``max_len`` for the self caches and ``cross_len`` for the cross
    caches."""
    hd = cfg.resolved_head_dim()

    def kv(T):
        return {n: ParamDef((batch, T, cfg.n_kv_heads, hd), init="zeros",
                            dtype=cache_dtype) for n in ("k", "v")}
    return {"self": stack_defs(kv(max_len), cfg.dec_layers),
            "cross": stack_defs(kv(cross_len), cfg.dec_layers)}


def _positions(B: int, T: int, offset: int, device) -> torch.Tensor:
    return (offset + torch.arange(T, device=device))[None, :].expand(B, T)


def encode(params, cfg: ModelConfig, src_embeds: torch.Tensor):
    """(B, T_src, d) frames -> (B, T_src, d) encoder output in cfg.dtype."""
    h = src_embeds.to(cfg.dtype)
    B, T = h.shape[:2]
    pos = _positions(B, T, 0, h.device)

    def layer(p, h):
        a, _ = self_attention(p["attn"], apply_norm(p["ln1"], h, cfg.norm),
                              cfg, causal=False, positions=pos)
        h = h + a
        return h + apply_mlp(p["mlp"], apply_norm(p["ln2"], h, cfg.norm), cfg)

    layer = _remat(layer, cfg)
    for i in range(cfg.enc_layers):
        h = layer(_index_tree(params["enc_blocks"], i), h)
    return apply_norm(params["ln_enc"], h, cfg.norm)


def decode_trunk(params, cfg: ModelConfig, tokens, enc_out,
                 caches: dict | None = None, cache_index: int = 0):
    """The decoder over ``tokens`` (B, T).  With ``caches`` ({"self",
    "cross"}, the cross caches filled) each layer writes its self cache at
    ``cache_index`` and reads its cross cache; ``enc_out`` is not read.
    Without, attention runs over the tokens alone and cross-attention over
    ``enc_out``.  Returns (h after the final norm, caches)."""
    h = params["embed"][tokens].to(cfg.dtype)
    B, T = h.shape[:2]
    pos = _positions(B, T, cache_index, h.device)

    def layer(p, h, c):
        a, _ = self_attention(p["self_attn"],
                              apply_norm(p["ln1"], h, cfg.norm), cfg,
                              causal=True, positions=pos,
                              cache=None if c is None else c["self"],
                              cache_index=cache_index)
        h = h + a
        a, _ = cross_attention(p["cross_attn"],
                               apply_norm(p["ln2"], h, cfg.norm), enc_out,
                               cfg, kv_cache=None if c is None else c["cross"])
        h = h + a
        return h + apply_mlp(p["mlp"], apply_norm(p["ln3"], h, cfg.norm), cfg)

    if caches is None:
        layer = _remat(layer, cfg)
    for i in range(cfg.dec_layers):
        h = layer(_index_tree(params["dec_blocks"], i), h,
                  None if caches is None else _index_tree(caches, i))
    return apply_norm(params["ln_dec"], h, cfg.norm), caches


def encdec_loss(params, cfg: ModelConfig, batch: dict):
    """batch: "src_embeds" (B, T_src, d), "tokens" and "labels" (B, T),
    optionally "mask".  Mean masked xent of the decoder's logits; the aux
    loss is 0.  Returns (loss, {"xent", "aux"})."""
    enc_out = encode(params, cfg, batch["src_embeds"])
    h, _ = decode_trunk(params, cfg, batch["tokens"], enc_out)
    labels = batch["labels"]
    mask = batch.get("mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32,
                       device=labels.device) if mask is None
            else mask.float())
    loss = chunked_xent(h, unembed_matrix(params, cfg), labels, mask, cfg)
    return loss, {"xent": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


def build_cross_caches(params, cfg: ModelConfig, enc_out, caches):
    """Fill each decoder layer's cross cache from the encoder output, in
    place: its first min(T_src, cross_len) positions, the rest zero (the
    JAX package pads there, and cross-attention attends the padding).
    Returns caches["cross"]."""
    cross = caches["cross"]
    Tc = cross["k"].shape[2]
    n = min(enc_out.shape[1], Tc)
    for i in range(cfg.dec_layers):
        p = _index_tree(params["dec_blocks"], i)["cross_attn"]
        for name, w in (("k", p["wk"]), ("v", p["wv"])):
            kv = torch.einsum("btd,dhk->bthk", enc_out[:, :n],
                              w.to(enc_out.dtype))
            cross[name][i, :, :n] = kv.to(cross[name].dtype)
            cross[name][i, :, n:] = 0
    return cross


def _logits(h, params, cfg: ModelConfig):
    """fp32 product of fp32 operands, as the JAX package's encdec logits
    (not ``lm_prefill``'s bf16-operand product)."""
    return torch.einsum("btd,dv->btv", h.float(),
                        unembed_matrix(params, cfg).float())


def encdec_prefill(params, cfg: ModelConfig, batch: dict, caches):
    """batch: "src_embeds" (B, T_src, d), "tokens" (B, T).  Encodes, fills
    the cross caches, runs the target prefix at cache index 0; returns the
    last position's logits (B, 1, V) and the caches."""
    enc_out = encode(params, cfg, batch["src_embeds"])
    build_cross_caches(params, cfg, enc_out, caches)
    h, caches = decode_trunk(params, cfg, batch["tokens"], None,
                             caches=caches, cache_index=0)
    return _logits(h[:, -1:], params, cfg), caches


def encdec_decode(params, cfg: ModelConfig, batch: dict, caches,
                  cache_index: int):
    """One decode step: batch["tokens"] (B, 1) against the caches."""
    h, caches = decode_trunk(params, cfg, batch["tokens"], None,
                             caches=caches, cache_index=cache_index)
    return _logits(h, params, cfg), caches
