"""Core layers: norms, RoPE / M-RoPE, self- and cross-attention, MLPs.

Counterpart of ``repro.models.layers``.  Attention goes through
``repro_torch.kernels.flash_attention.mha``: the hand-written kernel on a
CUDA card, its plain version on the CPU.  Weights are kept in
``param_dtype`` and cast to the compute dtype at each use, as the JAX
package does.

Tensor-parallel serving and training: given ``tp``
(``launch.sharding.ModelAxis``) and a rank's serving copies of the weights
(the train step computes in the same layout), attention and the MLP are
column- then row-parallel.  The Q/K/V and gate/up products take the
rank's heads and MLP columns (their input through ``CopyIn``); the out
and down products form the rank's partial sum in fp32, sum it over
"model" in fp32 (``SumOut``) and then cast to ``cfg.dtype``, so a bf16
output is rounded once, as the one-process product's; a bias after a
row-parallel product is added once, after the sum.  Where a leaf is not
split (its dim does not divide over "model", or ``tp`` is None or of one
rank) the one-process code runs.  The split is read from the shapes the
rank holds.  The backward is the split's own: ``CopyIn`` sums the
ranks' partial gradients of a product's input, the KV leaves that every
rank holds whole but reads in part are summed once (``kv_whole``), and on
the card the row-parallel product has its own backward (``_RowProduct``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import mha
from .common import ModelConfig, ParamDef


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_def(dim: int, dtype=torch.float32) -> dict:
    return {"scale": ParamDef((dim,), ("embed_noshard",), init="ones",
                              dtype=dtype)}


def layernorm_def(dim: int, dtype=torch.float32) -> dict:
    return {"scale": ParamDef((dim,), ("embed_noshard",), init="ones",
                              dtype=dtype),
            "bias": ParamDef((dim,), ("embed_noshard",), init="zeros",
                             dtype=dtype)}


def _ct(x: torch.Tensor) -> torch.dtype:
    """fp32, the compute type of the norms and RoPE (fp64 for fp64 ``x``,
    which only the float64 checks use)."""
    return torch.promote_types(x.dtype, torch.float32)


def apply_norm(params: dict, x: torch.Tensor, kind: str, eps: float = 1e-6):
    ct = _ct(x)
    xf = x.to(ct)
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].to(ct) + params["bias"].to(ct)
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].to(ct)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (split halves, not interleaved)
# ---------------------------------------------------------------------------
def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T) integer."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs                 # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(_ct(x)).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(half: int) -> tuple[int, int, int]:
    """The (temporal, h, w) split of the rotary frequencies: Qwen2-VL's
    (16, 24, 24) at head dim 128, generalised to any head dim."""
    a = half // 4
    b = (half - a) // 2
    return a, b, half - a - b


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, T, H, D); positions3: (B, T, 3)
    integer [temporal, h, w].  Frequency i of each half rotates by the
    position component its section names."""
    half = x.shape[-1] // 2
    sections = mrope_sections(half) if sections is None else sections
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    comp = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                      for i, n in enumerate(sections)])           # (half,)
    ang = positions3.float()[..., comp] * freqs                   # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(_ct(x)).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------
def attention_def(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim()
    pd = cfg.param_dtype
    d = {"wq": ParamDef((cfg.d_model, cfg.n_heads, hd),
                         ("embed", "heads", "head_dim"), dtype=pd),
         "wk": ParamDef((cfg.d_model, cfg.n_kv_heads, hd),
                         ("embed", "kv_heads", "head_dim"), dtype=pd),
         "wv": ParamDef((cfg.d_model, cfg.n_kv_heads, hd),
                         ("embed", "kv_heads", "head_dim"), dtype=pd),
         "wo": ParamDef((cfg.n_heads, hd, cfg.d_model),
                         ("heads", "head_dim", "embed"), dtype=pd)}
    if cfg.qkv_bias:
        d["bq"] = ParamDef((cfg.n_heads, hd), ("heads", "head_dim"),
                           init="zeros", dtype=pd)
        d["bk"] = ParamDef((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"),
                           init="zeros", dtype=pd)
        d["bv"] = ParamDef((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"),
                           init="zeros", dtype=pd)
    return d


def is_split(tp, local: int, whole: int) -> bool:
    """Whether a dim of ``whole`` is held as this rank's piece."""
    return tp is not None and tp.size > 1 and local != whole


def copy_in(x, tp, kind: str = "tp_grad"):
    from repro_torch.launch.sharding import CopyIn
    return CopyIn.apply(x, tp, kind)


class _RowProduct(torch.autograd.Function):
    """``x2 @ w`` of bf16 operands with an fp32 output (``torch.mm``'s
    ``out_dtype``: no fp32 copy of the weight), on the card.  The
    backward takes bf16 products with fp32 accumulation, as the unsplit
    bf16 product's backward does: the gradient of the fp32 output comes
    from the bf16 value it was cast to, so its bf16 copy is exact."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x2.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def row_parallel(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, tp,
                 kind: str = "tp_sum") -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, d) holding this rank's piece of
    K: the fp32 partial product of the cfg.dtype operands, summed over
    "model" in fp32 (``SumOut``, counted under ``kind``), then cast to
    cfg.dtype (fp64 throughout under an fp64 config).  On the card a bf16
    product reads its operands as they are and writes fp32
    (``_RowProduct``, differentiable), with no fp32 copy of the weight;
    the CPU has no such product, and casts both operands."""
    from repro_torch.launch.sharding import SumOut
    dt = cfg.dtype
    ct = torch.promote_types(dt, torch.float32)
    x2, w = x.to(dt).flatten(0, -2), w.to(dt)
    if x.is_cuda and dt != ct:
        part = _RowProduct.apply(x2, w)
    else:
        part = torch.mm(x2.to(ct), w.to(ct))
    part = part.unflatten(0, x.shape[:-1])
    return SumOut.apply(part, tp, kind).to(dt)


def kv_whole(params: dict, cfg: ModelConfig, tp) -> dict:
    """``params`` with the KV leaves (``wk``, ``wv``, ``bk``, ``bv``)
    through ``CopyIn`` (counted as "kv_grad") where the query heads are
    split and the KV heads whole on every rank: a rank's query heads read
    some of the KV heads (``rank_kv_heads``), so its gradient of each is a
    partial sum, summed over "model" once.  ``params`` itself otherwise."""
    if params["wk"].shape[-2] != cfg.n_kv_heads:
        return params
    return {k: copy_in(v, tp, "kv_grad") if k in ("wk", "wv", "bk", "bv")
            else v for k, v in params.items()}


def attention_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The projections, each bias (``qkv_bias``) added in the compute
    dtype before RoPE.  With this rank's head slices of the weights, its
    heads."""
    dt = cfg.dtype
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def attention_out(params: dict, o: torch.Tensor, cfg: ModelConfig,
                  tp=None):
    """The out projection; row-parallel over the rank's heads where
    ``wo`` holds a head slice (``row_parallel``)."""
    if is_split(tp, params["wo"].shape[0], cfg.n_heads):
        return row_parallel(o.flatten(-2), params["wo"].flatten(0, 1), cfg,
                            tp)
    return torch.einsum("bthk,hkd->btd", o, params["wo"].to(cfg.dtype))


def rank_kv_heads(k: torch.Tensor, cfg: ModelConfig, tp, hq: int
                  ) -> torch.Tensor:
    """The KV heads (dim 2 of ``k``) that this rank's ``hq`` query heads
    read.  Where the KV heads are split alongside the query heads (or
    nothing is split) ``k`` itself; where they are whole on every rank
    (``n_kv_heads`` does not divide over "model"), query head j of rank r
    is global head r hq + j and reads KV head (r hq + j) // (Hq / Hkv): a
    narrow view where that map is the kernel's grouped one, else an index
    of one KV head per query head."""
    if k.shape[2] != cfg.n_kv_heads or hq == cfg.n_heads:
        return k
    group = cfg.n_heads // cfg.n_kv_heads
    first = tp.index * hq
    heads = [(first + j) // group for j in range(hq)]
    lo, n = heads[0], heads[-1] + 1 - heads[0]
    if hq % n == 0 and heads == [lo + j // (hq // n) for j in range(hq)]:
        return k.narrow(2, lo, n)
    return k[:, :, heads]


def self_attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   causal: bool, positions: torch.Tensor,
                   cache: dict | None = None, cache_index: int = 0,
                   tp=None):
    """Self-attention, over a KV cache or (``cache`` None) over ``x`` alone.

    ``cache``: {"k": (B, Tmax, Hkv, D), "v": ...}; ``cache_index``: tokens
    already in the cache.  The new K/V are written at that offset and
    attention runs over the whole cache, masked to ``cache_index + T``
    keys.  ``positions``: (B, T), or (B, T, 3) under M-RoPE.  The causal
    mask starts at each row's first position, as the JAX package's does:
    ``cache_index`` for the (B, T) positions, which are ``cache_index +
    arange(T)``, and under M-RoPE the row's first temporal id (a per-row
    offset).  Without a cache (the encoder) the T keys are all there is
    and the mask starts at 0.  Returns (out, cache); the cache tensors are
    updated in place.

    With ``tp`` and head slices of the weights (module docstring): the
    rank's query heads, its KV heads (its slice of the cache), or every
    KV head where they are whole (``rank_kv_heads`` picks the ones its
    query heads read), and the row-parallel out projection.  Where
    ``tp.seq`` the cache is this rank's part of the sequence
    (``split_cache_attention``).
    """
    split = is_split(tp, params["wq"].shape[1], cfg.n_heads)
    if split:
        x = copy_in(x, tp)
        params = kv_whole(params, cfg, tp)
    q, k, v = attention_qkv(params, x, cfg)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
        q_offset = positions[:, 0, 0].to(torch.int32)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        q_offset = cache_index
    hq = q.shape[2]
    if cache is None:
        out = mha(q, rank_kv_heads(k, cfg, tp, hq),
                  rank_kv_heads(v, cfg, tp, hq), causal=causal)
        return attention_out(params, out, cfg, tp if split else None), None
    if tp is not None and tp.seq is not False:
        out = split_cache_attention(q, k, v, cache, cache_index, q_offset,
                                    cfg, tp, causal, split)
        return attention_out(params, out, cfg, tp if split else None), cache
    T, t_max = x.shape[1], cache["k"].shape[1]
    if cache_index + T > t_max:
        raise ValueError(f"cache of {t_max} positions cannot take {T} tokens "
                         f"at index {cache_index}")
    # In place, where the JAX package returns a new cache from
    # lax.dynamic_update_slice_in_dim.
    cache["k"][:, cache_index:cache_index + T] = k.to(cache["k"].dtype)
    cache["v"][:, cache_index:cache_index + T] = v.to(cache["v"].dtype)
    out = mha(q, rank_kv_heads(cache["k"], cfg, tp, hq).to(cfg.dtype),
              rank_kv_heads(cache["v"], cfg, tp, hq).to(cfg.dtype),
              causal=causal, kv_len=cache_index + T, q_offset=q_offset)
    return attention_out(params, out, cfg, tp if split else None), cache


def split_cache_attention(q, k, v, cache: dict, cache_index: int, q_offset,
                          cfg: ModelConfig, tp, causal: bool,
                          heads_split: bool) -> torch.Tensor:
    """Attention over a KV cache split by sequence over "model" (context-
    parallel decode): ``cache`` holds positions [r L, (r + 1) L) of every
    KV head, r = ``tp.index``, L its length.  ``q``, ``k``, ``v``: the
    step's projections (q this rank's heads where ``heads_split``, k and v
    every KV head); returns this rank's heads' output (B, T, Hq_r, D).

    A prefill (``cache_index`` 0) attends each of the rank's query heads
    over the whole prompt, as without the split, and writes into the
    cache only the prompt's positions in the rank's part; nothing goes
    over "model".  A decode step (T 1) writes the new K/V on the rank
    whose part holds ``cache_index``, gathers the step's query heads over
    "model" (``sharding.gather_heads``), attends every head over this
    rank's part with the row lse (its ``kv_len`` ``cache_index`` + 1 -
    r L clamped to [0, L], its causal offset ``q_offset`` - r L, per row
    under M-RoPE and negative where a row's position lies before the
    part), then merges the ranks' partial rows (``sharding.merge_partials``).
    Every rank takes part in both collectives, also one whose part holds
    no key yet.  A prefill at ``cache_index`` > 0 raises."""
    from repro_torch.launch.sharding import gather_heads, merge_partials
    if tp.seq is None:
        raise ValueError(
            "the rules put the KV cache's sequence over \"model\": give the "
            "step the caches' max_len (make_prefill_step / "
            "make_decode_step's max_len), which says whether it splits")
    T, L = q.shape[1], cache["k"].shape[1]
    start = tp.index * L
    if cache_index + T > L * tp.size:
        raise ValueError(f"cache of {L * tp.size} positions cannot take {T} "
                         f"tokens at index {cache_index}")
    ck, cv = cache["k"], cache["v"]
    hq = q.shape[2]
    if cache_index == 0:
        kc, vc = k.to(ck.dtype), v.to(cv.dtype)
        lo, hi = start, min(start + L, T)
        if hi > lo:
            ck[:, :hi - lo] = kc[:, lo:hi]
            cv[:, :hi - lo] = vc[:, lo:hi]
        return mha(q, rank_kv_heads(kc.to(cfg.dtype), cfg, tp, hq),
                   rank_kv_heads(vc.to(cfg.dtype), cfg, tp, hq),
                   causal=causal, kv_len=T, q_offset=q_offset)
    if T != 1:
        raise NotImplementedError(
            f"a prefill of {T} tokens at cache_index {cache_index} into a KV "
            "cache split by sequence over \"model\"; the serving loop "
            "prefills at 0 and decodes one token at a time")
    if start <= cache_index < start + L:
        ck[:, cache_index - start] = k[:, 0].to(ck.dtype)
        cv[:, cache_index - start] = v[:, 0].to(cv.dtype)
    qa = gather_heads(q, tp) if heads_split else q
    o, lse = mha(qa, ck.to(cfg.dtype), cv.to(cfg.dtype), causal=causal,
                 kv_len=min(max(cache_index + 1 - start, 0), L),
                 q_offset=q_offset - start, return_lse=True)
    return merge_partials(o, lse, tp, hq if heads_split else None)


def cross_attention_def(cfg: ModelConfig) -> dict:
    return attention_def(cfg.with_(qkv_bias=False))


def cross_attention(params: dict, x: torch.Tensor, kv_src, cfg: ModelConfig,
                    kv_cache: dict | None = None, tp=None):
    """Decoder cross-attention, non-causal and without RoPE.  ``kv_src``:
    the encoder output (B, Ts, d), projected to K/V when ``kv_cache`` is
    None; with ``kv_cache`` ({"k", "v"} precomputed) it is not read.  As in
    the JAX package there is no ``kv_len``: every position of the cross
    cache is attended, zero-padded ones too.  With ``tp``, split as
    ``self_attention``: the cross cache holds the rank's KV heads (or all
    of them, where they are whole).  Returns (out, kv_cache)."""
    dt = cfg.dtype
    split = is_split(tp, params["wq"].shape[1], cfg.n_heads)
    if split:
        x = copy_in(x, tp)
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(dt))
    if kv_cache is None:
        if split:
            # the rank's K/V heads of the source: its partial gradient
            params = kv_whole(params, cfg, tp)
            kv_src = copy_in(kv_src, tp)
        kv_cache = {
            "k": torch.einsum("btd,dhk->bthk", kv_src, params["wk"].to(dt)),
            "v": torch.einsum("btd,dhk->bthk", kv_src, params["wv"].to(dt))}
    hq = q.shape[2]
    out = mha(q, rank_kv_heads(kv_cache["k"], cfg, tp, hq).to(dt),
              rank_kv_heads(kv_cache["v"], cfg, tp, hq).to(dt), causal=False)
    return attention_out(params, out, cfg, tp if split else None), kv_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_def(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    """The MLP's weights, ``d_ff`` wide (default ``cfg.d_ff``; the MoE
    shared expert's is ``d_ff_expert``)."""
    f, pd = d_ff or cfg.d_ff, cfg.param_dtype
    if cfg.act == "swiglu":
        return {"wg": ParamDef((cfg.d_model, f), ("embed", "mlp"), dtype=pd),
                "wu": ParamDef((cfg.d_model, f), ("embed", "mlp"), dtype=pd),
                "wd": ParamDef((f, cfg.d_model), ("mlp", "embed"), dtype=pd)}
    return {"w1": ParamDef((cfg.d_model, f), ("embed", "mlp"), dtype=pd),
            "b1": ParamDef((f,), ("mlp",), init="zeros", dtype=pd),
            "w2": ParamDef((f, cfg.d_model), ("mlp", "embed"), dtype=pd),
            "b2": ParamDef((cfg.d_model,), ("embed_noshard",), init="zeros",
                           dtype=pd)}


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """The MLP; with ``tp`` and MLP-column slices of the weights (of a
    ``cfg.d_ff`` wide MLP), column- then row-parallel, the GELU MLP's
    ``b2`` added once, after the sum."""
    dt = cfg.dtype
    down = params["wd" if cfg.act == "swiglu" else "w2"]
    if is_split(tp, down.shape[0], cfg.d_ff):
        x = copy_in(x, tp)
        if cfg.act == "swiglu":
            g = torch.einsum("btd,df->btf", x, params["wg"].to(dt))
            u = torch.einsum("btd,df->btf", x, params["wu"].to(dt))
            return row_parallel(F.silu(g) * u, down, cfg, tp)
        h = (torch.einsum("btd,df->btf", x, params["w1"].to(dt))
             + params["b1"].to(dt))
        h = F.gelu(h, approximate="tanh")
        return row_parallel(h, down, cfg, tp) + params["b2"].to(dt)
    if cfg.act == "swiglu":
        g = torch.einsum("btd,df->btf", x, params["wg"].to(dt))
        u = torch.einsum("btd,df->btf", x, params["wu"].to(dt))
        return torch.einsum("btf,fd->btd", F.silu(g) * u, params["wd"].to(dt))
    h = torch.einsum("btd,df->btf", x, params["w1"].to(dt)) + params["b1"].to(dt)
    # jax.nn.gelu's default is the tanh form; torch's default is erf
    h = F.gelu(h, approximate="tanh")
    return (torch.einsum("btf,fd->btd", h, params["w2"].to(dt))
            + params["b2"].to(dt))
