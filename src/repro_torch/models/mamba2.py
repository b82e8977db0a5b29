"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block.

Counterpart of ``repro.models.mamba2``.  Prefill runs the chunked SSD scan
through ``repro_torch.kernels.ssd.ssd``: the hand-written kernel on a CUDA
card, its plain version (``ssd_chunked``) on the CPU.  Decode is the O(1)
recurrent update in plain torch, as in the JAX package, with a rolling
depthwise-conv window.  Both write the conv window and the SSD state into
the cache they are given, in place.

Head-parallel serving (``tp``, a ``launch.sharding.ModelAxis``, with the
rank's serving copies of the leaves, ``n_groups`` 1): the rank holds the
``in_proj`` columns [z_r | x_r | B | C | dt_r] and the conv columns
[x_r | B | C] (``common.ssm_head_columns``: a re-slice made at load, not
a contiguous piece of "ssm_inner"), and its H/tp heads' slices of
``A_log``, ``D``, ``dt_bias``, ``norm_w`` and the rows of ``out_proj``.
The depthwise conv runs over [x_r | B | C] and the SSD scan over the
rank's heads; the gated RMSNorm, which normalises over the whole
``d_inner``, sums the rank's squares over "model" in fp32 (counted as
"norm_sum"; ``AllSum``: each rank normalises only its own heads by the
sum, so the backward sums the ranks' gradients of it too), and
``out_proj`` is row-parallel (``layers.row_parallel``).
The state cache is the rank's ``ssm_heads`` slice of ``cache_specs``; the
conv window is the one cache leaf that departs from them: "conv_dim"
would cut [x | B | C] contiguously, and the rank holds [x_r | B | C]
(``whole_conv_window`` rebuilds the whole one from the ranks').

The train step computes in the same layout (``launch.steps``): a rank's
gradients of the B and C columns are its heads' partial sums, which the
step adds over "model" once, on the way back to the stored slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd
from .common import ModelConfig, ParamDef
from .layers import copy_in, is_split, row_parallel


def mamba2_def(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_ssm_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + H   # z, x, B, C, dt
    # A_log, D and dt_bias in fp32 (fp64 under an fp64 param dtype)
    pd = cfg.param_dtype
    ct = torch.promote_types(pd, torch.float32)
    return {
        "in_proj": ParamDef((d, proj_out), ("embed", "ssm_inner"), dtype=pd),
        "conv_w": ParamDef((s.d_conv, conv_ch), (None, "conv_dim"), scale=0.5,
                           dtype=pd),
        "conv_b": ParamDef((conv_ch,), ("conv_dim",), init="zeros", dtype=pd),
        "A_log": ParamDef((H,), ("ssm_heads",), init="zeros", dtype=ct),
        "D": ParamDef((H,), ("ssm_heads",), init="ones", dtype=ct),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros", dtype=ct),
        "norm_w": ParamDef((di,), ("ssm_inner",), init="ones", dtype=pd),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed"), dtype=pd),
    }


def _heads(params: dict, cfg: ModelConfig) -> int:
    """The SSM heads this rank holds (H, or H/tp on a serving rank)."""
    return params["A_log"].shape[-1]


def _split_proj(proj: torch.Tensor, cfg: ModelConfig, H: int | None = None):
    """z, x, B, C, dt: views of ``proj`` along its last dim, of ``H``
    heads (default: all of them; a serving rank's: its own)."""
    s = cfg.ssm
    H = s.n_ssm_heads(cfg.d_model) if H is None else H
    di = H * s.head_dim
    gn = s.n_groups * s.d_state
    return torch.split(proj, [di, di, gn, gn, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in x's dtype.  x: (B, T, C); w: (k, C).

    A cross-correlation, as ``lax.conv_general_dilated``: out[t, c] =
    sum_j x[t - k + 1 + j, c] w[j, c], so the (C, 1, k) weight is not
    flipped.  Returns a contiguous (B, T, C)."""
    k, C = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))                  # (B, C, T+k-1)
    out = F.conv1d(xp, w.T[:, None, :].to(x.dtype), groups=C)
    return out.transpose(1, 2).contiguous() + b.to(x.dtype)


def _ct(cfg: ModelConfig) -> torch.dtype:
    """fp32 compute type of the SSM's element-wise math (fp64 under an
    fp64 config, which only the rounding-growth measurement uses)."""
    return torch.promote_types(cfg.dtype, torch.float32)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. logaddexp(x, 0); ``F.softplus`` switches
    to the identity above 20, which this does not."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6, mean_sq=None) -> torch.Tensor:
    """RMSNorm of y * silu(z) over its last dim, in fp32.  ``mean_sq``,
    where given, forms the mean of the squares from this rank's squares
    (its heads' channels of a split ``d_inner``); by default their mean
    over the last dim."""
    ct = torch.promote_types(y.dtype, torch.float32)
    yf = y.to(ct) * F.silu(z.to(ct))
    sq = yf.square()
    ms = (sq.mean(dim=-1, keepdim=True) if mean_sq is None
          else mean_sq(sq))
    return (yf * torch.rsqrt(ms + eps) * w.to(ct)).to(y.dtype)


def _conv_split(conv_out: torch.Tensor, cfg: ModelConfig,
                H: int | None = None):
    """x (B, T, H, P), B_ and C_ (B, T, G, N): strided views of the conv
    output (B, T, conv_ch), not copies; ``H`` as ``_split_proj``."""
    s = cfg.ssm
    Bb, T, _ = conv_out.shape
    H = s.n_ssm_heads(cfg.d_model) if H is None else H
    di = H * s.head_dim
    gn = s.n_groups * s.d_state
    xh = conv_out[..., :di].unflatten(-1, (H, s.head_dim))
    B_ = conv_out[..., di:di + gn].unflatten(-1, (s.n_groups, s.d_state))
    C_ = conv_out[..., di + gn:].unflatten(-1, (s.n_groups, s.d_state))
    return xh, B_, C_


def _out(params: dict, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
         tp=None):
    """The gated norm and ``out_proj``; with ``tp`` over the rank's heads
    (module docstring)."""
    di = cfg.ssm.d_inner(cfg.d_model)
    if not is_split(tp, params["norm_w"].shape[0], di):
        y = _gated_rmsnorm(y, z, params["norm_w"])
        return torch.einsum("bti,id->btd", y,
                            params["out_proj"].to(cfg.dtype))
    from repro_torch.launch.sharding import AllSum

    def mean_sq(sq):
        return AllSum.apply(sq.sum(dim=-1, keepdim=True), tp,
                            "norm_sum") / di
    y = _gated_rmsnorm(y, z, params["norm_w"], mean_sq=mean_sq)
    return row_parallel(y, params["out_proj"], cfg, tp)


def whole_conv_window(parts, cfg: ModelConfig) -> torch.Tensor:
    """The whole conv window [x | B | C] (..., conv_ch) from the windows
    [x_r | B | C] of the ranks along "model", in rank order (B and C, the
    same on every rank, from the first)."""
    dil = parts[0].shape[-1] - 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return torch.cat([p[..., :dil] for p in parts] + [parts[0][..., dil:]],
                     dim=-1)


def _proj(params: dict, u: torch.Tensor, cfg: ModelConfig, tp):
    """``in_proj`` of u; its input through ``CopyIn`` where the heads are
    split."""
    H = _heads(params, cfg)
    if is_split(tp, H, cfg.ssm.n_ssm_heads(cfg.d_model)):
        u = copy_in(u, tp)
    return torch.einsum("btd,dp->btp", u, params["in_proj"].to(cfg.dtype)), H


def apply_mamba2(params: dict, u: torch.Tensor, cfg: ModelConfig,
                 cache: dict | None = None, cache_index=None, tp=None):
    """u: (B, T, d_model).  Prefill path (chunked SSD over T).

    With ``cache`` ({"conv": (B, k-1, conv_ch), "state": (B, H, P, N)})
    given, its window is prepended to the conv input and its state starts
    the scan; the final conv window and SSD state are written back into it
    in place (where the JAX package returns a new cache).  ``cache_index``
    is not read, as in the JAX package.  With ``tp``, over the rank's
    heads (module docstring).  Returns (out, cache | None).
    """
    s = cfg.ssm
    dt_ = cfg.dtype
    Bb, T, _ = u.shape

    proj, H = _proj(params, u, cfg, tp)
    z, xc, B_, C_, dtr = _split_proj(proj, cfg, H)
    xBC = torch.cat([xc, B_, C_], dim=-1)
    if cache is not None:
        xBC_in = torch.cat([cache["conv"].to(dt_), xBC], dim=1)
        conv_out = _causal_conv(xBC_in, params["conv_w"],
                                params["conv_b"])[:, -T:]
    else:
        conv_out = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xh, B_, C_ = _conv_split(F.silu(conv_out), cfg, H)

    ct = _ct(cfg)
    dt_act = _softplus(dtr.to(ct) + params["dt_bias"])
    a = -torch.exp(params["A_log"])                              # (H,) < 0
    state0 = cache["state"] if cache is not None else None
    y, state = ssd(xh, dt_act, a, B_, C_, chunk=s.chunk, state0=state0)
    y = y + params["D"][None, None, :, None] * xh.to(ct)
    out = _out(params, y.to(dt_).reshape(Bb, T, -1), z, cfg, tp)
    if cache is not None:
        cache["conv"].copy_(xBC_in[:, -(s.d_conv - 1):])
        cache["state"].copy_(state)
    return out, cache


def decode_mamba2(params: dict, u: torch.Tensor, cfg: ModelConfig,
                  cache: dict, tp=None):
    """Single-token decode.  u: (B, 1, d_model); O(1) state update; the
    cache is updated in place.  With ``tp``, over the rank's heads (module
    docstring).  Returns (out, cache)."""
    s = cfg.ssm
    dt_ = cfg.dtype
    Bb = u.shape[0]

    proj, H = _proj(params, u, cfg, tp)
    z, xc, B_, C_, dtr = _split_proj(proj, cfg, H)
    xBC = torch.cat([xc, B_, C_], dim=-1)                   # (B, 1, conv_ch)
    window = torch.cat([cache["conv"].to(dt_), xBC], dim=1)  # (B, k, conv_ch)
    # The same depthwise-conv op as prefill, on the window, last position:
    # the JAX package's fix for the decode drift of the hybrid models.
    conv_out = _causal_conv(window, params["conv_w"], params["conv_b"])[:, -1:]
    xh, B1, C1 = _conv_split(F.silu(conv_out), cfg, H)
    rep = H // s.n_groups
    ct = _ct(cfg)
    Bh = B1[:, 0].to(ct).repeat_interleave(rep, dim=1)          # (B, H, N)
    Ch = C1[:, 0].to(ct).repeat_interleave(rep, dim=1)

    dt1 = _softplus(dtr.to(ct)[:, 0] + params["dt_bias"])       # (B, H)
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt1 * a)                                  # (B, H)
    x1 = xh[:, 0].to(ct)                                        # (B, H, P)
    state = cache["state"].to(ct)
    state = (state * decay[..., None, None]
             + torch.einsum("bhn,bhp->bhpn", Bh, x1 * dt1[..., None]))
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    y = y + params["D"][None, :, None] * x1
    out = _out(params, y.reshape(Bb, 1, -1).to(dt_), z, cfg, tp)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return out, cache
