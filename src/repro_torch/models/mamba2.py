"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block.

Counterpart of ``repro.models.mamba2``.  Prefill runs the chunked SSD scan
through ``repro_torch.kernels.ssd.ssd``: the hand-written kernel on a CUDA
card, its plain version (``ssd_chunked``) on the CPU.  Decode is the O(1)
recurrent update in plain torch, as in the JAX package, with a rolling
depthwise-conv window.  Both write the conv window and the SSD state into
the cache they are given, in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd
from .common import ModelConfig, ParamDef


def mamba2_def(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_ssm_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + H   # z, x, B, C, dt
    pd, f32 = cfg.param_dtype, torch.float32
    return {
        "in_proj": ParamDef((d, proj_out), ("embed", "ssm_inner"), dtype=pd),
        "conv_w": ParamDef((s.d_conv, conv_ch), (None, "conv_dim"), scale=0.5,
                           dtype=pd),
        "conv_b": ParamDef((conv_ch,), ("conv_dim",), init="zeros", dtype=pd),
        "A_log": ParamDef((H,), ("ssm_heads",), init="zeros", dtype=f32),
        "D": ParamDef((H,), ("ssm_heads",), init="ones", dtype=f32),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros", dtype=f32),
        "norm_w": ParamDef((di,), ("ssm_inner",), init="ones", dtype=pd),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed"), dtype=pd),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """z, x, B, C, dt: views of ``proj`` along its last dim."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    H = s.n_ssm_heads(cfg.d_model)
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
                   eps: float = 1e-6) -> torch.Tensor:
    ct = torch.promote_types(y.dtype, torch.float32)
    yf = y.to(ct) * F.silu(z.to(ct))
    ms = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * w.to(ct)).to(y.dtype)


def _conv_split(conv_out: torch.Tensor, cfg: ModelConfig):
    """x (B, T, H, P), B_ and C_ (B, T, G, N): strided views of the conv
    output (B, T, conv_ch), not copies."""
    s = cfg.ssm
    Bb, T, _ = conv_out.shape
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    H = s.n_ssm_heads(cfg.d_model)
    xh = conv_out[..., :di].unflatten(-1, (H, s.head_dim))
    B_ = conv_out[..., di:di + gn].unflatten(-1, (s.n_groups, s.d_state))
    C_ = conv_out[..., di + gn:].unflatten(-1, (s.n_groups, s.d_state))
    return xh, B_, C_


def _out(params: dict, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig):
    y = _gated_rmsnorm(y, z, params["norm_w"])
    return torch.einsum("bti,id->btd", y, params["out_proj"].to(cfg.dtype))


def apply_mamba2(params: dict, u: torch.Tensor, cfg: ModelConfig,
                 cache: dict | None = None, cache_index=None):
    """u: (B, T, d_model).  Prefill path (chunked SSD over T).

    With ``cache`` ({"conv": (B, k-1, conv_ch), "state": (B, H, P, N)})
    given, its window is prepended to the conv input and its state starts
    the scan; the final conv window and SSD state are written back into it
    in place (where the JAX package returns a new cache).  ``cache_index``
    is not read, as in the JAX package.  Returns (out, cache | None).
    """
    s = cfg.ssm
    dt_ = cfg.dtype
    Bb, T, _ = u.shape

    proj = torch.einsum("btd,dp->btp", u, params["in_proj"].to(dt_))
    z, xc, B_, C_, dtr = _split_proj(proj, cfg)
    xBC = torch.cat([xc, B_, C_], dim=-1)
    if cache is not None:
        xBC_in = torch.cat([cache["conv"].to(dt_), xBC], dim=1)
        conv_out = _causal_conv(xBC_in, params["conv_w"],
                                params["conv_b"])[:, -T:]
    else:
        conv_out = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xh, B_, C_ = _conv_split(F.silu(conv_out), cfg)

    ct = _ct(cfg)
    dt_act = _softplus(dtr.to(ct) + params["dt_bias"])
    a = -torch.exp(params["A_log"])                              # (H,) < 0
    state0 = cache["state"] if cache is not None else None
    y, state = ssd(xh, dt_act, a, B_, C_, chunk=s.chunk, state0=state0)
    y = y + params["D"][None, None, :, None] * xh.to(ct)
    out = _out(params, y.to(dt_).reshape(Bb, T, -1), z, cfg)
    if cache is not None:
        cache["conv"].copy_(xBC_in[:, -(s.d_conv - 1):])
        cache["state"].copy_(state)
    return out, cache


def decode_mamba2(params: dict, u: torch.Tensor, cfg: ModelConfig,
                  cache: dict):
    """Single-token decode.  u: (B, 1, d_model); O(1) state update; the
    cache is updated in place.  Returns (out, cache)."""
    s = cfg.ssm
    dt_ = cfg.dtype
    Bb = u.shape[0]
    H = s.n_ssm_heads(cfg.d_model)

    proj = torch.einsum("btd,dp->btp", u, params["in_proj"].to(dt_))
    z, xc, B_, C_, dtr = _split_proj(proj, cfg)
    xBC = torch.cat([xc, B_, C_], dim=-1)                   # (B, 1, conv_ch)
    window = torch.cat([cache["conv"].to(dt_), xBC], dim=1)  # (B, k, conv_ch)
    # The same depthwise-conv op as prefill, on the window, last position:
    # the JAX package's fix for the decode drift of the hybrid models.
    conv_out = _causal_conv(window, params["conv_w"], params["conv_b"])[:, -1:]
    xh, B1, C1 = _conv_split(F.silu(conv_out), cfg)
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
    out = _out(params, y.reshape(Bb, 1, -1).to(dt_), z, cfg)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return out, cache
