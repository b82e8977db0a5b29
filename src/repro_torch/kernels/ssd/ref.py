"""Plain PyTorch versions of the Mamba-2 SSD scan, the SSD kernel's
references.

``ssd_ref`` is the naive O(T) recurrence (the JAX package's
``kernels/ssd/ref.py``); ``ssd_chunked`` the chunked algorithm of the JAX
package's ``models/mamba2.py::ssd_chunked``, which the kernel computes and
the CPU path runs.  Both compute in fp32 (in fp64 for fp64 inputs).
"""
from __future__ import annotations

import torch


def _compute_type(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def ssd_ref(x, dt, a, B_, C_):
    """x: (B, T, H, P); dt: (B, T, H) after softplus; a: (H,) negative;
    B_, C_: (B, T, G, N).  Returns y: (B, T, H, P) fp32.

        state_t = exp(dt_t * a) * state_{t-1} + dt_t * B_t (outer) x_t
        y_t     = C_t . state_t
    """
    Bb, T, H, P = x.shape
    N = B_.shape[3]
    rep = H // B_.shape[2]
    ct = _compute_type(x)
    xf, dtf, af = x.to(ct), dt.to(ct), a.to(ct)
    Bh = B_.to(ct).repeat_interleave(rep, dim=2)            # (B, T, H, N)
    Ch = C_.to(ct).repeat_interleave(rep, dim=2)
    state = torch.zeros(Bb, H, P, N, dtype=ct, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dtf[:, t] * af[None, :])            # (B, H)
        inp = torch.einsum("bhn,bhp->bhpn", Bh[:, t],
                           xf[:, t] * dtf[:, t][..., None])
        state = state * decay[..., None, None] + inp
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1)


def ssd_chunked(x, dt, a, B_, C_, chunk: int, state0=None):
    """The SSD scan chunk by chunk.  Shapes as ``ssd_ref``; ``state0``:
    (B, H, P, N) or None (zeros).  Returns (y: (B, T, H, P) fp32,
    final_state: (B, H, P, N) fp32).

    Chunks of L = min(chunk, T); T is padded to a multiple of L with
    dt = 0 (identity decay, no input), as the JAX package pads.
    """
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    L = min(chunk, T)
    n_chunks = -(-T // L)
    pad = n_chunks * L - T
    ct = _compute_type(x)
    xf, dtf, Bf, Cf = x.to(ct), dt.to(ct), B_.to(ct), C_.to(ct)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, 0, 0, pad))
    rep = H // G
    af = a.to(ct)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    state = (torch.zeros(Bb, H, P, N, dtype=ct, device=x.device)
             if state0 is None else state0.to(ct))
    ys = []
    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        xc, dtc = xf[:, sl], dtf[:, sl]
        Bh = Bf[:, sl].repeat_interleave(rep, dim=2)           # (B, L, H, N)
        Ch = Cf[:, sl].repeat_interleave(rep, dim=2)
        css = torch.cumsum(dtc * af, dim=1)                     # (B, L, H)
        seg_end = css[:, -1, :]                                 # (B, H)
        # inter-chunk: the carried state seen from each row
        y_inter = torch.einsum("blhn,bhpn->blhp",
                               Ch * torch.exp(css)[..., None], state)
        # intra-chunk quadratic form, masked lower-triangular
        scores = torch.einsum("blhn,bmhn->blmh", Ch, Bh)       # (B, L, L, H)
        # exp(css_l - css_m) for m <= l only: the masked entries are
        # exp(-inf) = 0, so no exp of a positive argument is formed
        diff = css[:, :, None, :] - css[:, None, :, :]
        decay = torch.exp(diff.masked_fill(~mask[None, :, :, None],
                                           float("-inf")))
        y_intra = torch.einsum("blmh,bmhp->blhp",
                               scores * decay * dtc[:, None, :, :], xc)
        # state update: decay to the chunk's end
        sdecay = torch.exp(seg_end[:, None, :] - css)           # (B, L, H)
        chunk_state = torch.einsum("blhn,blhp->bhpn",
                                   Bh * sdecay[..., None], xc * dtc[..., None])
        state = state * torch.exp(seg_end)[..., None, None] + chunk_state
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)
    return (y[:, :T] if pad else y), state
