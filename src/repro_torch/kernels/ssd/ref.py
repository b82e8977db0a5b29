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


def ssd_chunked_flops(Bb: int, T: int, H: int, P: int, N: int, chunk: int,
                      grads=None, dy: bool = True,
                      dstate: bool = False) -> int:
    """The FLOPs of ``ssd_chunked``'s products at these shapes: per chunk
    of L rows, the inter-chunk output and the chunk state (2 B L H P N
    each), the scores C B^T (2 B L^2 H N) and the intra-chunk output
    (2 B L^2 H P).

    With ``grads`` (whether x, dt, a, B_, C_ and state0 each want a
    gradient; state0 False when there is none), those of autograd through
    it instead: each product takes one product of its size for each
    operand that wants a gradient, where a gradient reaches its output.
    ``dy``, ``dstate``: whether y and the final state carry one.  Chunk
    0's state wants none unless state0 does, and the last chunk's state
    update reaches only the final state."""
    L = min(chunk, T)
    n = -(-T // L)
    u = 2 * Bb * L * H * P * N             # inter-chunk output, chunk state
    s = 2 * Bb * L * L * H * N             # C B^T
    w = 2 * Bb * L * L * H * P             # intra-chunk output
    if grads is None:
        return n * (2 * u + s + w)
    gx, gdt, ga, gB, gC, gs0 = grads
    gcss = gdt or ga                       # css = cumsum(dt a)
    a_inter = gC or gcss                   # C exp(css)
    b_state = gB or gcss                   # B exp(seg - css)
    x_state = gx or gdt                    # x dt
    att = gC or gB or gcss or gdt          # C B^T E dt
    total, s_req = 0, gs0                  # s_req: the state entering
    for c in range(n):
        if dy:
            total += (a_inter + s_req) * u + (gC + gB) * s + (att + gx) * w
        if dstate or (dy and c + 1 < n):
            total += (b_state + x_state) * u
        s_req = s_req or b_state or x_state
    return total


def ssd_chunked_bwd(x, dt, a, B_, C_, chunk: int, state0, dy, dstate):
    """The gradient of ``ssd_chunked`` from explicit formulas, chunk by
    chunk: a forward pass that keeps the state entering each chunk, then a
    reverse pass.  ``dy``: (B, T, H, P), the gradient of y; ``dstate``:
    (B, H, P, N), that of the final state, or None (zeros); ``state0`` as
    ``ssd_chunked``.  Returns (dx, ddt, da, dB, dC, dstate0) in the
    compute type (fp32, or fp64 for fp64 inputs); T is padded as
    ``ssd_chunked`` pads it.

    Per chunk and head (css the inclusive cumsum of dt a, seg its last
    value, E[l, m] = exp(css_l - css_m) for m <= l and 0 otherwise,
    w_m = exp(seg - css_m), s_in the state entering the chunk, ds the
    gradient of the state leaving it):

        dx_m   = sum_l CB E dt_m [l, m] dy_l + w_m dt_m ds B_m
        dC_l   = exp(css_l) s_in^T dy_l + sum_m Gm[l, m] B_m,  Gm = dyx E dt_m
        dB_m   = sum_l Gm[l, m] C_l + w_m dt_m ds^T x_m
        ddt_m  = sum_l dyx CB E [l, m] + w_m x_m^T ds B_m + a dda_m
        dcss_l = exp(css_l) dy_l^T s_in C_l + sum_m Q[l, m]
                 - sum_l' Q[l', l] - R_l,  Q = dyx CB E dt_m,
                 R_m = w_m dt_m x_m^T ds B_m, and the last row also takes
                 sum_m R_m + exp(seg) <ds, s_in>
        dda    = the reverse cumsum of dcss;  da += sum dt dda
        ds_prev = exp(seg) ds + sum_l exp(css_l) dy_l C_l^T

    with CB[l, m] = C_l . B_m and dyx[l, m] = dy_l . x_m; dB and dC are
    summed over the heads of a group.
    """
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    L = min(chunk, T)
    n_chunks = -(-T // L)
    pad = n_chunks * L - T
    ct = _compute_type(x)
    xf, dtf, Bf, Cf = x.to(ct), dt.to(ct), B_.to(ct), C_.to(ct)
    dyf = dy.to(ct)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, 0, 0, pad))
        dyf = torch.nn.functional.pad(dyf, (0, 0, 0, 0, 0, pad))
    rep = H // G
    af = a.to(ct)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))

    def chunk_of(c):
        sl = slice(c * L, (c + 1) * L)
        Bh = Bf[:, sl].repeat_interleave(rep, dim=2)           # (B, L, H, N)
        Ch = Cf[:, sl].repeat_interleave(rep, dim=2)
        dtc = dtf[:, sl]
        css = torch.cumsum(dtc * af, dim=1)                     # (B, L, H)
        return xf[:, sl], dtc, Bh, Ch, dyf[:, sl], css, css[:, -1, :]

    # forward: the state entering each chunk
    state = (torch.zeros(Bb, H, P, N, dtype=ct, device=x.device)
             if state0 is None else state0.to(ct))
    s_in = []
    for c in range(n_chunks):
        xc, dtc, Bh, _, _, css, seg = chunk_of(c)
        s_in.append(state)
        w = torch.exp(seg[:, None, :] - css)
        state = (state * torch.exp(seg)[..., None, None]
                 + torch.einsum("blhn,blhp->bhpn", Bh * w[..., None],
                                xc * dtc[..., None]))

    # reverse: the gradient of the state leaving each chunk, ds
    ds = (torch.zeros(Bb, H, P, N, dtype=ct, device=x.device)
          if dstate is None else dstate.to(ct))
    da = torch.zeros(H, dtype=ct, device=x.device)
    dxs, ddts, dBs, dCs = [], [], [], []
    for c in reversed(range(n_chunks)):
        xc, dtc, Bh, Ch, dyc, css, seg = chunk_of(c)
        sin = s_in[c]
        diff = css[:, :, None, :] - css[:, None, :, :]          # (B, L, L, H)
        E = torch.exp(diff.masked_fill(~mask[None, :, :, None],
                                       float("-inf")))
        Mt = E * dtc[:, None, :, :]                             # E dt_m
        CB = torch.einsum("blhn,bmhn->blmh", Ch, Bh)
        dyx = torch.einsum("blhp,bmhp->blmh", dyc, xc)
        A2 = dyx * Mt                                           # Gm
        ecs = torch.exp(css)
        w = torch.exp(seg[:, None, :] - css)
        wdt = w * dtc
        dsB = torch.einsum("bhpn,bmhn->bmhp", ds, Bh)           # ds B_m
        dxs.append(torch.einsum("blmh,blhp->bmhp", CB * Mt, dyc)
                   + wdt[..., None] * dsB)
        dC_inter = ecs[..., None] * torch.einsum("bhpn,blhp->blhn", sin, dyc)
        dCh = dC_inter + torch.einsum("blmh,bmhn->blhn", A2, Bh)
        dBh = (torch.einsum("blmh,blhn->bmhn", A2, Ch)
               + wdt[..., None] * torch.einsum("bhpn,bmhp->bmhn", ds, xc))
        dBs.append(dBh.unflatten(2, (G, rep)).sum(3))
        dCs.append(dCh.unflatten(2, (G, rep)).sum(3))
        Z = dyx * CB * E
        Q = Z * dtc[:, None, :, :]
        v = w * (xc * dsB).sum(-1)                              # (B, L, H)
        R = dtc * v
        dcss = ((dC_inter * Ch).sum(-1) + Q.sum(2) - Q.sum(1) - R)
        dcss[:, -1] += R.sum(1) + torch.exp(seg) * (ds * sin).sum((-1, -2))
        dda = torch.flip(torch.cumsum(torch.flip(dcss, [1]), 1), [1])
        ddts.append(Z.sum(1) + v + af * dda)
        da = da + (dtc * dda).sum((0, 1))
        ds = (ds * torch.exp(seg)[..., None, None]
              + torch.einsum("blh,blhp,blhn->bhpn", ecs, dyc, Ch))

    def whole(parts):
        out = torch.cat(parts[::-1], dim=1)
        return out[:, :T] if pad else out
    return (whole(dxs), whole(ddts), da, whole(dBs), whole(dCs), ds)
