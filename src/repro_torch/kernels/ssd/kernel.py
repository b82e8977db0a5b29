"""Mamba-2 SSD scan on Hopper: ctypes binding of ``csrc/ssd_fwd.cu``.

The hand-written CUDA kernels that replace the TPU Pallas kernel
``repro.kernels.ssd.kernel._ssd_kernel``; the source's header says how
each of its two paths is laid out and what bounds it.  They compute the
contract of the JAX model's ``ssd_chunked``: y and the final state, from
an optional initial state.  ``plan`` picks the path.  The library is built
by nvcc at first use (``repro_torch.kernels._build``), never at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
HEAD_DIMS = (8, 16, 64)          # P
STATE_DIMS = (8, 16, 64, 128)    # N
MAX_CHUNK = 128                  # L = min(chunk, T)
MAX_GRID_Y = 65535
DTYPES = (torch.float32, torch.bfloat16)
#: the source's paths, by the number its entry takes
PATHS = {"chunked": 0, "fp32": 1}
#: rows a chunk is padded to on each path: the mma tile, a float4
TILE = {"chunked": 16, "fp32": 4}

#: calls of the kernel in this process (chip_smoke.py reads it): one per
#: call, whatever number of device launches the path makes
LAUNCHES = 0
#: the path of the last call
LAST_PATH = None


class Plan(NamedTuple):
    """How one call runs; the source takes L, Lp and n_chunks as given."""
    path: str          # "chunked" or "fp32"
    L: int             # rows of a chunk, min(chunk, T)
    Lp: int            # L padded to the path's tile
    n_chunks: int

    @property
    def kernels(self) -> tuple[str, ...]:
        """The source's kernels one call launches, in order: the state
        passing only when there is a state to pass between chunks."""
        if self.path == "fp32":
            return ("ssd_fwd_fp32",)
        passing = ("ssd_state_passing",) if self.n_chunks > 1 else ()
        return ("ssd_chunk_cb", "ssd_chunk_state", *passing,
                "ssd_chunk_scan")


def plan(dtype: torch.dtype, T: int, chunk: int) -> Plan:
    """bfloat16 x/B/C take the chunk-parallel tensor-core path, float32
    the one-launch CUDA-core kernel."""
    path = "chunked" if dtype == torch.bfloat16 else "fp32"
    L = min(chunk, T)
    return Plan(path, L, -(-L // TILE[path]) * TILE[path], -(-T // L))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)))
    lib.ssd_fwd.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.ssd_fwd.restype = ctypes.c_int
    lib.ssd_fwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, a, B_, C_, chunk, state0) -> None:
    named = (("x", x), ("dt", dt), ("a", a), ("B_", B_), ("C_", C_))
    if state0 is not None:
        named += (("state0", state0),)
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} is on {t.device}, not on a "
                             "CUDA device")
        if t.device != x.device:
            raise ValueError("ssd_scan: the inputs must share a device")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or B_.dim() != 4:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B_ "
                         f"{tuple(B_.shape)}: expected (B, T, H, P), "
                         "(B, T, H), (H,), (B, T, G, N)")
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if (tuple(dt.shape) != (Bb, T, H) or tuple(a.shape) != (H,)
            or tuple(B_.shape[:2]) != (Bb, T) or C_.shape != B_.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B_ "
                         f"{tuple(B_.shape)}, C_ {tuple(C_.shape)} disagree")
    if x.dtype not in DTYPES or not (x.dtype == B_.dtype == C_.dtype):
        raise ValueError(f"ssd_scan: x, B_, C_ have dtypes {x.dtype}, "
                         f"{B_.dtype}, {C_.dtype}; the kernel takes one of "
                         "float32 and bfloat16 for all three")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError("ssd_scan: dt and a must be float32")
    if a.stride(0) != 1:
        raise ValueError("ssd_scan: a must be contiguous")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: head dim P={P} not in {HEAD_DIMS} or "
                         f"state dim N={N} not in {STATE_DIMS}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: G={G} does not divide H={H}")
    if chunk < 1 or min(chunk, T) > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk length min({chunk}, T={T}) must "
                         f"be in [1, {MAX_CHUNK}]")
    if T < 1 or Bb < 1:
        raise ValueError(f"ssd_scan: unsupported B={Bb}, T={T}")
    # the grid's y: B * H blocks on the chunked path, B on the fp32 path
    if plan(x.dtype, T, chunk).path == "chunked" and Bb * H > MAX_GRID_Y:
        raise ValueError(f"ssd_scan: B={Bb} x H={H} exceeds {MAX_GRID_Y} "
                         "on the chunked path")
    if Bb > MAX_GRID_Y:
        raise ValueError(f"ssd_scan: B={Bb} exceeds {MAX_GRID_Y}")
    if state0 is not None and (tuple(state0.shape) != (Bb, H, P, N)
                               or state0.dtype != torch.float32
                               or not state0.is_contiguous()):
        raise ValueError(f"ssd_scan: state0 must be a contiguous float32 "
                         f"{(Bb, H, P, N)}, got {tuple(state0.shape)} "
                         f"{state0.dtype}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 128,
             state0: torch.Tensor | None = None):
    """x: (B, T, H, P); dt: (B, T, H) float32 after softplus; a: (H,)
    float32, negative; B_, C_: (B, T, G, N).  x, B_ and C_ are float32 or
    bfloat16 with any element strides (no copy is made).  Returns
    (y: (B, T, H, P) float32, final_state: (B, H, P, N) float32), both
    contiguous.  ``state0`` (contiguous float32 (B, H, P, N)) or None for
    zeros.  Chunks of L = min(chunk, T); the ragged last chunk is masked in
    the kernel, which equals padding it with dt = 0."""
    global LAUNCHES, LAST_PATH
    _check(x, dt, a, B_, C_, chunk, state0)
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    pl = plan(x.dtype, T, chunk)
    if state0 is not None and state0.data_ptr() % 16:
        state0 = state0.clone()     # the kernels read it 16 bytes at a time
    y = torch.empty(Bb, T, H, P, dtype=torch.float32, device=x.device)
    state = torch.empty(Bb, H, P, N, dtype=torch.float32, device=x.device)
    cb = cs = segs = None
    if pl.path == "chunked":  # scratch: C B^T, chunk states, chunk decays
        cb = torch.empty(Bb * pl.n_chunks * G * pl.Lp * pl.Lp,
                         dtype=torch.float32, device=x.device)
        if "ssd_state_passing" in pl.kernels:
            cs = torch.empty(Bb * pl.n_chunks * H * P * N,
                             dtype=torch.float32, device=x.device)
            segs = torch.empty(Bb * pl.n_chunks * H, dtype=torch.float32,
                               device=x.device)
    strides = [*x.stride(), *dt.stride(), *B_.stride(), *C_.stride()]
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (cb, cs, segs)),
            PATHS[pl.path], Bb, T, H, G, P, N, pl.L, pl.Lp, pl.n_chunks,
            (ctypes.c_longlong * 15)(*strides), stream)
    if rc != 0:
        raise RuntimeError("ssd_fwd launch failed: "
                           + lib.ssd_fwd_error_string(rc).decode())
    LAUNCHES += 1
    LAST_PATH = pl.path
    return y, state
