"""Mamba-2 SSD scan on Hopper: ctypes bindings of ``csrc/ssd_fwd.cu`` and
``csrc/ssd_bwd.cu``.

The forward is the hand-written CUDA kernels that replace the TPU Pallas
kernel ``repro.kernels.ssd.kernel._ssd_kernel``; the source's header says
how each of its two paths is laid out and what bounds it.  They compute
the contract of the JAX model's ``ssd_chunked``: y and the final state,
from an optional initial state, and on request the state entering each
chunk.  ``plan`` picks the path.  The backward (``ssd_scan_bwd``) is the
gradient that the JAX package takes by autodiff of ``ssd_chunked``, from a
source of its own, which reads those chunk states; ``bwd_plan`` names its
path (by dtype, as ``plan``) and launches, ``bwd_slices`` the heads a block
of its tensor-core path takes, ``bwd_scratch`` mirrors its host-side
scratch in Python.  Each library is built by nvcc at first use
(``repro_torch.kernels._build``), never at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
BWD_SOURCE = SOURCE.with_name("ssd_bwd.cu")
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
#: calls of the backward in this process, one per call (each launches its
#: path's kernels)
BWD_LAUNCHES = 0
#: the backward's paths, by the number the source's entry takes, and the
#: kernels a call of each launches, in order: "mma" (bf16 x/B/C: products on
#: the tensor cores, a block for a slice of a group's heads) and
#: "cuda_core" (float32: fp32 products on the CUDA cores, a block a head)
BWD_PATHS = {"cuda_core": 0, "mma": 1}
BWD_KERNELS = {"cuda_core": ("ssd_bwd_dstate", "ssd_bwd_state_passing",
                             "ssd_bwd_chunk", "ssd_bwd_group_sum",
                             "ssd_bwd_da_sum"),
               "mma": ("ssd_bwd_dstate_mma", "ssd_bwd_state_passing",
                       "ssd_bwd_inter", "ssd_bwd_chunk_mma", "ssd_bwd_dda",
                       "ssd_bwd_group_sum", "ssd_bwd_da_sum")}
#: the backward's strips: a chunk's rows are padded to a multiple of it
BWD_TILE = 16
#: bf16 terms of each fp32 operand of the mma path's products (the
#: source's ``kTerms``; tests/test_torch_ssd.py emulates the arithmetic)
BWD_TERMS = 3
#: the mma path's grid: the blocks (chunks x B x G x slices) that
#: ``bwd_slices`` asks for, about two waves of the card's 132 SMs at one
#: block an SM (more slices, fewer heads a block, measured slower)
BWD_MIN_BLOCKS = 256


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


class BwdPlan(NamedTuple):
    """How one backward call runs; the source takes L, Lp and n_chunks as
    given."""
    path: str          # "mma" or "cuda_core"
    L: int             # rows of a chunk, min(chunk, T)
    Lp: int            # L padded to the strips of BWD_TILE rows
    n_chunks: int

    @property
    def kernels(self) -> tuple[str, ...]:
        return BWD_KERNELS[self.path]


def bwd_plan(dtype: torch.dtype, T: int, chunk: int) -> BwdPlan:
    """The backward's layout.  bfloat16 x/B/C take the tensor-core path
    ("mma"), float32 the CUDA-core path, as the forward picks its path."""
    if dtype not in DTYPES:
        raise ValueError(f"ssd_scan_bwd: dtype {dtype} not in {DTYPES}")
    path = "mma" if dtype == torch.bfloat16 else "cuda_core"
    L = min(chunk, T)
    return BwdPlan(path, L, -(-L // BWD_TILE) * BWD_TILE, -(-T // L))


def bwd_slices(B: int, H: int, G: int, n_chunks: int) -> int:
    """Slices of a group's heads on the mma path (a block takes one slice,
    H / (G S) heads, in head order): the fewest that divide H / G and give
    a grid of BWD_MIN_BLOCKS blocks, or of a quarter of one block a head
    where the call is smaller than that (a block then takes ~4 heads)."""
    rep = H // G
    want = min(BWD_MIN_BLOCKS, max(1, n_chunks * B * G * rep // 4))
    for S in range(1, rep + 1):
        if rep % S == 0 and n_chunks * B * G * S >= want:
            return S
    return rep


def bwd_scratch(B: int, T: int, H: int, P: int, N: int, pl: BwdPlan,
                G: int = 1) -> dict:
    """Scratch of a backward call, in fp32 words.  Both paths: ``dbh`` and
    ``dch``, the dB and dC partials that the group-sum launch sums over
    each group (B T H N each on the CUDA-core path, one a head; B T G S N
    on the mma path, one a slice of ``bwd_slices`` heads); ``dsc`` (each
    chunk's state-gradient term, then the gradient of the state leaving
    it); ``segs`` and ``da_part`` (one a (b, chunk, head)); ``dcss`` (the
    inter-chunk dC term's share of dcss, Lp a (b, chunk, head), on the mma
    path one for each half of N).  The mma path also passes v (``vv``, one
    for each half of P) and <ds, s_in> (``dsin``) from its inter kernel,
    and Z's column and row sums (``colz``, ``rowq``) from its chunk
    kernel, to its scan."""
    bch, Lp = B * pl.n_chunks * H, pl.Lp
    if pl.path == "cuda_core":
        return {"dbh": B * T * H * N, "dch": B * T * H * N,
                "dsc": bch * P * N, "segs": bch, "dcss": bch * Lp,
                "da_part": bch}
    parts = G * bwd_slices(B, H, G, pl.n_chunks)
    return {"dbh": B * T * parts * N, "dch": B * T * parts * N,
            "dsc": bch * P * N, "segs": bch, "dcss": 2 * bch * Lp,
            "da_part": bch, "vv": 2 * bch * Lp, "dsin": bch,
            "colz": bch * Lp, "rowq": bch * Lp}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)))
    lib.ssd_fwd.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.ssd_fwd.restype = ctypes.c_int
    lib.ssd_fwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(BWD_SOURCE)))
    lib.ssd_bwd.argtypes = (
        [ctypes.c_void_p] * 24 + [ctypes.c_int] * 12
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.ssd_bwd.restype = ctypes.c_int
    lib.ssd_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_bwd_error_string.restype = ctypes.c_char_p
    lib.ssd_bwd_smem.argtypes = [ctypes.c_int] * 4
    lib.ssd_bwd_smem.restype = ctypes.c_longlong
    return lib


def _check(x, dt, a, B_, C_, chunk, state0, who="ssd_scan") -> None:
    named = (("x", x), ("dt", dt), ("a", a), ("B_", B_), ("C_", C_))
    if state0 is not None:
        named += (("state0", state0),)
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}, not on a "
                             "CUDA device")
        if t.device != x.device:
            raise ValueError(f"{who}: the inputs must share a device")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or B_.dim() != 4:
        raise ValueError(f"{who}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B_ "
                         f"{tuple(B_.shape)}: expected (B, T, H, P), "
                         "(B, T, H), (H,), (B, T, G, N)")
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if (tuple(dt.shape) != (Bb, T, H) or tuple(a.shape) != (H,)
            or tuple(B_.shape[:2]) != (Bb, T) or C_.shape != B_.shape):
        raise ValueError(f"{who}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, B_ "
                         f"{tuple(B_.shape)}, C_ {tuple(C_.shape)} disagree")
    if x.dtype not in DTYPES or not (x.dtype == B_.dtype == C_.dtype):
        raise ValueError(f"{who}: x, B_, C_ have dtypes {x.dtype}, "
                         f"{B_.dtype}, {C_.dtype}; the kernel takes one of "
                         "float32 and bfloat16 for all three")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{who}: dt and a must be float32")
    if a.stride(0) != 1:
        raise ValueError(f"{who}: a must be contiguous")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"{who}: head dim P={P} not in {HEAD_DIMS} or "
                         f"state dim N={N} not in {STATE_DIMS}")
    if G < 1 or H % G:
        raise ValueError(f"{who}: G={G} does not divide H={H}")
    if chunk < 1 or min(chunk, T) > MAX_CHUNK:
        raise ValueError(f"{who}: chunk length min({chunk}, T={T}) must "
                         f"be in [1, {MAX_CHUNK}]")
    if T < 1 or Bb < 1:
        raise ValueError(f"{who}: unsupported B={Bb}, T={T}")
    # the grid's y: B * H blocks on the chunked path, B on the fp32 path
    if plan(x.dtype, T, chunk).path == "chunked" and Bb * H > MAX_GRID_Y:
        raise ValueError(f"{who}: B={Bb} x H={H} exceeds {MAX_GRID_Y} "
                         "on the chunked path")
    if Bb > MAX_GRID_Y:
        raise ValueError(f"{who}: B={Bb} exceeds {MAX_GRID_Y}")
    if state0 is not None and (tuple(state0.shape) != (Bb, H, P, N)
                               or state0.dtype != torch.float32
                               or not state0.is_contiguous()):
        raise ValueError(f"{who}: state0 must be a contiguous float32 "
                         f"{(Bb, H, P, N)}, got {tuple(state0.shape)} "
                         f"{state0.dtype}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 128,
             state0: torch.Tensor | None = None, return_states: bool = False):
    """x: (B, T, H, P); dt: (B, T, H) float32 after softplus; a: (H,)
    float32, negative; B_, C_: (B, T, G, N).  x, B_ and C_ are float32 or
    bfloat16 with any element strides (no copy is made).  Returns
    (y: (B, T, H, P) float32, final_state: (B, H, P, N) float32), both
    contiguous.  ``state0`` (contiguous float32 (B, H, P, N)) or None for
    zeros.  Chunks of L = min(chunk, T); the ragged last chunk is masked in
    the kernel, which equals padding it with dt = 0.  With
    ``return_states`` a third output is the float32 state entering each
    chunk, (B, chunks, H, P, N), which ``ssd_scan_bwd`` takes."""
    global LAUNCHES, LAST_PATH
    _check(x, dt, a, B_, C_, chunk, state0)
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    pl = plan(x.dtype, T, chunk)
    if state0 is not None and state0.data_ptr() % 16:
        state0 = state0.clone()     # the kernels read it 16 bytes at a time
    y = torch.empty(Bb, T, H, P, dtype=torch.float32, device=x.device)
    state = torch.empty(Bb, H, P, N, dtype=torch.float32, device=x.device)
    states = (torch.empty(Bb, pl.n_chunks, H, P, N, dtype=torch.float32,
                          device=x.device) if return_states else None)
    cb = cs = segs = None
    if pl.path == "chunked":  # scratch: C B^T, chunk states, chunk decays
        cb = torch.empty(Bb * pl.n_chunks * G * pl.Lp * pl.Lp,
                         dtype=torch.float32, device=x.device)
        if "ssd_state_passing" in pl.kernels:
            if states is None:    # else the states take the scratch's place
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
            *(None if t is None else t.data_ptr()
              for t in (cb, cs, segs, states)),
            PATHS[pl.path], Bb, T, H, G, P, N, pl.L, pl.Lp, pl.n_chunks,
            (ctypes.c_longlong * 15)(*strides), stream)
    if rc != 0:
        raise RuntimeError("ssd_fwd launch failed: "
                           + lib.ssd_fwd_error_string(rc).decode())
    LAUNCHES += 1
    LAST_PATH = pl.path
    return (y, state, states) if return_states else (y, state)


def _check_bwd(x, dt, a, B_, C_, dy, states, dstate, chunk) -> None:
    who = "ssd_scan_bwd"
    _check(x, dt, a, B_, C_, chunk, None, who=who)
    Bb, T, H, P = x.shape
    N = B_.shape[3]
    pl = bwd_plan(x.dtype, T, chunk)
    if Bb * H > MAX_GRID_Y:
        raise ValueError(f"{who}: B={Bb} x H={H} exceeds {MAX_GRID_Y}")
    if (dy.device != x.device or tuple(dy.shape) != (Bb, T, H, P)
            or dy.dtype != torch.float32):
        raise ValueError(f"{who}: dy must be a float32 {(Bb, T, H, P)} on "
                         f"{x.device}, got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    want = (Bb, pl.n_chunks, H, P, N)
    if (states.device != x.device or tuple(states.shape) != want
            or states.dtype != torch.float32
            or not states.is_contiguous()):
        raise ValueError(f"{who}: states must be the forward's contiguous "
                         f"float32 {want}, got {tuple(states.shape)} "
                         f"{states.dtype}")
    if dstate is not None and (dstate.device != x.device
                               or tuple(dstate.shape) != (Bb, H, P, N)
                               or dstate.dtype != torch.float32):
        raise ValueError(f"{who}: dstate must be a float32 {(Bb, H, P, N)} "
                         f"on {x.device}, got {tuple(dstate.shape)} "
                         f"{dstate.dtype}")


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 B_: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
                 states: torch.Tensor, *, chunk: int = 128,
                 dstate: torch.Tensor | None = None,
                 state0_grad: bool = True):
    """The gradient of ``ssd_scan``: (dx, ddt, da, dB, dC, dstate0), all
    float32 and contiguous, shaped like x, dt, a, B_, C_ and the state
    (dstate0 is None unless ``state0_grad``).  x, dt, a, B_, C_ and
    ``chunk`` are the forward's; ``states`` its ``return_states`` output;
    ``dy`` the float32 gradient of y, with any element strides; ``dstate``
    that of the final state, or None for zeros.  bfloat16 x/B_/C_ take
    the tensor-core path, float32 the CUDA-core path (``bwd_plan``).  The
    sums are fp32 and run
    in a fixed order (no atomic): equal inputs give equal outputs bit for
    bit.  Anything the kernel does not take raises."""
    global BWD_LAUNCHES
    _check_bwd(x, dt, a, B_, C_, dy, states, dstate, chunk)
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    pl = bwd_plan(x.dtype, T, chunk)
    if dstate is not None:            # read 16 bytes at a time
        dstate = dstate.contiguous()
        if dstate.data_ptr() % 16:
            dstate = dstate.clone()
    dev, f32 = x.device, torch.float32
    dx = torch.empty(Bb, T, H, P, dtype=f32, device=dev)
    ddt = torch.empty(Bb, T, H, dtype=f32, device=dev)
    da = torch.empty(H, dtype=f32, device=dev)
    dB = torch.empty(Bb, T, G, N, dtype=f32, device=dev)
    dC = torch.empty(Bb, T, G, N, dtype=f32, device=dev)
    dstate0 = (torch.empty(Bb, H, P, N, dtype=f32, device=dev)
               if state0_grad else None)
    scratch = {k: torch.empty(n, dtype=f32, device=dev)
               for k, n in bwd_scratch(Bb, T, H, P, N, pl, G).items()}
    strides = [*x.stride(), *dt.stride(), *B_.stride(), *C_.stride(),
               *dy.stride()]

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), dy.data_ptr(), ptr(dstate), states.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ptr(dstate0),
            *(ptr(scratch.get(k)) for k in ("dbh", "dch", "dsc", "segs",
                                            "dcss", "da_part", "vv",
                                            "dsin", "colz", "rowq")),
            BWD_PATHS[pl.path], bwd_slices(Bb, H, G, pl.n_chunks),
            int(x.dtype == torch.bfloat16), Bb, T, H, G, P, N, pl.L, pl.Lp,
            pl.n_chunks, (ctypes.c_longlong * 19)(*strides), stream)
    if rc != 0:
        raise RuntimeError("ssd_bwd launch failed: "
                           + lib.ssd_bwd_error_string(rc).decode())
    BWD_LAUNCHES += 1
    return dx, ddt, da, dB, dC, dstate0
