"""Flash attention on Hopper: ctypes bindings of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``.

The forward is the hand-written CUDA kernel that replaces the TPU Pallas
kernel ``repro.kernels.flash_attention.kernel._flash_fwd_kernel``; the
source's header says how each of its three paths is laid out and what
bounds it.  ``plan`` picks the path and the decode split count.  The
backward (``flash_attention_bwd``) is the gradient that the JAX package
takes by autodiff of ``chunked_attention``, from a source of its own;
``bwd_plan`` names its path and ``bwd_geometry``, ``bwd_scratch`` and
``bwd_tile`` mirror the host-side layout of the wgmma path in Python (the
CPU tests check them; the card's tests hold them to the source).  Each
library is built by nvcc at first use (``repro_torch.kernels._build``),
never at import.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .._build import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BWD_SOURCE = SOURCE.with_name("flash_bwd.cu")
HEAD_DIMS = (32, 64, 128, 160)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the source's paths, by the number its entry takes
PATHS = {"prefill_mma": 0, "decode_split": 1, "fp32": 2}
#: decode: keys per tile, stages of the cp.async ring, most query heads per
#: block; the source's kBK, kDecStages and largest R (the source gives a
#: float32 call at D 160 two stages; the split rule keeps three)
DECODE_TILE, DECODE_STAGES, DECODE_HEADS = 64, 3, 8
#: decode: blocks to aim for, in waves of one block per SM
DECODE_WAVES = 2

#: launches of the kernel in this process (chip_smoke.py reads it): one per
#: call, also where a split decode launches its merge as well
LAUNCHES = 0
#: calls of the backward in this process, one per call (each launches the
#: source's three kernels)
BWD_LAUNCHES = 0
#: the backward's paths, by the number its entry takes
BWD_PATHS = {"cuda_core": 0, "mma": 1, "wgmma": 2}
#: the kernels a call of each path launches, in order (the wgmma path's
#: zeroed counters are one fill before them)
BWD_KERNELS = {
    "cuda_core": ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"),
    "mma": ("flash_bwd_delta", "flash_bwd_dkdv_mma", "flash_bwd_dq_mma"),
    "wgmma": ("flash_bwd_stats", "flash_bwd_wgmma", "flash_bwd_dq_convert")}
#: wgmma path: keys a tile (64 a consumer warpgroup), query rows a ring
#: stage, threads a block: the source's kBK, kBQ, kHopperThreads
BWD_KEYS, BWD_ROWS, BWD_THREADS = 128, 64, 384
#: wgmma path: tiles a block's producer takes ahead (the source's kTileRing)
BWD_TILE_RING = 4
#: shared memory a block may take on an H100
SMEM_LIMIT = 232448


def decode_splits(B: int, Hq: int, Hkv: int, kv_len: int, sms: int) -> int:
    """Key splits of the decode path: enough blocks for ``DECODE_WAVES``
    waves on ``sms`` SMs, each split at least one ring of keys."""
    blocks = B * Hkv * -(-(Hq // Hkv) // DECODE_HEADS)
    most = max(1, -(-kv_len // (DECODE_TILE * DECODE_STAGES)))
    return max(1, min(most, -(-DECODE_WAVES * sms // blocks)))


def plan(dtype: torch.dtype, B: int, Hq: int, Hkv: int, Sq: int, kv_len: int,
         sms: int) -> tuple[str, int]:
    """(path, splits): Sq 1 takes the split decode; a bf16 prefill the
    tensor cores; a float32 prefill the CUDA-core kernel."""
    if Sq == 1:
        return "decode_split", decode_splits(B, Hq, Hkv, kv_len, sms)
    if dtype == torch.bfloat16:
        return "prefill_mma", 1
    return "fp32", 1


def bwd_plan(dtype: torch.dtype, D: int) -> str:
    """The backward's path: float32 on the CUDA cores (the tensor cores'
    fp32 product is TF32); bf16 at D 160 on ``mma.sync`` (the dK and dV
    accumulators of a warpgroup's 64 keys alone take 160 of the 240
    registers a thread may have, too many for wgmma's S, dP and dQ
    beside them); bf16 at D 32, 64, 128 on the Hopper kernel, ``wgmma``
    fed by TMA."""
    if dtype != torch.bfloat16:
        return "cuda_core"
    return "mma" if D == 160 else "wgmma"


def bwd_geometry(D: int) -> dict:
    """The wgmma path's tiles at head dim D, as the source lays them out:
    a TMA box row of ``box`` elements (128 bytes under the 128-byte
    swizzle; 64 bytes under the 64-byte one at D 32), ``boxes`` of them
    side by side, a ring of ``stages`` (Q, dO: ``rows`` x D bf16 each,
    lse2 and Delta: ``rows`` floats each), K and V of ``keys`` rows, two
    dS^T buffers (keys x rows bf16), ``dq_stages`` x ``boxes`` dQ share
    boxes (rows x box fp32; one reducer lane a stage), a ring of
    ``BWD_TILE_RING`` tile indices, the mbarriers, and 1,024 bytes to
    align the base: ``smem`` bytes of dynamic shared memory."""
    if D not in (32, 64, 128):
        raise ValueError(f"flash_attention_bwd: the wgmma path takes D 32, "
                         f"64 and 128, not {D}")
    box = min(D, 64)
    boxes = D // box
    stages, dq_stages = (2 if D >= 128 else 3), 2
    kv = 2 * BWD_KEYS * D * 2
    ring = stages * (2 * BWD_ROWS * D * 2 + 2 * BWD_ROWS * 4)
    ds = 2 * BWD_KEYS * BWD_ROWS * 2
    dq = dq_stages * boxes * BWD_ROWS * box * 4
    tiles = 4 * BWD_TILE_RING
    bars = 8 * (2 + 2 * stages + 3 * dq_stages + 2 * BWD_TILE_RING)
    return {"keys": BWD_KEYS, "rows": BWD_ROWS, "box": box, "boxes": boxes,
            "swizzle": 2 * box, "stages": stages,
            "dq_stages": dq_stages, "threads": BWD_THREADS,
            "smem": kv + ring + ds + dq + tiles + bars + 1024}


def bwd_scratch(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int) -> dict:
    """Scratch of a wgmma-path call, in 4-byte words: ``stats`` (lse *
    log2(e), then Delta, Sq padded to whole query tiles), ``dq_accum``
    (fp32 dQ, one box of rows x box a (query tile, box); the first key
    tile to add to a box writes it), ``sems`` (a counter a dQ box, then
    one a (kv head, key tile, consumer warpgroup), then the counter of
    tiles taken; zeroed), ``dkv_accum`` (fp32 dK and dV a (kv head, key
    tile), where a GQA group sums them, else 0)."""
    g = bwd_geometry(D)
    mq = -(-Sq // BWD_ROWS)
    n_kt = -(-Sk // BWD_KEYS)
    return {"stats": 2 * B * Hq * mq * BWD_ROWS,
            "dq_accum": B * Hq * mq * BWD_ROWS * D,
            "sems": B * Hq * mq * g["boxes"] + B * Hkv * n_kt * 2 + 1,
            "dkv_accum": (B * Hkv * n_kt * 2 * BWD_KEYS * D
                          if Hq > Hkv else 0)}


def bwd_tiles(B: int, Hq: int, Sk: int, sms: int) -> tuple[int, int]:
    """(tiles, blocks) of a wgmma-path call: a tile per (key tile, query
    head, batch row); a persistent grid of at most one block an SM, whose
    blocks take tiles in index order from a counter."""
    tiles = -(-Sk // BWD_KEYS) * B * Hq
    return tiles, min(tiles, sms)


def bwd_tile(t: int, Hq: int, Sk: int) -> tuple[int, int, int]:
    """(key tile, query head, batch row) of tile t: head by head (the key
    tiles of a head run at once, so their dQ adds meet in L2), the last
    key tile of a head first.  A tile waits only for tiles of lower index:
    the next key tile of its head (dQ sums run from the last key tile
    down) and the previous head of its GQA group (dK and dV)."""
    n_kt = -(-Sk // BWD_KEYS)
    hb = t // n_kt
    return n_kt - 1 - t % n_kt, hb % Hq, hb // Hq


def bwd_last_key_tile(m: int, kv_len: int, causal: bool,
                      q_offset: int) -> int:
    """The last key tile that visits query tile m: the first to add to its
    dQ, the key tiles below it adding after it in descending order."""
    lim = min(kv_len, q_offset + (m + 1) * BWD_ROWS) if causal else kv_len
    return (lim - 1) // BWD_KEYS


def bwd_visits(n: int, Sq: int, kv_len: int, causal: bool,
               q_offset: int) -> range:
    """The query tiles that key tile n visits: those with a row that sees
    one of its keys (counted over whole tiles)."""
    k0 = n * BWD_KEYS
    m1 = -(-Sq // BWD_ROWS) if k0 < kv_len else 0
    m0 = min(max(0, k0 - q_offset) // BWD_ROWS, m1) if causal else 0
    return range(m0, m1)


def aligned16(t: torch.Tensor) -> bool:
    """Rows that can be copied 16 bytes at a time: the address and the
    (b, h, s) strides in multiples of 16 bytes."""
    chunk = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % chunk == 0
                                          for s in t.stride()[:3])


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)))
    lib.flash_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(BWD_SOURCE)))
    lib.flash_bwd.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
    lib.flash_bwd.restype = ctypes.c_int
    lib.flash_bwd_geometry.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.flash_bwd_geometry.restype = ctypes.c_int
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_source_geometry(D: int) -> dict:
    """The source's own ``bwd_geometry`` (builds the library)."""
    out = (ctypes.c_int * 8)()
    if _bwd_lib().flash_bwd_geometry(D, out) != 0:
        raise ValueError(f"flash_bwd_geometry: no wgmma tiles at D {D}")
    keys = ("keys", "rows", "box", "boxes", "stages", "dq_stages",
            "threads", "smem")
    return dict(zip(keys, out))


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             "not on a CUDA device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d "
                             f"(B, H, S, D), got {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} has dtype {t.dtype}; "
                             "the kernel takes float32 and bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs stride 1 in D")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must share a device")
    B, Hq, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    Hkv = k.shape[1]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if Sq < 1 or B < 1 or B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention: unsupported B={B}, Hq={Hq}, "
                         f"Sq={Sq}")
    # K and V tiles, and Q on the tensor-core path, are copied 16 bytes at
    # a time.
    copied = (("k", k), ("v", v))
    if Sq > 1 and q.dtype == torch.bfloat16:
        copied = (("q", q),) + copied
    for name, t in copied:
        if not aligned16(t):
            raise ValueError(f"flash_attention: {name} strides "
                             f"{t.stride()} or its address are not 16-byte "
                             "aligned")


def _row_offsets(q_offset, q: torch.Tensor):
    """(scalar offset, per-row offsets or None): a (B,) integer tensor on
    q's device goes to the kernel as contiguous int32 (no copy when it
    already is one); its values are not read on the host.  A scalar
    offset may be negative at Sq 1 only (the decode path takes signed
    offsets: the row then sees no key)."""
    if not isinstance(q_offset, torch.Tensor):
        if q_offset < 0 and q.shape[2] > 1:
            raise ValueError(f"flash_attention: q_offset={q_offset} must be "
                             ">= 0 where Sq > 1")
        return int(q_offset), None
    if (q_offset.dim() != 1 or q_offset.shape[0] != q.shape[0]
            or q_offset.device != q.device
            or q_offset.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"flash_attention: per-row q_offset must be a "
                         f"({q.shape[0]},) integer tensor on {q.device}, got "
                         f"{tuple(q_offset.shape)} {q_offset.dtype} on "
                         f"{q_offset.device}")
    return 0, q_offset.to(torch.int32).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None,
                    q_offset: int | torch.Tensor = 0,
                    return_lse: bool = False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), any strides with stride 1
    in D.  Returns (B, Hq, Sq, D) in q's dtype, laid out like q; with
    ``return_lse`` also each query row's log-sum-exp of its scaled scores,
    (B, Hq, Sq) fp32, -inf where a row sees no key (the backward's input,
    and at Sq 1 the context-parallel decode's merge weights; every path
    writes it).

    Key j is seen by query row i of batch row b iff ``j < kv_len`` and,
    when causal, ``j <= q_offset + i``; ``q_offset`` is an int, or a (B,)
    integer tensor on q's device with one offset per batch row (the host
    does not read it).  Offsets are >= 0 where Sq > 1; at Sq 1 (the
    decode path) they are signed, and a row whose offset is negative sees
    no key: its output is 0 and its lse -inf, as at ``kv_len`` 0.
    ``kv_len`` and ``q_offset`` are runtime values: nothing is rebuilt
    when they change.
    """
    global LAUNCHES
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kv_len = Sk if kv_len is None else min(int(kv_len), Sk)
    if kv_len < 0:
        raise ValueError(f"flash_attention: kv_len={kv_len} must be >= 0")
    q_offset, rows = _row_offsets(q_offset, q)
    out = torch.empty_like(q)
    lse = (torch.empty(B, Hq, Sq, device=q.device, dtype=torch.float32)
           if return_lse else None)
    strides = []
    for t in (q, k, v, out):
        sb, sh, ss, _ = t.stride()
        strides += [sb, ss, sh]
    lib = _lib()
    with torch.cuda.device(q.device):
        path, splits = plan(q.dtype, B, Hq, Hkv, Sq, kv_len,
                            sm_count(q.device.index))
        scratch = None
        if splits > 1:      # (max, sum, accumulator) of each split
            scratch = torch.empty(B * Hq * splits * (D + 2), device=q.device,
                                  dtype=torch.float32)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), PATHS[path],
            DTYPES[q.dtype], B, Hq, Hkv, Sq, D,
            (ctypes.c_longlong * 12)(*strides), kv_len, q_offset,
            None if rows is None else rows.data_ptr(), int(causal),
            1.0 / math.sqrt(D), splits,
            None if lse is None else lse.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.flash_fwd_error_string(rc).decode())
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        kv_len: int | None = None,
                        q_offset: int | torch.Tensor = 0):
    """The gradient of ``flash_attention``: (dq, dk, dv), each in q's
    dtype and laid out like q, k and v.  ``out`` and ``lse`` are the
    forward's output and log-sum-exp on the same inputs and mask; ``dout``
    is the gradient of ``out``.  Every tensor is a strided view with
    stride 1 in D.  The sums are fp32 and run in a fixed order (no
    atomic whose order varies): equal inputs give equal outputs bit for
    bit.  ``bwd_plan`` names the path; the
    tensor-core paths read q, k, v and dout by TMA or 16-byte copies (the
    wgmma path out too), so each of them must have a 16-byte aligned
    address and (b, h, s) strides.  Anything the kernel does not take
    raises."""
    global BWD_LAUNCHES
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if (t.shape != q.shape or t.dtype != q.dtype
                or t.device != q.device or t.stride(-1) != 1):
            raise ValueError(f"flash_attention_bwd: {name} must be like q "
                             f"{tuple(q.shape)} {q.dtype} with stride 1 in "
                             f"D, got {tuple(t.shape)} {t.dtype} stride "
                             f"{t.stride()}")
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"({B}, {Hq}, {Sq}) float32 tensor on {q.device}")
    kv_len = Sk if kv_len is None else min(int(kv_len), Sk)
    if kv_len < 0:
        raise ValueError(f"flash_attention_bwd: kv_len={kv_len} must be "
                         ">= 0")
    path = bwd_plan(q.dtype, D)
    if path != "cuda_core":
        vector = (("q", q), ("k", k), ("v", v), ("dout", dout))
        if path == "wgmma":           # its statistics read out 16 bytes at a time
            vector += (("out", out),)
        for name, t in vector:
            if not aligned16(t):
                raise ValueError(f"flash_attention_bwd: {name} strides "
                                 f"{t.stride()} or its address are not "
                                 "16-byte aligned")
    q_offset, rows = _row_offsets(q_offset, q)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dev = q.device
    dq_accum = dkv_accum = sems = None
    if path == "wgmma":
        n = bwd_scratch(B, Hq, Hkv, Sq, Sk, D)
        stats = torch.empty(n["stats"], device=dev, dtype=torch.float32)
        dq_accum = torch.empty(n["dq_accum"], device=dev, dtype=torch.float32)
        sems = torch.zeros(n["sems"], device=dev, dtype=torch.int32)
        if n["dkv_accum"]:
            dkv_accum = torch.empty(n["dkv_accum"], device=dev,
                                    dtype=torch.float32)
    else:
        stats = torch.empty(B, Hq, Sq, device=dev, dtype=torch.float32)
    strides = []
    for t in (q, k, v, out, dout, dq, dk, dv):
        sb, sh, ss, _ = t.stride()
        strides += [sb, ss, sh]

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), ptr(dq_accum), ptr(dkv_accum),
            ptr(sems), BWD_PATHS[path], B, Hq, Hkv, Sq,
            Sk, D, (ctypes.c_longlong * 24)(*strides), kv_len, q_offset,
            ptr(rows), int(causal), 1.0 / math.sqrt(D),
            sm_count(dev.index), stream)
    if rc != 0:
        raise RuntimeError("flash_bwd launch failed: "
                           + lib.flash_bwd_error_string(rc).decode())
    BWD_LAUNCHES += 1
    return dq, dk, dv
