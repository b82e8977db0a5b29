"""Flash attention on Hopper: ctypes bindings of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``.

The forward is the hand-written CUDA kernel that replaces the TPU Pallas
kernel ``repro.kernels.flash_attention.kernel._flash_fwd_kernel``; the
source's header says how each of its three paths is laid out and what
bounds it.  ``plan`` picks the path and the decode split count.  The
backward (``flash_attention_bwd``) is the gradient that the JAX package
takes by autodiff of ``chunked_attention``, as three kernels of its own
source.  Each library is built by nvcc at first use
(``repro_torch.kernels._build``), never at import.
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


def bwd_plan(dtype: torch.dtype) -> str:
    """The backward's path, which the source picks by dtype: bf16 on the
    tensor cores, float32 on the CUDA cores (the tensor cores' fp32
    product is TF32)."""
    return "mma" if dtype == torch.bfloat16 else "cuda_core"


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
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_float, ctypes.c_void_p])
    lib.flash_bwd.restype = ctypes.c_int
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


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
    already is one); its values are not read on the host."""
    if not isinstance(q_offset, torch.Tensor):
        if q_offset < 0:
            raise ValueError(f"flash_attention: q_offset={q_offset} must be "
                             ">= 0")
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
    (B, Hq, Sq) fp32, -inf where a row sees no key (the backward's input;
    Sq >= 2, the prefill paths).

    Key j is seen by query row i of batch row b iff ``j < kv_len`` and,
    when causal, ``j <= q_offset + i``; ``q_offset`` is an int, or a (B,)
    integer tensor on q's device with one offset per batch row (each >= 0:
    the host does not read it).  ``kv_len`` and ``q_offset`` are runtime
    values: nothing is rebuilt when they change.
    """
    global LAUNCHES
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kv_len = Sk if kv_len is None else min(int(kv_len), Sk)
    if kv_len < 0:
        raise ValueError(f"flash_attention: kv_len={kv_len} must be >= 0")
    q_offset, rows = _row_offsets(q_offset, q)
    if return_lse and Sq < 2:
        raise ValueError("flash_attention: the log-sum-exp is written by "
                         "the prefill paths, which take Sq >= 2")
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
    stride 1 in D; on the tensor-core path q, k, v and dout also 16-byte
    aligned rows.  The sums are fp32, with no atomics: equal inputs give
    equal outputs bit for bit."""
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
    if bwd_plan(q.dtype) == "mma":
        for name, t in (("q", q), ("dout", dout)):
            if not aligned16(t):
                raise ValueError(f"flash_attention_bwd: {name} strides "
                                 f"{t.stride()} or its address are not "
                                 "16-byte aligned")
    q_offset, rows = _row_offsets(q_offset, q)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(B, Hq, Sq, device=q.device, dtype=torch.float32)
    strides = []
    for t in (q, k, v, out, dout, dq, dk, dv):
        sb, sh, ss, _ = t.stride()
        strides += [sb, ss, sh]
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype],
            B, Hq, Hkv, Sq,
            Sk, D, (ctypes.c_longlong * 24)(*strides), kv_len, q_offset,
            None if rows is None else rows.data_ptr(), int(causal),
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError("flash_bwd launch failed: "
                           + lib.flash_bwd_error_string(rc).decode())
    BWD_LAUNCHES += 1
    return dq, dk, dv
