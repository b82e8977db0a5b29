"""Times versions of the flash backward's source against each other on one
card, at chip_smoke.py's 13b shapes (stablelm-1.6b's and qwen2-7b's
training attention, bf16, causal), beside SDPA's backward.

Each source is built with the port's nvcc flags into ``build/variants/``
(one nvcc each, in parallel) and bound in place of the library
``kernel.flash_attention_bwd`` loads, so the same wrapper, scratch and
inputs drive every version.  The versions run in turns (first, second,
..., then in reverse), each timed from CUDA-graph replays and checked
against the plain version (``--no-dq-add`` versions are timed only: their
dQ is wrong by design).

    python3 scripts/flash_bwd_ab.py                       # the repo's source
    python3 scripts/flash_bwd_ab.py old.cu new.cu          # two versions
    python3 scripts/flash_bwd_ab.py --no-dq-add            # + the diagnostic

A version must take the scratch the wrapper passes now (its dQ
accumulator is not zeroed, for one).  ``--no-dq-add`` adds a copy of the
repo's source whose reducer lanes skip
the bulk adds of dQ's shares (and the counter waits before them): the time
the rest of the kernel needs, the part the dQ adds cost being the
difference.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: the reducer's wait and bulk add, which ``--no-dq-add`` removes
DQ_ADD = """      if (turn > 0) {                           // the tiles before are in
#pragma unroll
        for (int c = 0; c < G::NBOX; ++c)
          while (ld_acquire(sems + c) != turn) {
          }
        fence_proxy_async();
      }"""
DQ_ADD_CALL = """        if (turn == 0) bulk_store(dst, src, G::DQ_BOX * 4);
        else bulk_reduce_add(dst, src, G::DQ_BOX * 4);"""


def no_dq_add(source: Path, out: Path) -> Path:
    text = source.read_text()
    for piece in (DQ_ADD, DQ_ADD_CALL):
        if text.count(piece) != 1:
            raise SystemExit(f"--no-dq-add: {source} has no single "
                             f"{piece.splitlines()[0].strip()!r}")
        text = text.replace(piece, "")
    out.write_text(text)
    return out


def build(name: str, source: Path, nvcc: str, flags) -> Path:
    lib = ROOT / "build" / "variants" / f"lib{name}.so"
    t0 = time.time()
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {source}:\n{proc.stderr[-3000:]}")
    print(f"built {name} from {source} in {time.time() - t0:.1f} s",
          flush=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--no-dq-add", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_bwd_ref, kernel

    print(cs.nvidia_smi_line(), flush=True)
    (ROOT / "build" / "variants").mkdir(parents=True, exist_ok=True)
    versions = {f"v{i}_{s.stem}": s for i, s in enumerate(
        args.sources or [Path(kernel.BWD_SOURCE)])}
    timed_only = set()
    if args.no_dq_add:
        name = "no_dq_add"
        versions[name] = no_dq_add(Path(kernel.BWD_SOURCE), ROOT / "build" /
                                   "variants" / "flash_bwd_no_dq_add.cu")
        timed_only.add(name)
    with ThreadPoolExecutor(len(versions)) as pool:
        libs = dict(zip(versions, pool.map(
            lambda kv: build(kv[0], kv[1], _build.nvcc_path(),
                             _build.NVCC_FLAGS), versions.items())))
    loader = kernel._bwd_lib
    base = loader()
    bound_libs = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.flash_bwd.argtypes = base.flash_bwd.argtypes
        lib.flash_bwd.restype = ctypes.c_int
        lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        bound_libs[name] = lib
    order = list(bound_libs) + list(bound_libs)[::-1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape, B, Hq, Hkv, T, D in cs.BWD_TIMED:
        q, k, v, do = cs.bwd_inputs(torch, B, Hq, Hkv, T, T, D,
                                    torch.bfloat16, 11)
        out, lse = kernel.flash_attention(q, k, v, causal=True,
                                          return_lse=True)
        flops = 2.5 * 4 * D * B * Hq * T * (T + 1) / 2
        b_ms, b_by = cs.bwd_bound(B, Hq, Hkv, T, D, 2)
        refs = attention_bwd_ref(q, k, v, out, do, lse, causal=True)

        def call():
            return kernel.flash_attention_bwd(q, k, v, out, do, lse,
                                              causal=True)
        try:
            for name in order:
                kernel._bwd_lib = lambda lib=bound_libs[name]: lib
                grads = call()
                errs = [cs.grad_rel(g, r) for g, r in zip(grads, refs)]
                if name not in timed_only:
                    cs.check(max(errs) <= cs.TOL["bfloat16"],
                             f"{name} disagrees at {shape}: {errs}")
                ms = cs.device_ms(torch, call, calls=3, replays=3)
                per = cs.device_ms_per_launch(torch, call,
                                              r"(flash_bwd_\w+)", calls=3)
                print(f"{shape:20s} {name:24s} {ms:8.4f} ms "
                      f"{flops / ms / 1e9:7.1f} TFLOP/s, "
                      f"{100 * b_ms / ms:5.1f}% of the bound ({b_ms:.4f} ms, "
                      f"{b_by}); dq/dk/dv "
                      + " ".join(f"{e:.2e}" for e in errs) + "; "
                      + ", ".join(f"{k} {v:.4f}" for k, v in per.items()),
                      flush=True)
                del grads
        finally:
            kernel._bwd_lib = loader
        qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
        lib_out = sdpa(qc, kc, vc, is_causal=True, enable_gqa=Hq != Hkv)
        lms = cs.host_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qc, kc, vc), do, retain_graph=True))
        print(f"{shape:20s} {'SDPA backward':24s} {lms:8.4f} ms "
              f"{flops / lms / 1e9:7.1f} TFLOP/s", flush=True)
        del q, k, v, do, out, lse, refs, qc, kc, vc, lib_out
        torch.cuda.empty_cache()
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
