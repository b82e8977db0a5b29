#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card's name and power limit (nvidia-smi), torch, CUDA and nvcc
   versions;
2. the build of the flash-attention kernel from ``src/`` into
   ``build/kernels/``, with nvcc's ``-Xptxas -v`` report;
3. the kernel against its plain PyTorch version on the card, case by case
   (float32 at 2e-5, bfloat16 at 2e-2, as tests/test_kernels.py), with
   every attention call of the main path: its batches are formed by
   ``serve.make_requests`` and ``serve.batched``, as ``serve.main`` forms
   them;
4. the main path: ``repro_torch.launch.serve.main`` serving 8 requests of
   12 new tokens with stablelm-1.6b at full width (random weights from a
   seed); the kernel's launch count must be 24 x (prefills + decode steps)
   and the batches served must be those phase 3 checked;
5. a profile (``torch.profiler``) of decode steps at the main path's first
   batch: wall and device-busy time per step, kernels per step, the top
   kernels and operators;
6. the model on the card against the same model on the CPU, where
   attention takes the plain version: a reduced config, the full-width
   weights cut to 2 layers, and all 24 layers with the attention weights
   scaled to unit score variance (see ``unit_score_scale``);
7. the kernel's device time beside its plain version's, SDPA's (a
   yardstick the port never calls) and its bound, at the serve shapes, a
   4k prefill and a 32k decode: CUDA events around replays of a CUDA graph
   of back-to-back calls, so the host's overhead does not count; the time
   per call with that overhead (``host_ms``) is reported beside it.

The last lines are a ``kernels`` JSON object, the card's nvidia-smi line
and ``{"ok": true, "device": {...}}``; the full report goes to
``build/reports/chip_smoke.json``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:29"

BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
HBM_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth, bytes/s
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernel against its plain version
# ---------------------------------------------------------------------------
def serve_cases(batch_shapes, H, D):
    """Every attention call of the main path: per batch (B, T, steps), the
    prefill over the cache of T + steps positions and each decode step."""
    cases = []
    for B, T, steps in batch_shapes:
        Sk = T + steps
        cases.append((f"serve prefill B{B} T{T}", B, H, H, T, Sk, D, True, T,
                      0, "cache"))
        for kv in range(T + 1, Sk + 1):
            cases.append((f"serve decode B{B} kv_len={kv}/{Sk}", B, H, H, 1,
                          Sk, D, True, kv, kv - 1, "cache"))
    return cases


def kernel_cases(batch_shapes, serve_heads, serve_head_dim):
    """(name, B, Hq, Hkv, Sq, Sk, D, causal, kv_len, q_offset, layout)."""
    cases = []
    for B, Hq, Hkv, Sq, Sk, D, causal in [
            (1, 2, 2, 64, 64, 32, True),
            (2, 4, 2, 128, 128, 64, True),      # GQA
            (1, 4, 1, 96, 160, 32, False),      # MQA, unaligned, bidir
            (1, 2, 2, 1, 256, 64, False)]:      # decode shape
        cases.append((f"oracle B{B} H{Hq}/{Hkv} Sq{Sq} Sk{Sk} D{D}",
                      B, Hq, Hkv, Sq, Sk, D, causal, None, 0, "bhsd"))
    cases.append(("kv_len=50", 1, 2, 2, 8, 128, 32, False, 50, 0, "bhsd"))
    cases.append(("decode q_offset=39", 2, 4, 2, 1, 64, 64, True, 40, 39,
                  "bhsd"))
    cases.append(("chunk q_offset=20", 2, 4, 2, 5, 64, 64, True, 25, 20,
                  "bhsd"))
    for D in (32, 64, 128):               # every head dim x row tiling
        for Sq in (1, 33):
            cases.append((f"instances D{D} Sq{Sq}", 2, 4, 2, Sq, 70, D, True,
                          70, 70 - Sq, "bhsd"))
    # the serve shapes: (B, S, H, D) over views of a stacked cache
    return cases + serve_cases(batch_shapes, serve_heads, serve_head_dim)


def make_inputs(torch, B, Hq, Hkv, Sq, Sk, D, dtype, layout, seed):
    """q, k, v as (B, H, S, D) tensors; for layout "cache" they are views
    of (B, S, H, D) storage, K/V of layer 1 of a two-layer cache."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "cache":
        q = torch.randn(B, Sq, Hq, D, generator=g, device="cuda").to(dtype)
        kc = torch.randn(2, B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(2, B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        return q.transpose(1, 2), kc[1].transpose(1, 2), vc[1].transpose(1, 2)
    q = torch.randn(B, Hq, Sq, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dtype)
    return q, k, v


def run_kernel_checks(torch, kernel, mha, attention_ref, cases):
    results = []
    for i, (name, B, Hq, Hkv, Sq, Sk, D, causal, kv_len, q_off,
            layout) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q, k, v = make_inputs(torch, B, Hq, Hkv, Sq, Sk, D, dtype, layout,
                                  seed=i)
            if layout == "cache":     # through the model's entry, (B, S, H, D)
                out = mha(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, kv_len=kv_len,
                          q_offset=q_off).transpose(1, 2)
            else:
                out = kernel.flash_attention(q, k, v, causal=causal,
                                             kv_len=kv_len, q_offset=q_off)
            ref = attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                q_offset=q_off)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == ref.shape,
                  f"{name} {dname}: dtype/shape {out.dtype} {tuple(out.shape)}")
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            tol = TOL[dname]
            ok = bool((diff <= tol + tol * ref.float().abs()).all())
            if name == "kv_len=50":   # keys past kv_len must not matter
                k2 = k.clone()
                k2[:, :, kv_len:] = 1e3
                out2 = kernel.flash_attention(q, k2, v, causal=causal,
                                              kv_len=kv_len, q_offset=q_off)
                ok = ok and bool(torch.equal(out2, out))
            print(f"  {name:32s} {dname:9s} max_abs_err {err:.3e} "
                  f"tol {tol:g} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"kernel disagrees with its plain version: {name} "
                      f"{dname}, max_abs_err {err}")
            results.append({"case": name, "dtype": dname, "max_abs_err": err,
                            "serve": layout == "cache"})
    return results


# ---------------------------------------------------------------------------
# Phase 6: the model on the card against the model on the CPU
# ---------------------------------------------------------------------------
def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def first_layers(params, n):
    """The parameters with only the first ``n`` stacked blocks."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    return {**params, "blocks": cut(params["blocks"])}


def unit_score_scale(params, cfg):
    """The parameters with ``wq`` and ``wk`` scaled by head_dim**-0.5.

    The init rule (std 1/sqrt(shape[-2]), the heads dim of ``wq``) gives
    attention scores of std d_model / n_heads = 64 here, so softmax is
    near one-hot and rounding differences grow layer by layer until 24
    random layers carry them to the size of the logits.  At unit score
    std the model is well conditioned, and a card-vs-CPU gap at full depth
    measures the code, not the init."""
    s = cfg.resolved_head_dim() ** -0.5
    attn = dict(params["blocks"]["attn"])
    attn["wq"], attn["wk"] = attn["wq"] * s, attn["wk"] * s
    return {**params, "blocks": {**params["blocks"], "attn": attn}}


def model_reference_check(torch, build_model, cfg, params, B, T, steps, tol,
                          label, cache_dtype=None):
    """Prefill then teacher-forced decode steps with the same weights on the
    card (kernel) and on the CPU (plain attention); logits must agree to
    ``tol`` x max|logit|.  Greedy tokens are not compared: with random
    weights the largest logit may change on rounding."""
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, T), generator=gen)
    forced = torch.randint(0, cfg.vocab, (steps, B, 1), generator=gen)
    cache_kw = {} if cache_dtype is None else {"cache_dtype": cache_dtype}
    logits = {}
    for dev in ("cuda", "cpu"):
        p = to_device(params, dev)
        caches = model.init_caches(B, T + steps, device=dev, **cache_kw)
        with torch.inference_mode():
            out, caches = model.prefill(p, {"tokens": prompt.to(dev)}, caches)
            outs = [out.float().cpu()]
            for s in range(steps):
                out, caches = model.decode(p, {"tokens": forced[s].to(dev)},
                                           caches, T + s)
                outs.append(out.float().cpu())
        logits[dev] = outs
        del p, caches
    worst = 0.0
    for a, b in zip(logits["cuda"], logits["cpu"]):
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite logits")
        rel = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        check(rel <= tol, f"{label}: card vs CPU logits differ by {rel:.3e} "
                          f"x max|logit| (tol {tol})")
    print(f"  {label}: card vs CPU logits max err {worst:.3e} x max|logit| "
          f"(tol {tol})", flush=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 5: profile of decode steps; phase 7: kernel timing
# ---------------------------------------------------------------------------
PROFILE_STEPS = 4


def _device_us(event, inclusive: bool) -> float:
    name = "device_time_total" if inclusive else "self_device_time_total"
    legacy = "cuda_time_total" if inclusive else "self_cuda_time_total"
    return float(getattr(event, name, getattr(event, legacy, 0.0)))


def profile_decode(torch, loop, kernel, B, T, steps=PROFILE_STEPS):
    """``steps`` decode steps of the served model, batch ``B`` over a
    prompt of ``T`` tokens, under torch.profiler: wall and device-busy time
    per step (one stream, so device events do not overlap), kernels per
    step, the top kernels and operators by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, loop.cfg.vocab, (B, T), generator=gen)
    with torch.inference_mode():
        caches = loop.model.init_caches(B, T + steps, device=loop.device)
        logits, caches = loop.prefill(loop.params,
                                      {"tokens": toks.to(loop.device)}, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)
        torch.cuda.synchronize()
        launches0 = kernel.LAUNCHES
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(steps):
                tok, _, caches = loop.decode(loop.params,
                                             {"tokens": tok[:, None]},
                                             caches, T + s)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [(e.key, _device_us(e, False), e.count) for e in events
               if e.device_type != DeviceType.CPU]
    ops = [(e.key, _device_us(e, True), e.count) for e in events
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
           and _device_us(e, True) > 0]
    check(sum(us for _, us, _ in kernels) > 0,
          "torch.profiler saw no device time")
    kernels = sorted(((k, us / 1e3 / steps, n) for k, us, n in kernels),
                     key=lambda r: -r[1])
    ops = sorted(((k, us / 1e3 / steps, n) for k, us, n in ops),
                 key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    flash_ms = sum(ms for k, ms, _ in kernels if "flash_fwd" in k)
    out = {"batch": B, "prompt": T, "steps": steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms,
            "kernels_per_step": sum(n for _, _, n in kernels) / steps,
            "flash_ms_per_step": flash_ms,
            "flash_launches_per_step": (kernel.LAUNCHES - launches0) / steps,
            "kernels": kernels[:40], "operators": ops[:40]}
    print(f"  batch {B}, cache {T}+{steps}: wall {out['wall_ms_per_step']:.3f}"
          f" ms/step, device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / out['wall_ms_per_step']:.1f}%) over "
          f"{out['kernels_per_step']:.0f} kernels, flash kernel "
          f"{flash_ms:.4f} ms/step over {out['flash_launches_per_step']:.0f}"
          " launches", flush=True)
    print("  top kernels (ms/step, calls over all steps):")
    for k, ms, n in kernels[:12]:
        print(f"    {ms:9.4f}  {n:6d}  {k[:100]}")
    print("  top operators by inclusive device time (ms/step):")
    for k, ms, n in ops[:8]:
        print(f"    {ms:9.4f}  {n:6d}  {k}")
    return out


def host_ms(torch, fn, budget_ms=300.0):
    """Time per call as the caller sees it: CUDA events around back-to-back
    calls, which take the host's launch overhead in whenever the device
    waits on it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max((time.perf_counter() - t0) * 1e3, 1e-3)
    iters = int(min(200, max(5, budget_ms / once)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls=10, replays=3):
    """Device time per call without the host's overhead: CUDA events around
    replays of a CUDA graph that captured ``calls`` back-to-back calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up off the capturing stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound(B, Hq, Hkv, Sq, D, causal, kv_len, q_offset, elem, flops_peak):
    """Least time for the work these inputs need: valid (q, k) pairs x 4D
    operations at the type's peak, against q and o once plus the K/V rows
    that are needed once at the HBM rate."""
    lims = [min(kv_len, q_offset + i + 1) if causal else kv_len
            for i in range(Sq)]
    flops = 4 * D * B * Hq * sum(lims)
    nbytes = elem * (2 * B * Sq * Hq * D + 2 * B * Hkv * max(lims) * D)
    t_ops, t_bytes = flops / flops_peak, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def run_timings(torch, mha, attention_ref, sdpa, serve_batch, H, D):
    """bf16 at the main path's first batch (its prefill and its last decode
    step), a 4k prefill and a 32k decode."""
    B0, T0, steps0 = serve_batch
    Sk0 = T0 + steps0
    shapes = [  # name, B, Sq, Sk, kv_len, q_offset, causal
        ("serve prefill", B0, T0, Sk0, T0, 0, True),
        ("serve decode", B0, 1, Sk0, Sk0, Sk0 - 1, True),
        ("prefill 4k", 1, 4096, 4096, 4096, 0, True),
        ("decode 32k", 8, 1, 32768, 32768, 32767, True),
    ]
    rows = []
    for name, B, Sq, Sk, kv_len, q_off, causal in shapes:
        dtype = torch.bfloat16
        q, k, v = make_inputs(torch, B, H, H, Sq, Sk, D, dtype, "cache", 7)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def kern():
            return mha(qs, ks, vs, causal=causal, kv_len=kv_len,
                       q_offset=q_off)

        def plain():
            return attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                 q_offset=q_off)
        # SDPA on contiguous (B, H, S, D) copies, with the same mask
        qc = q.contiguous()
        kc, vc = k[:, :, :kv_len].contiguous(), v[:, :, :kv_len].contiguous()
        mask = (torch.arange(kv_len, device="cuda")[None, :]
                <= q_off + torch.arange(Sq, device="cuda")[:, None])
        if not causal or bool(mask.all()):   # every row sees every key
            kw = {}
        elif q_off == 0 and Sq == kv_len:
            kw = {"is_causal": True}
        else:
            kw = {"attn_mask": mask}

        def lib():
            return sdpa(qc, kc, vc, **kw)
        lib_err = float((lib().float() - plain().float()).abs().max())
        check(lib_err < 5e-2, f"SDPA yardstick disagrees at {name}: {lib_err}")
        b_ms, b_by = bound(B, H, H, Sq, D, causal, kv_len, q_off, 2,
                           BF16_FLOPS)
        row = {"shape": name, "B": B, "H": H, "Sq": Sq, "Sk": Sk,
               "kv_len": kv_len, "q_offset": q_off, "D": D, "dtype": "bfloat16",
               "ms": device_ms(torch, kern),
               "plain_ms": device_ms(torch, plain),
               "library_ms": device_ms(torch, lib),
               "host_ms": host_ms(torch, kern),
               "plain_host_ms": host_ms(torch, plain),
               "library_host_ms": host_ms(torch, lib),
               "bound_ms": b_ms, "bound_by": b_by}
        print(f"  {name:14s} device: kernel {row['ms']:9.4f} ms  plain "
              f"{row['plain_ms']:9.4f} ms  sdpa {row['library_ms']:9.4f} ms  "
              f"bound {b_ms:9.4f} ms ({b_by}); host per call: kernel "
              f"{row['host_ms']:9.4f} ms  plain {row['plain_host_ms']:9.4f} ms"
              f"  sdpa {row['library_host_ms']:9.4f} ms", flush=True)
        rows.append(row)
        del q, k, v, qs, ks, vs, qc, kc, vc
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_ref, kernel, mha
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = get_config("stablelm-1.6b")
    H, D = cfg.n_heads, cfg.resolved_head_dim()
    n_requests, max_new = 8, 12
    batch_shapes = [
        (len(b), max(len(r.prompt) for r in b), max(r.max_new for r in b))
        for b in serve.batched(serve.make_requests(cfg.vocab, n_requests,
                                                   max_new))]

    t_start = time.time()
    print("== phase 1: card", flush=True)
    smi = nvidia_smi_line()
    print(smi)
    nvcc = _build.nvcc_path()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc_v[-1]}, python {sys.version.split()[0]}", flush=True)

    print("== phase 2: build", flush=True)
    t0 = time.time()
    lib = _build.build(kernel.SOURCE)
    print(f"built {lib.relative_to(ROOT)} in {time.time() - t0:.1f}s")
    print(_build.build_log(kernel.SOURCE).strip(), flush=True)

    print("== phase 3: kernel against its plain version; serve batches "
          f"(B, T, steps) {batch_shapes}", flush=True)
    checks = run_kernel_checks(torch, kernel, mha, attention_ref,
                               kernel_cases(batch_shapes, H, D))

    print("== phase 4: main path, stablelm-1.6b at full width", flush=True)
    torch.cuda.reset_peak_memory_stats()
    kernel.LAUNCHES = 0
    summary = serve.main(["--arch", "stablelm-1.6b", "--requests",
                          str(n_requests), "--max-new", str(max_new)])
    launches = kernel.LAUNCHES
    loop = summary.pop("loop")
    forwards = summary["prefills"] + summary["decode_steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  requests {summary['requests']}, tokens {summary['tokens']}, "
          f"wall {summary['seconds']:.3f} s, median decode step "
          f"{summary['median_step_ms']:.3f} ms, peak memory {peak_gb:.2f} GB, "
          f"kernel launches {launches} = {cfg.n_layers} x {forwards} forwards",
          flush=True)
    check(summary["requests"] == n_requests
          and summary["tokens"] == n_requests * max_new,
          f"served {summary['requests']} requests, {summary['tokens']} tokens")
    for r in summary["done"]:
        check(len(r.out) == max_new and all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid}: tokens {r.out}")
    check(launches > 0 and launches == cfg.n_layers * forwards,
          f"kernel launched {launches} times on the main path, expected "
          f"{cfg.n_layers} x {forwards}")
    check(loop.batch_shapes == batch_shapes,
          f"served batches {loop.batch_shapes}, checked {batch_shapes}")

    print("== phase 5: profile of decode steps (torch.profiler)", flush=True)
    profile = profile_decode(torch, loop, kernel, *batch_shapes[0][:2])

    print("== phase 6: model on the card against the model on the CPU",
          flush=True)
    small = smoke_config("stablelm-1.6b").with_(
        d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
        vocab=512)
    small_params = build_model(small).init(0, device="cpu")
    f32 = cfg.with_(dtype=torch.float32)
    model_errs = {
        "small float32": model_reference_check(
            torch, build_model, small.with_(dtype=torch.float32),
            small_params, 2, 9, 3, 1e-4, "small float32"),
        "small bfloat16": model_reference_check(
            torch, build_model, small, small_params, 2, 9, 3, 3e-2,
            "small bfloat16"),
        "full width 2 layers float32": model_reference_check(
            torch, build_model, f32.with_(n_layers=2),
            first_layers(loop.params, 2), 2, 6, 2, 1e-4,
            "full width 2 layers float32"),
        "full width 24 layers float32, unit score scale": model_reference_check(
            torch, build_model, f32, unit_score_scale(loop.params, cfg), 2, 6,
            2, 1e-4, "full width 24 layers float32, unit score scale",
            cache_dtype=torch.float32),
    }
    del loop, summary["done"]
    torch.cuda.empty_cache()

    print("== phase 7: kernel timing (bf16, D 64; device time from CUDA "
          "graph replays, host time from back-to-back calls)", flush=True)
    rows = run_timings(torch, mha, attention_ref,
                       torch.nn.functional.scaled_dot_product_attention,
                       batch_shapes[0], H, D)

    serve_errs = [c["max_abs_err"] for c in checks
                  if c["serve"] and c["dtype"] == "bfloat16"]
    main_row = next(r for r in rows if r["shape"] == "serve decode")
    entry = {"name": "flash_attention_fwd", "route": "cuda",
             "source": KERNEL_SOURCE, "replaces": REPLACES,
             "replaces_function": "_flash_fwd_kernel",
             "launches": launches, "max_abs_err": max(serve_errs),
             "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
             "bound_ms": main_row["bound_ms"],
             "bound_by": main_row["bound_by"],
             "library_ms": main_row["library_ms"],
             "host_ms": main_row["host_ms"],
             "timed_shape": "serve decode", "shapes": rows}
    report = {"kernels": [entry], "checks": checks, "serve": summary,
              "batch_shapes": batch_shapes, "peak_memory_gb": peak_gb,
              "decode_profile": profile, "model_rel_err": model_errs,
              "card": smi, "seconds": time.time() - t_start}
    out_dir = ROOT / "build" / "reports"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
