#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

It drives both of the port's serving paths, stablelm-1.6b (every attention
through the flash-attention kernel) and mamba2-1.3b (every prefill of every
layer through the SSD-scan kernel), and Lotaru's estimator path, online
loop, multi-workflow fleet and accelerator-plane estimator.  Phases,
in order; any failure ends the run with a non-zero exit code:

1. the card's name and power limit (nvidia-smi), torch, CUDA and nvcc
   versions;
2. the build of both kernels from ``src/`` into ``build/kernels/``, one
   nvcc per source, started together, with nvcc's ``-Xptxas -v`` reports;
3. the flash kernel against its plain PyTorch version on the card, case
   by case (float32 at 2e-5, bfloat16 at 2e-2, as tests/test_kernels.py),
   through each of its three paths (the tensor-core prefill, the split
   decode, the float32 kernel) and their edges, with every attention call
   of the stablelm path: its batches are formed by ``serve.make_requests``
   and ``serve.batched``, as ``serve.main`` forms them;
3b. the SSD kernel against its plain version ``ssd_chunked``, y and final
   state, in float32 (the CUDA-core path) and with bfloat16 x/B/C (the
   chunked tensor-core path), at 1e-5 of the reference's max (see
   ``SSD_TOL``): the shapes of tests/test_kernels.py, initial states (one
   over 8 chunks at full width), every prefill batch of the mamba2 path
   and a 4k prefill; each case prints the path it took, and its call,
   captured into a CUDA graph, must launch that path's kernels
   (``plan(...).kernels``) once each, as the driver records them;
4. the stablelm path: ``repro_torch.launch.serve.main`` serving 8 requests
   of 12 new tokens with stablelm-1.6b at full width (random weights from a
   seed); the flash kernel's launch count must be 24 x (prefills + decode
   steps) and the batches served must be those phase 3 checked;
5. a profile (``torch.profiler``) of decode steps at the stablelm path's
   first batch: wall and device-busy time per step, kernels per step, the
   top kernels and operators;
6. the stablelm model on the card against the same model on the CPU, where
   attention takes the plain version: a reduced config, the full-width
   weights cut to 2 layers, and all 24 layers with the attention weights
   scaled to unit score variance (see ``unit_score_scale``);
7. the flash kernel's device time beside its plain version's, SDPA's (a
   yardstick the port never calls) and its bound, at the serve shapes, a
   4k prefill and a 32k decode: CUDA events around replays of a CUDA graph
   of back-to-back calls, so the host's overhead does not count; the time
   per call with that overhead (``host_ms``) is reported beside it.  At
   each shape the kernel is first held against its plain version (bf16
   bar), and the launcher's path (and split count) is recorded;
4b. the mamba2 path: ``serve.main`` serving 8 requests of 12 new tokens
   with mamba2-1.3b at full width; the SSD kernel's launch count must be
   48 x prefills, the flash kernel's 0, and the batches served those
   phase 3b checked;
5b. a profile of one mamba2 prefill and of decode steps;
6b. the mamba2 model on the card against the CPU: the smoke config, the
   full-width weights cut to 2 layers and all 48 layers; and a prefill of
   129 tokens against a prefill of 128 and one decode step, on the card
   and, without the kernel, on the CPU;
7b. the SSD kernel's device and host time beside its plain version's and
   its bound, at the serve prefill and a 4k prefill; at each shape the
   kernel is first held against its plain version (``SSD_TOL``), its path
   and its device launches per call, as the driver records them, are
   recorded and held to the plan, and torch.profiler splits its device
   time by kernel.

8. the estimator path, which has no kernel (float64 tensor code on the
   card, HEFT on the host), held to the same calls on the CPU at 1e-12
   (``rel_err``) and HEFT's makespans at 1e-9: the first and the warm
   ``inv_ex`` calls; 8a ``profile_local`` on the card (fp32 matmul
   GFLOP/s and stream GB/s); 8b the paper path (every workflow fitted
   from ``ClusterSimulator(seed=0)``'s local runs, its matrix, the gates
   and ``w``, and HEFT of the chipseq chain, 6 samples on 10 nodes); 8c
   the scale of benchmarks/bench_predict.py (1,000 tasks x 64 nodes,
   ``fit_task_batch``, the full matrix, a 4,096-observation update
   stream and ``observe_batch``, the dirty-row matrix, the scalar
   ``predict``, HEFT over ``synthetic_dag(100, 140)``), each call's host
   ms, CUDA-event ms and profiler-busy ms on the card beside its CPU ms,
   and the peak device memory;
9. the online loop, which has no kernel either (``core/tick.py``'s fused
   tick, ``online/executor.py``): 9a the five paper workflows through
   ``OnlineExecutor`` at the reference tests' sizes (2 samples, 2 nodes
   per type), on the card and on the CPU, fused and legacy, faults off
   and on — the same assignments and counters, times within 1e-12, and
   fused equal to legacy; 9b one online tick at 8c's scale through
   ``TickEngine.observe_batch``, eager and replayed from a CUDA graph (bit
   for bit equal, and equal across two eager runs), beside the legacy
   tick (``observe_batch`` + the dirty-row ``predict_matrix``) and the
   same tick on the CPU (1e-12), then the HEFT re-plan over the
   10,610-task DAG; host ms, CUDA-event ms, the ``tick_step`` span,
   device-busy ms and launches;
10. the multi-workflow fleet and ``LotaruML``, no kernel either: 10a
   ``online/fleet.py``'s ``fleet_tick_step`` at bench_online's fleet
   sweep (W 4, 16, 64 at T 128 x N 16, 64 observations a workflow a
   tick) and at W 4 x T 1,000 x N 64 (1,024 a workflow), 4 ticks of fresh
   rows: every workflow held to its own ``tick_step`` on the card and to
   the fleet on the CPU (1e-12), the (1, 1) mesh's fleet equal bit for
   bit, a tick's launches at W 64 within 1.5x of W 4; host, CUDA-event
   and busy ms, launches and cells per second beside the W per-workflow
   ``tick_step`` calls and the CPU; 10b ``LotaruML`` at 1,000 cells x 64
   target nodes: the full matrix, the scalar-factor matrix, a
   4,096-observation ``observe_batch`` (two copies back) and the
   dirty-row matrix against the CPU (1e-12) and the matrix against the
   scalar ``predict``, with their times.

The last lines are a ``kernels`` JSON object, the card's nvidia-smi line
and ``{"ok": true, "device": {...}}``; the full report goes to
``build/reports/chip_smoke.json``.
"""
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:29"
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd_fwd.cu"
SSD_KERNEL_NAME = r"(ssd_\w+)(?![\w:])"   # a kernel of ssd_fwd.cu, by name
SSD_REPLACES = "src/repro/kernels/ssd/kernel.py:27"

BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
HBM_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth, bytes/s
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: SSD: 1e-5 of the reference's max |y| (and of its max |state|), as
#: tests/test_kernels.py, in bfloat16 too: both sides upcast the same bf16
#: values of x, B and C, so only the order of the fp32 sums differs.
SSD_TOL = 1e-5


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
    cases.append(("kv_len=50 decode", 1, 2, 2, 1, 128, 32, False, 50, 0,
                  "bhsd"))
    cases.append(("decode q_offset=39", 2, 4, 2, 1, 64, 64, True, 40, 39,
                  "bhsd"))
    cases.append(("chunk q_offset=20", 2, 4, 2, 5, 64, 64, True, 25, 20,
                  "bhsd"))
    for D in (32, 64, 128):               # every head dim x row tiling
        for Sq in (1, 33):
            cases.append((f"instances D{D} Sq{Sq}", 2, 4, 2, Sq, 70, D, True,
                          70, 70 - Sq, "bhsd"))
    # the edges of the tensor-core prefill and of the split decode
    for name, B, Hq, Hkv, Sq, Sk, D, causal, kv_len, q_off in [
            ("prefill Sq15", 2, 4, 4, 15, 27, 64, True, 15, 0),
            ("prefill Sq33", 1, 2, 2, 33, 33, 64, True, None, 0),
            ("prefill Sq100", 1, 2, 1, 100, 100, 64, True, None, 0),
            ("prefill Sk150 kv_len=130 bidir", 1, 2, 2, 100, 150, 64, False,
             130, 0),
            ("chunk q_offset=111 Sk200", 2, 4, 4, 70, 200, 64, True, 181, 111),
            ("chunk D32 GQA q_offset=100", 2, 8, 2, 48, 160, 32, True, 148,
             100),
            ("chunk D128 MQA q_offset=200", 1, 8, 1, 40, 256, 128, True, 240,
             200),
            ("chunk D128 q_offset=160", 1, 4, 2, 130, 300, 128, True, 290,
             160),
            ("decode kv_len=1", 2, 4, 2, 1, 64, 64, True, 1, 0),
            ("decode empty splits q_offset=300", 1, 2, 2, 1, 4096, 64, True,
             4096, 300),
            ("decode Sk4096 splits", 1, 2, 2, 1, 4096, 64, True, 4096, 4095),
            ("decode MQA D128 splits", 2, 8, 1, 1, 4096, 128, True, 3000,
             2999),
            ("decode GQA8 D32 bidir", 1, 16, 2, 1, 1000, 32, False, None, 0),
            ("decode GQA12 two head chunks", 1, 24, 2, 1, 500, 64, True, 500,
             499)]:
        cases.append((name, B, Hq, Hkv, Sq, Sk, D, causal, kv_len, q_off,
                      "bhsd"))
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
            if name.startswith("kv_len=50"):  # keys past kv_len must not matter
                k2 = k.clone()
                k2[:, :, kv_len:] = 1e3
                out2 = kernel.flash_attention(q, k2, v, causal=causal,
                                              kv_len=kv_len, q_offset=q_off)
                ok = ok and bool(torch.equal(out2, out))
            path, splits = kernel.plan(
                dtype, B, Hq, Hkv, Sq, Sk if kv_len is None else kv_len,
                kernel.sm_count(q.device.index))
            print(f"  {name:34s} {dname:9s} {path:12s} splits {splits:3d} "
                  f"max_abs_err {err:.3e} tol {tol:g} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"kernel disagrees with its plain version: {name} "
                      f"{dname}, max_abs_err {err}")
            results.append({"case": name, "dtype": dname, "max_abs_err": err,
                            "path": path, "splits": splits,
                            "serve": layout == "cache"})
    return results


# ---------------------------------------------------------------------------
# Phase 3b: the SSD kernel against its plain version
# ---------------------------------------------------------------------------
def ssd_cases(batch_shapes, cfg):
    """(name, B, T, H, P, G, N, chunk, layout, state0)."""
    s = cfg.ssm
    H, P, G, N = (s.n_ssm_heads(cfg.d_model), s.head_dim, s.n_groups,
                  s.d_state)
    cases = [(f"oracle B{B} T{T} H{Hh} P{Pp} G{Gg} N{Nn} chunk {c}",
              B, T, Hh, Pp, Gg, Nn, c, "bthp", None)
             for B, T, Hh, Pp, Gg, Nn, c in [      # tests/test_kernels.py
                 (1, 32, 2, 8, 1, 8, 8),
                 (2, 64, 4, 16, 2, 16, 16),
                 (1, 50, 4, 8, 1, 8, 16)]]          # unaligned T
    cases.append(("state0 B2 T50 H4 P16 G2 N16 chunk 16", 2, 50, 4, 16, 2,
                  16, 16, "bthp", "random"))
    cases.append(("state0 full width B2 T129", 2, 129, H, P, G, N, s.chunk,
                  "conv", "random"))           # two chunks, the second of 1
    cases.append(("state0 full width B1 T1000", 1, 1000, H, P, G, N, s.chunk,
                  "conv", "random"))           # 8 chunks, ragged
    # the main path's prefills: views of the conv output, zero state0
    for B, T, _ in batch_shapes:
        cases.append((f"serve prefill B{B} T{T}", B, T, H, P, G, N, s.chunk,
                      "conv", "zeros"))
    cases.append(("prefill 4k B1 T4096", 1, 4096, H, P, G, N, s.chunk,
                  "conv", "zeros"))             # 32 chunks: the carry
    return cases


def ssd_inputs(torch, B, T, H, P, G, N, dtype, layout, state0, seed):
    """x, dt, a, B_, C_, state0 on the card, drawn as tests/test_kernels.py
    draws them.  Layout "conv": x, B_ and C_ are strided views of one
    (B, T, H*P + 2*G*N) tensor, as the model passes its conv output."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    if layout == "conv":
        conv = rnd(B, T, H * P + 2 * G * N).to(dtype)
        x = conv[..., :H * P].unflatten(-1, (H, P))
        B_ = conv[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        C_ = conv[..., H * P + G * N:].unflatten(-1, (G, N))
    else:
        x = rnd(B, T, H, P).to(dtype)
        B_, C_ = rnd(B, T, G, N).to(dtype), rnd(B, T, G, N).to(dtype)
    dt = (0.05 + 0.02 * rnd(B, T, H)).abs()
    a = -(1.0 + 0.3 * rnd(H)).abs()
    if state0 == "random":
        s0 = rnd(B, H, P, N)
    elif state0 == "zeros":
        s0 = torch.zeros(B, H, P, N, device="cuda")
    else:
        s0 = None
    return x, dt, a, B_, C_, s0


def ssd_rel_errs(y, st, ref_y, ref_st):
    """Max |error| of y and of the state, each over the reference's max."""
    return (float((y - ref_y).abs().max() / ref_y.abs().max()),
            float((st - ref_st).abs().max() / ref_st.abs().max()))


def run_ssd_checks(torch, ssd_kernel, ssd, ssd_chunked, launched_kernels,
                   cases):
    results = []
    for i, (name, B, T, H, P, G, N, chunk, layout, state0) in \
            enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x, dt, a, B_, C_, s0 = ssd_inputs(torch, B, T, H, P, G, N, dtype,
                                              layout, state0, seed=100 + i)
            # through the model's entry, or the kernel's own
            scan = ssd if layout == "conv" else ssd_kernel.ssd_scan

            def call():
                return scan(x, dt, a, B_, C_, chunk=chunk, state0=s0)
            y, st = call()
            path, pl = ssd_kernel.LAST_PATH, ssd_kernel.plan(dtype, T, chunk)
            check(path == pl.path,
                  f"{name} {dname}: the kernel took the {path} path")
            launched = check_launches(launched_kernels, call, pl,
                                      f"{name} {dname}")
            ref_y, ref_st = ssd_chunked(x, dt, a, B_, C_, chunk, state0=s0)
            torch.cuda.synchronize()
            check(y.dtype == st.dtype == torch.float32
                  and y.shape == ref_y.shape and st.shape == ref_st.shape,
                  f"{name} {dname}: y {y.dtype} {tuple(y.shape)}, state "
                  f"{st.dtype} {tuple(st.shape)}")
            err_y = float((y - ref_y).abs().max())
            err_st = float((st - ref_st).abs().max())
            rel_y, rel_st = ssd_rel_errs(y, st, ref_y, ref_st)
            ok = (bool(torch.isfinite(y).all()) and rel_y <= SSD_TOL
                  and rel_st <= SSD_TOL)
            print(f"  {name:40s} {dname:9s} {path:8s} "
                  f"{len(launched)} launches, y err {rel_y:.3e} "
                  f"state err "
                  f"{rel_st:.3e} x max (tol {SSD_TOL:g}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"SSD kernel disagrees with its plain version: {name} "
                      f"{dname}, y {rel_y:.3e}, state {rel_st:.3e} x max")
            results.append({"case": name, "dtype": dname, "path": path,
                            "launched": launched,
                            "max_abs_err": err_y, "state_max_abs_err": err_st,
                            "rel_err": rel_y, "state_rel_err": rel_st,
                            "serve": name.startswith("serve")})
            del x, dt, a, B_, C_, s0, y, st, ref_y, ref_st
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


def profile_steps(torch, fn, steps, marker, label, launches):
    """``fn(s)`` for s in range(steps) under torch.profiler: wall and
    device-busy time per step (one stream, so device events do not
    overlap), kernels per step, the device time and launches per step of
    the kernels whose name holds ``marker``, the top kernels and
    operators by device time.  ``launches()`` reads the kernel's counter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    launches0 = launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            fn(s)
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
    own_ms = sum(ms for k, ms, _ in kernels if marker in k)
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_busy_ms_per_step": busy_ms,
           "kernels_per_step": sum(n for _, _, n in kernels) / steps,
           f"{label}_ms_per_step": own_ms,
           f"{label}_launches_per_step": (launches() - launches0) / steps,
           "kernels": kernels[:40], "operators": ops[:40]}
    print(f"  wall {out['wall_ms_per_step']:.3f} ms/step, device busy "
          f"{busy_ms:.3f} ms/step "
          f"({100 * busy_ms / out['wall_ms_per_step']:.1f}%) over "
          f"{out['kernels_per_step']:.0f} kernels, {label} kernel "
          f"{own_ms:.4f} ms/step ({100 * own_ms / busy_ms:.1f}% of busy) "
          f"over {out[f'{label}_launches_per_step']:.0f} launches",
          flush=True)
    print("  top kernels (ms/step, calls over all steps):")
    for k, ms, n in kernels[:12]:
        print(f"    {ms:9.4f}  {n:6d}  {k[:100]}")
    print("  top operators by inclusive device time (ms/step):")
    for k, ms, n in ops[:8]:
        print(f"    {ms:9.4f}  {n:6d}  {k}")
    return out


def profile_serve(torch, loop, kernel, marker, label, B, T,
                  steps=PROFILE_STEPS, prefill=False):
    """``steps`` decode steps of the served model, batch ``B`` over a
    prompt of ``T`` tokens, under the profiler; with ``prefill`` the
    prefill itself is profiled first, on its own."""
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, loop.cfg.vocab, (B, T),
                         generator=gen).to(loop.device)
    state = {}

    def run_prefill(_):
        state["caches"] = loop.model.init_caches(B, T + steps,
                                                 device=loop.device)
        logits, state["caches"] = loop.prefill(loop.params, {"tokens": toks},
                                               state["caches"])
        state["tok"] = torch.argmax(logits[:, -1], dim=-1)

    def run_decode(s):
        state["tok"], _, state["caches"] = loop.decode(
            loop.params, {"tokens": state["tok"][:, None]}, state["caches"],
            T + s)

    def launches():
        return kernel.LAUNCHES
    out = {"batch": B, "prompt": T}
    with torch.inference_mode():
        if prefill:
            print(f"  prefill, batch {B}, prompt {T}:", flush=True)
            out["prefill"] = profile_steps(torch, run_prefill, 1, marker,
                                           label, launches)
        else:
            run_prefill(0)
        print(f"  decode, batch {B}, cache {T}+{steps}:", flush=True)
        out["decode"] = profile_steps(torch, run_decode, steps, marker,
                                      label, launches)
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


def run_timings(torch, kernel, mha, attention_ref, sdpa, serve_batch, H,
                D):
    """bf16 at the main path's first batch (its prefill and its last decode
    step), a 4k prefill and a 32k decode.  At each shape the kernel and SDPA
    are first held against the plain version (bf16 bar), and the path the
    launcher takes is recorded."""
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
        ref = plain().float()
        lib_err = float((lib().float() - ref).abs().max())
        check(lib_err < 5e-2, f"SDPA yardstick disagrees at {name}: {lib_err}")
        diff = (kern().transpose(1, 2).float() - ref).abs()
        err, tol = float(diff.max()), TOL["bfloat16"]
        check(bool((diff <= tol + tol * ref.abs()).all()),
              f"kernel disagrees with its plain version at {name}: "
              f"max_abs_err {err}")
        del ref, diff
        path, splits = kernel.plan(dtype, B, H, H, Sq, kv_len,
                                   kernel.sm_count(q.device.index))
        b_ms, b_by = bound(B, H, H, Sq, D, causal, kv_len, q_off, 2,
                           BF16_FLOPS)
        row = {"shape": name, "B": B, "H": H, "Sq": Sq, "Sk": Sk,
               "kv_len": kv_len, "q_offset": q_off, "D": D, "dtype": "bfloat16",
               "path": path, "splits": splits, "max_abs_err": err,
               "ms": device_ms(torch, kern),
               "plain_ms": device_ms(torch, plain),
               "library_ms": device_ms(torch, lib),
               "host_ms": host_ms(torch, kern),
               "plain_host_ms": host_ms(torch, plain),
               "library_host_ms": host_ms(torch, lib),
               "bound_ms": b_ms, "bound_by": b_by}
        print(f"  {name:14s} {path} (splits {splits}), max_abs_err "
              f"{err:.3e} (tol {tol:g})", flush=True)
        print(f"  {name:14s} device: kernel {row['ms']:9.4f} ms  plain "
              f"{row['plain_ms']:9.4f} ms  sdpa {row['library_ms']:9.4f} ms  "
              f"bound {b_ms:9.4f} ms ({b_by}); host per call: kernel "
              f"{row['host_ms']:9.4f} ms  plain {row['plain_host_ms']:9.4f} ms"
              f"  sdpa {row['library_host_ms']:9.4f} ms", flush=True)
        rows.append(row)
        del q, k, v, qs, ks, vs, qc, kc, vc
        torch.cuda.empty_cache()
    return rows


def ssd_bound(B, T, H, P, G, N, chunk, elem):
    """Least time for the SSD scan on these inputs: HBM bytes (x, dt, B_,
    C_ and state0 read once; y and the final state written once) at the
    HBM rate against operations at the bf16 peak, per chunk of L rows:
    scores 2 L^2 N per group, and per head intra 2 L^2 P, inter 2 L N P
    and the state update 2 L N P."""
    L = min(chunk, T)
    flops = 0
    for t0 in range(0, T, L):
        rows = min(L, T - t0)
        flops += B * (G * 2 * rows * rows * N
                      + H * (2 * rows * rows * P + 4 * rows * N * P))
    nbytes = (elem * B * T * (H * P + 2 * G * N) + 4 * B * T * H
              + 4 * B * T * H * P + 2 * 4 * B * H * P * N)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def device_ms_per_launch(torch, fn, pattern, calls=10):
    """Device ms per launch of each kernel whose name matches the regex
    ``pattern`` (its first group names it), from torch.profiler over
    ``calls`` calls of ``fn``: where a call's time goes among its
    launches.  An average over the launches the profile recorded (it can
    miss the first)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, count = {}, {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m and e.count:
            us[m.group(1)] = us.get(m.group(1), 0.0) + _device_us(e, False)
            count[m.group(1)] = count.get(m.group(1), 0) + e.count
    return {k: us[k] / 1e3 / count[k] for k in us}


def check_launches(launched_kernels, fn, pl, what):
    """The kernels one call of ``fn`` launches, as the driver records them
    (``repro_torch.kernels._launches``): each kernel of the plan once,
    and no other."""
    launched = launched_kernels(fn)
    check(sorted(launched) == sorted(pl.kernels),
          f"{what}: the {pl.path} path should launch {list(pl.kernels)} "
          f"once each; the driver recorded {launched}")
    return launched


def run_ssd_timings(torch, ssd_kernel, ssd, ssd_chunked, launched_kernels,
                    cfg, serve_batch):
    """bf16 x/B/C as the model passes them (views of the conv output, zero
    state0), at the main path's first prefill and at a 4k prefill.  At
    each shape the kernel is first held against the plain version
    (``SSD_TOL``), and its path and its device launches per call, as the
    driver records them, are recorded."""
    s = cfg.ssm
    H, P, G, N = (s.n_ssm_heads(cfg.d_model), s.head_dim, s.n_groups,
                  s.d_state)
    rows = []
    for name, B, T in [("serve prefill", serve_batch[0], serve_batch[1]),
                       ("prefill 4k", 1, 4096)]:
        x, dt, a, B_, C_, s0 = ssd_inputs(torch, B, T, H, P, G, N,
                                          torch.bfloat16, "conv", "zeros", 7)

        def kern():
            return ssd(x, dt, a, B_, C_, chunk=s.chunk, state0=s0)

        def plain():
            return ssd_chunked(x, dt, a, B_, C_, s.chunk, state0=s0)
        y, st = kern()
        ref_y, ref_st = plain()
        rel_y, rel_st = ssd_rel_errs(y, st, ref_y, ref_st)
        err = float((y - ref_y).abs().max())
        pl = ssd_kernel.plan(torch.bfloat16, T, s.chunk)
        check(ssd_kernel.LAST_PATH == pl.path and rel_y <= SSD_TOL
              and rel_st <= SSD_TOL,
              f"SSD kernel ({ssd_kernel.LAST_PATH}) disagrees with its plain "
              f"version at {name}: y {rel_y:.3e}, state {rel_st:.3e} x max")
        launched = check_launches(launched_kernels, kern, pl, name)
        per_launch = device_ms_per_launch(torch, kern, SSD_KERNEL_NAME)
        del y, st, ref_y, ref_st
        b_ms, b_by = ssd_bound(B, T, H, P, G, N, s.chunk, 2)
        row = {"shape": name, "B": B, "T": T, "H": H, "P": P, "G": G, "N": N,
               "chunk": s.chunk, "dtype": "bfloat16", "path": pl.path,
               "launches_per_call": len(launched), "launched": launched,
               "max_abs_err": err,
               "rel_err": rel_y, "state_rel_err": rel_st,
               "ms": device_ms(torch, kern),
               "plain_ms": device_ms(torch, plain),
               "library_ms": None,
               "library": "none: no single PyTorch call computes the SSD "
                          "scan",
               "host_ms": host_ms(torch, kern),
               "plain_host_ms": host_ms(torch, plain),
               "bound_ms": b_ms, "bound_by": b_by,
               "kernels_ms": {k: per_launch.get(k) for k in launched}}
        print(f"  {name:14s} B{B} T{T}: {pl.path}, {len(launched)} launches "
              "a call (as the driver records them), "
              f"y err {rel_y:.3e}, state err {rel_st:.3e} x max "
              f"(tol {SSD_TOL:g})", flush=True)
        print(f"  {name:14s} B{B} T{T}: device: kernel {row['ms']:9.4f} ms "
              f" plain {row['plain_ms']:9.4f} ms  bound {b_ms:9.4f} ms "
              f"({b_by}); host per call: kernel {row['host_ms']:9.4f} ms  "
              f"plain {row['plain_host_ms']:9.4f} ms", flush=True)
        print(f"  {name:14s} B{B} T{T}: device ms per launch by kernel "
              "(torch.profiler): " + ", ".join(
                  f"{k} {v:.4f}" if v is not None else f"{k} not recorded"
                  for k, v in row["kernels_ms"].items()), flush=True)
        rows.append(row)
        del x, dt, a, B_, C_, s0
        torch.cuda.empty_cache()
    return rows


def prefill_decode_consistency(torch, build_model, cfg, params, B, T, tol,
                               label, device="cuda"):
    """The last logits of a prefill over T + 1 tokens against a prefill
    over T tokens and one decode step, to ``tol`` x max|logit|.  With
    T = chunk the long prefill ends in a chunk of one token, so on the card
    the kernel's ragged edge and carried state meet the decode recurrence;
    on the CPU (``device="cpu"``) the same check runs without the kernel
    and shows how far fp32 rounding alone moves it."""
    model = build_model(cfg)
    params = to_device(params, device)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (B, T + 1), generator=gen).to(device)
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": toks},
                                model.init_caches(B, T + 1, device=device,
                                                  cache_dtype=cfg.dtype))
        caches = model.init_caches(B, T + 1, device=device,
                                   cache_dtype=cfg.dtype)
        _, caches = model.prefill(params, {"tokens": toks[:, :T]}, caches)
        dec, _ = model.decode(params, {"tokens": toks[:, T:]}, caches, T)
    full, dec = full[:, -1].float(), dec[:, -1].float()
    check(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
          f"{label}: non-finite logits")
    rel = float((full - dec).abs().max() / full.abs().max())
    print(f"  {label}, {device}: prefill {T + 1} against prefill {T} + 1 "
          f"decode step: {rel:.3e} x max|logit| (tol {tol})", flush=True)
    check(rel <= tol, f"{label}, {device}: {rel:.3e} x max|logit| "
                      f"(tol {tol})")
    return rel


def serve_batches(serve, vocab, n_requests, max_new):
    """(B, T, steps) of the batches ``serve.main`` forms for ``vocab``."""
    return [(len(b), max(len(r.prompt) for r in b), max(r.max_new for r in b))
            for b in serve.batched(serve.make_requests(vocab, n_requests,
                                                       max_new))]


def check_served(summary, cfg, n_requests, max_new):
    check(summary["requests"] == n_requests
          and summary["tokens"] == n_requests * max_new,
          f"served {summary['requests']} requests, {summary['tokens']} tokens")
    for r in summary["done"]:
        check(len(r.out) == max_new and all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid}: tokens {r.out}")


# ---------------------------------------------------------------------------
# Phase 8: the estimator path (profile -> fit -> matrix -> updates -> HEFT)
# ---------------------------------------------------------------------------
#: card against CPU on the float64 estimator path (tests/test_tick_engine.py)
EST_TOL = 1e-12
#: HEFT makespans scheduled from the card's and from the CPU's matrices
HEFT_TOL = 1e-9
#: benchmarks/bench_predict.py's scale: tasks, nodes, the predicted size;
#: the observation stream absorbed by observe_batch
EST_TASKS, EST_NODES, EST_SIZE, EST_STREAM = 1000, 64, 128.0, 4096


def rel_err(a, b) -> float:
    """max |a - b| / (1 + |b|) over the entries: at most EST_TOL exactly
    when ``np.allclose(a, b, rtol=EST_TOL, atol=EST_TOL)`` holds, the bar
    of the tests (relative for entries of magnitude >= 1, absolute for the
    near-zero entries of a posterior mean)."""
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    check(a.shape == b.shape, f"shapes {a.shape} and {b.shape} differ")
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b)), initial=0.0))


def timed(torch, fn, device, reps=1):
    """(the last call's result, host ms, device ms), each the median over
    ``reps`` calls: the host clock around the call and a synchronize, and
    on the card CUDA events recorded around the call (the span of the
    device's timeline it covers, idle gaps included; None on the CPU)."""
    walls, devs, out = [], [], None
    for _ in range(reps):
        if device == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            devs.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            walls.append((time.perf_counter() - t0) * 1e3)
    return (out, sorted(walls)[len(walls) // 2],
            sorted(devs)[len(devs) // 2] if devs else None)


def device_busy(torch, fn):
    """One call under torch.profiler: the device-busy ms (the summed device
    time of its kernels and copies), their count and the top entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    ev = sorted(((e.key, _device_us(e, False) / 1e3, e.count) for e in avg
                 if e.device_type != DeviceType.CPU), key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in avg if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    return {"wall_ms_profiled": wall_ms,
            "busy_ms": sum(ms for _, ms, _ in ev),
            "device_launches": sum(n for _, _, n in ev), "top": ev[:8],
            "host_top": host[:10]}


def synthetic_estimator(n_tasks, n_nodes, device, seed=0):
    """benchmarks/bench_predict.py's ``_synthetic_estimator``, built from
    the port: T tasks fitted from seeded samples (70% size-correlated, the
    rest flat) over N synthetic node benches."""
    import numpy as np
    from repro_torch.core import LotaruEstimator, fit_task
    from repro_torch.core.estimator import FittedTask
    from repro_torch.core.profiler import BenchResult
    rng = np.random.default_rng(seed)
    local = BenchResult(node="local-cpu", cpu_events_s=450.0,
                        matmul_gflops=90.0, mem_gbps=18.0,
                        io_read_mbps=420.0, io_write_mbps=400.0,
                        link_gbps=0.0)
    benches = {}
    for j in range(n_nodes):
        nm = f"node{j:03d}"
        benches[nm] = BenchResult(
            node=nm, cpu_events_s=float(rng.uniform(150, 900)),
            matmul_gflops=float(rng.uniform(50, 5000)),
            mem_gbps=float(rng.uniform(10, 900)),
            io_read_mbps=float(rng.uniform(100, 900)),
            io_write_mbps=float(rng.uniform(100, 900)),
            link_gbps=float(rng.uniform(0, 100)))
    est = LotaruEstimator(local, benches, device=device)
    n_part = 8
    for i in range(n_tasks):
        sizes = np.geomspace(1.0, 256.0, n_part) * rng.uniform(0.5, 2.0)
        if rng.random() < 0.7:      # size-correlated task -> BLR
            rts = (rng.uniform(0.1, 5.0) * sizes + rng.uniform(1, 50)
                   + rng.normal(0, 0.05, n_part))
        else:                       # flat -> median fallback
            rts = rng.uniform(20, 200) + rng.normal(0, 0.5, n_part)
        est.tasks[f"task{i:04d}"] = FittedTask(
            model=fit_task(sizes, rts, device=device),
            w=float(rng.uniform(0, 1)), sizes=sizes, runtimes=np.abs(rts))
    return est


def paper_path(device):
    """The quickstart path with the port on ``device``: every workflow
    fitted from the simulator's local runs (seed 0), then its (task x
    target node) matrix."""
    import numpy as np
    from repro_torch.core import (LotaruEstimator, get_node, profile_cluster,
                                  profile_node, target_nodes)
    from repro_torch.sched.simulator import ClusterSimulator
    from repro_torch.sched.workflows import INPUTS, WORKFLOWS
    sim = ClusterSimulator(seed=0)
    local = get_node("local-cpu")
    local_bench = profile_node(local, np.random.default_rng(7))
    tbenches = profile_cluster(target_nodes(), seed=13)
    nodes = [nt.name for nt in target_nodes()]
    out = {}
    for wf, tasks in WORKFLOWS.items():
        by = {t.name: t for t in tasks}
        size = INPUTS[(wf, 1)]
        est = LotaruEstimator(local_bench, tbenches, device=device)
        est.fit_tasks(list(by), size,
                      lambda n, s, cf: sim.run_task(by[n], local, s,
                                                    cpu_factor=cf))
        mean, std = est.predict_matrix(nodes, size)
        out[wf] = {"est": est, "nodes": nodes, "mean": mean, "std": std,
                   "gates": [est.tasks[n].model.correlated
                             for n in est.task_names()],
                   "w": [est.tasks[n].w for n in est.task_names()]}
    return out


def chain_schedule(run, n_samples=6):
    """heterogeneous_schedule.py's plan: the chipseq chain over
    ``n_samples`` inputs on 2 nodes of each type, risk_k 1.0, its costs
    read from the (task x node type) matrix."""
    from repro_torch.core import target_nodes
    from repro_torch.sched.heft import SchedTask, heft_schedule
    est, mean, std = run["est"], run["mean"], run["std"]
    row = {n: i for i, n in enumerate(est.task_names())}
    col = {n: j for j, n in enumerate(run["nodes"])}
    hnodes = [f"{nt.name}/{i}" for nt in target_nodes() for i in range(2)]
    ntype = {n: n.rsplit("/", 1)[0] for n in hnodes}
    tasks, cost, unc = {}, {}, {}
    for s in range(n_samples):
        prev = None
        for name in est.task_names():
            tid = f"s{s}.{name}"
            tasks[tid] = SchedTask(id=tid)
            if prev:
                tasks[tid].pred.append(prev)
                tasks[prev].succ.append(tid)
            prev = tid
            cost[tid] = {n: float(mean[row[name], col[ntype[n]]])
                         for n in hnodes}
            unc[tid] = {n: float(std[row[name], col[ntype[n]]])
                        for n in hnodes}
    return heft_schedule(tasks, cost, hnodes, uncertainty=unc, risk_k=1.0)


def estimator_at_scale(torch, device):
    """Phase 8c on ``device``: the T x N synthetic estimator's batched fit,
    full matrix, update stream, observe_batch, dirty-row matrix, scalar
    predict, and HEFT over a ~10k-task DAG from its matrix."""
    import numpy as np
    from repro_torch.core import blr
    from repro_torch.data.synthetic import synthetic_dag
    from repro_torch.sched.heft import heft_schedule_array
    T, N, S, size = EST_TASKS, EST_NODES, EST_STREAM, EST_SIZE
    t = {}
    est, t["build_ms"], _ = timed(
        torch, lambda: synthetic_estimator(T, N, device), device)
    nodes, names = list(est.target_benches), est.task_names()
    fts = [est.tasks[n] for n in names]

    def fit():
        return blr.fit_task_batch([ft.sizes for ft in fts],
                                  [ft.runtimes for ft in fts], device=device)

    def full():
        est._mat_cache = None
        return est.predict_matrix(nodes, size)

    model, t["fit_ms"], t["fit_device_ms"] = timed(torch, fit, device, 5)
    est.predict_matrix(nodes, size)          # primes the batch cache
    (mean, std), t["matrix_ms"], t["matrix_device_ms"] = timed(
        torch, full, device, 5)
    _, base, _ = est._batched()
    rng = np.random.default_rng(1)
    ti = rng.integers(0, T, S)
    ni = rng.integers(0, N, S)
    xs = rng.uniform(1.0, 256.0, S)
    rs = rng.uniform(5.0, 2000.0, S)

    def stream():       # on a copy of the log: the estimator's stays as is
        st = base.stats
        return blr.update_task_batch_stream(
            blr.BatchedTaskModel(base.correlated, base.post, base.median,
                                 base.spread,
                                 blr.OnlineStats(st.moments, st.log.copy())),
            ti, xs, rs)

    upd, t["stream_ms"], t["stream_device_ms"] = timed(torch, stream,
                                                       device, 3)
    obs = [(names[i], nodes[j], float(x), float(r))
           for i, j, x, r in zip(ti, ni, xs, rs)]
    ys, t["observe_ms"], t["observe_device_ms"] = timed(
        torch, lambda: est.observe_batch(obs), device)
    dirty = sorted(est._dirty_rows)
    (dmean, dstd), t["dirty_matrix_ms"], t["dirty_matrix_device_ms"] = \
        timed(torch, lambda: est.predict_matrix(nodes, size), device)
    calls = 100
    _, scalar_ms, _ = timed(torch, lambda: [
        est.predict(names[k], nodes[k % N], size) for k in range(calls)],
        device)
    t["scalar_predict_ms_per_call"] = scalar_ms / calls
    dag = synthetic_dag(width=100, depth=140, fanout=2.0, seed=0)
    cost = dmean[np.arange(dag.n_tasks) % T]
    sched, t["heft_ms"], _ = timed(
        torch, lambda: heft_schedule_array(dag.succ, dag.pred, cost), "cpu")
    prof = {}
    if device == "cuda":
        prof = {"fit": device_busy(torch, fit),
                "matrix": device_busy(torch, full),
                "stream": device_busy(torch, stream)}
        est._dirty_rows = set(dirty)         # the same rows, recomputed
        prof["dirty_matrix"] = device_busy(
            torch, lambda: est.predict_matrix(nodes, size))
    t["per_observation_ms"] = t["stream_ms"] / S
    return {"times": t, "profile": prof, "model": model, "mean": mean,
            "std": std, "upd": upd, "ys": ys, "dirty_rows": len(dirty),
            "dmean": dmean, "dstd": dstd, "sched": sched,
            "dag": (dag.n_tasks, dag.n_edges)}


def run_estimator_phase(torch, smi):
    """Phase 8: the port's estimator path on the card, held to the same
    path on the CPU (float64, EST_TOL) and timed beside it."""
    import numpy as np
    from repro_torch.core import blr, profile_local
    report = {}

    print("  the first inv_ex call of the process, then warm ones "
          f"({EST_TASKS} 2x2 float64 matrices)", flush=True)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(EST_TASKS, 2, 2))
    a = a @ a.transpose(0, 2, 1) + np.eye(2)
    ac = torch.tensor(a, device="cuda")
    inv, first_ms, first_dev = timed(
        torch, lambda: torch.linalg.inv_ex(ac).inverse, "cuda")
    _, warm_ms, warm_dev = timed(
        torch, lambda: torch.linalg.inv_ex(ac).inverse, "cuda", 21)
    err = rel_err(inv.cpu(), torch.linalg.inv_ex(torch.tensor(a)).inverse)
    print(f"  first {first_ms:.3f} ms host / {first_dev:.3f} ms device, "
          f"warm {warm_ms:.4f} / {warm_dev:.4f} ms; against the CPU "
          f"{err:.3e}", flush=True)
    check(err <= EST_TOL, f"inv_ex on the card against the CPU: {err:.3e}")
    report["inv_ex"] = {"first_ms": first_ms, "first_device_ms": first_dev,
                        "warm_ms": warm_ms, "warm_device_ms": warm_dev,
                        "rel_err": err}

    print("== phase 8a: profile_local on the card (fp32, TF32 off)",
          flush=True)
    bench = profile_local(device="cuda", fast=False)
    for k in ("matmul_gflops", "mem_gbps"):
        v = getattr(bench, k)
        check(np.isfinite(v) and v > 0, f"profile_local {k} = {v}")
    print(f"  {smi}: matmul {bench.matmul_gflops:.1f} GFLOP/s "
          f"(512 x 512 fp32, 8 chained products), memory "
          f"{bench.mem_gbps:.1f} GB/s (256 MB stream, 8 passes)",
          flush=True)
    report["profile_local"] = bench.to_dict()

    print("== phase 8b: the paper path, five workflows x 6 node types, on "
          "the card and on the CPU", flush=True)
    card, first_ms, _ = timed(torch, lambda: paper_path("cuda"), "cuda")
    card, card_ms, _ = timed(torch, lambda: paper_path("cuda"), "cuda")
    host, host_ms_, _ = timed(torch, lambda: paper_path("cpu"), "cpu")
    paper = {"card_first_ms": first_ms, "card_ms": card_ms,
             "cpu_ms": host_ms_, "workflows": {}}
    for wf in card:
        c, h = card[wf], host[wf]
        e_mean, e_std = rel_err(c["mean"], h["mean"]), rel_err(c["std"],
                                                              h["std"])
        print(f"  {wf}: {len(c['gates'])} tasks, {sum(c['gates'])} on the "
              f"BLR branch; matrix card vs CPU {e_mean:.3e} / {e_std:.3e}",
              flush=True)
        check(e_mean <= EST_TOL and e_std <= EST_TOL,
              f"{wf}: card against CPU {e_mean:.3e} / {e_std:.3e}")
        check(c["gates"] == h["gates"], f"{wf}: Pearson gates differ")
        check(c["w"] == h["w"], f"{wf}: w differs")
        paper["workflows"][wf] = {"tasks": len(c["gates"]),
                                  "blr_tasks": sum(c["gates"]),
                                  "rel_err_mean": e_mean,
                                  "rel_err_std": e_std}
    sc, sh = chain_schedule(card["chipseq"]), chain_schedule(host["chipseq"])
    e_span = abs(sc["makespan"] - sh["makespan"]) / sh["makespan"]
    same = np.mean([sc["assignment"][k] == sh["assignment"][k]
                    for k in sh["assignment"]])
    print(f"  HEFT chipseq x 6 samples on 10 nodes, risk_k 1.0: makespan "
          f"{sc['makespan']:.3f} s (card) vs {sh['makespan']:.3f} s (CPU), "
          f"{e_span:.3e} apart; equal assignments {100 * same:.1f}%; "
          f"paper path {card_ms:.1f} ms on the card (its first run "
          f"{first_ms:.1f}), {host_ms_:.1f} ms on the CPU", flush=True)
    check(e_span <= HEFT_TOL, f"HEFT makespans {e_span:.3e} apart")
    paper["heft"] = {"makespan_card": sc["makespan"],
                     "makespan_cpu": sh["makespan"], "rel_err": e_span,
                     "equal_assignments": float(same)}
    report["paper"] = paper

    print(f"== phase 8c: {EST_TASKS} tasks x {EST_NODES} nodes, a "
          f"{EST_STREAM}-observation stream, HEFT over synthetic_dag(100, "
          "140) (card against CPU)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    held_mb = torch.cuda.memory_allocated() / 1e6
    g = estimator_at_scale(torch, "cuda")
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    c = estimator_at_scale(torch, "cpu")
    errs = {}
    for f in blr.POSTERIOR_FIELDS:
        errs[f"fit_{f}"] = rel_err(blr._np(getattr(g["model"].post, f)),
                                   blr._np(getattr(c["model"].post, f)))
        errs[f"stream_{f}"] = rel_err(blr._np(getattr(g["upd"].post, f)),
                                      blr._np(getattr(c["upd"].post, f)))
    errs["stream_moments"] = rel_err(blr._np(g["upd"].stats.moments),
                                     blr._np(c["upd"].stats.moments))
    errs["matrix_mean"] = rel_err(g["mean"], c["mean"])
    errs["matrix_std"] = rel_err(g["std"], c["std"])
    errs["observe_ys"] = rel_err(g["ys"], c["ys"])
    errs["dirty_mean"] = rel_err(g["dmean"], c["dmean"])
    errs["dirty_std"] = rel_err(g["dstd"], c["dstd"])
    abs_errs = {}
    for f in blr.POSTERIOR_FIELDS:
        abs_errs[f"fit_{f}"] = float(np.max(np.abs(
            blr._np(getattr(g["model"].post, f))
            - blr._np(getattr(c["model"].post, f)))))
        abs_errs[f"stream_{f}"] = float(np.max(np.abs(
            blr._np(getattr(g["upd"].post, f))
            - blr._np(getattr(c["upd"].post, f)))))
    worst = max(errs, key=errs.get)
    print(f"  card against CPU: worst {worst} {errs[worst]:.3e} (bar "
          f"{EST_TOL:g}, |a - b| / (1 + |b|)); posteriors' max |a - b| "
          f"{max(abs_errs.values()):.3e}; gates after the stream equal: "
          f"{torch.equal(g['upd'].correlated.cpu(), c['upd'].correlated)}",
          flush=True)
    check(errs[worst] <= EST_TOL, f"8c card against CPU: {worst} "
          f"{errs[worst]:.3e}")
    check(torch.equal(g["model"].correlated.cpu(), c["model"].correlated)
          and torch.equal(g["upd"].correlated.cpu(), c["upd"].correlated),
          "8c: Pearson gates differ between the card and the CPU")
    gs, cs = g["sched"], c["sched"]
    e_span = abs(gs["makespan"] - cs["makespan"]) / cs["makespan"]
    same = float(np.mean(gs["assignment"] == cs["assignment"]))
    check(e_span <= HEFT_TOL, f"8c HEFT makespans {e_span:.3e} apart")
    print(f"  HEFT over {g['dag'][0]} tasks / {g['dag'][1]} edges on "
          f"{EST_NODES} nodes: makespan {gs['makespan']:.3f} (card's "
          f"matrix) vs {cs['makespan']:.3f} (CPU's), {e_span:.3e} apart, "
          f"equal assignments {100 * same:.1f}%", flush=True)
    print(f"  {'call':34s} {'card host ms':>13s} {'card events ms':>15s} "
          f"{'card busy ms':>13s} {'launches':>9s} {'CPU ms':>10s}")
    rows = (("fit_task_batch (T 1000)", "fit", "fit"),
            ("predict_matrix, full", "matrix", "matrix"),
            (f"update stream ({EST_STREAM} obs)", "stream", "stream"),
            (f"observe_batch ({EST_STREAM} obs)", "observe", None),
            (f"predict_matrix, {g['dirty_rows']} dirty rows",
             "dirty_matrix", "dirty_matrix"),
            ("heft_schedule_array (host)", "heft", None))
    for label, key, pk in rows:
        p = g["profile"].get(pk, {}) if pk else {}
        dev = g["times"].get(f"{key}_device_ms")
        print(f"  {label:34s} {g['times'][f'{key}_ms']:13.3f} "
              f"{dev if dev is not None else float('nan'):15.3f} "
              f"{p.get('busy_ms', float('nan')):13.3f} "
              f"{p.get('device_launches', 0):9d} "
              f"{c['times'][f'{key}_ms']:10.3f}", flush=True)
    for pk in ("matrix", "stream"):
        print(f"  host ops of {pk} by self time (ms, calls): " + ", ".join(
            f"{k} {ms:.2f} x{n}" for k, ms, n in
            g["profile"][pk]["host_top"][:6]), flush=True)
    launches_per_obs = g["profile"]["stream"]["device_launches"] / EST_STREAM
    print(f"  update: {g['times']['per_observation_ms'] * 1e3:.2f} us per "
          f"observation on the card ({launches_per_obs:.2f} device launches "
          f"each, by the profiler), {c['times']['per_observation_ms'] * 1e3:.2f}"
          f" us on the CPU; scalar predict "
          f"{g['times']['scalar_predict_ms_per_call']:.4f} ms per call "
          f"(card) / {c['times']['scalar_predict_ms_per_call']:.4f} (CPU); "
          f"peak device memory {peak_mb:.1f} MB ({held_mb:.1f} MB held "
          "before 8c)", flush=True)
    report["scale"] = {
        "tasks": EST_TASKS, "nodes": EST_NODES, "stream": EST_STREAM,
        "size": EST_SIZE, "dag": g["dag"], "dirty_rows": g["dirty_rows"],
        "card": g["times"], "cpu": c["times"], "card_profile": g["profile"],
        "launches_per_observation": launches_per_obs,
        "peak_memory_mb": peak_mb, "held_before_mb": held_mb,
        "rel_err": errs,
        "posterior_max_abs_err": abs_errs,
        "heft": {"makespan_card": gs["makespan"],
                 "makespan_cpu": cs["makespan"], "rel_err": e_span,
                 "equal_assignments": same}}
    return report



# ---------------------------------------------------------------------------
# Phase 9: the online loop (fused tick engine, OnlineExecutor)
# ---------------------------------------------------------------------------
#: the reference tests' executor scenario (tests/test_tick_engine.py)
ONLINE_SAMPLES, ONLINE_NODES_PER_TYPE = 2, 2


def online_run(device, wf, fused, with_faults, seed=0):
    """One run of the port's ``OnlineExecutor`` on ``device``: ``wf``
    fanned over ONLINE_SAMPLES inputs on ONLINE_NODES_PER_TYPE nodes of
    each type, risk_k 0.5, spec_tail 0.6, with or without the fault
    injector (p_fail 0.08), the estimator fitted from
    ``ClusterSimulator(seed)`` and the truth from seed + 2000."""
    import numpy as np
    from repro_torch.core import (LotaruEstimator, get_node, profile_cluster,
                                  profile_node, target_nodes)
    from repro_torch.online import OnlineExecutor, fanout_chain_dag
    from repro_torch.sched.simulator import (ClusterSimulator, FaultInjector,
                                             GridEngine)
    from repro_torch.sched.workflows import INPUTS, WORKFLOWS
    local = get_node("local-cpu")
    size = INPUTS[(wf, 1)]
    by = {t.name: t for t in WORKFLOWS[wf]}
    tasks, task_name = fanout_chain_dag(list(by), ONLINE_SAMPLES)
    truth = ClusterSimulator(seed=seed + 2000)
    tab = {(tid, nt.name): truth.run_task(by[task_name[tid]], nt, size)
           for tid in tasks for nt in target_nodes()}
    sim = ClusterSimulator(seed=seed)
    est = LotaruEstimator(profile_node(local, np.random.default_rng(7)),
                          profile_cluster(target_nodes(), seed=13),
                          bias_empirical_bayes=True, device=device)
    est.fit_tasks(list(by), size, lambda n, s, cf: sim.run_task(
        by[n], local, s, cpu_factor=cf))
    grid = GridEngine.from_types(nodes_per_type=ONLINE_NODES_PER_TYPE)
    faults = FaultInjector(p_fail=0.08, seed=seed + 31) if with_faults \
        else None
    return OnlineExecutor(
        est, tasks, task_name, size, grid,
        lambda tid, node: tab[(tid, grid.type_of(node).name)],
        confidence=0.9, risk_k=0.5, spec_tail=0.6, faults=faults,
        rel_k=1.0 if with_faults else None, max_attempts=6, strict=False,
        fused=fused).run()


def trace_agreement(a, b):
    """(same assignments, same counters, max relative time error) of two
    execution traces: task -> node, the loop's counters, and every
    start/end time and dispatch-time prediction (``rel_err``)."""
    import numpy as np

    def sig(tr):
        recs = sorted((r.id, r.node, r.start, r.end, r.pred_mean, r.pred_std)
                      for r in tr.records)
        return ([r[:2] for r in recs],
                (tr.replans, tr.surprises, tr.completed, tr.failures,
                 tr.retries, tr.speculations, tr.spec_wins, tr.stranded),
                np.array([r[2:] for r in recs] + [[tr.makespan] * 4]))

    sa, sb = sig(a), sig(b)
    same = sa[0] == sb[0]
    return same, sa[1] == sb[1], rel_err(sa[2], sb[2]) if same else None


def online_executors(torch):
    """Phase 9a: the five paper workflows through the port's executor on
    the card and on the CPU, fused and legacy, faults off and on."""
    from repro_torch.sched.workflows import WORKFLOWS
    runs, ms = {}, {}
    for dev in ("cuda", "cpu"):
        for wf in WORKFLOWS:
            for faults in (False, True):
                for fused in (False, True):
                    key = (dev, wf, faults, fused)
                    runs[key], ms[key], _ = timed(
                        torch, lambda: online_run(dev, wf, fused, faults),
                        dev)
    out = []
    print(f"  {'workflow':10s} {'faults':>6s} {'mode':>6s} {'tasks':>5s} "
          f"{'replans':>7s} {'card vs CPU':>12s} {'fused vs legacy':>16s} "
          f"{'card ms':>9s} {'CPU ms':>9s}", flush=True)
    for wf in WORKFLOWS:
        for faults in (False, True):
            for fused in (False, True):
                card = runs[("cuda", wf, faults, fused)]
                cpu = runs[("cpu", wf, faults, fused)]
                same, counters, err = trace_agreement(card, cpu)
                fl = trace_agreement(card, runs[("cuda", wf, faults, False)])
                row = {"workflow": wf, "faults": faults, "fused": fused,
                       "completed": card.completed, "replans": card.replans,
                       "surprises": card.surprises,
                       "failures": card.failures,
                       "same_assignments": same, "same_counters": counters,
                       "rel_err": err, "fused_vs_legacy": list(fl),
                       "card_ms": ms[("cuda", wf, faults, fused)],
                       "cpu_ms": ms[("cpu", wf, faults, fused)]}
                out.append(row)
                print(f"  {wf:10s} {str(faults):>6s} "
                      f"{'fused' if fused else 'legacy':>6s} "
                      f"{card.completed:5d} {card.replans:7d} "
                      f"{'equal' if same and counters else 'DIFFER':>6s} "
                      f"{err if err is not None else float('nan'):.0e} "
                      f"{'equal' if fl[0] and fl[1] else 'DIFFER':>9s} "
                      f"{fl[2] if fl[2] is not None else float('nan'):.0e} "
                      f"{row['card_ms']:9.1f} {row['cpu_ms']:9.1f}",
                      flush=True)
                check(same and counters and err <= EST_TOL,
                      f"9a {wf} faults={faults} fused={fused}: the card's "
                      f"trace differs from the CPU's ({same}, {counters}, "
                      f"{err})")
                check(fl[0] and fl[1] and fl[2] <= EST_TOL,
                      f"9a {wf} faults={faults}: fused differs from legacy "
                      f"on the card ({fl})")
    return out


#: ticks of phase 9b: the first warms up (eager) or captures (graph)
TICKS = 4


def tick_stream(names, nodes, seed):
    """A stream of EST_STREAM observations over random (task, node) pairs
    from numpy seed ``seed``, and its wave counts (moments, bias)."""
    import numpy as np
    from repro_torch.core.tick import pack_waves
    T, N, S = len(names), len(nodes), EST_STREAM
    rng = np.random.default_rng(seed)
    ti, ni = rng.integers(0, T, S), rng.integers(0, N, S)
    xs, rs = rng.uniform(1.0, 256.0, S), rng.uniform(5.0, 2000.0, S)
    obs = [(names[i], nodes[j], float(x), float(r))
           for i, j, x, r in zip(ti, ni, xs, rs)]
    packed = np.column_stack([ti, ni, np.zeros((S, 5)), np.ones(S)])
    _, wm, wb = pack_waves(packed, N)
    return obs, [wm, wb]


def tick_engines(torch, base, streams):
    """Phase 9b's engines: a fresh ``TickEngine`` over a copy of the fitted
    estimator for each of eager on the card, graph on the card, a second
    eager on the card and eager on the CPU.  Tick k feeds every engine
    ``streams[k]`` (a fresh stream a tick, so the wave counts vary as in
    real traffic), the engines taking turns tick by tick so that the
    host's drift hits them alike; each tick's ``observe_batch`` is timed
    (host ms, CUDA-event ms) and its ``tick_step`` span (the tick's
    dispatch and its one copy back) read from an ``EventLog``."""
    import copy
    from repro_torch.core.tick import TickEngine
    from repro_torch.obs import EventLog
    kinds = {"eager": ("cuda", False), "graph": ("cuda", True),
             "second_eager": ("cuda", False), "cpu": ("cpu", False)}
    engines, recs = {}, {k: [] for k in kinds}
    for name, (dev, graph) in kinds.items():
        b = base[dev]
        engines[name] = TickEngine(copy.deepcopy(b), list(b.target_benches),
                                   size=EST_SIZE, cuda_graph=graph)
        engines[name].tracer = EventLog()
    for obs in streams:
        for name, (dev, _) in kinds.items():
            e = engines[name]
            ys, host, devms = timed(torch, lambda: e.observe_batch(obs), dev)
            span = e.tracer.spans("tick_step")[-1].data["dur_s"] * 1e3
            recs[name].append({
                "host_ms": host, "device_ms": devms, "span_ms": span,
                "host_loop_ms": host - span, "graphs": len(e._graphs),
                "mean": e._mean.copy(), "std": e._std.copy(), "ys": ys,
                "leaves": [t.detach().clone() for t in
                           tick_leaves(e.state)]})
    return engines, recs


def steady(ticks, key):
    """The median of ``key`` over the ticks after the first."""
    vals = sorted(t[key] for t in ticks[1:] if t[key] is not None)
    return vals[len(vals) // 2] if vals else None


def tick_leaves(state):
    from repro_torch.core import blr
    m = state.model
    return ([m.stats.moments, m.correlated, m.median, m.spread,
             state.bias_counts, state.bias_log_sum, state.bias_log_sq]
            + [getattr(m.post, f) for f in blr.POSTERIOR_FIELDS])


def online_tick_at_scale(torch):
    """Phase 9b: one online tick at phase 8c's scale through
    ``TickEngine.observe_batch``, eager and CUDA-graphed, beside the
    legacy tick (``observe_batch`` + the dirty-row ``predict_matrix``)
    and the same tick on the CPU, then the HEFT re-plan."""
    import copy
    import numpy as np
    from repro_torch.data.synthetic import synthetic_dag
    from repro_torch.sched.heft import heft_schedule_array
    T, N, S = EST_TASKS, EST_NODES, EST_STREAM
    base = {dev: synthetic_estimator(T, N, dev) for dev in ("cuda", "cpu")}
    for b in base.values():
        b._batched()                            # the batched fit, once
    nodes, names = list(base["cuda"].target_benches), \
        base["cuda"].task_names()
    # tick k absorbs the stream of numpy seed k + 1; one more stream for
    # the profiled tick
    streams, waves = zip(*(tick_stream(names, nodes, seed)
                           for seed in range(1, TICKS + 2)))
    res = {"tasks": T, "nodes": N, "stream": S, "seeds": TICKS + 1,
           "waves": list(waves), "ticks": TICKS}
    engines, recs = tick_engines(torch, base, streams[:TICKS])
    te, tc = recs["eager"], recs["cpu"]
    # bit for bit: graph = eager, and eager = eager across two engines
    for k in range(TICKS):
        for name in ("graph", "second_eager"):
            other = recs[name]
            check(np.array_equal(te[k]["mean"], other[k]["mean"])
                  and np.array_equal(te[k]["std"], other[k]["std"])
                  and all(torch.equal(a, b) for a, b in
                          zip(te[k]["leaves"], other[k]["leaves"])),
                  f"9b tick {k + 1}: the {name} engine differs from eager "
                  "in some bit")
    errs = {}
    for k in range(TICKS):
        errs[f"tick{k + 1}_mean"] = rel_err(te[k]["mean"], tc[k]["mean"])
        errs[f"tick{k + 1}_std"] = rel_err(te[k]["std"], tc[k]["std"])
        errs[f"tick{k + 1}_leaves"] = max(
            rel_err(a.cpu().double(), b.double())
            for a, b in zip(te[k]["leaves"], tc[k]["leaves"]))
    worst = max(errs, key=errs.get)
    check(errs[worst] <= EST_TOL, f"9b card against CPU: {worst} "
          f"{errs[worst]:.3e}")
    # profile of one more tick on the eager and the graph engines (the
    # same state bit for bit, so the same work)
    prof = {name: device_busy(
        torch, lambda: engines[name].observe_batch(streams[TICKS]))
        for name in ("eager", "graph")}
    # the legacy tick on the card and on the CPU, from the same fit and
    # tick 1's stream
    legacy = {}
    for dev in ("cuda", "cpu"):
        est = copy.deepcopy(base[dev])
        est.predict_matrix(nodes, EST_SIZE)
        ys, ob_ms, ob_dev = timed(
            torch, lambda: est.observe_batch(streams[0]), dev)
        (lm, ls), pm_ms, pm_dev = timed(
            torch, lambda: est.predict_matrix(nodes, EST_SIZE), dev)
        legacy[dev] = {"observe_ms": ob_ms, "observe_device_ms": ob_dev,
                       "dirty_matrix_ms": pm_ms,
                       "dirty_matrix_device_ms": pm_dev,
                       "tick_ms": ob_ms + pm_ms, "mean": lm, "std": ls,
                       "ys": ys}
    lg = legacy["cuda"]
    errs["legacy_vs_fused_mean"] = rel_err(lg["mean"], te[0]["mean"])
    errs["legacy_vs_fused_std"] = rel_err(lg["std"], te[0]["std"])
    errs["legacy_vs_fused_ys"] = rel_err(lg["ys"], te[0]["ys"])
    check(max(errs[k] for k in errs if k.startswith("legacy")) <= EST_TOL,
          "9b: the legacy tick and the fused tick disagree")
    # the re-plan: HEFT over the ~10k-task DAG from the tick's matrix
    dag = synthetic_dag(width=100, depth=140, fanout=2.0, seed=0)
    rows = np.arange(dag.n_tasks) % T
    heft = {}
    for dev, tick in (("cuda", te[0]), ("cpu", tc[0])):
        sched, h_ms, _ = timed(torch, lambda: heft_schedule_array(
            dag.succ, dag.pred, tick["mean"][rows]), "cpu")
        heft[dev] = {"ms": h_ms, "makespan": sched["makespan"],
                     "assignment": sched["assignment"]}
    e_span = abs(heft["cuda"]["makespan"] - heft["cpu"]["makespan"]) \
        / heft["cpu"]["makespan"]
    check(e_span <= HEFT_TOL, f"9b HEFT makespans {e_span:.3e} apart")
    same = float(np.mean(heft["cuda"]["assignment"]
                         == heft["cpu"]["assignment"]))

    def rec(ticks):
        out = {"ticks": [{k: v for k, v in t.items()
                          if k not in ("mean", "std", "leaves", "ys")}
                         for t in ticks]}
        for key in ("host_ms", "device_ms", "span_ms", "host_loop_ms"):
            out[f"steady_{key}"] = steady(ticks, key)
        return out

    res.update({name: rec(r) for name, r in recs.items()})
    res.update({
        "graphs_captured": len(engines["graph"]._graphs),
        "graph_keys": [list(k) for k in engines["graph"]._graphs],
        "profile": prof,
        "legacy": {d: {k: v for k, v in r.items()
                       if k not in ("mean", "std", "ys")}
                   for d, r in legacy.items()},
        "heft": {"card_ms": heft["cuda"]["ms"], "cpu_ms": heft["cpu"]["ms"],
                 "makespan_card": heft["cuda"]["makespan"],
                 "makespan_cpu": heft["cpu"]["makespan"],
                 "rel_err": e_span, "equal_assignments": same,
                 "dag": [dag.n_tasks, dag.n_edges]},
        "rel_err": errs, "bitwise": {"graph_vs_eager": True,
                                     "eager_run_to_run": True}})
    return res


def run_online_phase(torch, smi):
    """Phase 9: the online loop on the card."""
    report = {}
    print("== phase 9a: the five workflows through OnlineExecutor, card "
          "and CPU, fused and legacy, faults off and on (2 samples, 2 "
          "nodes per type)", flush=True)
    report["executors"] = online_executors(torch)
    print(f"== phase 9b: one online tick at {EST_TASKS} tasks x "
          f"{EST_NODES} nodes, {EST_STREAM} observations (numpy seeds 1-"
          f"{TICKS + 1}, one a tick), then HEFT over synthetic_dag(100, "
          "140)", flush=True)
    r = online_tick_at_scale(torch)
    report["tick"] = r
    pe = r["profile"]["eager"]
    print(f"  {smi}; waves (moments, bias) by tick {r['waves']}; graphs "
          f"captured {r['graphs_captured']} (keys {r['graph_keys']}); bit "
          "for bit: graph = eager, eager = eager across two engines; card "
          f"against CPU worst {max(r['rel_err'].values()):.3e}", flush=True)
    print(f"  ticks of {EST_STREAM} observations, the first (warm-up or "
          f"capture) and the median of the {TICKS - 1} after it; the span "
          "is tick_step's (dispatch and the one copy back), the host loop "
          "the rest of observe_batch")
    print(f"  {'observe_batch':26s} {'host ms':>9s} {'events ms':>10s} "
          f"{'span ms':>8s} {'loop ms':>8s} {'busy ms':>8s} "
          f"{'launches':>8s}")
    nan = float("nan")
    for name, label in (("eager", "eager, card"), ("graph", "graph, card"),
                        ("second_eager", "eager again, card"),
                        ("cpu", "eager, CPU")):
        t0, p = r[name]["ticks"][0], r["profile"].get(name)
        for tag, t in (("tick 1", t0), ("steady", {
                k[len("steady_"):]: v for k, v in r[name].items()
                if k.startswith("steady_")})):
            dev = t["device_ms"]
            q = p if (p and tag == "steady") else None
            print(f"  {label + ', ' + tag:26s} {t['host_ms']:9.3f} "
                  f"{dev if dev is not None else nan:10.3f} "
                  f"{t['span_ms']:8.3f} {t['host_loop_ms']:8.3f} "
                  f"{q['busy_ms'] if q else nan:8.3f} "
                  f"{q['device_launches'] if q else 0:8d}", flush=True)
    for dev in ("cuda", "cpu"):
        lg = r["legacy"][dev]
        print(f"  legacy tick on {'the card' if dev == 'cuda' else 'the CPU'}"
              f": observe_batch {lg['observe_ms']:.3f} ms + dirty-row "
              f"predict_matrix {lg['dirty_matrix_ms']:.3f} ms = "
              f"{lg['tick_ms']:.3f} ms", flush=True)
    h = r["heft"]
    print(f"  HEFT re-plan over {h['dag'][0]} tasks: {h['card_ms']:.3f} ms "
          f"(card's matrix) / {h['cpu_ms']:.3f} ms (CPU's), makespans "
          f"{h['rel_err']:.3e} apart, equal assignments "
          f"{100 * h['equal_assignments']:.1f}%", flush=True)
    print("  host ops of the eager tick by self time (ms, calls): "
          + ", ".join(f"{k} {ms:.2f} x{n}" for k, ms, n in
                      pe["host_top"][:6]), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 10: the multi-workflow fleet and LotaruML
# ---------------------------------------------------------------------------
#: benchmarks/bench_online.py's fleet sweep (``bench_scale``,
#: ``_fleet_point``): W workflows at T x N, observations per workflow per
#: tick, the input size; then W 4 at phase 8c's T x N with 1,024
#: observations per workflow (4,096 a tick, phase 9b's stream)
FLEET_WS, FLEET_T, FLEET_N, FLEET_BATCH, FLEET_SIZE = (4, 16, 64), 128, 16, \
    64, 64.0
FLEET_BIG = (4, EST_TASKS, EST_NODES, EST_STREAM // 4)
#: ticks of a fleet point (numpy seeds 1-4), the first a warm-up
FLEET_TICKS = 4
#: launches a fleet tick may grow by from W 4 to W 64 (the same batch per
#: workflow): the fleet runs as one batched pass, not a loop
FLEET_LAUNCH_GROWTH = 1.5
#: benchmarks/bench_predict.py's scale for LotaruML: cells x target
#: nodes, ``fit_cell``'s partitions, the observe_batch stream
ML_CELLS, ML_NODES, ML_PARTITIONS, ML_STREAM = 1000, 64, 6, 4096


def fleet_obs(W, T, N, B, seed):
    """One fleet tick's (W, B, 8) rows from numpy seed ``seed``, in
    bench_online's ``_fleet_point`` form: uniform rows, columns and
    runtimes (5-120 s), the runtime as the row's median and 1 as its
    spread; sizes 0.5-1.5 x FLEET_SIZE."""
    import numpy as np
    rng = np.random.default_rng(seed)
    obs = np.zeros((W, B, 8))
    obs[..., 0] = rng.integers(0, T, (W, B))
    obs[..., 1] = rng.integers(0, N, (W, B))
    obs[..., 2] = FLEET_SIZE * rng.uniform(0.5, 1.5, (W, B))
    obs[..., 3] = rng.uniform(5.0, 120.0, (W, B))
    obs[..., 5] = obs[..., 3]
    obs[..., 6] = 1.0
    obs[..., 7] = 1.0
    return obs


def fleet_point(torch, W, T, N, B, bases):
    """One fleet point: ``bases[dev]``'s state stacked W times (as
    bench_online stacks it) on the card, on the card's (1, 1) mesh and
    on the CPU, beside W per-workflow ``tick_step`` states on the card;
    FLEET_TICKS ticks of fresh rows, each workflow predicting at its own
    size.  Every tick: the mesh's fleet equals the card's bit for bit,
    and every workflow's slice is held to its ``tick_step`` and to the
    CPU's fleet (EST_TOL).  Then one more tick of each, profiled."""
    import numpy as np
    from repro_torch.core import build_state
    from repro_torch.core.tick import tick_step
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.online.fleet import (fleet_slice, fleet_tick_step,
                                          shard_fleet, stack_states)
    nodes = list(bases["cuda"].target_benches)
    one = {dev: build_state(bases[dev], nodes)[0] for dev in bases}
    fleets = {dev: stack_states([one[dev]] * W) for dev in bases}
    mesh = make_fleet_mesh(device="cuda:0")
    check(mesh.shape == {"wf": 1, "task": 1}, f"mesh {mesh.shape}")
    sharded = shard_fleet(fleets["cuda"], mesh)
    loops = [build_state(bases["cuda"], nodes)[0] for _ in range(W)]
    sizes = FLEET_SIZE * np.linspace(0.5, 1.5, W)
    recs = {"fleet": [], "loop": [], "cpu": []}
    worst = {"fleet_vs_loop": 0.0, "card_vs_cpu": 0.0}

    def fleet_tick(dev, obs):
        f, m, s = fleet_tick_step(fleets[dev], obs, sizes)
        fleets[dev] = f
        return m, s

    def loop_tick(obs):
        out = []
        for w in range(W):
            loops[w], m, s, _ = tick_step(loops[w], obs[w], sizes[w], False)
            out.append((m, s))
        return out

    for k in range(FLEET_TICKS):
        obs = fleet_obs(W, T, N, B, k + 1)
        (cm, cs), host, dev_ms = timed(torch, lambda: fleet_tick("cuda", obs),
                                       "cuda")
        recs["fleet"].append({"host_ms": host, "device_ms": dev_ms})
        sharded, sm, ss = fleet_tick_step(sharded, obs, sizes)
        check(torch.equal(sm, cm) and torch.equal(ss, cs),
              f"10a W {W} tick {k + 1}: the (1, 1) mesh's fleet differs "
              "from the unsharded fleet in some bit")
        (hm, hs), host, _ = timed(torch, lambda: fleet_tick("cpu", obs),
                                  "cpu")
        recs["cpu"].append({"host_ms": host, "device_ms": None})
        outs, host, dev_ms = timed(torch, lambda: loop_tick(obs), "cuda")
        recs["loop"].append({"host_ms": host, "device_ms": dev_ms})
        worst["card_vs_cpu"] = max(worst["card_vs_cpu"],
                                   rel_err(cm.cpu(), hm), rel_err(cs.cpu(), hs))
        for w, (m, s) in enumerate(outs):
            for a, b in ((cm, m), (cs, s)):
                worst["fleet_vs_loop"] = max(
                    worst["fleet_vs_loop"],
                    rel_err(fleet_slice(a, fleets["cuda"], w), b.cpu()))
    st = fleets["cuda"].state
    worst["leaves_card_vs_cpu"] = max(
        rel_err(a.cpu().double(), b.double()) for a, b in
        zip(tick_leaves(st), tick_leaves(fleets["cpu"].state)))
    bad = max(worst, key=worst.get)
    check(worst[bad] <= EST_TOL, f"10a W {W} T {T} N {N}: {bad} "
          f"{worst[bad]:.3e}")
    obs = fleet_obs(W, T, N, B, FLEET_TICKS + 1)
    prof = {"fleet": device_busy(torch, lambda: fleet_tick("cuda", obs)),
            "loop": device_busy(torch, lambda: loop_tick(obs))}
    out = {"W": W, "T": T, "N": N, "batch_per_workflow": B,
           "cells": W * T * N, "rel_err": worst, "bitwise_mesh": True,
           "ticks": recs}
    for name, ticks in recs.items():
        for key in ("host_ms", "device_ms"):
            out[f"{name}_steady_{key}"] = steady(ticks, key)
    for name, p in prof.items():
        out[f"{name}_busy_ms"] = p["busy_ms"]
        out[f"{name}_launches"] = p["device_launches"]
    out["cells_per_s"] = W * T * N / (out["fleet_steady_host_ms"] / 1e3)
    out["profile_top"] = prof["fleet"]["top"]
    return out


def run_fleet_phase(torch, smi):
    """Phase 10a: the fleet on the card (bench_online's sweep, then W 4
    at phase 8c's scale)."""
    import copy
    devs = ("cuda", "cpu")
    small = {d: synthetic_estimator(FLEET_T, FLEET_N, d) for d in devs}
    points = [fleet_point(torch, W, FLEET_T, FLEET_N, FLEET_BATCH, small)
              for W in FLEET_WS]
    W, T, N, B = FLEET_BIG
    big = {d: synthetic_estimator(T, N, d) for d in devs}
    points.append(fleet_point(torch, W, T, N, B, big))
    del small, big
    first, last = points[0], points[len(FLEET_WS) - 1]
    growth = last["fleet_launches"] / first["fleet_launches"]
    print(f"  {smi}; steady = median of ticks 2-{FLEET_TICKS}; busy and "
          "launches from one more tick under torch.profiler", flush=True)
    print(f"  {'W x T x N, B/wf':22s} {'host ms':>9s} {'events ms':>10s} "
          f"{'busy ms':>8s} {'launch':>7s} {'Mcells/s':>9s} | "
          f"{'W tick_step: host':>17s} {'events':>9s} {'busy':>8s} "
          f"{'launch':>7s} | {'CPU ms':>9s} | {'err loop':>9s} "
          f"{'err CPU':>9s}")
    for p in points:
        print(f"  {p['W']:3d} x {p['T']:4d} x {p['N']:3d}, "
              f"{p['batch_per_workflow']:5d}  "
              f"{p['fleet_steady_host_ms']:9.3f} "
              f"{p['fleet_steady_device_ms']:10.3f} "
              f"{p['fleet_busy_ms']:8.3f} {p['fleet_launches']:7d} "
              f"{p['cells_per_s'] / 1e6:9.3f} | "
              f"{p['loop_steady_host_ms']:17.3f} "
              f"{p['loop_steady_device_ms']:9.3f} {p['loop_busy_ms']:8.3f} "
              f"{p['loop_launches']:7d} | {p['cpu_steady_host_ms']:9.3f} | "
              f"{p['rel_err']['fleet_vs_loop']:9.2e} "
              f"{p['rel_err']['card_vs_cpu']:9.2e}", flush=True)
    print(f"  launches a fleet tick, W {last['W']} against W {first['W']}: "
          f"{growth:.3f}x (at most {FLEET_LAUNCH_GROWTH}x); the (1, 1) "
          "mesh's fleet equal to the unsharded fleet bit for bit at every "
          "tick", flush=True)
    check(growth <= FLEET_LAUNCH_GROWTH,
          f"10a: a fleet tick's launches grew {growth:.3f}x from W "
          f"{first['W']} to W {last['W']}")
    return {"points": copy.deepcopy(points), "launch_growth": growth,
            "card": smi}


def synthetic_ml(n_cells, n_nodes, device, seed=0):
    """tests/test_batched_predict.py's ``_toy_ml`` at scale, built from
    the port: ``n_cells`` cells from numpy seed ``seed`` (step tokens
    2048 x (i + 1), random roofline terms, local runs linear in the
    tokens with N(0, 1e-3) noise), the even ones with a throttled second
    run (the dual-run branch), the odd ones without (the ratio branch),
    over ``n_nodes`` target benches; ``fit_cell`` with ML_PARTITIONS
    partitions."""
    import numpy as np
    from repro_torch.core import LotaruML
    from repro_torch.core.profiler import BenchResult
    rng = np.random.default_rng(seed)
    local = BenchResult(node="local-cpu", cpu_events_s=450.0,
                        matmul_gflops=90.0, mem_gbps=18.0,
                        io_read_mbps=420.0, io_write_mbps=420.0,
                        link_gbps=0.0)
    benches = {}
    for j in range(n_nodes):
        nm = f"node{j:03d}"
        benches[nm] = BenchResult(
            node=nm, cpu_events_s=200.0,
            matmul_gflops=float(rng.uniform(500, 5000)),
            mem_gbps=float(rng.uniform(100, 900)), io_read_mbps=300.0,
            io_write_mbps=300.0, link_gbps=float(rng.uniform(0, 60)))
    est = LotaruML(local, benches, device=device)
    for i in range(n_cells):
        slope = float(rng.uniform(1e-4, 1e-3))
        cell = {"arch": f"a{i:04d}", "shape": "s", "roofline": {
            "step_tokens": 2048 * (i + 1),
            "compute_s": float(rng.uniform(0.1, 2)),
            "memory_s": float(rng.uniform(0.1, 2)),
            "collective_s": float(rng.uniform(0.0, 1)),
            "flops_per_device": float(rng.uniform(1e12, 5e13)),
            "bytes_per_device": float(rng.uniform(1e10, 1e12)),
            "coll_bytes_per_device": float(rng.uniform(1e8, 1e10))}}
        noise = iter(rng.normal(0, 1e-3, ML_PARTITIONS))

        def run(c, f, s=slope, noise=noise):
            return s * f * c["roofline"]["step_tokens"] + 0.5 + next(noise)

        def slow(c, f, s=slope):
            return s * f * c["roofline"]["step_tokens"] * 1.25 + 0.6

        est.fit_cell(cell, run, n_partitions=ML_PARTITIONS,
                     run_local_throttled=slow if i % 2 == 0 else None)
    return est


def ml_stream(est, seed):
    """ML_STREAM observations over random (cell, target node) pairs from
    numpy seed ``seed``: tokens 0.5-1.5 x the cell's step tokens, runtimes
    0.5-2 x the cell's local time at those tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    names, nodes = est.cell_names(), list(est.target_benches)
    ci = rng.integers(0, len(names), ML_STREAM)
    ni = rng.integers(0, len(nodes), ML_STREAM)
    scale = rng.uniform(0.5, 1.5, ML_STREAM)
    slow = rng.uniform(0.5, 2.0, ML_STREAM)
    out = []
    for c, n, a, b in zip(ci, ni, scale, slow):
        fc = est.cells[names[c]]
        tokens = float(a * fc.full_tokens)
        local = float(np.interp(tokens, fc.tokens[:ML_PARTITIONS],
                                fc.runtimes[:ML_PARTITIONS]))
        out.append((names[c], nodes[n], tokens, float(b * local)))
    return out


def ml_run(torch, est, device, stream):
    """Phase 10b's calls on ``device``: the full (cell x node) matrix, the
    scalar-factor matrix, ``observe_batch`` of ``stream`` and the
    dirty-row matrix, each timed (host ms, CUDA-event ms on the card)."""
    nodes = list(est.target_benches)
    t, out = {}, {}

    def full():
        est._mat_cache = None
        return est.predict_matrix(nodes)

    out["matrix"], t["matrix_ms"], t["matrix_device_ms"] = timed(
        torch, full, device, 5)
    out["scalar"], t["scalar_matrix_ms"], t["scalar_matrix_device_ms"] = \
        timed(torch, lambda: est.predict_matrix_scalar(nodes), device, 5)
    fetches = est.fetches
    out["ys"], t["observe_ms"], t["observe_device_ms"] = timed(
        torch, lambda: est.observe_batch(stream), device)
    t["observe_fetches"] = est.fetches - fetches
    out["dirty_rows"] = sorted(est._dirty_rows)
    out["dirty"], t["dirty_matrix_ms"], t["dirty_matrix_device_ms"] = timed(
        torch, lambda: est.predict_matrix(nodes), device)
    return t, out


def run_ml_phase(torch, smi):
    """Phase 10b: LotaruML at bench_predict's scale on the card, held to
    the CPU (EST_TOL) and to its own scalar ``predict``."""
    import copy
    import numpy as np
    est = {}
    build = {}
    for dev in ("cuda", "cpu"):
        est[dev], build[dev], _ = timed(
            torch, lambda: synthetic_ml(ML_CELLS, ML_NODES, dev), dev)
    nodes = list(est["cuda"].target_benches)
    stream = ml_stream(est["cpu"], 1)
    fresh = copy.deepcopy(est["cuda"])       # profiled after the checks
    times, outs = {}, {}
    for dev in ("cuda", "cpu"):
        times[dev], outs[dev] = ml_run(torch, est[dev], dev, stream)
    c, h = outs["cuda"], outs["cpu"]
    errs = {"matrix_mean": rel_err(c["matrix"][0], h["matrix"][0]),
            "matrix_std": rel_err(c["matrix"][1], h["matrix"][1]),
            "scalar_matrix_mean": rel_err(c["scalar"][0], h["scalar"][0]),
            "scalar_matrix_std": rel_err(c["scalar"][1], h["scalar"][1]),
            "observe_ys": rel_err(c["ys"], h["ys"]),
            "dirty_matrix_mean": rel_err(c["dirty"][0], h["dirty"][0]),
            "dirty_matrix_std": rel_err(c["dirty"][1], h["dirty"][1]),
            "bias_log_sum": rel_err(est["cuda"].bias.log_sum,
                                    est["cpu"].bias.log_sum)}
    check(c["dirty_rows"] == h["dirty_rows"],
          "10b: the card and the CPU dirtied different rows")
    # the matrix against the scalar predict on the card, 64 sampled pairs
    rng = np.random.default_rng(0)
    names = est["cuda"].cell_names()
    mean, std = c["dirty"]
    oracle = 0.0
    for i, j in zip(rng.integers(0, ML_CELLS, 64), rng.integers(0, ML_NODES,
                                                               64)):
        m, s = est["cuda"].predict(names[i], nodes[j])
        oracle = max(oracle, rel_err([mean[i, j], std[i, j]], [m, s]))
    errs["matrix_vs_scalar_predict"] = oracle
    bad = max(errs, key=errs.get)
    check(errs[bad] <= EST_TOL, f"10b: {bad} {errs[bad]:.3e}")
    for dev in ("cuda", "cpu"):
        check(times[dev]["observe_fetches"] == 2,
              f"10b: observe_batch read back {times[dev]['observe_fetches']}"
              " times on " + dev)
    fresh.predict_matrix(nodes)
    prof = {"matrix": device_busy(torch, lambda: (
        setattr(fresh, "_mat_cache", None), fresh.predict_matrix(nodes))),
            "scalar_matrix": device_busy(
                torch, lambda: fresh.predict_matrix_scalar(nodes)),
            "observe": device_busy(torch, lambda: fresh.observe_batch(stream))}
    fresh._dirty_rows = set(c["dirty_rows"])
    prof["dirty_matrix"] = device_busy(
        torch, lambda: fresh.predict_matrix(nodes))
    n_dual = sum(est["cpu"].cells[n].w_compute is not None for n in names)
    print(f"  {smi}; {ML_CELLS} cells ({n_dual} dual-run, "
          f"{ML_CELLS - n_dual} ratio) x {ML_NODES} target nodes, built in "
          f"{build['cuda']:.1f} ms (card) / {build['cpu']:.1f} ms (CPU); "
          f"{len(c['dirty_rows'])} rows dirtied by {ML_STREAM} "
          "observations (numpy seed 1)", flush=True)
    print(f"  {'call':28s} {'host ms':>9s} {'events ms':>10s} "
          f"{'busy ms':>8s} {'launches':>8s} {'CPU ms':>9s}")
    tc, th = times["cuda"], times["cpu"]
    for key, label in (("matrix", "predict_matrix, full"),
                       ("scalar_matrix", "predict_matrix_scalar"),
                       ("observe", f"observe_batch, {ML_STREAM} obs"),
                       ("dirty_matrix", "predict_matrix, dirty rows")):
        p = prof[key]
        print(f"  {label:28s} {tc[key + '_ms']:9.3f} "
              f"{tc[key + '_device_ms']:10.3f} {p['busy_ms']:8.3f} "
              f"{p['device_launches']:8d} {th[key + '_ms']:9.3f}",
              flush=True)
    print(f"  observe_batch read back {tc['observe_fetches']} times; card "
          f"against CPU worst {max(errs.values()):.3e} ({bad}); matrix "
          f"against scalar predict {oracle:.3e}", flush=True)
    return {"cells": ML_CELLS, "nodes": ML_NODES, "stream": ML_STREAM,
            "dual_run_cells": n_dual, "build_ms": build, "times": times,
            "profile": {k: {q: v for q, v in p.items() if q != "host_top"}
                        for k, p in prof.items()},
            "dirty_rows": len(c["dirty_rows"]), "rel_err": errs,
            "card": smi}


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
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ssd, ssd_chunked
    from repro_torch.kernels._launches import launched_kernels
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = get_config("stablelm-1.6b")
    mcfg = get_config("mamba2-1.3b")
    H, D = cfg.n_heads, cfg.resolved_head_dim()
    n_requests, max_new = 8, 12
    batch_shapes = serve_batches(serve, cfg.vocab, n_requests, max_new)
    mbatch_shapes = serve_batches(serve, mcfg.vocab, n_requests, max_new)

    t_start = time.time()
    print("== phase 1: card", flush=True)
    smi = nvidia_smi_line()
    print(smi)
    nvcc = _build.nvcc_path()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc_v[-1]}, python {sys.version.split()[0]}", flush=True)

    print("== phase 2: build (one nvcc per source, started together)",
          flush=True)
    t0 = time.time()
    sources = [kernel.SOURCE, ssd_kernel.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_build.build, sources))
    print(f"built {', '.join(str(p.relative_to(ROOT)) for p in libs)} in "
          f"{time.time() - t0:.1f}s")
    for src in sources:
        print(f"-- {Path(src).name}")
        print(_build.build_log(src).strip(), flush=True)

    print("== phase 3: flash kernel against its plain version; stablelm "
          f"serve batches (B, T, steps) {batch_shapes}", flush=True)
    checks = run_kernel_checks(torch, kernel, mha, attention_ref,
                               kernel_cases(batch_shapes, H, D))

    print("== phase 3b: SSD kernel against its plain version; mamba2 serve "
          f"batches (B, T, steps) {mbatch_shapes}", flush=True)
    ssd_checks = run_ssd_checks(torch, ssd_kernel, ssd, ssd_chunked,
                                launched_kernels,
                                ssd_cases(mbatch_shapes, mcfg))

    print("== phase 4: main path, stablelm-1.6b at full width", flush=True)
    torch.cuda.reset_peak_memory_stats()
    kernel.LAUNCHES = ssd_kernel.LAUNCHES = 0
    summary = serve.main(["--arch", "stablelm-1.6b", "--requests",
                          str(n_requests), "--max-new", str(max_new)])
    launches, ssd_on_stablelm = kernel.LAUNCHES, ssd_kernel.LAUNCHES
    loop = summary.pop("loop")
    forwards = summary["prefills"] + summary["decode_steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  requests {summary['requests']}, tokens {summary['tokens']}, "
          f"wall {summary['seconds']:.3f} s, median decode step "
          f"{summary['median_step_ms']:.3f} ms, peak memory {peak_gb:.2f} GB, "
          f"kernel launches {launches} = {cfg.n_layers} x {forwards} forwards",
          flush=True)
    check_served(summary, cfg, n_requests, max_new)
    check(launches > 0 and launches == cfg.n_layers * forwards,
          f"kernel launched {launches} times on the main path, expected "
          f"{cfg.n_layers} x {forwards}")
    check(ssd_on_stablelm == 0,
          f"the SSD kernel ran {ssd_on_stablelm} times on the stablelm path")
    check(loop.batch_shapes == batch_shapes,
          f"served batches {loop.batch_shapes}, checked {batch_shapes}")

    print("== phase 5: profile of decode steps (torch.profiler)", flush=True)
    profile = profile_serve(torch, loop, kernel, "flash_fwd", "flash",
                            *batch_shapes[0][:2])

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
    rows = run_timings(torch, kernel, mha, attention_ref,
                       torch.nn.functional.scaled_dot_product_attention,
                       batch_shapes[0], H, D)

    print("== phase 4b: main path, mamba2-1.3b at full width", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel.LAUNCHES = ssd_kernel.LAUNCHES = 0
    msummary = serve.main(["--arch", "mamba2-1.3b", "--requests",
                           str(n_requests), "--max-new", str(max_new)])
    ssd_launches, flash_on_mamba = ssd_kernel.LAUNCHES, kernel.LAUNCHES
    mloop = msummary.pop("loop")
    mpeak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefills = msummary["prefills"]
    # the prefill's own time, at the first batch's shape (counted apart)
    B0, T0, _ = mbatch_shapes[0]
    toks = torch.zeros(B0, T0, dtype=torch.long, device="cuda")
    prefill_s = []
    with torch.inference_mode():
        for _ in range(3):
            caches = mloop.model.init_caches(B0, T0 + max_new, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mloop.prefill(mloop.params, {"tokens": toks}, caches)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
    del caches
    prefill_ms = 1e3 * sorted(prefill_s)[1]
    print(f"  requests {msummary['requests']}, tokens {msummary['tokens']}, "
          f"wall {msummary['seconds']:.3f} s, median decode step "
          f"{msummary['median_step_ms']:.3f} ms, prefill B{B0} T{T0} "
          f"{prefill_ms:.3f} ms (median of 3), peak memory {mpeak_gb:.2f} GB,"
          f" SSD kernel launches {ssd_launches} = {mcfg.n_layers} x "
          f"{prefills} prefills, flash launches {flash_on_mamba}", flush=True)
    check_served(msummary, mcfg, n_requests, max_new)
    check(ssd_launches > 0 and ssd_launches == mcfg.n_layers * prefills,
          f"SSD kernel launched {ssd_launches} times on the main path, "
          f"expected {mcfg.n_layers} x {prefills}")
    check(flash_on_mamba == 0,
          f"the flash kernel ran {flash_on_mamba} times on the mamba2 path")
    check(mloop.batch_shapes == mbatch_shapes,
          f"served batches {mloop.batch_shapes}, checked {mbatch_shapes}")

    print("== phase 5b: profile of a mamba2 prefill and decode steps "
          "(torch.profiler)", flush=True)
    mprofile = profile_serve(torch, mloop, ssd_kernel, "ssd_", "ssd",
                             B0, T0, prefill=True)

    print("== phase 6b: mamba2 on the card against the CPU; prefill against "
          "decode on the card", flush=True)
    msmoke = smoke_config("mamba2-1.3b")
    msmoke_params = build_model(msmoke).init(0, device="cpu")
    mf32 = mcfg.with_(dtype=torch.float32)
    f32c = {"cache_dtype": torch.float32}
    mmodel_errs = {
        "smoke float32": model_reference_check(
            torch, build_model, msmoke.with_(dtype=torch.float32),
            msmoke_params, 2, 9, 3, 1e-4, "smoke float32", **f32c),
        "smoke bfloat16": model_reference_check(
            torch, build_model, msmoke, msmoke_params, 2, 9, 3, 3e-2,
            "smoke bfloat16"),
        "full width 2 layers float32": model_reference_check(
            torch, build_model, mf32.with_(n_layers=2),
            first_layers(mloop.params, 2), 2, 6, 2, 1e-4,
            "full width 2 layers float32", **f32c),
        "full width 48 layers float32": model_reference_check(
            torch, build_model, mf32, mloop.params, 2, 6, 2, 1e-4,
            "full width 48 layers float32", **f32c),
    }
    for dev in ("cuda", "cpu"):
        mmodel_errs[f"prefill 129 vs 128 + decode, full width float32, "
                    f"{dev}"] = prefill_decode_consistency(
            torch, build_model, mf32, mloop.params, 2, mcfg.ssm.chunk, 1e-4,
            "full width 48 layers float32", device=dev)
    del mloop, msummary["done"]
    torch.cuda.empty_cache()

    print("== phase 7b: SSD kernel timing (bf16 x/B/C; device time from "
          "CUDA graph replays, host time from back-to-back calls)",
          flush=True)
    ssd_rows = run_ssd_timings(torch, ssd_kernel, ssd, ssd_chunked,
                               launched_kernels, mcfg, mbatch_shapes[0])

    print("== phase 8: the estimator path (float64; card against the CPU "
          "at 1e-12)", flush=True)
    estimator = run_estimator_phase(torch, smi)

    print("== phase 9: the online loop (fused tick engine and executor; "
          "float64, card against the CPU at 1e-12)", flush=True)
    online = run_online_phase(torch, smi)

    print("== phase 10: the multi-workflow fleet and LotaruML (float64; "
          "card against the CPU at 1e-12)", flush=True)
    print(f"== phase 10a: the fleet, W {', '.join(map(str, FLEET_WS))} at T "
          f"{FLEET_T} x N {FLEET_N} ({FLEET_BATCH} observations a workflow), "
          f"then W {FLEET_BIG[0]} at T {FLEET_BIG[1]} x N {FLEET_BIG[2]} "
          f"({FLEET_BIG[3]} a workflow); {FLEET_TICKS} ticks, numpy seeds "
          f"1-{FLEET_TICKS}", flush=True)
    fleet = run_fleet_phase(torch, smi)
    print(f"== phase 10b: LotaruML, {ML_CELLS} cells x {ML_NODES} target "
          f"nodes, a {ML_STREAM}-observation observe_batch", flush=True)
    ml = run_ml_phase(torch, smi)

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
    ssd_serve_errs = [c["max_abs_err"] for c in ssd_checks
                      if c["serve"] and c["dtype"] == "bfloat16"]
    ssd_row = next(r for r in ssd_rows if r["shape"] == "serve prefill")
    ssd_entry = {"name": "ssd_scan_fwd", "route": "cuda",
                 "source": SSD_SOURCE, "replaces": SSD_REPLACES,
                 "replaces_function": "_ssd_kernel",
                 "launches": ssd_launches,
                 "max_abs_err": max(ssd_serve_errs),
                 "ms": ssd_row["ms"], "plain_ms": ssd_row["plain_ms"],
                 "bound_ms": ssd_row["bound_ms"],
                 "bound_by": ssd_row["bound_by"],
                 "library_ms": None, "library": ssd_row["library"],
                 "host_ms": ssd_row["host_ms"],
                 "timed_shape": "serve prefill", "shapes": ssd_rows}
    kernels_line = {"kernels": [entry, ssd_entry]}
    report = {**kernels_line, "checks": checks, "ssd_checks": ssd_checks,
              "serve": summary, "batch_shapes": batch_shapes,
              "peak_memory_gb": peak_gb, "decode_profile": profile,
              "model_rel_err": model_errs,
              "mamba2": {"serve": msummary, "batch_shapes": mbatch_shapes,
                         "peak_memory_gb": mpeak_gb,
                         "prefill_ms": prefill_ms, "profile": mprofile,
                         "model_rel_err": mmodel_errs},
              "estimator": estimator, "online": online, "fleet": fleet,
              "ml": ml,
              "card": smi, "seconds": time.time() - t_start}
    out_dir = ROOT / "build" / "reports"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"chip_smoke: {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
