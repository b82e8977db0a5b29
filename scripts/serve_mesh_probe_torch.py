"""Two probes of chip_smoke.py's phase 17 (serving on a ("data", "model")
mesh), on the CUDA card, with that script's helpers.

    PYTHONPATH=src python scripts/serve_mesh_probe_torch.py

1. The floor.  For each config of ``FLOOR_RUNS`` (bf16 weights, attention
   at unit score variance), one process serves each of phase 17b's
   batches and a random (4, 15) batch, greedy, then serves again fed the
   same tokens:
   the first two rows alone (B 2), and rows 0, 1, 0, 1 (B 4, the same
   shape as the first serve).  It prints, per call (the prefill, then
   each decode step), each serve's max |difference| from the first one
   over its rows 0 and 1, over the first serve's max |logit|: with
   ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
   as PyTorch sets it (True), then False.
   Then, for the prefill's products at ``ARCH``'s shapes (random bf16
   operands, the model's einsums) and its flash attention, whether rows
   0 and 1 of the B 2 call equal those of the B 4 call bit for bit, at
   T 13 and 15.
2. A profile of a decode step of ``ARCH``.  One process, then two gloo
   processes
   sharing the card on the (1, 2) mesh, serve phase 17b's first batch and
   run ``PROFILE_STEPS`` decode steps under ``torch.profiler``: per rank
   the wall time a step, the device time a step by kind of kernel (GEMM,
   flash, copies, the rest) and the host time inside gloo's all-reduce.
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [os.fspath(ROOT), os.fspath(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

ARCH = "qwen2-7b"
#: (arch, n_layers (0: the config's), activation dtype) of the floor
FLOOR_RUNS = (("qwen2-7b", 0, "bfloat16"), ("mamba2-1.3b", 0, "bfloat16"),
              ("mamba2-1.3b", 0, "float32"))
PROFILE_STEPS = 8
#: kinds of device kernels, by name
KINDS = (("gemm", r"gemm|gemv|nvjet|xmma|cutlass|splitK"),
         ("flash", r"flash"), ("copies", r"Memcpy|Memset"))


def _gap(got, ref, rows):
    """Per call: max |got[:rows] - ref[:rows]| over max |ref|."""
    return [float((a[:rows] - b[:rows]).abs().max() / b.abs().max())
            for a, b in zip(got["logits"], ref["logits"])]


def floor(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, sharding
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    for arch, n_layers, dtype in FLOOR_RUNS:
        cfg = cs.p17_config(get_config, arch, n_layers, dtype)
        model = build_model(cfg)
        params = cs.unit_score_scale(model.init(0, device=cs.P17_DEVICE),
                                     cfg)
        steps = (make_prefill_step(model), make_decode_step(model))
        gen = torch.Generator(device=cs.P17_DEVICE).manual_seed(5)
        batches = [(f"17b batch {i}", t) for i, t in
                   enumerate(cs.p17_batches(torch, serve, cfg))]
        batches.append(("random", torch.randint(
            0, cfg.vocab, (4, 15), device=cs.P17_DEVICE, generator=gen)))
        matmul = torch.backends.cuda.matmul
        for reduced in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = reduced
            for label, toks in batches:
                def run(t, forced=None):
                    return cs.p17_serve(torch, sharding, model, *steps,
                                        params, t, forced=forced)
                ref = run(toks)
                half = run(toks[:2], [t[:2] for t in ref["tokens"]])
                pick = torch.tensor([0, 1, 0, 1])
                same = run(toks[pick.to(toks.device)],
                           [t[pick] for t in ref["tokens"]])
                print(f"floor {cs.p17_key(arch, n_layers, dtype)} {label} "
                      f"{tuple(toks.shape)} reduced-precision bf16 "
                      f"reduction {reduced}:\n  B 2         "
                      + " ".join(f"{g:.2e}" for g in _gap(half, ref, 2))
                      + "\n  B 4 (0101)  "
                      + " ".join(f"{g:.2e}" for g in _gap(same, ref, 2)),
                      flush=True)
        del params
        torch.cuda.empty_cache()
    products(torch, cs.p17_config(get_config, ARCH))


def products(torch, cfg) -> None:
    from repro_torch.kernels.flash_attention import mha
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim(), cfg.d_ff
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    #: (name, einsum, input's last dims, weight's shape)
    cases = (("wq", "btd,dhk->bthk", (d,), (d, Hq, hd)),
             ("wk", "btd,dhk->bthk", (d,), (d, Hkv, hd)),
             ("wo", "bthk,hkd->btd", (Hq, hd), (Hq, hd, d)),
             ("wg", "btd,df->btf", (d,), (d, ff)),
             ("wd", "btf,fd->btd", (ff,), (ff, d)))
    gen = torch.Generator(device=cs.P17_DEVICE).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cs.P17_DEVICE,
                           dtype=torch.bfloat16)
    for T in (13, 15):
        out = []
        for name, eq, xs, ws in cases:
            x, w = rnd(4, T, *xs), rnd(*ws) * ws[0] ** -0.5
            a, b = torch.einsum(eq, x[:2], w), torch.einsum(eq, x, w)[:2]
            out.append(f"{name} {'equal' if torch.equal(a, b) else 'differ'}")
        q, k, v = rnd(4, T, Hq, hd), rnd(4, T, Hkv, hd), rnd(4, T, Hkv, hd)
        a = mha(q[:2], k[:2], v[:2], causal=True)
        b = mha(q, k, v, causal=True)[:2]
        out.append(f"flash {'equal' if torch.equal(a, b) else 'differ'}")
        print(f"products at T {T}, rows 0-1 of B 2 against B 4: "
              + ", ".join(out), flush=True)


def _profile(torch, loop, toks, rows) -> dict:
    """PROFILE_STEPS decode steps of ``loop`` on ``toks`` (this rank's
    ``rows``) after its prefill and two warm steps, under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import sharding
    B, T = toks.shape
    n = PROFILE_STEPS + 2
    kw = {} if loop.mesh is None else {"rows": rows}
    caches = loop.model.init_caches(B, T + n, device=loop.device,
                                    rules=loop.rules, mesh=loop.mesh)
    with torch.inference_mode():
        logits, caches = loop.prefill(loop.params, {"tokens": rows.take(toks)},
                                      caches, **kw)
        tok = sharding.greedy(logits[:, -1],
                              sharding.model_axis(loop.mesh, loop.rules),
                              loop.cfg.vocab)

        def step(s):
            nonlocal tok, caches
            tok, _, caches = loop.decode(loop.params,
                                         {"tokens": tok[:, None]}, caches,
                                         T + s, **kw)
        step(0)
        step(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(2, n):
                step(s)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    device, gloo = {k: 0.0 for k, _ in KINDS}, [0.0, 0]
    device["rest"] = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            ms = cs._device_us(e, False) / 1e3 / PROFILE_STEPS
            kind = next((k for k, pat in KINDS if re.search(pat, e.key)),
                        "rest")
            device[kind] += ms
        elif re.search(r"all_?reduce", e.key) and "gloo" in e.key:
            gloo[0] += e.cpu_time_total / 1e3 / PROFILE_STEPS
            gloo[1] += e.count / PROFILE_STEPS
    return {"wall_ms": wall, "device_ms": device,
            "busy_ms": sum(device.values()), "gloo_allreduce_ms": gloo[0],
            "gloo_allreduce_calls": gloo[1]}


def _print_profile(who, p) -> None:
    print(f"profile {who}: step {p['wall_ms']:.2f} ms wall, device busy "
          f"{p['busy_ms']:.2f} ms ("
          + ", ".join(f"{k} {v:.2f}" for k, v in p["device_ms"].items())
          + f"), host in gloo all-reduce {p['gloo_allreduce_ms']:.2f} ms "
          f"over {p['gloo_allreduce_calls']:.0f} calls", flush=True)


def _worker(rank, device, out_dir):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, sharding
    from repro_torch.launch.mesh import make_mesh, make_rules
    mesh = make_mesh((1, 2), ("data", "model"), device=device)
    rules = make_rules(mesh)
    cfg = cs.p17_config(get_config, ARCH)
    loop = serve.ServeLoop(cfg, rules=rules, mesh=mesh)
    loop.params = cs.unit_score_scale(loop.params, cfg)
    toks = cs.p17_batches(torch, serve, cfg)[0]
    rows = sharding.serve_rows(mesh, rules, toks.shape[0])
    out = _profile(torch, loop, toks, rows)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def profile(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.sharding import Rows
    cfg = cs.p17_config(get_config, ARCH)
    loop = serve.ServeLoop(cfg)
    loop.params = cs.unit_score_scale(loop.params, cfg)
    toks = cs.p17_batches(torch, serve, cfg)[0]
    _print_profile("one process", _profile(torch, loop, toks,
                                           Rows(0, toks.shape[0])))
    del loop
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        spawn(_worker, 2, (d,), rendezvous=Path(d) / "rdv", backend="gloo",
              device=cs.P17_DEVICE, timeout_s=cs.P17_TIMEOUT)
        for r in range(2):
            _print_profile(f"(1, 2) rank {r}", json.loads(
                (Path(d) / f"rank{r}.json").read_text()))


def main() -> None:
    import torch
    from repro_torch import resolve_device
    resolve_device("cuda")          # raises without a card
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), torch.__version__, flush=True)
    floor(torch)
    profile(torch)


if __name__ == "__main__":
    main()
