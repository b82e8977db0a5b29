#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

It drives the port's serving paths and its training paths, stablelm-1.6b
(every attention through the flash-attention kernel; trained at full
width through its backward kernel too), mamba2-1.3b (every prefill of every
layer through the SSD-scan kernel; trained at full width through the SSD
backward kernel too), qwen2-7b, qwen2-vl-7b, stablelm-12b,
starcoder2-15b and zamba2-1.2b (both kernels), qwen3-moe-30b-a3b,
llama4-maverick-400b-a17b and seamless-m4t-large-v2 (flash), the int8 KV
cache, and Lotaru's estimator path, online loop, multi-workflow fleet and
accelerator-plane estimator.  Phases,
in order; any failure ends the run with a non-zero exit code:

1. the card's name and power limit (nvidia-smi), torch, CUDA and nvcc
   versions;
2. the build of the kernels from ``src/`` into ``build/kernels/`` (the
   flash forward and backward, the SSD scan and its backward), one nvcc
   per source,
   started together, with nvcc's ``-Xptxas -v`` reports;
3. the flash kernel against its plain PyTorch version on the card, case
   by case (float32 at 2e-5, bfloat16 at 2e-2, as tests/test_kernels.py),
   through each of its three paths (the tensor-core prefill, the split
   decode, the float32 kernel) and their edges, at head dims 32, 64, 128
   and 160 (stablelm-12b's; the float32 decode on a 2-stage ring) and with
   one query offset per batch row (the M-RoPE model's mask), with every
   attention call of the stablelm path and of each phase-11 and phase-12
   config: their batches are formed by ``serve.make_requests`` and
   ``serve.batched``, as ``serve.main`` forms them (qwen2-vl-7b's with
   per-row offsets), and seamless's encoder, self, cross and decode calls;
   GQA 8 and GQA 5 at D 128 on each path, non-causal D 64 H 16 at Sq 256 /
   Sk 256, Sq 13 / Sk 256 and Sq 1 / Sk 4,096; every decode call (Sq 1)
   also with its row lse, against ``lse_ref`` (the output the same bits
   as without), with context-parallel decode's edges: kv_len 0, a
   negative query offset and per-row offsets with one negative;
3b. the SSD kernel against its plain version ``ssd_chunked``, y and final
   state, in float32 (the CUDA-core path) and with bfloat16 x/B/C (the
   chunked tensor-core path), at 1e-5 of the reference's max (see
   ``SSD_TOL``): the shapes of tests/test_kernels.py, initial states (one
   over 8 chunks at full width), every prefill batch of the mamba2 path
   and a 4k prefill, then the same at zamba2's N 64 (its own kernel
   instantiation); each case prints the path it took, and its call,
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
   bar), and the launcher's path (and split count) is recorded; the two
   decode shapes are also timed with the row lse, in turns with the call
   without it, the lse held to ``lse_ref``; then the same four shapes at
   stablelm-12b's D 160 with 32 query and 8 kv heads;
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
   time by kernel; then zamba2's serve prefill and a 4k prefill at N 64.

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
   scalar ``predict``, with their times;
11. the other serving configs, each at full published width with random
   weights from a seed, freed before the next: qwen2-7b, qwen2-vl-7b
   (text-only, as the JAX ServeLoop), stablelm-12b, starcoder2-15b and
   zamba2-1.2b.  ``serve.main`` serves 8 requests of 12 new tokens; the
   flash launches must be n_layers x forwards (zamba2: its 6 shared-block
   applications x forwards) and the SSD launches 0 (zamba2: 38 x
   prefills), the batches those phase 3 checked, the peak memory within
   the card.  A profile of decode steps, then the card against the CPU in
   float32 at 1e-4 x max|logit|: the full width cut to 2 layers (zamba2:
   its 2 tail layers, and one super-unit of 6 layers and the shared
   block); qwen2-vl-7b also with 64 vision embeddings on an 8 x 8 grid,
   their M-RoPE positions and per-row decode offsets, at unit score
   variance (70 positions of near one-hot attention, where fp32 rounding
   alone reaches ~1e-4 with the init's weights); zamba2 also 14 layers
   against the CPU and, on the card, the prefill of 129 against 128 + one
   decode step at all 38 layers, at unit score variance of the shared
   block;
12. the MoE configs, the encoder-decoder and the int8 KV cache, each model
   freed before the next.  12a qwen3-moe-30b-a3b, all 48 layers at full
   width with bf16 weights (61.1 GB), and 12b llama4-maverick-400b-a17b
   cut to one unit (one dense and one MoE layer of 128 experts and the
   shared expert, 18.55 B parameters, bf16), each served by ``ServeLoop``
   and ``serve_queue`` (8 requests of 12 new tokens) with phase 11's checks
   (flash n_layers x forwards, the batches phase 3 checked, peak memory,
   a profile of decode steps) and the (token, k) assignments each
   prefill's routers dropped past the capacity; the card against the CPU:
   qwen3-moe at 2 layers in float32 activations (1e-4); llama4's unit is
   not held to the CPU (its CPU copy is 37 GB; cut for time).  12c
   seamless-m4t-large-v2 whole (24 + 24 layers, float32
   weights) through ``make_prefill_step`` / ``make_decode_step`` on
   ``concrete_batch(cfg, "prefill", 4, 256)``, 12 decode steps (flash 72
   launches a prefill, 48 a step), a profile of decode steps, the card
   against the CPU at 2 + 2 layers in float32 and the prefill of 257
   against 256 + one decode step on the card, each at unit score
   variance (held at 1e-4; with the init's near one-hot
   attentions fp32 rounding alone passes 1e-4).  12d ``kv_quant`` at qwen2-7b's
   decode_32k cache (B 8, 32,768 positions, 4 kv heads of 128): codes and
   scales of the card equal to the CPU's, attention over the int8 cache
   within 0.05 of the float cache's (tests/test_kv_quant.py's bar), the
   footprint against bf16.  12e phase 7's timings at D 128 GQA 8 and GQA 5
   (serve shapes, 4k prefill, 32k decode) and at seamless's D 64 H 16
   (encoder, self and cross calls of 12c, a non-causal 4k encoder prefill
   and a cross decode over 4k);
13. training, every attention's forward through the flash kernel with its
   log-sum-exp and its backward through the backward kernel
   (``flash_bwd.cu``, built in phase 2).  13a the backward against its
   plain version ``attention_bwd_ref`` on the kernel's own output and lse
   (float32 at 2e-5, bf16 at 2e-2, each of each gradient's max; the lse
   against ``lse_ref``): causal and non-causal self-attention, cross
   attention with Sq < Sk and Sq > Sk, GQA 1/4/7/8, D 32/64/128/160,
   ragged lengths, and a second run equal bit for bit; 13b its device time
   (CUDA-graph replays) at stablelm-1.6b's and qwen2-7b's training
   attention (B 4, T 4,096, causal, bf16) beside its plain version's,
   SDPA's backward (a yardstick the port never calls), the bound and the
   forward with and without lse; 13c one train step at one layer of
   stablelm-1.6b, qwen2-7b, qwen2-vl-7b (vision embeddings),
   qwen3-moe-30b-a3b (the aux loss) and seamless-m4t-large-v2 (1 + 1
   layers: encoder and cross-attention) at full width in float32
   activations on the card against the CPU: loss and every gradient leaf
   within 1e-4 x max at unit score variance, and for stablelm-1.6b and
   mamba2-1.3b every parameter after the AdamW step too; 13d ``train`` 6
   steps straight against ``train_with_restarts`` failing at step 4
   (2 layers of stablelm-1.6b, checkpoints every 2 steps under
   ``build/ckpt_restart``, removed after) at 1e-4 on the last loss, and
   tests/test_training_convergence.py's small LM at its thresholds; 13e
   ``launch.train.train`` of stablelm-1.6b at full width, 4 steps of 8 x
   4,096 tokens in 2 microbatches: flash forward launches 2 x 24 x 2 a
   step (full remat) and backward 24 x 2, median step, tokens/s, peak
   memory and the busy share of one more step under torch.profiler.
   13c also trains mamba2-1.3b (2 layers) and zamba2-1.2b (7 layers: one
   super-unit of 6 Mamba-2 layers and the shared attention block, and
   one tail layer) at full width and T 320 (three chunks, the last
   ragged), every Mamba-2 layer through the SSD scan with its chunk
   states and its backward kernel (``ssd_bwd.cu``), with exact SSD
   launch counts.  13f the SSD backward against its plain version
   ``ssd_chunked_bwd`` in float64 on the fp32 upcasts of the same inputs
   (each gradient within 1e-5 of its max, the plain version's own fp32
   gap printed beside it): mamba2's and zamba2's widths, G 2, initial
   states, a final-state gradient, ragged T, one chunk and eight, float32
   (the CUDA-core path) and bf16 x/B/C (the tensor-core path, "mma"), the
   path of each call printed, and a second run equal bit for bit; 13g its
   device time (CUDA-graph replays) at mamba2's and zamba2's training
   shape (B 4, T 4,096, bf16, the mma path) beside its plain version's,
   its bound, its host time and the forward with and without its chunk
   states; 13h
   ``launch.train.train`` of mamba2-1.3b at full width with 13e's
   settings: SSD forward launches 2 x 48 x 2 a step, backward 48 x 2, no
   flash launch, finite losses, median step, tokens/s, peak memory and
   one more step under torch.profiler (its busy share and the SSD
   backward's device ms by launch);
14. the dry run and ``LotaruML`` against the card.  14a dry-runs 13e's
   and 13h's cuts (``run_cell`` with 13e's shape and microbatches) and
   prints model FLOPs, the dry run's FLOPs and bytes, its roofline step,
   MFU (model FLOPs over the measured median step at the bf16 peak) and
   its peak memory beside ``max_memory_allocated``; 14b fits
   ``LotaruML`` from the card's own steps (``profile_local`` on the
   card, ``fit_cell`` over full-width train steps of 4, 2 and 1 rows of
   4,096 tokens, one step after a warm-up), prints the predicted
   full step against 13e's / 13h's median and the simulated targets'
   predictions, and refits on the CPU from the same runtimes, which must
   equal the card's fit within 1e-12.  The 40-cell sweep (``python -m
   repro_torch.launch.dryrun``) needs no card and runs as a command of
   its own;
15. the linter against the card's syncs: PyTorch's sync detector
   (``torch.cuda.set_sync_debug_mode("warn")``, through
   ``repro_torch.analysis.syncs.trace_syncs``) records every synchronizing
   call of the main paths at its innermost frame in the port, each run
   after its phase's timed work: 15a two eager ticks and two graph
   replays of phase 9b's engines (T 1,000 x N 64, 4,096 observations),
   15b one fleet tick at W 64 x T 128 x N 16 (phase 10a), 15c a batch of
   phase 4's stablelm-1.6b loop at 1 and at 2 new tokens (the difference
   is one decode step), 15d one more stablelm-1.6b training step at 13e's
   shape (through the flash kernel's autograd function).  Printed: the
   syncs per tick or step and their sites by ``file:line``.  The run fails
   if a sync lies in a function that the port's RA001 treats as traced, at
   a line where the port's linter neither reports RA001 nor finds a
   justified ``# repro_torch: ignore[RA001]``;
16. the sharded train step (``launch.mesh``, ``launch.sharding``): 16a
   one step of stablelm-1.6b at full width and depth (B 4 x T 4,096, one
   microbatch, fp32 weights and AdamW state, bf16 activations, full
   remat) through ``make_train_step`` without rules and through the (1,
   1) ("data", "model") mesh and ``make_rules``, from the same seed and
   batch: loss, gradients and updated weights equal bit for bit; 16b the
   same step on a (2, 1) mesh of two processes sharing the card over
   gloo (``mesh.spawn``), each rank drawing the global weights from the
   seed and keeping its slice: each rank's gradient slices (read from
   16a's gradients saved in the checkpoint format, ``restore(shardings=)``)
   and the loss within 3e-2 x max (the models' bar at bf16 activations),
   the flash launches of the sharded step, each rank's step ms (the
   first step: gloo's connections are made in it), peak memory, the
   payload of each collective and the syncs of the step beside the
   one-device step's ms and the nvidia-smi line; 16c mamba2-1.3b at 2 layers on the same mesh against
   its (1, 1) step, every Mamba-2 layer through the SSD kernels; 16d the
   multi-workflow fleet (``online.fleet``, no kernel, float64) in the same
   two ranks: 64 workflows of phase 10a's big point (T 1,000 x N 64, 1,024
   observations a workflow a tick, with bias decay and empirical-Bayes
   pooling), sharded over the (2, 1) and (1, 2) ("wf", "task") meshes,
   predicted and ticked 4 times; each rank's slices of every output and
   leaf, and ``fleet_gather``'s whole matrices, within 1e-12 of the same
   ticks of the one-process card fleet, which the parent runs before the
   spawn; printed: a tick's host and CUDA-event ms, its collective payload
   and calls, the gather's ms and bytes, peak memory, bit for bit or not;
   16e (after 16d, in the same two ranks) MoE over groups and experts:
   qwen3-moe-30b-a3b at full width (d_model 2,048, 128 experts, top-8,
   expert d_ff 768, vocab 151,936) and TRAIN_LAYERS layer, fp32 weights
   and bf16 activations, one step of 4 x 4,096 tokens at ``moe_groups``
   2 (S 8,192, C 640) on the (2, 1) mesh (a group a rank) and the (1, 2)
   mesh (64 experts and 16 attention heads a rank, the experts' outputs
   all-gathered over "model"), each rank's loss and gradient slices
   within 3e-2 x max of the one-process card step at the same groups,
   which the parent saves before the spawn; the (1, 2) mesh at float32
   activations against a float32 step (``P16_MOE_RUNS``: at bf16 the split
   attention moves the router's choice for a few tokens), and at bf16
   measured only; printed: each rank's step ms and peak, its gathered
   bytes (expert leaves and the rest), its exchange bytes, the tokens
   its router sent elsewhere than one process's, the flash launches, the
   worst gradient leaf, bit for bit or not (measured only); 16f (after 16e, in the same two ranks) tensor-parallel training
   on the (1, 2) mesh, each rank holding, gathering and computing its
   "model" slices: stablelm-1.6b at full width and depth, qwen2-7b at full width and one layer (14 query and 2 KV heads a
   rank, V/2 of each chunk's logits) and mamba2-1.3b at 2 layers (32
   SSM heads a rank, the gated norm's sum both ways), at unit score
   variance, each against its one-process step, which the parent saves
   before the spawn: each rank's loss and gradient slices within 3e-2 x
   max, its
   flash and SSD launches a step's, no parameter gathered for the dense
   configs and only the Mamba-2 in_proj and conv leaves ("all_gather_model")
   for mamba2; printed: step ms, peak, gathered bytes and tensor-parallel
   collectives by kind, launches.  Its census, after the spawn in this
   process: the same three steps traced on ``meta`` tensors as rank 0 of
   the (1, 2) mesh over a fake process group of two
   (``launch.dryrun.fake_group``; ``p16f_census``), their calls and
   payload bytes by kind equal to what both gloo ranks counted on the
   card; printed: the census's ring-model wire bytes by op beside the
   ranks' measured steps.
17. serving on a ("data", "model") mesh (``make_prefill_step`` /
   ``make_decode_step`` and ``ServeLoop`` with ``rules`` and ``mesh``):
   17a the flash kernel at qwen2-7b's head counts on a rank of tp 2 (14
   query heads, 2 KV heads, D 128) and the SSD kernel at mamba2-1.3b's
   (32 heads), every prefill and decode call of their serve batches,
   against the plain versions, and the flash decode calls of 17d's ranks
   (28 query and 4 KV heads over a rank's part of the cache, at its local
   kv_len and offset) with their row lse; 17b the one-process serve on
   the card of
   qwen2-7b (28 layers, bf16 activations), mamba2-1.3b (48 layers at
   float32 activations: at bf16 one process's serve of 2 rows lies ~0.1
   x max of the logits from its serve of 4; and 2
   layers at bf16) at full width with bf16 weights (seed 0, attention at
   unit score variance as in phase 6: at the init's scores 28 layers
   carry any rounding difference to the size of the logits), 8 requests
   of 4-16 prompt tokens and 12 new tokens (seed 0), greedy, its tokens
   and logits saved, and its serve of each batch's first two rows (how
   far a change of batch shape alone moves them, printed; for qwen2-7b
   one batch's, through cuBLAS's order of sums for ``wk`` at 26 rows:
   ``scripts/serve_mesh_probe_torch.py``); 17c two gloo processes
   sharing the card serve them, qwen2-7b on the (1, 2) and (2, 1) meshes
   and mamba2-1.3b on (1, 2), each rank holding its serving copies of
   the weights and caches, the 17b tokens fed back: each rank's logits
   within 3e-2 x max of 17b's at every step, its flash and SSD launches
   (counted from 0 over that serve) those of its forwards, a decode
   step's collectives 2 x n_layers "tp_sum" (mamba2: n_layers "tp_sum"
   and "norm_sum"), one "embed_sum" and one "argmax" at tp 2 and none at
   tp 1, its weights and caches at most 0.55 of one process's at tp 2;
   then the queue served again by the rank's ``ServeLoop`` itself;
   printed: per rank the weights and caches held, prefill and decode step
   ms, peak memory, the collectives by kind, greedy tokens equal to 17b's
   (measured only).  17d, in 17c's spawn: qwen2-7b whole on (1, 2) with
   its KV caches split by sequence over "model" (``P17_CP``:
   context-parallel decode, each rank holding half of every layer's
   positions and attending all 28 query heads over them, the partial rows
   merged by log-sum-exp), teacher-forced, held to 17b at 3e-2 x max, a
   rank's K/V cache exactly half the whole at its length (the length
   rounded up to whole parts, ``sharding.cache_len``) and a decode step's
   collectives 17c's plus one "cp_q" and one "cp_merge" a layer.  Their
   census, after the spawn in this process: qwen2-7b's (1, 2) serves
   without and with the rule traced on ``meta`` tensors as rank 0 over a
   fake process group of two (``p17_census``: every batch's prefill,
   greedy token and decode steps), the serve's and its last decode
   step's calls and payload bytes by kind equal to what both gloo ranks
   counted; printed: the wire bytes by op beside the ranks' decode step.

Every top-level phase's seconds are printed as it ends, and their table
before the last lines.

The last lines are a ``kernels`` JSON object (phase 16's and 17's
launches in each kernel's ``launches_by_path``), the card's nvidia-smi
line and ``{"ok":
true, "device": {...}}``; the full report goes to
``build/reports/chip_smoke.json``.
"""
import gc
import json
import math
import os
import statistics
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

sys.path.insert(0, str(SRC))
try:
    # the card's dense bf16 peak (FLOP/s) and HBM rate (bytes/s): the H100
    # SXM's data-sheet figures, from the port's roofline (one source)
    from repro_torch.analysis.roofline import HBM_BW as HBM_BYTES
    from repro_torch.analysis.roofline import PEAK_FLOPS as BF16_FLOPS
except ImportError:          # without the port's sources: main() says so
    BF16_FLOPS = HBM_BYTES = None
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


class PhaseClock:
    """The seconds of each top-level phase: ``clock(name)`` ends the phase
    running (printing its seconds) and starts ``name`` (None: none)."""

    def __init__(self):
        self.name, self.start, self.seconds = None, time.time(), {}

    def __call__(self, name):
        now = time.time()
        if self.name is not None:
            self.seconds[self.name] = now - self.start
            print(f"  [{self.name}: {now - self.start:.1f} s]", flush=True)
        self.name, self.start = name, now


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernel against its plain version
# ---------------------------------------------------------------------------
def serve_cases(batch_shapes, Hq, D, Hkv=None, label="", per_row=False):
    """Every attention call of a main path: per batch (B, T, steps), the
    prefill over the cache of T + steps positions and each decode step.
    ``per_row``: the offset goes in as a tensor of one offset per batch row
    (a tuple here), as the M-RoPE model passes it."""
    Hkv = Hq if Hkv is None else Hkv
    cases = []

    def off(o, B):
        return (o,) * B if per_row else o
    for B, T, steps in batch_shapes:
        Sk = T + steps
        cases.append((f"serve {label}prefill B{B} T{T}", B, Hq, Hkv, T, Sk,
                      D, True, T, off(0, B), "cache"))
        for kv in range(T + 1, Sk + 1):
            cases.append((f"serve {label}decode B{B} kv_len={kv}/{Sk}", B,
                          Hq, Hkv, 1, Sk, D, True, kv, off(kv - 1, B),
                          "cache"))
    return cases


def kernel_cases(batch_shapes, serve_heads, serve_head_dim, more_serve=()):
    """(name, B, Hq, Hkv, Sq, Sk, D, causal, kv_len, q_offset, layout); a
    tuple ``q_offset`` is one offset per batch row.  ``more_serve``: the
    serve cases of the other main paths (``serve_cases``)."""
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
    for D in (32, 64, 128, 160):          # every head dim x row tiling
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
            # context-parallel decode: a rank's part with no key yet, a
            # causal offset before its part, per-row offsets (one before)
            ("decode kv_len=0", 2, 4, 2, 1, 64, 64, True, 0, 0),
            ("decode q_offset=-3", 2, 4, 2, 1, 64, 64, True, 40, -3),
            ("per-row decode GQA7 D128 splits, one offset -5", 4, 28, 4, 1,
             4096, 128, True, 4096, (4095, 100, -5, 2000)),
            ("decode empty splits q_offset=300", 1, 2, 2, 1, 4096, 64, True,
             4096, 300),
            ("decode Sk4096 splits", 1, 2, 2, 1, 4096, 64, True, 4096, 4095),
            ("decode MQA D128 splits", 2, 8, 1, 1, 4096, 128, True, 3000,
             2999),
            ("decode GQA8 D32 bidir", 1, 16, 2, 1, 1000, 32, False, None, 0),
            ("decode GQA12 two head chunks", 1, 24, 2, 1, 500, 64, True, 500,
             499),
            # head dim 160 (stablelm-12b): 105 KB tiles on the tensor
            # cores; the float32 decode on its 2-stage ring
            ("prefill D160 Sq70 GQA4", 1, 8, 2, 70, 70, 160, True, None, 0),
            ("chunk D160 q_offset=160", 2, 8, 2, 130, 300, 160, True, 290,
             160),
            ("prefill D160 Sk90 kv_len=80 bidir", 1, 4, 4, 33, 90, 160,
             False, 80, 0),
            ("decode D160 kv_len=1", 2, 4, 2, 1, 64, 160, True, 1, 0),
            ("decode D160 GQA4 splits", 1, 32, 8, 1, 4096, 160, True, 4096,
             4095),
            ("decode D160 MQA empty splits q_offset=300", 1, 8, 1, 1, 4096,
             160, True, 3000, 300),
            ("decode GQA7 D128 (qwen2)", 2, 28, 4, 1, 700, 128, True, 700,
             699),
            # one offset per batch row (the M-RoPE model's mask)
            ("per-row decode GQA7 D128", 3, 28, 4, 1, 600, 128, True, 595,
             (0, 200, 594)),
            ("per-row prefill D64", 3, 8, 2, 33, 200, 64, True, 195,
             (0, 66, 162)),
            ("per-row decode D160 splits", 3, 8, 2, 1, 4096, 160, True, 4091,
             (0, 1365, 4090)),
            ("per-row chunk D160", 3, 8, 2, 70, 300, 160, True, 295,
             (0, 100, 225)),
            # qwen3-moe's GQA 8 and llama4's GQA 5 at D 128 (5 query heads
            # fill a decode block of 8 rows in part)
            ("prefill D128 GQA8", 1, 32, 4, 70, 70, 128, True, None, 0),
            ("chunk D128 GQA8 q_offset=100", 2, 32, 4, 40, 200, 128, True,
             140, 100),
            ("decode D128 GQA8 splits", 2, 32, 4, 1, 4096, 128, True, 4096,
             4095),
            ("prefill D128 GQA5", 1, 40, 8, 70, 70, 128, True, None, 0),
            ("chunk D128 GQA5 q_offset=100", 2, 40, 8, 40, 200, 128, True,
             140, 100),
            ("decode D128 GQA5 splits", 2, 40, 8, 1, 4096, 128, True, 4096,
             4095),
            ("decode D128 GQA5 kv_len=1", 2, 40, 8, 1, 64, 128, True, 1, 0),
            # seamless: non-causal D 64 H 16, Sq = Sk, Sq < Sk, Sq 1
            ("bidir D64 H16 Sq256 Sk256", 1, 16, 16, 256, 256, 64, False,
             None, 0),
            ("cross D64 H16 Sq13 Sk256", 2, 16, 16, 13, 256, 64, False, None,
             0),
            ("cross decode D64 H16 Sk4096", 2, 16, 16, 1, 4096, 64, False,
             None, 0)]:
        cases.append((name, B, Hq, Hkv, Sq, Sk, D, causal, kv_len, q_off,
                      "bhsd"))
    # the serve shapes: (B, S, H, D) over views of a stacked cache
    return (cases + serve_cases(batch_shapes, serve_heads, serve_head_dim)
            + list(more_serve))


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


def lse_errs(torch, lse, ref, tol):
    """(max |difference| over the rows that see a key, within ``tol`` +
    ``tol`` |ref| there and -inf exactly where ``ref`` is)."""
    empty = torch.isinf(ref)
    diff = (lse - ref)[~empty].abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = (bool(torch.equal(torch.isinf(lse), empty))
          and bool((diff <= tol + tol * ref[~empty].abs()).all()))
    return err, ok


def run_kernel_checks(torch, kernel, mha, attention_ref, cases):
    """Each case against the plain version in float32 and bf16; a decode
    call (Sq 1) also with its row lse, against ``lse_ref``, its output
    with the lse the same bits as without."""
    from repro_torch.kernels.flash_attention import lse_ref
    results = []
    for i, (name, B, Hq, Hkv, Sq, Sk, D, causal, kv_len, offset,
            layout) in enumerate(cases):
        q_off = (torch.tensor(offset, dtype=torch.int32, device="cuda")
                 if isinstance(offset, tuple) else offset)
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
            lse_err = None
            if Sq == 1:
                if layout == "cache":
                    out_l, lse = mha(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     kv_len=kv_len, q_offset=q_off,
                                     return_lse=True)
                    out_l = out_l.transpose(1, 2)
                else:
                    out_l, lse = kernel.flash_attention(
                        q, k, v, causal=causal, kv_len=kv_len,
                        q_offset=q_off, return_lse=True)
                lse_err, lse_ok = lse_errs(torch, lse, lse_ref(
                    q, k, causal=causal, kv_len=kv_len, q_offset=q_off), tol)
                ok = ok and lse_ok and bool(torch.equal(out_l, out))
            path, splits = kernel.plan(
                dtype, B, Hq, Hkv, Sq, Sk if kv_len is None else
                max(kv_len, 0), kernel.sm_count(q.device.index))
            print(f"  {name:42s} {dname:9s} {path:12s} splits {splits:3d} "
                  f"max_abs_err {err:.3e}"
                  + ("" if lse_err is None else f" lse {lse_err:.3e}")
                  + f" tol {tol:g} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"kernel disagrees with its plain version: {name} "
                      f"{dname}, max_abs_err {err}, lse {lse_err}")
            results.append({"case": name, "dtype": dname, "max_abs_err": err,
                            "lse_max_abs_err": lse_err,
                            "path": path, "splits": splits,
                            "serve": layout == "cache"})
    return results


# ---------------------------------------------------------------------------
# Phase 3b: the SSD kernel against its plain version
# ---------------------------------------------------------------------------
def ssd_cases(batch_shapes, cfg, label="", oracle=True):
    """(name, B, T, H, P, G, N, chunk, layout, state0): with ``oracle`` the
    shapes of tests/test_kernels.py, then ``cfg``'s full width (named with
    ``label``): initial states, its main path's prefills, a 4k prefill."""
    s = cfg.ssm
    H, P, G, N = (s.n_ssm_heads(cfg.d_model), s.head_dim, s.n_groups,
                  s.d_state)
    cases = [(f"oracle B{B} T{T} H{Hh} P{Pp} G{Gg} N{Nn} chunk {c}",
              B, T, Hh, Pp, Gg, Nn, c, "bthp", None)
             for B, T, Hh, Pp, Gg, Nn, c in [      # tests/test_kernels.py
                 (1, 32, 2, 8, 1, 8, 8),
                 (2, 64, 4, 16, 2, 16, 16),
                 (1, 50, 4, 8, 1, 8, 16)]] if oracle else []
    cases.append((f"state0 B2 T50 H4 P16 G2 N{N if N != 128 else 16} "
                  "chunk 16", 2, 50, 4, 16, 2, N if N != 128 else 16, 16,
                  "bthp", "random"))
    cases.append((f"state0 {label}full width B2 T129", 2, 129, H, P, G, N,
                  s.chunk, "conv", "random"))  # two chunks, the second of 1
    cases.append((f"state0 {label}full width B1 T1000", 1, 1000, H, P, G, N,
                  s.chunk, "conv", "random"))  # 8 chunks, ragged
    # the main path's prefills: views of the conv output, zero state0
    for B, T, _ in batch_shapes:
        cases.append((f"serve {label}prefill B{B} T{T}", B, T, H, P, G, N,
                      s.chunk, "conv", "zeros"))
    cases.append((f"{label}prefill 4k B1 T4096", 1, 4096, H, P, G, N,
                  s.chunk, "conv", "zeros"))   # 32 chunks: the carry
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
            print(f"  {name:46s} {dname:9s} {path:8s} "
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
    """The parameters with every ``wq`` and ``wk`` scaled by
    head_dim**-0.5 (in the hybrid, those of the shared attention block; in
    a MoE unit, each layer's; in the encoder-decoder, the encoder's and
    the decoder's self- and cross-attention).  A new tree: ``params`` is
    left as it is.

    The init rule (std 1/sqrt(shape[-2]), the heads dim of ``wq``) gives
    attention scores of std d_model / n_heads = 64 here, so softmax is
    near one-hot and rounding differences grow layer by layer until 24
    random layers carry them to the size of the logits.  At unit score
    std the model is well conditioned, and a card-vs-CPU gap at full depth
    measures the code, not the init."""
    s = cfg.resolved_head_dim() ** -0.5

    def scale(tree):
        return {k: (scale(v) if isinstance(v, dict)
                    else v * s if k in ("wq", "wk") else v)
                for k, v in tree.items()}
    return scale(params)


def model_reference_check(torch, build_model, cfg, params, B, T, steps, tol,
                          label, cache_dtype=None, extra=None,
                          step_extra=None, check_tol=True):
    """Prefill then teacher-forced decode steps with the same weights on the
    card (kernel) and on the CPU (plain attention); logits must agree to
    ``tol`` x max|logit| (with ``check_tol`` False the gap is only
    measured).  ``extra``: more prefill inputs (CPU tensors: vision
    embeddings, positions), which add to the cached length;
    ``step_extra(s)``: more inputs of decode step s.  Greedy tokens are not
    compared: with random weights the largest logit may change on
    rounding."""
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, T), generator=gen)
    forced = torch.randint(0, cfg.vocab, (steps, B, 1), generator=gen)
    cache_kw = {} if cache_dtype is None else {"cache_dtype": cache_dtype}
    extra = extra or {}
    n = T + (extra["vision_embeds"].shape[1] if "vision_embeds" in extra
             else 0)
    logits, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = to_device(params, dev)
        caches = model.init_caches(B, n + steps, device=dev, **cache_kw)
        with torch.inference_mode():
            out, caches = model.prefill(
                p, {"tokens": prompt.to(dev),
                    **{k: v.to(dev) for k, v in extra.items()}}, caches)
            outs = [out.float().cpu()]
            for s in range(steps):
                more = step_extra(s) if step_extra else {}
                out, caches = model.decode(
                    p, {"tokens": forced[s].to(dev),
                        **{k: v.to(dev) for k, v in more.items()}},
                    caches, n + s)
                outs.append(out.float().cpu())
        logits[dev] = outs
        del p, caches
        seconds[dev] = time.perf_counter() - t0
    worst = 0.0
    for a, b in zip(logits["cuda"], logits["cpu"]):
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite logits")
        rel = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        check(rel <= tol or not check_tol,
              f"{label}: card vs CPU logits differ by {rel:.3e} "
              f"x max|logit| (tol {tol})")
    print(f"  {label}: card vs CPU logits max err {worst:.3e} x max|logit| "
          f"({'tol' if check_tol else 'measured only; the bar is'} {tol}; "
          f"card {seconds['cuda']:.1f} s, CPU {seconds['cpu']:.1f} s)",
          flush=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 5: profile of decode steps; phase 7: kernel timing
# ---------------------------------------------------------------------------
PROFILE_STEPS = 4


def _device_us(event, inclusive: bool) -> float:
    name = "device_time_total" if inclusive else "self_device_time_total"
    legacy = "cuda_time_total" if inclusive else "self_cuda_time_total"
    return float(getattr(event, name, getattr(event, legacy, 0.0)))


def profile_steps(torch, fn, steps, marker, label, launches, parts=()):
    """``fn(s)`` for s in range(steps) under torch.profiler: wall and
    device-busy time per step (one stream, so device events do not
    overlap), kernels per step, the device time and launches per step of
    the kernels whose name holds ``marker`` (and, under ``parts_ms``, of
    those whose name holds each of ``parts``), the top kernels and
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
           "parts_ms": {part: sum(ms for k, ms, _ in kernels if part in k)
                        for part in parts},
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


def decoder_shapes(serve_batch):
    """(name, B, Sq, Sk, kv_len, q_offset, causal) of a decoder's timings:
    a main path's first batch (its prefill and its last decode step), a
    4k prefill and a 32k decode."""
    B0, T0, steps0 = serve_batch
    Sk0 = T0 + steps0
    return [("serve prefill", B0, T0, Sk0, T0, 0, True),
            ("serve decode", B0, 1, Sk0, Sk0, Sk0 - 1, True),
            ("prefill 4k", 1, 4096, 4096, 4096, 0, True),
            ("decode 32k", 8, 1, 32768, 32768, 32767, True)]


def run_timings(torch, kernel, mha, attention_ref, sdpa, serve_batch, H,
                D, Hkv=None, label="", shapes=None):
    """bf16 at ``shapes`` (default ``decoder_shapes(serve_batch)``), at
    ``H`` query and ``Hkv`` kv heads of ``D``; shapes named with
    ``label``.  At each shape the kernel and SDPA are first held against
    the plain version (bf16 bar), and the path the launcher takes is
    recorded.  A decode shape (Sq 1) is also timed with the row lse and
    its lse held to ``lse_ref``."""
    from repro_torch.kernels.flash_attention import lse_ref
    Hkv = H if Hkv is None else Hkv
    shapes = decoder_shapes(serve_batch) if shapes is None else shapes
    rows = []
    for name, B, Sq, Sk, kv_len, q_off, causal in shapes:
        name = label + name
        dtype = torch.bfloat16
        q, k, v = make_inputs(torch, B, H, Hkv, Sq, Sk, D, dtype, "cache", 7)
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
        if Hkv != H:
            kw["enable_gqa"] = True

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
        path, splits = kernel.plan(dtype, B, H, Hkv, Sq, kv_len,
                                   kernel.sm_count(q.device.index))
        b_ms, b_by = bound(B, H, Hkv, Sq, D, causal, kv_len, q_off, 2,
                           BF16_FLOPS)
        row = {"shape": name, "B": B, "H": H, "Hkv": Hkv, "Sq": Sq, "Sk": Sk,
               "kv_len": kv_len, "q_offset": q_off, "D": D, "dtype": "bfloat16",
               "path": path, "splits": splits, "max_abs_err": err,
               "ms": device_ms(torch, kern),
               "plain_ms": device_ms(torch, plain),
               "library_ms": device_ms(torch, lib),
               "host_ms": host_ms(torch, kern),
               "plain_host_ms": host_ms(torch, plain),
               "library_host_ms": host_ms(torch, lib),
               "bound_ms": b_ms, "bound_by": b_by}
        if Sq == 1:
            # the decode with its row lse (context-parallel decode's call),
            # held to lse_ref, timed beside the call without it, in turns
            def kern_lse():
                return mha(qs, ks, vs, causal=causal, kv_len=kv_len,
                           q_offset=q_off, return_lse=True)
            lse_err, lse_ok = lse_errs(torch, kern_lse()[1], lse_ref(
                q, k, causal=causal, kv_len=kv_len, q_offset=q_off), tol)
            check(lse_ok, f"the decode lse disagrees with lse_ref at {name}: "
                          f"max_abs_err {lse_err}")
            row.update(lse_max_abs_err=lse_err,
                       lse_ms=device_ms(torch, kern_lse),
                       lse_ms_again=device_ms(torch, kern_lse),
                       ms_again=device_ms(torch, kern))
            print(f"  {name:27s} row lse: max_abs_err {lse_err:.3e} (tol "
                  f"{tol:g}); device, in turns: without {row['ms']:9.4f} ms,"
                  f" with the lse {row['lse_ms']:9.4f} and "
                  f"{row['lse_ms_again']:9.4f} ms, without "
                  f"{row['ms_again']:9.4f} ms", flush=True)
        print(f"  {name:27s} {path} (splits {splits}), max_abs_err "
              f"{err:.3e} (tol {tol:g})", flush=True)
        print(f"  {name:27s} device: kernel {row['ms']:9.4f} ms  plain "
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
                    cfg, serve_batch, label=""):
    """bf16 x/B/C as the model passes them (views of the conv output, zero
    state0), at a main path's first prefill and at a 4k prefill, at
    ``cfg``'s widths; shapes named with ``label``.  At each shape the
    kernel is first held against the plain version (``SSD_TOL``), and its
    path and its device launches per call, as a captured CUDA graph records
    them, are recorded."""
    s = cfg.ssm
    H, P, G, N = (s.n_ssm_heads(cfg.d_model), s.head_dim, s.n_groups,
                  s.d_state)
    rows = []
    for name, B, T in [(label + "serve prefill", serve_batch[0],
                        serve_batch[1]),
                       (label + "prefill 4k", 1, 4096)]:
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
        print(f"  {name:20s} B{B} T{T}: {pl.path}, {len(launched)} launches "
              "a call (as the driver records them), "
              f"y err {rel_y:.3e}, state err {rel_st:.3e} x max "
              f"(tol {SSD_TOL:g})", flush=True)
        print(f"  {name:20s} B{B} T{T}: device: kernel {row['ms']:9.4f} ms "
              f" plain {row['plain_ms']:9.4f} ms  bound {b_ms:9.4f} ms "
              f"({b_by}); host per call: kernel {row['host_ms']:9.4f} ms  "
              f"plain {row['plain_host_ms']:9.4f} ms", flush=True)
        print(f"  {name:20s} B{B} T{T}: device ms per launch by kernel "
              "(torch.profiler): " + ", ".join(
                  f"{k} {v:.4f}" if v is not None else f"{k} not recorded"
                  for k, v in row["kernels_ms"].items()), flush=True)
        rows.append(row)
        del x, dt, a, B_, C_, s0
        torch.cuda.empty_cache()
    return rows


def prefill_decode_consistency(torch, build_model, cfg, params, B, T, tol,
                               label, device="cuda", check_tol=True,
                               extra=None):
    """The last logits of a prefill over T + 1 tokens against a prefill
    over T tokens and one decode step, to ``tol`` x max|logit| (with
    ``check_tol`` False only measured).  With T = chunk the long prefill
    ends in a chunk of one token, so on the card the kernel's ragged edge
    and carried state meet the decode recurrence; on the CPU
    (``device="cpu"``) the same check runs without the kernel and shows
    how far fp32 rounding alone moves it.  ``extra``: more prefill inputs
    (the encoder-decoder's source frames), the same for both prefills."""
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = to_device(params, device)
    extra = {k: v.to(device) for k, v in (extra or {}).items()}
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (B, T + 1), generator=gen).to(device)
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": toks, **extra},
                                model.init_caches(B, T + 1, device=device,
                                                  cache_dtype=cfg.dtype))
        caches = model.init_caches(B, T + 1, device=device,
                                   cache_dtype=cfg.dtype)
        _, caches = model.prefill(params, {"tokens": toks[:, :T], **extra},
                                  caches)
        dec, _ = model.decode(params, {"tokens": toks[:, T:]}, caches, T)
    full, dec = full[:, -1].float(), dec[:, -1].float()
    check(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
          f"{label}: non-finite logits")
    rel = float((full - dec).abs().max() / full.abs().max())
    print(f"  {label}, {device}: prefill {T + 1} against prefill {T} + 1 "
          f"decode step: {rel:.3e} x max|logit| "
          f"({'tol' if check_tol else 'measured only; the bar is'} {tol}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    check(rel <= tol or not check_tol,
          f"{label}, {device}: {rel:.3e} x max|logit| (tol {tol})")
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
# Phase 11: the other serving configs at full width
# ---------------------------------------------------------------------------
#: the serving configs of phase 11, in the order they are served
SERVE_ARCHS = ["qwen2-7b", "qwen2-vl-7b", "stablelm-12b", "starcoder2-15b",
               "zamba2-1.2b"]
#: qwen2-vl-7b's vision check: a patch grid of VISION_GRID x VISION_GRID
VISION_GRID = 8


def vision_inputs(torch, cfg, B, T):
    """``B`` rows of VISION_GRID**2 vision embeddings (CPU generator, seed
    6) then ``T`` text tokens, with Qwen2-VL's (temporal, h, w) ids: the
    grid at temporal 0, then text whose three ids all start one past the
    grid's largest (row b's start moved 3 ids later per row, so the rows'
    decode offsets differ).  Returns (prefill extras, step_extra)."""
    g = VISION_GRID
    gen = torch.Generator().manual_seed(6)
    vis = torch.randn(B, g * g, cfg.d_model, generator=gen)
    i = torch.arange(g * g)
    grid = torch.stack([torch.zeros_like(i), i // g, i % g], -1)
    starts = g + 3 * torch.arange(B)
    text = (starts[:, None] + torch.arange(T))[..., None].expand(B, T, 3)
    pos = torch.cat([grid[None].expand(B, g * g, 3), text], 1)

    def step(s):
        return {"positions": (starts + T + s)[:, None, None].expand(B, 1, 3)}
    return {"vision_embeds": vis, "positions": pos.contiguous()}, step


def count_drops(moe, loop):
    """Wrap ``moe.route`` and ``loop.prefill`` so that each prefill records,
    per MoE layer, the (token, k) assignments its router dropped past the
    capacity (a device tensor each: nothing is read until ``read``).
    Returns (read, restore): ``read()`` gives one list of per-layer counts
    per prefill."""
    route, prefill = moe.route, loop.prefill
    counts, inside = [], [False]

    def counting_route(*args):
        out = route(*args)
        if inside[0]:
            counts[-1].append((~out[3]).sum())
        return out

    def counting_prefill(*args):
        inside[0] = True
        counts.append([])
        try:
            return prefill(*args)
        finally:
            inside[0] = False

    def restore():
        moe.route, loop.prefill = route, prefill
    moe.route, loop.prefill = counting_route, counting_prefill
    return (lambda: [[int(c) for c in layers] for layers in counts]), restore


def serve_config(torch, serve, kernel, ssd_kernel, build_model, cfg,
                 n_requests, max_new, batch_shapes, cut=False):
    """One config of phase 11 or 12: served at full width with its launch
    counts, a profile of its decode steps, and its card-against-CPU
    checks; the model is freed before it returns.  A published config
    goes through ``serve.main``; a ``cut`` one (phase 12's MoE configs:
    bf16 weights, fewer layers) through ``ServeLoop`` and ``serve_queue``,
    the two calls ``main`` makes, and prints the assignments each
    prefill's routers dropped."""
    arch, hybrid = cfg.arch, cfg.family == "hybrid"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    drops = None
    if cut:
        from repro_torch.models import moe
        t0 = time.perf_counter()
        loop = serve.ServeLoop(cfg)
        torch.cuda.synchronize()
        print(f"  {arch}: {cfg.param_count():,} parameters in "
              f"{str(cfg.param_dtype).split('.')[1]} drawn on the card in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
        read_drops, restore = count_drops(moe, loop)
        kernel.LAUNCHES = ssd_kernel.LAUNCHES = 0
        try:
            summary = serve.serve_queue(loop, serve.make_requests(
                cfg.vocab, n_requests, max_new))
        finally:
            flash, ssd_n = kernel.LAUNCHES, ssd_kernel.LAUNCHES
            restore()
        drops = read_drops()
    else:
        kernel.LAUNCHES = ssd_kernel.LAUNCHES = 0
        summary = serve.main(["--arch", arch, "--requests", str(n_requests),
                              "--max-new", str(max_new)])
        flash, ssd_n = kernel.LAUNCHES, ssd_kernel.LAUNCHES
    loop = summary.pop("loop")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    prefills = summary["prefills"]
    forwards = prefills + summary["decode_steps"]
    per_forward = (cfg.n_layers // cfg.hybrid_attn_every if hybrid
                   else cfg.n_layers)
    ssd_want = cfg.n_layers * prefills if hybrid else 0
    print(f"  {arch}: requests {summary['requests']}, tokens "
          f"{summary['tokens']}, wall {summary['seconds']:.3f} s, median "
          f"decode step {summary['median_step_ms']:.3f} ms, peak memory "
          f"{peak_gb:.2f} GB of {card_gb:.2f}, flash launches {flash} = "
          f"{per_forward} x {forwards} forwards, SSD launches {ssd_n} = "
          f"{ssd_want}", flush=True)
    check_served(summary, cfg, n_requests, max_new)
    check(loop.batch_shapes == batch_shapes,
          f"{arch}: served batches {loop.batch_shapes}, checked "
          f"{batch_shapes}")
    check(flash > 0 and flash == per_forward * forwards,
          f"{arch}: flash kernel launched {flash} times, expected "
          f"{per_forward} x {forwards}")
    check(ssd_n == ssd_want, f"{arch}: SSD kernel launched {ssd_n} times, "
                             f"expected {ssd_want}")
    check(peak_gb < card_gb, f"{arch}: peak memory {peak_gb:.2f} GB")
    if drops is not None:
        m = cfg.moe
        for (B, T, _), layers in zip(batch_shapes, drops):
            check(len(layers) == cfg.n_layers // m.every,
                  f"{arch}: {len(layers)} routers ran in a prefill")
            print(f"  {arch}: prefill B{B} T{T}: the routers dropped "
                  f"{sum(layers)} of {B * T * m.top_k * len(layers)} (s, k) "
                  f"assignments over {len(layers)} MoE layers (capacity "
                  f"{moe._capacity(B * T, cfg)} per expert; most in a layer "
                  f"{max(layers)}, layers with a drop "
                  f"{sum(c > 0 for c in layers)})", flush=True)
    print(f"  {arch}: profile of decode steps (torch.profiler)", flush=True)
    prof = profile_serve(torch, loop, kernel, "flash_fwd", "flash",
                         *batch_shapes[0][:2])
    f32, c32 = cfg.with_(dtype=torch.float32), {"cache_dtype": torch.float32}
    errs = {}
    if hybrid:
        # the 2 layers of the tail, and one super-unit (6 Mamba-2 layers and
        # the shared block): the cuts that hold no and one attention
        errs["2 layers"] = model_reference_check(
            torch, build_model, f32.with_(n_layers=2),
            first_layers(loop.params, 0), 2, 6, 2, 1e-4,
            f"{arch} full width 2 layers (the tail) float32", **c32)
        one_unit = {k: v for k, v in first_layers(loop.params, 1).items()
                    if k != "tail_blocks"}
        errs["6 layers"] = model_reference_check(
            torch, build_model, f32.with_(n_layers=cfg.hybrid_attn_every),
            one_unit, 2, 6, 2, 1e-4,
            f"{arch} full width 6 layers (one super-unit) float32", **c32)
        # two super-units and the tail: the shared block read by a second
        # unit over its own cache, at a third of the 38 layers' CPU time;
        # the card's prefill-against-decode check keeps all 38
        every = cfg.hybrid_attn_every
        deep = f32.with_(n_layers=cfg.n_layers
                         - (cfg.n_layers // every - 2) * every)
        scaled = unit_score_scale(loop.params, cfg)
        two = unit_score_scale(first_layers(loop.params, 2), cfg)
        what = f"{arch} full width {{}} layers float32, unit score scale"
        errs[f"{deep.n_layers} layers, unit score scale"] = \
            model_reference_check(torch, build_model, deep, two, 2, 6, 2,
                                  1e-4, what.format(deep.n_layers), **c32)
        # on the card, all 38 layers (the CPU's run of the same check at
        # 14 layers was cut for time)
        errs["prefill 129 vs 128 + decode, unit score scale, cuda"] = \
            prefill_decode_consistency(
                torch, build_model, f32, scaled, 2, cfg.ssm.chunk, 1e-4,
                what.format(f32.n_layers), device="cuda")
        del scaled, two
    elif cfg.family == "moe" and cfg.moe.every > 1:
        # llama4's unit: its card-against-CPU check (a 37 GB CPU copy of
        # every expert, 33.5 s of CPU time) was cut for time; the smoke
        # config is held to the JAX package on the CPU
        # (tests/test_torch_moe.py) and phase 3 holds its kernel calls
        print(f"  {arch}: card against CPU not run (cut for time)",
              flush=True)
    elif cfg.mrope:
        pass      # the 2 layers are held below, with vision embeddings
    else:
        errs["2 layers"] = model_reference_check(
            torch, build_model, f32.with_(n_layers=2),
            first_layers(loop.params, 2), 2, 6, 2, 1e-4,
            f"{arch} full width 2 layers float32", **c32)
    if cfg.mrope:
        # 70 positions of near one-hot attention: with the init's weights
        # fp32 rounding alone moves the logits to ~1e-4 (the CPU against
        # itself in float64, tests/test_torch_families.py), so the bar is
        # held at unit score variance
        extra, step = vision_inputs(torch, cfg, 2, 6)
        two = f32.with_(n_layers=2)
        what = (f"{arch} full width 2 layers float32, {VISION_GRID ** 2} "
                "vision embeddings and M-RoPE positions, per-row decode "
                "offsets")
        errs["2 layers, vision, unit score scale"] = model_reference_check(
            torch, build_model, two,
            unit_score_scale(first_layers(loop.params, 2), cfg), 2, 6, 2,
            1e-4, what + ", unit score scale", extra=extra, step_extra=step,
            **c32)
    del loop, summary["done"]
    torch.cuda.empty_cache()
    return {"serve": summary, "batch_shapes": batch_shapes,
            "peak_memory_gb": peak_gb, "card_memory_gb": card_gb,
            "flash_launches": flash, "ssd_launches": ssd_n,
            "forwards": forwards, "profile": prof, "model_rel_err": errs,
            "params": cfg.param_count(), "dropped_per_prefill": drops}


# ---------------------------------------------------------------------------
# Phase 12: the MoE configs, the encoder-decoder and the int8 KV cache
# ---------------------------------------------------------------------------
#: phase 12's MoE configs, served in this order
MOE_ARCHS = ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"]
ENCDEC_ARCH = "seamless-m4t-large-v2"
#: 12c: batch, source frames = target prefix, decode steps
ENC_B, ENC_T, ENC_STEPS = 4, 256, 12
#: 12d: qwen2-7b's decode_32k cache (B, positions, kv heads, head dim) and
#: its query heads
KVQ_SHAPE, KVQ_HEADS = (8, 32768, 4, 128), 28
KVQ_TOL = 0.05       # tests/test_kv_quant.py's bar


def moe_cuts(torch, get_config):
    """Phase 12's MoE configs: the JAX package's, with bf16 weights
    (qwen3-moe: 61.1 GB instead of 122) and llama4 cut to one unit of one
    dense and one MoE layer (18.55 B parameters, 37.1 GB)."""
    return {"qwen3-moe-30b-a3b": get_config("qwen3-moe-30b-a3b").with_(
                param_dtype=torch.bfloat16),
            "llama4-maverick-400b-a17b": get_config(
                "llama4-maverick-400b-a17b").with_(
                param_dtype=torch.bfloat16, n_layers=2)}


def encdec_cases(cfg, B, T, steps):
    """Every attention call of 12c's path (distinct shapes once): the
    bidirectional encoder, the decoder's causal self-attention over its
    cache of T + steps, the cross-attention over the T-position cross
    cache (non-causal, no kv_len), then each decode step's self-attention
    and the cross decode."""
    H, D = cfg.n_heads, cfg.resolved_head_dim()
    Sk = T + steps
    cases = [(f"seamless encoder B{B} T{T} bidir", B, H, H, T, T, D, False,
              None, 0, "cache"),
             (f"seamless self prefill B{B} T{T}", B, H, H, T, Sk, D, True, T,
              0, "cache"),
             (f"seamless cross prefill B{B} T{T} Sk{T}", B, H, H, T, T, D,
              False, None, 0, "cache"),
             (f"seamless cross decode B{B} Sk{T}", B, H, H, 1, T, D, False,
              None, 0, "cache")]
    for kv in range(T + 1, Sk + 1):
        cases.append((f"seamless self decode B{B} kv_len={kv}/{Sk}", B, H, H,
                      1, Sk, D, True, kv, kv - 1, "cache"))
    return cases


def first_encdec_layers(params, n):
    """The encoder-decoder's parameters with only the first ``n`` encoder
    and ``n`` decoder layers."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    return {**params, "enc_blocks": cut(params["enc_blocks"]),
            "dec_blocks": cut(params["dec_blocks"])}


def serve_encdec(torch, kernel, shapes, steps_mod, build_model, cfg):
    """12c: the whole encoder-decoder at full width through
    ``make_prefill_step`` / ``make_decode_step`` fed by ``concrete_batch``
    (ENC_T source frames and an ENC_T-token target prefix), ENC_STEPS
    greedy decode steps; flash launches per prefill and per step; a
    profile of decode steps; the card against the CPU at 2 + 2 layers in
    float32; a prefill of T + 1 against T and one decode step on the
    card.  The model is freed before it returns."""
    B, T, steps = ENC_B, ENC_T, ENC_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(0)
    prefill = steps_mod.make_prefill_step(model)
    decode = steps_mod.make_decode_step(model)
    per_prefill = cfg.enc_layers + 2 * cfg.dec_layers
    per_step = 2 * cfg.dec_layers
    batch = shapes.concrete_batch(cfg, "prefill", B, T)
    times, launches, toks = [], [], []
    with torch.inference_mode():
        caches = model.init_caches(B, T + steps, cross_len=T)
        torch.cuda.synchronize()
        kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch, caches)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches.append(kernel.LAUNCHES)
        check(logits.shape == (B, 1, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"{cfg.arch}: prefill logits {tuple(logits.shape)}")
        tok = torch.argmax(logits[:, -1], dim=-1)
        for s in range(steps):
            n0 = kernel.LAUNCHES
            t0 = time.perf_counter()
            tok, logits, caches = decode(params, {"tokens": tok[:, None]},
                                         caches, T + s)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append(kernel.LAUNCHES - n0)
            check(bool(torch.isfinite(logits).all()),
                  f"{cfg.arch}: decode step {s}: non-finite logits")
            toks.append(tok.tolist())
    flash = kernel.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    step_ms = sorted(times)[len(times) // 2]
    print(f"  {cfg.arch}: prefill B{B} (source {T}, target {T}) "
          f"{prefill_ms:.3f} ms, {steps} decode steps, median "
          f"{step_ms:.3f} ms ({B * steps / (sum(times) / 1e3):.1f} tok/s), "
          f"peak memory {peak_gb:.2f} GB of {card_gb:.2f}, flash launches "
          f"{launches[0]} per prefill = {cfg.enc_layers} encoder + "
          f"{cfg.dec_layers} self + {cfg.dec_layers} cross, "
          f"{sorted(set(launches[1:]))} per step", flush=True)
    check(launches[0] == per_prefill,
          f"{cfg.arch}: {launches[0]} flash launches in the prefill, "
          f"expected {per_prefill}")
    check(all(n == per_step for n in launches[1:]),
          f"{cfg.arch}: flash launches per step {launches[1:]}, expected "
          f"{per_step}")
    check(all(0 <= t < cfg.vocab for row in toks for t in row),
          f"{cfg.arch}: tokens out of range")
    check(peak_gb < card_gb, f"{cfg.arch}: peak memory {peak_gb:.2f} GB")

    print(f"  {cfg.arch}: profile of decode steps (torch.profiler)",
          flush=True)
    state = {}
    with torch.inference_mode():
        state["caches"] = model.init_caches(B, T + PROFILE_STEPS,
                                            cross_len=T)
        logits, state["caches"] = prefill(params, batch, state["caches"])
        state["tok"] = torch.argmax(logits[:, -1], dim=-1)

        def run_decode(s):
            state["tok"], _, state["caches"] = decode(
                params, {"tokens": state["tok"][:, None]}, state["caches"],
                T + s)
        prof = {"batch": B, "prompt": T,
                "decode": profile_steps(torch, run_decode, PROFILE_STEPS,
                                        "flash_fwd", "flash",
                                        lambda: kernel.LAUNCHES)}
    del state

    errs = {}
    f32 = cfg.with_(dtype=torch.float32)
    src = shapes.concrete_batch(cfg, "prefill", 2, 6,
                                device="cpu")["src_embeds"]
    # six near one-hot attentions (score std ~64): with the init's weights
    # fp32 rounding alone moves the logits past the bar (the CPU against
    # itself in float64, tests/test_torch_encdec.py), so the bar is held
    # at unit score variance
    two = f32.with_(enc_layers=2, dec_layers=2, n_layers=4)
    what = (f"{cfg.arch} full width 2 encoder + 2 decoder layers float32 (a "
            "source of 6 frames, the cross cache padded to 8)")
    errs["2 + 2 layers, unit score scale"] = model_reference_check(
        torch, build_model, two,
        unit_score_scale(first_encdec_layers(params, 2), cfg), 2, 6, 2, 1e-4,
        what + ", unit score scale", cache_dtype=torch.float32,
        extra={"src_embeds": src})
    src = shapes.concrete_batch(cfg, "prefill", 2, T,
                                device="cpu")["src_embeds"]
    what = (f"{cfg.arch} full width {cfg.enc_layers} + {cfg.dec_layers} "
            f"layers float32, source {T}")
    scaled = unit_score_scale(params, cfg)
    # on the card (the CPU's run of the same check was cut for time)
    errs[f"prefill {T + 1} vs {T} + decode, unit score scale, cuda"] = \
        prefill_decode_consistency(torch, build_model, f32, scaled, 2, T,
                                   1e-4, what + ", unit score scale",
                                   device="cuda", extra={"src_embeds": src})
    del scaled
    del params, caches, model
    torch.cuda.empty_cache()
    return {"batch": B, "source": T, "target": T, "steps": steps,
            "prefill_ms": prefill_ms, "step_ms": times,
            "median_step_ms": step_ms,
            "tok_per_s": B * steps / (sum(times) / 1e3),
            "flash_per_prefill": launches[0], "flash_per_step": launches[1:],
            "flash_launches": flash, "peak_memory_gb": peak_gb,
            "card_memory_gb": card_gb, "profile": prof,
            "model_rel_err": errs, "params": cfg.param_count()}


def kv_quant_on_card(torch, kernel, kvq, mha):
    """12d: ``models/kv_quant.py`` at qwen2-7b's decode_32k cache: the
    codes and scales the card writes against the CPU's (equal), attention
    over the int8 cache against the float cache's (bf16 and float32, at
    KVQ_TOL), the footprint against a bf16 cache, device times."""
    B, T, H, D = KVQ_SHAPE
    g = torch.Generator(device="cuda").manual_seed(8)
    k = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
    cache = kvq.append_quant_cache(kvq.init_quant_cache(B, T, H, D), k, v, 0)
    cpu = kvq.append_quant_cache(kvq.init_quant_cache(B, T, H, D,
                                                      device="cpu"),
                                 k.cpu(), v.cpu(), 0)
    differ = {n: int((cache[n].cpu() != cpu[n]).sum()) for n in cache}
    print(f"  codes and scales, card against CPU: entries that differ "
          f"{differ} (of {k.numel():,} codes and {k.numel() // D:,} scales "
          "each)", flush=True)
    check(not any(differ.values()), f"kv_quant: the card's codes or scales "
                                    f"differ from the CPU's: {differ}")
    del cpu
    out = {"shape": [B, T, H, D], "query_heads": KVQ_HEADS,
           "differ": differ}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q = torch.randn(B, 1, KVQ_HEADS, D, generator=g, device="cuda").to(
            dtype)
        kf, vf = k.to(dtype), v.to(dtype)

        def quant():
            return kvq.attention_over_quant_cache(q, cache, kv_len=T,
                                                  causal=True, q_offset=T - 1)

        def plain_cache():
            return mha(q, kf, vf, causal=True, kv_len=T, q_offset=T - 1)
        n0 = kernel.LAUNCHES
        got = quant()
        check(kernel.LAUNCHES - n0 == 1,
              "attention_over_quant_cache did not launch the flash kernel")
        err = float((got.float() - plain_cache().float()).abs().max())
        row = {"max_abs_err": err, "ms": device_ms(torch, quant),
               "float_cache_ms": device_ms(torch, plain_cache)}
        print(f"  attention over the int8 cache, {dname} queries: max_abs_err"
              f" {err:.3e} against the float cache (tol {KVQ_TOL}); device "
              f"{row['ms']:.4f} ms (dequantize + flash) against "
              f"{row['float_cache_ms']:.4f} ms over the {dname} cache",
              flush=True)
        check(err < KVQ_TOL, f"kv_quant attention {dname}: {err}")
        out[dname] = row
        del q, kf, vf, got
    q8 = sum(t.numel() * t.element_size() for t in cache.values())
    bf16 = 2 * k.numel() * 2
    out.update(int8_bytes=q8, bf16_bytes=bf16, ratio=q8 / bf16)
    print(f"  footprint: int8 codes + fp32 scales {q8 / 1e6:.1f} MB against "
          f"a bf16 cache's {bf16 / 1e6:.1f} MB ({q8 / bf16:.4f})", flush=True)
    check(q8 < 0.6 * bf16, f"kv_quant footprint {q8} of {bf16}")
    del k, v, cache
    torch.cuda.empty_cache()
    return out


def encdec_timing_shapes(B, T, steps):
    """(name, B, Sq, Sk, kv_len, q_offset, causal) of 12e's D 64 H 16
    timings: 12c's encoder (and cross) prefill, its self prefill, its last
    self decode step and its cross decode, then the bidirectional encoder
    prefill at 4k and a cross decode over 4k (B 8)."""
    Sk = T + steps
    return [("encoder prefill", B, T, T, T, 0, False),
            ("self prefill", B, T, Sk, T, 0, True),
            ("self decode", B, 1, Sk, Sk, Sk - 1, True),
            ("cross decode", B, 1, T, T, 0, False),
            ("encoder prefill 4k", 1, 4096, 4096, 4096, 0, False),
            ("cross decode 4k", 8, 1, 4096, 4096, 0, False)]


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


def synthetic_estimator(n_tasks, n_nodes, device, seed=0, **bias):
    """benchmarks/bench_predict.py's ``_synthetic_estimator``, built from
    the port: T tasks fitted from seeded samples (70% size-correlated, the
    rest flat) over N synthetic node benches; ``bias``: the estimator's
    bias settings (default: its defaults)."""
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
    est = LotaruEstimator(local, benches, device=device, **bias)
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


def online_tick_at_scale(torch, sync_log=None):
    """Phase 9b: one online tick at phase 8c's scale through
    ``TickEngine.observe_batch``, eager and CUDA-graphed, beside the
    legacy tick (``observe_batch`` + the dirty-row ``predict_matrix``)
    and the same tick on the CPU, then the HEFT re-plan; with a
    ``sync_log``, phase 15a's sync traces at the end."""
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
    if sync_log is not None:
        # phase 15a, after the timed work: two more ticks of each engine on
        # ticks 2's and 3's streams, whose graphs are captured (replays only)
        for name in ("eager", "graph"):
            e = engines[name]
            sync_log.run(f"15a tick, {name}", lambda: [
                e.observe_batch(streams[k]) for k in (1, 2)], per=2)

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


def run_online_phase(torch, smi, sync_log=None):
    """Phase 9: the online loop on the card (and phase 15a's traces)."""
    report = {}
    print("== phase 9a: the five workflows through OnlineExecutor, card "
          "and CPU, fused and legacy, faults off and on (2 samples, 2 "
          "nodes per type)", flush=True)
    report["executors"] = online_executors(torch)
    print(f"== phase 9b: one online tick at {EST_TASKS} tasks x "
          f"{EST_NODES} nodes, {EST_STREAM} observations (numpy seeds 1-"
          f"{TICKS + 1}, one a tick), then HEFT over synthetic_dag(100, "
          "140)", flush=True)
    r = online_tick_at_scale(torch, sync_log)
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


def fleet_point(torch, W, T, N, B, bases, sync_log=None):
    """One fleet point: ``bases[dev]``'s state stacked W times (as
    bench_online stacks it) on the card, on the card's (1, 1) mesh and
    on the CPU, beside W per-workflow ``tick_step`` states on the card;
    FLEET_TICKS ticks of fresh rows, each workflow predicting at its own
    size.  Every tick: the mesh's fleet equals the card's bit for bit,
    and every workflow's slice is held to its ``tick_step`` and to the
    CPU's fleet (EST_TOL).  Then one more tick of each, profiled, and
    with a ``sync_log`` one more fleet tick under phase 15b's trace."""
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
    if sync_log is not None:
        obs = fleet_obs(W, T, N, B, FLEET_TICKS + 2)
        sync_log.run(f"15b fleet tick, W {W} x T {T} x N {N}",
                     lambda: fleet_tick("cuda", obs))
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


def run_fleet_phase(torch, smi, sync_log=None):
    """Phase 10a: the fleet on the card (bench_online's sweep, then W 4
    at phase 8c's scale); phase 15b traces the sweep's last point."""
    import copy
    devs = ("cuda", "cpu")
    small = {d: synthetic_estimator(FLEET_T, FLEET_N, d) for d in devs}
    points = [fleet_point(torch, W, FLEET_T, FLEET_N, FLEET_BATCH, small,
                          sync_log if W == FLEET_WS[-1] else None)
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


# ---------------------------------------------------------------------------
# Phase 13: training (the flash backward kernel, a train step against the
# CPU, restarts, stablelm-1.6b at full width)
# ---------------------------------------------------------------------------
BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu"
#: what the backward replaces: the gradient of the TPU kernel's function,
#: which the JAX package takes by XLA's autodiff of chunked_attention
BWD_GRADIENT_OF = "src/repro/models/layers.py:94"
#: 13a: (name, B, Hq, Hkv, Sq, Sk, D, causal): causal and non-causal
#: self-attention, cross-attention with Sq < Sk and Sq > Sk, GQA 1/4/7/8,
#: D 32/64/128/160, lengths that are no multiple of the 64-row tiles
BWD_CASES = [
    ("causal D64", 2, 8, 8, 256, 256, 64, True),
    ("causal ragged T300 D32", 1, 4, 4, 300, 300, 32, True),
    ("causal GQA4 D128", 2, 16, 4, 200, 200, 128, True),
    ("causal GQA7 D128 (qwen2)", 1, 28, 4, 130, 130, 128, True),
    ("causal GQA8 D128 (qwen3-moe)", 1, 32, 4, 97, 97, 128, True),
    ("causal GQA4 D160 (stablelm-12b)", 1, 32, 8, 150, 150, 160, True),
    ("encoder non-causal H16 D64", 2, 16, 16, 256, 256, 64, False),
    ("cross Sq77 Sk256 H16 D64", 2, 16, 16, 77, 256, 64, False),
    ("cross Sq300 Sk65 GQA8 D32", 1, 8, 1, 300, 65, 32, False),
    ("stablelm train B1 T1024", 1, 32, 32, 1024, 1024, 64, True),
]
#: 13b: (name, B, Hq, Hkv, T, D): the training attention of stablelm-1.6b
#: (13e's microbatch) and of qwen2-7b, causal bf16
BWD_TIMED = [("stablelm-1.6b train", 4, 32, 32, 4096, 64),
             ("qwen2-7b train", 4, 28, 4, 4096, 128)]
#: 13c: the configs trained one step at TRAIN_LAYERS layers (the
#: encoder-decoder: as many encoder and decoder layers) on the card and the
#: CPU; one layer keeps the CPU side, most of the script's host time, short
TRAIN_LAYERS = 1
TRAIN_ARCHS = ["stablelm-1.6b", "qwen2-7b", "qwen2-vl-7b",
               "qwen3-moe-30b-a3b", "seamless-m4t-large-v2"]
TRAIN_B, TRAIN_T = 2, 16
TRAIN_TOL = 1e-4
#: 13c: the configs whose AdamW step is also held card against CPU (the
#: update is the same elementwise code for every config's leaves; a step
#: on the CPU is most of a config's host time)
TRAIN_STEP_ARCHS = ("stablelm-1.6b", "mamba2-1.3b")
#: 13c: the ssm and hybrid configs and their layers (zamba2: one super-unit
#: of 6 Mamba-2 layers and the shared attention block, and one tail layer),
#: at T 320: the SSD scan over three chunks, the last of 64 rows
TRAIN_SSM = [("mamba2-1.3b", 2), ("zamba2-1.2b", 7)]
TRAIN_SSM_T = 320
#: 13e and 13h: stablelm-1.6b and mamba2-1.3b at full width: steps,
#: sequence (train_4k's), global batch, microbatches
FULL_STEPS, FULL_SEQ, FULL_BATCH, FULL_MICRO = 4, 4096, 8, 2
SSD_BWD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu"
#: what the SSD backward replaces: the gradient of the TPU kernel's
#: function, which the JAX package takes by XLA's autodiff of ssd_chunked
SSD_BWD_GRADIENT_OF = "src/repro/models/mamba2.py:60"
#: 13f: (name, B, T, H, P, G, N, chunk, layout, state0, dstate): mamba2's
#: and zamba2's widths (N 128, N 64) on views of the conv output, G 2,
#: initial states, a final-state gradient or none, ragged T, one chunk
#: and several
SSD_BWD_CASES = [
    ("mamba2 B2 T300 state0 dstate", 2, 300, 64, 64, 1, 128, 128, "conv",
     "random", True),
    ("mamba2 B1 T1000 (8 chunks)", 1, 1000, 64, 64, 1, 128, 128, "conv",
     None, False),
    ("mamba2 B2 T13 (one chunk) state0", 2, 13, 64, 64, 1, 128, 128, "conv",
     "random", False),
    ("zamba2 B2 T300 state0 dstate", 2, 300, 64, 64, 1, 64, 128, "conv",
     "random", True),
    ("G2 N64 B2 T200 state0", 2, 200, 16, 64, 2, 64, 128, "bthp", "random",
     False),
    ("G2 N128 B1 T129 dstate", 1, 129, 16, 64, 2, 128, 128, "bthp", None,
     True),
]


def bwd_bound(B, Hq, Hkv, S, D, elem):
    """Least time for a causal backward at these shapes: 2.5 x the
    forward's operations (4 D per valid (q, k) pair) at the bf16 peak,
    against q, o, dO, k, v and lse read once and dq, dk, dv written once
    at the HBM rate."""
    flops = 2.5 * 4 * D * B * Hq * S * (S + 1) / 2
    nbytes = (elem * (4 * B * Hq * S * D + 4 * B * Hkv * S * D)
              + 4 * B * Hq * S)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def grad_rel(out, ref) -> float:
    """max |out - ref| over max |ref| (fp32)."""
    ref = ref.float()
    return float((out.float() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def bwd_inputs(torch, B, Hq, Hkv, Sq, Sk, D, dtype, seed):
    """q, k, v and dO as (B, H, S, D) views of (B, S, H, D) storage, the
    layout ``mha`` passes down."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(S, H):
        return torch.randn(B, S, H, D, generator=g, device="cuda").to(
            dtype).transpose(1, 2)
    return rnd(Sq, Hq), rnd(Sk, Hkv), rnd(Sk, Hkv), rnd(Sq, Hq)


def run_bwd_checks(torch, kernel, attention_bwd_ref, lse_ref):
    """13a: each case in float32 (the CUDA-core path) and bf16 (the wgmma
    path; mma.sync at D 160): the
    forward's lse against ``lse_ref``, dq, dk, dv against
    ``attention_bwd_ref`` on the same inputs (the kernel's output and
    lse), each within the forward's bar relative to the gradient's max,
    and a second run equal bit for bit."""
    results = []
    for i, (name, B, Hq, Hkv, Sq, Sk, D, causal) in enumerate(BWD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            path = kernel.bwd_plan(dtype, D)
            dname = str(dtype).split(".")[1]
            tol = TOL[dname]
            q, k, v, do = bwd_inputs(torch, B, Hq, Hkv, Sq, Sk, D, dtype, i)
            out, lse = kernel.flash_attention(q, k, v, causal=causal,
                                              return_lse=True)
            ref_lse = lse_ref(q, k, causal=causal)
            lse_err = float((lse - ref_lse).abs().max())
            check(lse_err <= tol * (1 + float(ref_lse.abs().max())),
                  f"{name} {dname}: lse off by {lse_err}")
            grads = kernel.flash_attention_bwd(q, k, v, out, do, lse,
                                               causal=causal)
            refs = attention_bwd_ref(q, k, v, out, do, lse, causal=causal)
            again = kernel.flash_attention_bwd(q, k, v, out, do, lse,
                                               causal=causal)
            torch.cuda.synchronize()
            errs = {f"d{n}": grad_rel(g, r)
                    for n, g, r in zip("qkv", grads, refs)}
            abs_err = max(float((g.float() - r.float()).abs().max())
                          for g, r in zip(grads, refs))
            same = all(torch.equal(g, h) for g, h in zip(grads, again))
            ok = max(errs.values()) <= tol and same
            print(f"  {name:32s} {dname:9s} {path:9s} lse {lse_err:.2e} "
                  + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
                  + f" (x max, tol {tol:g}) rerun "
                  f"{'equal' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"flash_bwd disagrees with its plain version or with "
                      f"itself: {name} {dname} {path} {errs} rerun equal "
                      f"{same}")
            results.append({"case": name, "dtype": dname, "path": path,
                            "rel_err": errs,
                            "max_abs_err": abs_err, "lse_err": lse_err,
                            "rerun_equal": same})
            del q, k, v, do, out, lse, grads, refs, again
    return results


def run_bwd_timings(torch, kernel, attention_bwd_ref, lse_ref, sdpa):
    """13b: at each of BWD_TIMED's shapes (bf16, causal): the forward's
    lse held to ``lse_ref`` (the backward's plain version takes the
    kernel's lse, so a wrong lse would shift both alike) and the kernel to
    its plain version, then device ms of the backward (CUDA-graph
    replays), of its plain version and of SDPA's backward
    (``torch.autograd.grad`` through ``scaled_dot_product_attention``,
    a yardstick the port never calls; both with ``host_ms``, CUDA events
    around back-to-back calls: a CUDA graph cannot take autograd, nor the
    plain version's tens of GB of temporaries), the forward with and
    without lse, the bound; the achieved TFLOP/s and share of the bound
    (13e's profile splits the call among its kernels)."""
    rows = []
    for name, B, Hq, Hkv, T, D in BWD_TIMED:
        q, k, v, do = bwd_inputs(torch, B, Hq, Hkv, T, T, D, torch.bfloat16,
                                 11)
        out, lse = kernel.flash_attention(q, k, v, causal=True,
                                          return_lse=True)
        ref_lse = lse_ref(q, k, causal=True)
        lse_err = float((lse - ref_lse).abs().max())
        check(lse_err <= TOL["bfloat16"] * (1 + float(ref_lse.abs().max())),
              f"flash forward's lse off by {lse_err} at {name}")
        del ref_lse
        torch.cuda.empty_cache()

        def kern():
            return kernel.flash_attention_bwd(q, k, v, out, do, lse,
                                              causal=True)

        def plain():
            return attention_bwd_ref(q, k, v, out, do, lse, causal=True)
        refs = plain()
        grads = kern()
        errs = {f"d{n}": grad_rel(g, r) for n, g, r in zip("qkv", grads, refs)}
        abs_err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(grads, refs))
        check(max(errs.values()) <= TOL["bfloat16"],
              f"flash_bwd disagrees with its plain version at {name}: {errs}")
        # SDPA on contiguous (B, H, S, D) leaves; its gradient checked too
        qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
        lib_out = sdpa(qc, kc, vc, is_causal=True, enable_gqa=Hq != Hkv)

        def lib():
            return torch.autograd.grad(lib_out, (qc, kc, vc), do,
                                       retain_graph=True)
        lib_errs = [grad_rel(g, r) for g, r in zip(lib(), refs)]
        check(max(lib_errs) < 5e-2,
              f"SDPA's backward disagrees at {name}: {lib_errs}")
        del refs, grads
        torch.cuda.empty_cache()
        b_ms, b_by = bwd_bound(B, Hq, Hkv, T, D, 2)
        bwd_flops = 2.5 * 4 * D * B * Hq * T * (T + 1) / 2
        row = {"shape": name, "B": B, "H": Hq, "Hkv": Hkv, "T": T, "D": D,
               "dtype": "bfloat16", "causal": True, "rel_err": errs,
               "max_abs_err": abs_err, "lse_err": lse_err,
               "path": kernel.bwd_plan(torch.bfloat16, D),
               "ms": device_ms(torch, kern, calls=3, replays=2),
               "host_ms": host_ms(torch, kern, budget_ms=100.0),
               "plain_ms": host_ms(torch, plain, budget_ms=100.0),
               "library_ms": host_ms(torch, lib),
               "fwd_ms": device_ms(torch, lambda: kernel.flash_attention(
                   q, k, v, causal=True)),
               "fwd_lse_ms": device_ms(torch, lambda: kernel.flash_attention(
                   q, k, v, causal=True, return_lse=True)),
               "bound_ms": b_ms, "bound_by": b_by}
        row["tflops"] = bwd_flops / row["ms"] / 1e9
        row["library_tflops"] = bwd_flops / row["library_ms"] / 1e9
        row["bound_share"] = b_ms / row["ms"]
        print(f"  {name:22s} B{B} T{T} H{Hq}/{Hkv} D{D}: lse {lse_err:.2e}; "
              "dq/dk/dv "
              + " ".join(f"{e:.2e}" for e in errs.values())
              + f" (tol 2e-2); device: kernel {row['ms']:9.4f} ms  plain "
              f"{row['plain_ms']:9.4f} ms  sdpa bwd {row['library_ms']:9.4f} "
              f"ms  bound {b_ms:9.4f} ms ({b_by}); host {row['host_ms']:9.4f}"
              f" ms; forward {row['fwd_ms']:.4f} ms, with lse "
              f"{row['fwd_lse_ms']:.4f} ms", flush=True)
        print(f"    {row['path']}: {row['tflops']:.1f} TFLOP/s "
              f"({100 * row['bound_share']:.1f}% of the bound; SDPA's "
              f"backward {row['library_tflops']:.1f} TFLOP/s), kernel / "
              f"SDPA {row['ms'] / row['library_ms']:.3f}", flush=True)
        rows.append(row)
        del q, k, v, do, out, lse, qc, kc, vc, lib_out
        torch.cuda.empty_cache()
    return rows


def ssd_bwd_bound(B, T, H, P, G, N, chunk, elem):
    """Least time for the SSD backward on these inputs (no final-state
    gradient, as in training): x, B_ and C_ (``elem`` bytes), dt and dy
    (fp32) read once, dx, ddt, dB and dC (fp32) written once, at the HBM
    rate (the forward's chunk states, which this design reads, are not
    the gradient's own need and are left out), against the operations at
    the bf16
    peak, per chunk of ``rows`` rows and its rows (rows + 1) / 2 pairs
    m <= l: C B^T 2 N a pair per group; per head dy x^T, A1^T dy 2 P and
    A2^T C, A2 B 2 N a pair each, and the four products with a state
    (the state-gradient term, s_in^T dy, ds B, ds^T x) 2 P N a row each."""
    L = min(chunk, T)
    flops = 0
    for t0 in range(0, T, L):
        rows = min(L, T - t0)
        pairs = rows * (rows + 1) // 2
        flops += B * (G * 2 * N * pairs
                      + H * (4 * P * pairs + 4 * N * pairs
                             + 8 * rows * P * N))
    nbytes = (elem * B * T * (H * P + 2 * G * N) + 4 * B * T * H
              + 4 * B * T * H * P
              + 4 * B * T * H * P + 4 * B * T * H + 2 * 4 * B * T * G * N)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


SSD_GRADS = ("dx", "ddt", "da", "dB", "dC", "dstate0")


def ssd_bwd_call(torch, ssd_kernel, case_inputs, chunk):
    """The forward with its chunk states, then ``call()`` of the
    backward on them."""
    x, dt, a, B_, C_, s0, dy, ds = case_inputs
    _, _, states = ssd_kernel.ssd_scan(x, dt, a, B_, C_, chunk=chunk,
                                       state0=s0, return_states=True)

    def call():
        return ssd_kernel.ssd_scan_bwd(x, dt, a, B_, C_, dy, states,
                                       chunk=chunk, dstate=ds,
                                       state0_grad=s0 is not None)
    return call


def ssd_bwd_inputs(torch, B, T, H, P, G, N, dtype, layout, state0, dstate,
                   seed):
    """``ssd_inputs`` and a gradient of y (and of the final state)."""
    x, dt, a, B_, C_, s0 = ssd_inputs(torch, B, T, H, P, G, N, dtype, layout,
                                      state0, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(B, T, H, P, generator=g, device="cuda")
    ds = (torch.randn(B, H, P, N, generator=g, device="cuda") if dstate
          else None)
    return x, dt, a, B_, C_, s0, dy, ds


def ssd_bwd_refs(ssd_chunked_bwd, inputs, chunk, dtype):
    """``ssd_chunked_bwd`` on the inputs upcast to ``dtype`` (float64 for
    the bar, float32 for the plain version's own gap)."""
    x, dt, a, B_, C_, s0, dy, ds = inputs
    up = [None if t is None else t.to(dtype)
          for t in (x, dt, a, B_, C_, s0, dy, ds)]
    return ssd_chunked_bwd(*up[:5], chunk, *up[5:])


def ssd_grad_errs(grads, refs):
    """Each gradient's max |error| over the reference's max (None where
    the gradient is not asked for)."""
    return {n: grad_rel(g, r) for n, g, r in zip(SSD_GRADS, grads, refs)
            if g is not None}


def run_ssd_bwd_checks(torch, ssd_kernel, ssd_chunked_bwd):
    """13f: each of SSD_BWD_CASES in float32 and with bf16 x/B/C: the
    backward kernel's fp32 gradients, before any cast, against
    ``ssd_chunked_bwd`` in float64 on the fp32 upcasts of the same inputs
    (and the forward's chunk states), each within SSD_TOL of its max; the
    plain version's own gap in float32 beside it; a second call equal bit
    for bit."""
    results = []
    for i, (name, B, T, H, P, G, N, chunk, layout, state0, dstate) in \
            enumerate(SSD_BWD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            inputs = ssd_bwd_inputs(torch, B, T, H, P, G, N, dtype, layout,
                                    state0, dstate, 300 + i)
            call = ssd_bwd_call(torch, ssd_kernel, inputs, chunk)
            grads, again = call(), call()
            torch.cuda.synchronize()
            ref64 = ssd_bwd_refs(ssd_chunked_bwd, inputs, chunk,
                                 torch.float64)
            ref32 = ssd_bwd_refs(ssd_chunked_bwd, inputs, chunk,
                                 torch.float32)
            errs = ssd_grad_errs(grads, ref64)
            plain = ssd_grad_errs(ref32[:len(errs)], ref64)
            abs_err = max(float((g.double() - r).abs().max())
                          for g, r in zip(grads, ref64) if g is not None)
            same = all(torch.equal(g, h) for g, h in zip(grads, again)
                       if g is not None)
            finite = all(bool(torch.isfinite(g).all()) for g in grads
                         if g is not None)
            ok = max(errs.values()) <= SSD_TOL and same and finite
            path = ssd_kernel.bwd_plan(dtype, T, chunk).path
            print(f"  {name:32s} {dname:9s} {path:9s} "
                  + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
                  + f" (x max, tol {SSD_TOL:g}; plain fp32 "
                  f"{max(plain.values()):.2e}) rerun "
                  f"{'equal' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"ssd_bwd disagrees with its plain version or with "
                      f"itself: {name} {dname} {errs} rerun equal {same}, "
                      f"finite {finite}")
            results.append({"case": name, "dtype": dname, "path": path,
                            "rel_err": errs,
                            "plain_fp32_rel_err": plain,
                            "max_abs_err": abs_err, "rerun_equal": same})
            del inputs, call, grads, again, ref64, ref32
    torch.cuda.empty_cache()
    return results


def run_ssd_bwd_timings(torch, ssd_kernel, ssd_chunked_bwd, cfgs):
    """13g: at each config's training shape (13h's microbatch, B 4 x T
    4,096, bf16 x/B/C on views of the conv output, zero state0 and no
    final-state gradient, as the model calls it): the backward held to
    ``ssd_chunked_bwd`` in float64 (SSD_TOL), then device ms of the
    backward (CUDA-graph replays), of its plain version in float32, of
    the forward with and without its chunk states, the host ms per call,
    the bound.  No single PyTorch call computes this gradient; 13h's
    profiled step splits a call at mamba2's shape among its path's
    launches (a profile of these direct calls, late in the script, records
    none of them)."""
    rows = []
    for label, cfg in cfgs:
        s = cfg.ssm
        H, P, G, N = (s.n_ssm_heads(cfg.d_model), s.head_dim, s.n_groups,
                      s.d_state)
        B, T = FULL_BATCH // FULL_MICRO, FULL_SEQ
        inputs = ssd_bwd_inputs(torch, B, T, H, P, G, N, torch.bfloat16,
                                "conv", None, False, 17)
        kern = ssd_bwd_call(torch, ssd_kernel, inputs, s.chunk)
        grads = kern()
        ref = ssd_bwd_refs(ssd_chunked_bwd, inputs, s.chunk, torch.float64)
        errs = ssd_grad_errs(grads, ref)
        abs_err = max(float((g.double() - r).abs().max())
                      for g, r in zip(grads, ref) if g is not None)
        check(max(errs.values()) <= SSD_TOL,
              f"ssd_bwd disagrees with its plain version at {label}: {errs}")
        del grads, ref
        torch.cuda.empty_cache()
        x, dt, a, B_, C_ = inputs[:5]

        def plain():
            return ssd_bwd_refs(ssd_chunked_bwd, inputs, s.chunk,
                                torch.float32)
        b_ms, b_by = ssd_bwd_bound(B, T, H, P, G, N, s.chunk, 2)
        pl = ssd_kernel.bwd_plan(torch.bfloat16, T, s.chunk)
        row = {"shape": f"{label} train", "B": B, "T": T, "H": H, "P": P,
               "G": G, "N": N, "chunk": s.chunk, "dtype": "bfloat16",
               "path": pl.path, "rel_err": errs, "max_abs_err": abs_err,
               "ms": device_ms(torch, kern, calls=3, replays=2),
               "host_ms": host_ms(torch, kern, budget_ms=200.0),
               "plain_ms": device_ms(torch, plain, calls=1, replays=2),
               "library_ms": None,
               "library": "none: no single PyTorch call computes the SSD "
                          "scan's gradient",
               "fwd_ms": device_ms(torch, lambda: ssd_kernel.ssd_scan(
                   x, dt, a, B_, C_, chunk=s.chunk)),
               "fwd_states_ms": device_ms(torch, lambda: ssd_kernel.ssd_scan(
                   x, dt, a, B_, C_, chunk=s.chunk, return_states=True)),
               "bound_ms": b_ms, "bound_by": b_by}
        row["bound_share"] = b_ms / row["ms"]
        print(f"  {label:12s} B{B} T{T} H{H} P{P} G{G} N{N} {pl.path}: "
              + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f" (tol {SSD_TOL:g}); device: kernel {row['ms']:9.4f} ms  "
              f"plain {row['plain_ms']:9.4f} ms  bound {b_ms:9.4f} ms "
              f"({b_by}, {100 * row['bound_share']:.1f}%); host "
              f"{row['host_ms']:9.4f} ms; forward {row['fwd_ms']:.4f} ms, "
              f"with its chunk states {row['fwd_states_ms']:.4f} ms",
              flush=True)
        rows.append(row)
        del inputs, kern, x, dt, a, B_, C_
        torch.cuda.empty_cache()
    return rows


def copy_to(tree, device):
    """A copy of a tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: copy_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def cut_depth(cfg, n=2):
    """The config cut to ``n`` layers (the encoder-decoder: n + n)."""
    if cfg.family == "encdec":
        return cfg.with_(n_layers=2 * n, enc_layers=n, dec_layers=n)
    return cfg.with_(n_layers=n)


def train_reference_check(torch, build_model, apply_updates, state_defs,
                          tree_defs_init, SyntheticLMData, AdamWConfig,
                          leaves, unflatten, cfg, label, seq=TRAIN_T,
                          with_step=True):
    """13c: loss and gradients of one batch of ``seq`` tokens on the card
    (the kernels of the path) and on the CPU (plain versions), within
    TRAIN_TOL x each leaf's max at unit score variance (a config without
    attention has no score to scale, and runs with the init's weights);
    then, ``with_step``, one AdamW step from the same (zero) state and the
    card's gradients, on the card and on the CPU: every parameter after
    the step within TRAIN_TOL x the leaf's max.  The step from the CPU's
    gradients is measured beside it: Adam's first step is ~lr x sign(g),
    so an element whose gradient is 0 up to the two devices' rounding can
    land 2 lr apart.  The CPU's results are compared on the card; the CPU
    copy of the weights is updated in place by the step."""
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = to_device(model.init(0, device="cuda"), "cpu")
    if cfg.family != "ssm":
        params = unit_score_scale(params, cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)

    def loss_and_grads(p, dev):
        batch = SyntheticLMData(cfg, seq=seq, global_batch=TRAIN_B,
                                seed=3, device=dev).batch(0)
        flat = leaves(p)
        for t in flat:
            t.requires_grad_(True)
        loss, _ = model.loss(p, batch)
        grads = torch.autograd.grad(loss, flat)
        for t in flat:
            t.requires_grad_(False)
        return float(loss.detach()), list(grads)

    def step(p, grads, dev):
        """One AdamW step of ``p`` (updated in place) on ``dev``; its
        leaves after it, on the card."""
        state = tree_defs_init(state_defs(model.param_defs, opt), None, dev)
        apply_updates(p, unflatten(p, [g.to(dev) for g in grads]), state,
                      opt)
        return [t.to("cuda") for t in leaves(p)]

    def worst(a, b):
        return max(grad_rel(x, y.to("cuda")) for x, y in zip(a, b))

    t = time.perf_counter()
    loss_cpu, g_cpu = loss_and_grads(params, "cpu")
    cpu_s = time.perf_counter() - t     # the CPU's gradients and step
    loss_card, g_card = loss_and_grads(to_device(params, "cuda"), "cuda")
    check(all(bool(torch.isfinite(g).all()) for g in g_card),
          f"{label}: non-finite gradients on the card")
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    grad_err = worst(g_card, g_cpu)
    out = {"loss": loss_card, "loss_rel_err": loss_err,
           "grad_rel_err": grad_err}
    weights = ("the init's weights" if cfg.family == "ssm"
               else "unit score variance")
    if with_step:
        card = step(copy_to(params, "cuda"), g_card, "cuda")
        own_err = worst(card, step(copy_to(params, "cuda"), g_cpu, "cuda"))
        t = time.perf_counter()
        after = step(params, g_card, "cpu")
        cpu_s += time.perf_counter() - t
        param_err = worst(card, after)
        del after, card
        out.update(param_rel_err=param_err, param_rel_err_own_grads=own_err)
        print(f"  {label}: loss {loss_card:.5f}; card vs CPU loss "
              f"{loss_err:.3e}, gradients {grad_err:.3e}, parameters after "
              f"the step {param_err:.3e} x max (tol {TRAIN_TOL}, {weights});"
              f" from each device's own gradients {own_err:.3e} (measured "
              "only)", flush=True)
    else:
        param_err = 0.0
        print(f"  {label}: loss {loss_card:.5f}; card vs CPU loss "
              f"{loss_err:.3e}, gradients {grad_err:.3e} x max (tol "
              f"{TRAIN_TOL}, {weights})", flush=True)
    check(max(loss_err, grad_err, param_err) <= TRAIN_TOL,
          f"{label}: card vs CPU loss {loss_err:.3e}, gradients "
          f"{grad_err:.3e}, parameters after the step {param_err:.3e} "
          f"(tol {TRAIN_TOL})")
    del g_cpu, g_card, params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["cpu_seconds"] = cpu_s
    print(f"  {label}: {out['seconds']:.1f} s ({cpu_s:.1f} s of it the "
          "CPU's gradients" + (" and step)" if with_step else ")"),
          flush=True)
    return out


def restart_check(torch, train_mod, cfg, workdir):
    """13d: ``train`` 6 steps straight against ``train_with_restarts``
    failing at step 4 (resumed from the step-3 checkpoint), its
    checkpoints every 2 steps under ``workdir`` (removed after: a
    checkpoint of 2 full-width stablelm layers with its AdamW state is
    ~6 GB; the straight run writes none); the last losses within 1e-4,
    tests/test_checkpoint.py's bar."""
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)
    free_gb = shutil.disk_usage(ROOT).free / 1e9
    print(f"  disk free under the checkout: {free_gb:.1f} GB", flush=True)
    kw = dict(steps=6, seq=16, global_batch=2, seed=5, device="cuda")
    t0 = time.perf_counter()
    straight = train_mod.train(cfg, **kw)
    restarted = train_mod.train_with_restarts(
        cfg, ckpt_dir=workdir, ckpt_every=2, failures=[4], **kw)
    shutil.rmtree(workdir)
    seconds = time.perf_counter() - t0
    gap = abs(straight.losses[-1] - restarted.losses[-1])
    print(f"  restart at step 4: losses straight {straight.losses}, "
          f"restarted {restarted.losses} ({restarted.restarts} restart); "
          f"last-loss gap {gap:.3e} (tol 1e-4); {seconds:.1f} s with the "
          "checkpoints", flush=True)
    check(restarted.restarts == 1 and restarted.final_step == 5
          and restarted.steps_run == 2,
          f"the restarted run did not resume at step 4: {restarted}")
    check(gap <= 1e-4, f"restart changed the last loss by {gap:.3e}")
    return {"straight": straight.losses, "restarted": restarted.losses,
            "gap": gap, "seconds": seconds, "disk_free_gb": free_gb}


def small_lm_learns(torch, build_model, make_train_step, AdamWConfig,
                    state_defs, tree_defs_init, SyntheticLMData, ModelConfig):
    """13d: tests/test_training_convergence.py's small LM on the card
    (bf16 activations: the tensor-core forward and the backward kernel),
    40 steps, held to that test's thresholds."""
    import math
    cfg = ModelConfig(arch="conv-test", family="dense", n_layers=2,
                      d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
                      vocab=2048, head_dim=32, norm="rmsnorm", act="swiglu",
                      attn_chunk=64, xent_chunk=64, remat="full")
    model = build_model(cfg)
    opt = AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=100,
                      schedule="constant")
    params = model.init(0, device="cuda")
    state = tree_defs_init(state_defs(model.param_defs, opt),
                           torch.Generator(device="cuda").manual_seed(1),
                           "cuda")
    data = SyntheticLMData(cfg, seq=64, global_batch=8, seed=0,
                           device="cuda")
    step = make_train_step(model, opt)
    losses = []
    for i in range(40):
        params, state, m = step(params, state, data.batch(i))
        losses.append(float(m["loss"]))
    first, last, uniform = losses[0], losses[-1], math.log(cfg.vocab)
    print(f"  small LM: loss {first:.4f} -> {last:.4f} over 40 steps "
          f"(uniform {uniform:.4f}; thresholds: first > uniform - 1, last < "
          f"first - 1.5, last < uniform - 1)", flush=True)
    check(first > uniform - 1.0 and last < first - 1.5
          and last < uniform - 1.0,
          f"the small LM did not learn on the card: {first} -> {last}")
    return {"losses": losses, "uniform": uniform}


def full_width_training(torch, kernel, other, label, bwd_kernels, train_mod,
                        make_train_step, AdamWConfig, state_defs,
                        tree_defs_init, SyntheticLMData, cfg, sync_log=None):
    """13e and 13h: ``train`` of ``cfg`` at full width, FULL_STEPS steps
    of FULL_BATCH x FULL_SEQ tokens in FULL_MICRO microbatches (no
    checkpoint: its state would be ~26 GB); the launches of the run of
    the path's kernel module ``kernel`` (``label``: forward twice a layer
    a microbatch under full remat, backward once; every layer of
    stablelm-1.6b is an attention, every layer of mamba2-1.3b a Mamba-2
    layer) and none of ``other``'s, median step, tokens/s, peak memory,
    then one more step under torch.profiler for the device-busy share and
    the backward's device ms (``bwd_kernels``, its launches); with a
    ``sync_log``, one more step under phase 15d's trace."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    other.LAUNCHES = other.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    rep = train_mod.train(cfg, steps=FULL_STEPS, seq=FULL_SEQ,
                          global_batch=FULL_BATCH, microbatches=FULL_MICRO,
                          seed=0, device="cuda")
    wall = time.perf_counter() - t0
    fwd, bwd = kernel.LAUNCHES, kernel.BWD_LAUNCHES
    stray = other.LAUNCHES + other.BWD_LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    passes = FULL_STEPS * FULL_MICRO
    step_ms = 1e3 * sorted(rep.step_times)[len(rep.step_times) // 2]
    tok_s = FULL_BATCH * FULL_SEQ / (step_ms / 1e3)
    print(f"  losses {[round(x, 4) for x in rep.losses]}; step times "
          f"{[round(1e3 * t, 1) for t in rep.step_times]} ms, median "
          f"{step_ms:.1f} ms, {tok_s:.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB; {label} forward launches {fwd} = {passes} "
          f"passes x {cfg.n_layers} layers x 2 (remat), backward {bwd} = "
          f"{passes} x {cfg.n_layers}; the other kernels {stray}; "
          f"{wall:.1f} s in all", flush=True)
    check(all(x == x and abs(x) < 1e4 for x in rep.losses),
          f"non-finite losses at full width: {rep.losses}")
    check(fwd == passes * cfg.n_layers * 2,
          f"{label} forward launched {fwd} times, expected "
          f"{passes} x {cfg.n_layers} x 2")
    check(bwd == passes * cfg.n_layers,
          f"{label} backward launched {bwd} times, expected "
          f"{passes} x {cfg.n_layers}")
    check(stray == 0, f"the other kernels ran {stray} times on the "
                      f"{cfg.arch} path")
    check(peak_gb < torch.cuda.get_device_properties(0).total_memory / 1e9,
          "peak memory past the card")
    # one more step, profiled, from the trained parameters and a fresh state
    from repro_torch.models import build_model
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=FULL_STEPS)
    state = tree_defs_init(state_defs(model.param_defs, opt), None, "cuda")
    batch = SyntheticLMData(cfg, seq=FULL_SEQ, global_batch=FULL_BATCH,
                            seed=0, device="cuda").batch(FULL_STEPS)
    step = make_train_step(model, opt, microbatches=FULL_MICRO)
    params, losses = rep.params, rep.losses
    del rep

    def one(_):
        step(params, state, batch)

    def launches():
        return kernel.LAUNCHES + kernel.BWD_LAUNCHES
    print("  one more step under torch.profiler:", flush=True)
    prof = profile_steps(torch, one, 1, f"{label}_", label, launches,
                         parts=(f"{label}_bwd",) + bwd_kernels)
    if sync_log is not None:
        sync_log.run(f"15d train step, {cfg.arch}", lambda: one(0))
    del params, state, batch
    torch.cuda.empty_cache()
    bwd_ms = prof["parts_ms"][f"{label}_bwd"]
    busy = prof["device_busy_ms_per_step"]
    print(f"  {label} backward {bwd_ms:.3f} ms of the step's {busy:.3f} "
          f"busy ms ({100 * bwd_ms / busy:.1f}%): "
          + ", ".join(f"{k} {prof['parts_ms'][k]:.3f}" for k in bwd_kernels),
          flush=True)
    return {"losses": losses, "step_ms": step_ms, "tokens_per_s": tok_s,
            "peak_memory_gb": peak_gb, f"{label}_fwd_launches": fwd,
            f"{label}_bwd_launches": bwd, "seconds": wall, "profile": prof,
            f"{label}_bwd_ms_per_step": bwd_ms,
            "busy_share": busy / prof["wall_ms_per_step"]}


def run_training_phase(torch, kernel, ssd_kernel, get_config, build_model,
                       sync_log=None):
    """Phase 13: 13a the flash backward against its plain version, 13b its
    timings, 13c a train step card vs CPU for TRAIN_ARCHS and TRAIN_SSM,
    13d restarts and the small LM, 13e stablelm-1.6b at full width; 13f
    the SSD backward against its plain version, 13g its timings, 13h
    mamba2-1.3b at full width."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     lse_ref)
    from repro_torch.kernels.ssd import ssd_chunked_bwd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models.common import ModelConfig, tree_defs_init
    from repro_torch.optim import AdamWConfig, apply_updates, state_defs
    from repro_torch.optim.adamw import leaves, unflatten

    t0 = time.perf_counter()
    print("== phase 13a: flash backward kernel against its plain version "
          "(float32 at 2e-5, bf16 at 2e-2, of each gradient's max; reruns "
          "bit for bit)", flush=True)
    checks = run_bwd_checks(torch, kernel, attention_bwd_ref, lse_ref)
    print(f"== phase 13b ({time.perf_counter() - t0:.1f} s): flash "
          "backward timing (bf16, causal; device time from CUDA graph "
          "replays)", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = run_bwd_timings(torch, kernel, attention_bwd_ref, lse_ref, sdpa)
    print(f"== phase 13c ({time.perf_counter() - t0:.1f} s): one train "
          f"step at {TRAIN_LAYERS} layer(s), card against CPU "
          f"(B {TRAIN_B}, T {TRAIN_T}, float32 activations): "
          + ", ".join(TRAIN_ARCHS) + "; at T " + str(TRAIN_SSM_T) + ": "
          + ", ".join(f"{a} ({n} layers)" for a, n in TRAIN_SSM),
          flush=True)
    steps_check = {}
    for arch in TRAIN_ARCHS:
        cfg = cut_depth(get_config(arch), TRAIN_LAYERS).with_(
            dtype=torch.float32)
        steps_check[arch] = train_reference_check(
            torch, build_model, apply_updates, state_defs, tree_defs_init,
            SyntheticLMData, AdamWConfig, leaves, unflatten, cfg,
            f"{arch} ({cfg.param_count():,} parameters)",
            with_step=arch in TRAIN_STEP_ARCHS)
    for arch, n_layers in TRAIN_SSM:
        cfg = get_config(arch).with_(n_layers=n_layers, dtype=torch.float32)
        ssd_kernel.LAUNCHES = ssd_kernel.BWD_LAUNCHES = 0
        steps_check[arch] = train_reference_check(
            torch, build_model, apply_updates, state_defs, tree_defs_init,
            SyntheticLMData, AdamWConfig, leaves, unflatten, cfg,
            f"{arch} {n_layers} layers, T {TRAIN_SSM_T} "
            f"({cfg.param_count():,} parameters)", seq=TRAIN_SSM_T,
            with_step=arch in TRAIN_STEP_ARCHS)
        fwd, bwd = ssd_kernel.LAUNCHES, ssd_kernel.BWD_LAUNCHES
        print(f"  {arch}: SSD forward launches {fwd}, backward {bwd} "
              f"(one gradient pass x {n_layers} layers)", flush=True)
        check(fwd == 2 * n_layers and bwd == n_layers,
              f"{arch}: SSD launches forward {fwd}, backward {bwd}; expected "
              f"{2 * n_layers} and {n_layers}")
        steps_check[arch].update(ssd_fwd_launches=fwd, ssd_bwd_launches=bwd)
    print(f"== phase 13d ({time.perf_counter() - t0:.1f} s): restarts "
          "(stablelm-1.6b, 2 layers at full width, checkpoints every 2 "
          "steps) and the small LM on the card", flush=True)
    restart = restart_check(torch, train_mod,
                            cut_depth(get_config("stablelm-1.6b")),
                            ROOT / "build" / "ckpt_restart")
    learns = small_lm_learns(torch, build_model, steps_mod.make_train_step,
                             AdamWConfig, state_defs, tree_defs_init,
                             SyntheticLMData, ModelConfig)
    cfg = get_config("stablelm-1.6b")
    print(f"== phase 13e ({time.perf_counter() - t0:.1f} s): stablelm-1.6b "
          f"at full width ({cfg.param_count():,}"
          f" parameters), {FULL_STEPS} steps of {FULL_BATCH} x {FULL_SEQ} "
          f"tokens in {FULL_MICRO} microbatches", flush=True)
    full = full_width_training(
        torch, kernel, ssd_kernel, "flash",
        kernel.BWD_KERNELS[kernel.bwd_plan(torch.bfloat16,
                                           cfg.resolved_head_dim())],
        train_mod, steps_mod.make_train_step, AdamWConfig, state_defs,
        tree_defs_init, SyntheticLMData, cfg, sync_log)
    t13f = time.perf_counter()
    print(f"== phase 13f ({t13f - t0:.1f} s): SSD backward kernel against "
          f"its plain version in float64 (each gradient within {SSD_TOL:g} "
          "of its max; float32 and bf16 x/B/C, with the path each took; "
          "reruns bit for bit)", flush=True)
    ssd_checks = run_ssd_bwd_checks(torch, ssd_kernel, ssd_chunked_bwd)
    mcfg, zcfg = get_config("mamba2-1.3b"), get_config("zamba2-1.2b")
    print(f"== phase 13g ({time.perf_counter() - t0:.1f} s): SSD backward "
          f"timing at the training shape (B {FULL_BATCH // FULL_MICRO}, T "
          f"{FULL_SEQ}, bf16; device time from CUDA graph replays)",
          flush=True)
    ssd_rows = run_ssd_bwd_timings(torch, ssd_kernel, ssd_chunked_bwd,
                                   [("mamba2-1.3b", mcfg),
                                    ("zamba2-1.2b", zcfg)])
    print(f"== phase 13h ({time.perf_counter() - t0:.1f} s): mamba2-1.3b at "
          f"full width ({mcfg.param_count():,} parameters), {FULL_STEPS} "
          f"steps of {FULL_BATCH} x {FULL_SEQ} tokens in {FULL_MICRO} "
          "microbatches", flush=True)
    ssm_full = full_width_training(
        torch, ssd_kernel, kernel, "ssd",
        ssd_kernel.BWD_KERNELS[ssd_kernel.bwd_plan(torch.bfloat16, FULL_SEQ,
                                                   mcfg.ssm.chunk).path],
        train_mod, steps_mod.make_train_step, AdamWConfig, state_defs,
        tree_defs_init, SyntheticLMData, mcfg)
    print(f"  phases 13f-13h: {time.perf_counter() - t13f:.1f} s; phase 13: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"bwd_checks": checks, "bwd_timings": rows,
            "train_step": steps_check, "restart": restart,
            "small_lm": learns, "full_width": full,
            "ssd_bwd_checks": ssd_checks, "ssd_bwd_timings": ssd_rows,
            "ssm_full_width": ssm_full,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 14: the dry run and LotaruML against the card
# ---------------------------------------------------------------------------
#: 14b: fit_cell's partitions (FULL_BATCH / 2, / 4 and / 8 rows of FULL_SEQ
#: tokens, one microbatch) and the steps timed at each after one warm-up
#: (13e's and 13h's steps spread by ~1%, so one is read)
FIT_PARTITIONS, FIT_STEPS = 3, 1
#: 14b: the card as Lotaru's local node
LOCAL_NODE = "local-h100"
def dryrun_cut(arch, measured, smi):
    """14a: the dry run of 13e's / 13h's cut (FULL_BATCH x FULL_SEQ in
    FULL_MICRO microbatches, fp32 weights and AdamW state, bf16
    activations, full remat) beside that run's median step and peak."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.shapes import ShapeSpec
    rec = run_cell(arch, "train_4k",
                   spec=ShapeSpec("train_4k", "train", FULL_SEQ, FULL_BATCH),
                   dist={"microbatches": FULL_MICRO})
    check(rec["status"] == "ok", f"14a: {arch}'s dry run: {rec}")
    rf, mem = rec["roofline"], rec["memory"]
    step_s = measured["step_ms"] / 1e3
    mfu = rf["model_flops_total"] / (step_s * BF16_FLOPS)
    dry_gb = mem["hbm_estimate_bytes"] / 1e9
    gap = dry_gb / measured["peak_memory_gb"] - 1
    print(f"  {arch}: model FLOPs {rf['model_flops_total']:.6e}, dry run "
          f"{rf['flops_per_device']:.6e} FLOPs ("
          + ", ".join(f"{k} {v:.4e}" for k, v in rec["flops_by_op"].items())
          + f"), {rf['bytes_per_device']:.6e} bytes; roofline step "
          f"{rf['step_time_s'] * 1e3:.1f} ms ({rf['bound']}-bound) against "
          f"the measured {measured['step_ms']:.1f} ms; MFU {mfu:.4f} "
          f"(model FLOPs / (step x {BF16_FLOPS:.3g})); peak {dry_gb:.2f} GB "
          f"(arguments {mem['argument_bytes'] / 1e9:.2f} + step "
          f"{mem['temp_bytes'] / 1e9:.2f}) against the measured "
          f"{measured['peak_memory_gb']:.2f} GB ({100 * gap:+.1f}%); "
          f"traced in {rec['trace_s']:.1f} s; {smi}", flush=True)
    return rec, {"model_flops": rf["model_flops_total"],
                 "flops": rf["flops_per_device"],
                 "flops_by_op": rec["flops_by_op"],
                 "bytes": rf["bytes_per_device"],
                 "roofline_step_ms": rf["step_time_s"] * 1e3,
                 "bound": rf["bound"], "measured_step_ms": measured["step_ms"],
                 "mfu": mfu, "dryrun_peak_gb": dry_gb,
                 "measured_peak_gb": measured["peak_memory_gb"],
                 "peak_gap": gap, "trace_s": rec["trace_s"]}


def local_runs(torch, cfg):
    """14b's ``run_local(cell, f)``: ``make_train_step`` of ``cfg`` at
    full width on the card, f x FULL_BATCH rows of FULL_SEQ tokens in one
    microbatch, the median of FIT_STEPS timed steps after one warm-up
    (host clock around the step and a read of its loss, as
    ``launch.train``); and ``full_step()``, the same harness at 13e's
    FULL_BATCH rows in FULL_MICRO microbatches.  Parameters and state are
    drawn anew (seed 0): 13e's and 13h's were freed, and the step's time
    does not depend on their values.  Returns (run_local, {f: seconds},
    full_step, release)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_defs_init
    from repro_torch.optim import AdamWConfig, state_defs
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=FULL_STEPS)
    held = {"params": model.init(0, device="cuda"),
            "state": tree_defs_init(state_defs(model.param_defs, opt), None,
                                    "cuda")}
    measured = {}

    def median_step(rows, micro):
        step = make_train_step(model, opt, microbatches=micro)
        batch = SyntheticLMData(cfg, seq=FULL_SEQ, global_batch=rows,
                                seed=0, device="cuda").batch(0)
        times = []
        for _ in range(1 + FIT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, metrics = step(held["params"], held["state"], batch)
            float(metrics["loss"])
            times.append(time.perf_counter() - t0)
        print(f"    {rows} x {FULL_SEQ} tokens in {micro} microbatch(es): "
              f"steps {[round(1e3 * t, 1) for t in times]} ms (the first a "
              f"warm-up), median {1e3 * sorted(times[1:])[FIT_STEPS // 2]:.1f}"
              " ms", flush=True)
        return sorted(times[1:])[FIT_STEPS // 2]

    def run_local(cell, f):
        measured[f] = median_step(round(f * FULL_BATCH), 1)
        return measured[f]

    def full_step():
        return median_step(FULL_BATCH, FULL_MICRO)

    def release():
        held.clear()
        torch.cuda.empty_cache()
    return run_local, measured, full_step, release


def posterior_errs(a, b) -> float:
    """The worst rel_err between two cells' fitted models (the posterior
    fields, or the median fallback's)."""
    from repro_torch.core.blr import POSTERIOR_FIELDS
    check(a.correlated == b.correlated, "14b: the gates differ")
    errs = [rel_err([a.median, a.spread], [b.median, b.spread])]
    if a.correlated:
        errs += [rel_err(getattr(a.post, f).cpu(), getattr(b.post, f))
                 for f in POSTERIOR_FIELDS]
    return max(errs)


def lotaru_ml_on_card(torch, records, cfgs, measured, smi):
    """14b: ``LotaruML`` fitted from the card's own training steps: the
    local bench ``profile_local(fast=False, device="cuda")``, the simulated
    targets (``profile_cluster(target_nodes(), seed=13)``, as
    examples/heterogeneous_schedule_torch.py), ``fit_cell(record,
    run_local, n_partitions=FIT_PARTITIONS)`` for each dry-run record,
    the predicted full step against 13e's / 13h's measured median; then
    the same fit on the CPU from the same runtimes, which must equal the
    card's within EST_TOL."""
    from repro_torch.core import (LotaruML, profile_cluster, profile_local,
                                  target_nodes)
    local = profile_local(LOCAL_NODE, fast=False, device="cuda")
    targets = profile_cluster(target_nodes(), seed=13)
    print(f"  local bench ({smi}): matmul {local.matmul_gflops:.1f} GFLOP/s, "
          f"memory {local.mem_gbps:.1f} GB/s", flush=True)
    card = LotaruML(local, targets, device="cuda")
    cpu = LotaruML(local, targets, device="cpu")
    out = {"local_bench": local.to_dict()}
    for arch, rec in records.items():
        name = f"{rec['arch']}__{rec['shape']}"
        run_local, runtimes, full_step, release = local_runs(torch,
                                                            cfgs[arch])
        card.fit_cell(rec, run_local, n_partitions=FIT_PARTITIONS)
        same_ms = 1e3 * full_step()
        release()
        cpu.fit_cell(rec, lambda cell, f: runtimes[f],
                     n_partitions=FIT_PARTITIONS)
        mean, std = card.predict(name, LOCAL_NODE)
        step_ms = measured[arch]["step_ms"]
        err = mean * 1e3 / step_ms - 1
        preds = {n: card.predict(name, n) for n in [LOCAL_NODE] + list(targets)}
        cpu_preds = {n: cpu.predict(name, n) for n in preds}
        worst = max([posterior_errs(card.cells[name].model,
                                    cpu.cells[name].model)]
                    + [rel_err(preds[n], cpu_preds[n]) for n in preds])
        print(f"  {arch}: predicted full step {1e3 * mean:.1f} +- "
              f"{1e3 * std:.1f} ms against the measured {step_ms:.1f} ms "
              f"({100 * err:+.1f}%; this harness's full step {same_ms:.1f} "
              f"ms, {100 * (mean * 1e3 / same_ms - 1):+.1f}%); simulated "
              "targets: "
              + ", ".join(f"{n} {1e3 * m:.1f} ms" for n, (m, _) in
                          preds.items() if n != LOCAL_NODE)
              + f"; the CPU's fit against the card's {worst:.3e}",
              flush=True)
        check(worst <= EST_TOL, f"14b: {arch}: the CPU's fit is "
                                f"{worst:.3e} off the card's")
        out[arch] = {"runtimes_s": {str(f): t for f, t in runtimes.items()},
                     "predicted_ms": 1e3 * mean, "predicted_std_ms": 1e3 * std,
                     "measured_ms": step_ms, "rel_err": err,
                     "harness_full_step_ms": same_ms,
                     "targets_ms": {n: 1e3 * m for n, (m, _) in preds.items()},
                     "cpu_vs_card": worst}
    return out


def run_dryrun_phase(torch, get_config, training, smi):
    """Phase 14: 14a the dry runs of 13e's and 13h's cuts, 14b LotaruML
    from the card's steps."""
    t0 = time.time()
    measured = {"stablelm-1.6b": training["full_width"],
                "mamba2-1.3b": training["ssm_full_width"]}
    print("== phase 14a: the dry run of 13e's and 13h's cuts "
          f"(B {FULL_BATCH} x T {FULL_SEQ} in {FULL_MICRO} microbatches)",
          flush=True)
    records, cuts = {}, {}
    for arch in measured:
        records[arch], cuts[arch] = dryrun_cut(arch, measured[arch], smi)
    print(f"== phase 14b ({time.time() - t0:.1f} s): LotaruML from the "
          f"card's steps ({FIT_PARTITIONS} partitions: {FULL_BATCH // 2}, "
          f"{FULL_BATCH // 4}, {FULL_BATCH // 8} rows x {FULL_SEQ}; median "
          f"of {FIT_STEPS} step(s) after a warm-up)", flush=True)
    ml = lotaru_ml_on_card(torch, records,
                           {a: get_config(a) for a in measured}, measured,
                           smi)
    return {"cuts": cuts, "lotaru_ml": ml, "seconds": time.time() - t0}


# ---------------------------------------------------------------------------
# Phase 16: the sharded train step on one card (two gloo processes)
# ---------------------------------------------------------------------------
P16_ARCH, P16_SSM = "stablelm-1.6b", ("mamba2-1.3b", 2)
P16_SEQ, P16_BATCH = 4096, 4
P16_TOL = 3e-2            # the models' bar at bf16 activations
P16_TIMEOUT = 240         # seconds for the two ranks, then they are ended
#: 16e: qwen3-moe at full width and TRAIN_LAYERS layer(s), a microbatch
#: of P16_BATCH x P16_SEQ tokens in P16_MOE_GROUPS groups (S 8,192, C
#: 640), on a (2, 1) mesh (a group a rank) and a (1, 2) mesh (64 of the
#: 128 experts a rank); fp32 weights and bf16 activations, as 16a-16c
#: (with bf16 weights each rank's gradient is a bf16 partial sum: the
#: (2, 1) mesh's gradients were 4.96e-2 x max off the one-process step on
#: the card, past the models' bar)
P16_MOE = "qwen3-moe-30b-a3b"
P16_MOE_GROUPS = 2
#: 16e's (mesh, activation dtype, gated): at (1, 2) the attention heads are
#: split over "model" too, and at bf16 its reordered fp32 sums change the
#: rounding of some hidden states, which moves the router's top-8 of a few
#: tokens and the gradients of the experts they leave or join by their
#: whole contribution (4.01e-2 x max off one process in chip call 1 of PR
#: 30): that run prints how many tokens the router sent elsewhere, and
#: the gated (1, 2) run is at float32 activations against a float32
#: one-process step
P16_MOE_RUNS = (((2, 1), "bfloat16", True), ((1, 2), "float32", True),
                ((1, 2), "bfloat16", False))


def p16e_label(shape, dtype) -> str:
    return f"{P16_MOE} {tuple(shape)} {dtype}"


def p16e_ref(dtype) -> str:
    return P16_MOE if dtype == "bfloat16" else f"{P16_MOE} {dtype}"
#: 16f: tensor-parallel training on the (1, 2) mesh, (arch, n_layers):
#: stablelm-1.6b at its full depth, qwen2-7b at one layer and mamba2-1.3b
#: at 2 layers, each against its one-process step at unit score variance
#: (``unit_score_scale``): at the init's scores the split's reordered sums
#: alone took stablelm's 24 layers 1.68 x max off one process (chip call
#: 2 of PR 30), as deep attention at those scores carries any rounding
#: difference (phase 6, phase 17)
P16F = ((P16_ARCH, 0), ("qwen2-7b", 1), P16_SSM)
P16F_MESH = (1, 2)
#: the tensor-parallel collective kinds 16f prints (launch.sharding)
TP_KINDS = ("embed_sum", "tp_sum", "tp_grad", "kv_grad", "norm_sum", "xent")


def p16f_label(arch) -> str:
    return f"{arch} {P16F_MESH}"


def p16f_ref(arch) -> str:
    return f"{arch} 16f"


def p16_opt():
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=FULL_STEPS)


def p16_config(get_config, arch, n_layers=0, dtype=None):
    """The config of a phase-16 run; ``dtype`` (a torch dtype's name) the
    activations' (default the config's, bf16)."""
    cfg = get_config(arch)
    if arch == P16_MOE:
        cfg = cfg.with_(moe_groups=P16_MOE_GROUPS)
    if dtype is not None:
        import torch
        cfg = cfg.with_(dtype=getattr(torch, dtype))
    return cfg.with_(n_layers=n_layers) if n_layers else cfg


def first_route(moe):
    """Wrap ``moe.route``: ``seen`` gets the sorted expert choices (G, S, K)
    of its first call (a one-layer step's forward; the remat's recompute
    calls it again).  Returns (seen, restore)."""
    route = moe.route
    seen = []

    def recording(*args):
        out = route(*args)
        if not seen:
            seen.append(out[1].sort(dim=-1).values)
        return out
    moe.route = recording
    return seen, (lambda: setattr(moe, "route", route))


def p16_counts(kernel, ssd_kernel) -> dict:
    return {"flash_fwd": kernel.LAUNCHES, "flash_bwd": kernel.BWD_LAUNCHES,
            "ssd_fwd": ssd_kernel.LAUNCHES, "ssd_bwd": ssd_kernel.BWD_LAUNCHES}


def p16_reset(kernel, ssd_kernel) -> None:
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    ssd_kernel.LAUNCHES = ssd_kernel.BWD_LAUNCHES = 0


def p16_expected(cfg) -> dict:
    """A one-microbatch step's launches of each kernel (full remat: the
    forward twice a layer, the backward once)."""
    attn = cfg.family != "ssm"
    n = cfg.n_layers
    return {"flash_fwd": 2 * n if attn else 0, "flash_bwd": n if attn else 0,
            "ssd_fwd": 0 if attn else 2 * n, "ssd_bwd": 0 if attn else n}


def leaf_paths(tree, prefix=""):
    """Each leaf's key path, "a/b/c", in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def p16_step(torch, step, params, state, batch):
    """One step, timed to its end on the card: (params, state, metrics,
    ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    float(m["loss"])
    torch.cuda.synchronize()
    return params, state, m, 1e3 * (time.perf_counter() - t0)


def traced_step(trace_syncs, fn):
    """``(fn(), sites, native)``: ``fn()`` under the sync trace
    (``sites``: the syncs of this thread, by site) with the process's
    stderr read meanwhile: gloo's worker threads sync on CUDA tensors
    outside Python, where the detector's warning goes to stderr; ``native``
    counts those warnings."""
    import tempfile
    from repro_torch.analysis.syncs import SYNC_MESSAGE
    with tempfile.TemporaryFile(mode="w+") as f:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(f.fileno(), 2)
        try:
            out, sites = trace_syncs(fn)
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        native = f.read().count(SYNC_MESSAGE)
    return out, sites, native


#: 16d: phase 10a's big point at W 64 (FLEET_BIG's T x N and its
#: observations a workflow, each workflow at its own size), with bias decay
#: and empirical-Bayes pooling, so that the sharded tick has its two
#: per-workflow sums to complete over "task"; on each ("wf", "task") mesh
#: of phase 16's two ranks
P16_FLEET_W = 64
P16_FLEET_BIAS = {"bias_decay": 0.97, "bias_empirical_bayes": True}
P16_FLEET_MESHES = ((2, 1), (1, 2))


def p16_fleet():
    """16d's global fleet, built on the CPU from seed 0 (the same bits in
    every process), and the workflows' sizes."""
    import numpy as np
    from repro_torch.core import build_state
    from repro_torch.online.fleet import stack_states
    _, T, N, _ = FLEET_BIG
    base = synthetic_estimator(T, N, "cpu", **P16_FLEET_BIAS)
    state = build_state(base, list(base.target_benches))[0]
    return (stack_states([state] * P16_FLEET_W),
            FLEET_SIZE * np.linspace(0.5, 1.5, P16_FLEET_W))


def fleet_leaves(fleet) -> dict:
    """Every tensor leaf of a fleet (or every spec of ``fleet_pspecs``),
    by name."""
    from repro_torch.core import blr
    st, m = fleet.state, fleet.state.model
    out = {"moments": m.stats.moments, "correlated": m.correlated,
           "median": m.median, "spread": m.spread,
           **{f: getattr(m.post, f) for f in blr.POSTERIOR_FIELDS}}
    for f in ("factors", "node_cols", "bias_counts", "bias_log_sum",
              "bias_log_sq", "rel_succ", "rel_fail"):
        out[f] = getattr(st, f)
    out["t_count"], out["n_count"] = fleet.t_count, fleet.n_count
    return out


def fleet_ticks(torch, fleet, sizes, on_tick=None):
    """``fleet_predict``, then FLEET_TICKS timed ticks of ``fleet_obs``
    (seeds 1-4): (fleet, the (mean, std) of each, a row a tick: host and
    CUDA-event ms, and what ``on_tick`` returns)."""
    from repro_torch.online.fleet import fleet_predict, fleet_tick_step
    _, T, N, B = FLEET_BIG
    outs = [fleet_predict(fleet, sizes)]
    ticks = []
    for k in range(FLEET_TICKS):
        obs = fleet_obs(P16_FLEET_W, T, N, B, k + 1)
        (fleet, m, s), host, dev = timed(
            torch, lambda: fleet_tick_step(fleet, obs, sizes), "cuda")
        ticks.append({"host_ms": host, "device_ms": dev,
                      **(on_tick() if on_tick else {})})
        outs.append((m, s))
    return fleet, outs, ticks


def fleet_reference(torch, path):
    """16d's reference, run by the parent before the spawn: the global
    fleet placed whole on the card's (1, 1) mesh, its predict and ticks
    (``fleet_ticks``); the outputs and the final leaves saved to ``path``
    for the ranks.  Returns its row."""
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.online.fleet import shard_fleet
    whole, sizes = p16_fleet()
    fleet = shard_fleet(whole, make_fleet_mesh(device="cuda:0"))
    del whole
    torch.cuda.reset_peak_memory_stats()
    fleet, outs, ticks = fleet_ticks(torch, fleet, sizes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.save({"outs": [(m.cpu(), s.cpu()) for m, s in outs],
                "leaves": {k: v.cpu() for k, v in
                           fleet_leaves(fleet).items()}}, path)
    return {"ticks": ticks, "steady_host_ms": steady(ticks, "host_ms"),
            "steady_device_ms": steady(ticks, "device_ms"),
            "peak_memory_gb": peak_gb}


def fleet_on_meshes(torch, device, ref_path):
    """16d in one rank: for each of P16_FLEET_MESHES, the global fleet
    (``p16_fleet``) sharded over the two ranks, predicted and ticked as the
    parent's reference (``fleet_ticks``), then the last tick's matrices
    read back whole (``fleet_gather``).  Every output and final leaf of the
    rank is held to its slice of the reference, the gathered matrices to
    the whole (``rel_err``; bit for bit or not); each tick's collective
    payload and calls, the gather's ms and bytes and the peak memory are
    recorded.  Returns a row a mesh."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.online.fleet import (fleet_gather, fleet_pspecs,
                                          shard_fleet)
    ref = torch.load(ref_path, mmap=True)
    whole, sizes = p16_fleet()
    rows = []
    for shape in P16_FLEET_MESHES:
        mesh = make_fleet_mesh(wf=shape[0], task=shape[1], device=device)
        specs = fleet_leaves(fleet_pspecs(whole, mesh))

        def cut(x, spec):
            return x[sharding.Sharding(mesh, spec).slices(x.shape)]

        def counts():
            out = {"bytes": dict(sharding.BYTES),
                   "calls": dict(sharding.CALLS)}
            sharding.reset_counts()
            return out

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fleet = shard_fleet(whole, mesh)
        sharding.reset_counts()
        fleet, outs, ticks = fleet_ticks(torch, fleet, sizes, counts)
        gathered, gather_ms, gather_dev_ms = timed(
            torch, lambda: fleet_gather(outs[-1][0], fleet), "cuda")
        gather = counts()
        gathered = (gathered, fleet_gather(outs[-1][1], fleet))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        pairs = [(a, cut(b, ("wf", "task")))
                 for out, ref_out in zip(outs, ref["outs"])
                 for a, b in zip(out, ref_out)]
        pairs += [(leaf, cut(ref["leaves"][name], specs[name]))
                  for name, leaf in fleet_leaves(fleet).items()]
        whole_pairs = list(zip(gathered, ref["outs"][-1]))
        rows.append({
            "mesh": list(shape), "coords": list(mesh.coords),
            "local_shape": list(fleet.state.factors.shape), "ticks": ticks,
            "steady_host_ms": steady(ticks, "host_ms"),
            "steady_device_ms": steady(ticks, "device_ms"),
            "gather_ms": gather_ms, "gather_device_ms": gather_dev_ms,
            "gather_bytes": gather["bytes"], "gather_calls": gather["calls"],
            "peak_memory_gb": peak_gb,
            "rel_err": max(rel_err(a.cpu(), b) for a, b in pairs),
            "gather_rel_err": max(rel_err(a.cpu(), b)
                                  for a, b in whole_pairs),
            "bit_for_bit": all(torch.equal(a.cpu(), b)
                               for a, b in pairs + whole_pairs)})
        del fleet, outs, gathered, pairs, whole_pairs
    return rows


def sharded_worker(rank, device, runs, ref_root, out_dir, fleet_ref):
    """16b/16c/16e, one rank of a ("data", "model") mesh of the two
    processes on the one card: for each (label, arch, n_layers, mesh
    shape, reference) of ``runs``, the global parameters drawn from seed
    0 with this rank's slice kept, this rank's rows of the global batch,
    one sharded step (timed under the sync trace, its kernel launches and
    collective bytes counted) held to the one-device step's gradient
    slices and loss under ``ref_root / reference``; then 16d, the fleet
    on the ("wf", "task") meshes of the two ranks against the reference
    ``fleet_ref`` (``fleet_on_meshes``).  Writes ``rank<r>.json`` to
    ``out_dir``."""
    from collections import Counter

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.analysis.syncs import trace_syncs
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_defs_to_specs
    from repro_torch.optim import state_defs
    from repro_torch.optim.adamw import leaves

    meshes = {}
    opt = p16_opt()
    out = {}
    from repro_torch.models import moe as moe_mod
    for label, arch, n_layers, shape, ref_label, dtype, unit in runs:
        t_run = time.perf_counter()
        shape = tuple(shape)
        if shape not in meshes:       # every rank forms them in one order
            meshes[shape] = make_mesh(shape, ("data", "model"),
                                      device=device)
        mesh = meshes[shape]
        rules = make_rules(mesh)
        cfg = p16_config(get_config, arch, n_layers, dtype)
        model = build_model(cfg)
        sdefs = state_defs(model.param_defs, opt)
        psh = sharding.tree_shardings(model.param_specs(rules), mesh)
        ssh = sharding.tree_shardings(tree_defs_to_specs(sdefs, rules), mesh)
        gen = torch.Generator(device=device).manual_seed(0)
        params = sharding.init_local(model.param_defs, gen, device, psh)
        if unit:
            params = unit_score_scale(params, cfg)
        state = sharding.init_local(sdefs, None, device, ssh)
        batch = sharding.local_batch(
            SyntheticLMData(cfg, seq=P16_SEQ, global_batch=P16_BATCH, seed=0,
                            device=device).batch(0), mesh, rules)
        step = make_train_step(model, opt, rules=rules, mesh=mesh,
                               keep_grads=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p16_reset(kernel, ssd_kernel)
        sharding.reset_counts()
        routes, unwrap = (first_route(moe_mod) if cfg.moe is not None
                          else ([], lambda: None))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            (params, state, m), sites, native = traced_step(
                trace_syncs, lambda: step(params, state, batch))
        finally:
            unwrap()
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = p16_counts(kernel, ssd_kernel)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        collective = {"bytes": dict(sharding.BYTES),
                      "calls": dict(sharding.CALLS)}
        gnorm = float(m["grad_norm"])
        grads = leaves(m["grads"])
        rows = batch["tokens"].shape[0]
        # this rank's slice of an expert leaf: E/tp experts
        wg = (list(m["grads"]["blocks"]["moe_layer"]["moe"]["wg"].shape)
              if cfg.moe is not None else None)
        del m, params, state, step, batch
        ref, manifest = restore(ref_root / ref_label, device=device,
                                shardings={"grads": psh})
        rerouted = None
        if routes:
            # the tokens whose top-k the router chose otherwise than the
            # one-process step did
            one_route = torch.load(ref_root / f"{ref_label}.route.pt",
                                   map_location=device)
            # this rank's groups of the microbatch's (split over dp)
            g = routes[0].shape[0]
            one_route = one_route[g * sharding.dp_index(
                mesh, sharding.dp_axes(mesh, rules)):][:g]
            rerouted = [int((routes[0] != one_route).any(-1).sum()),
                        int(one_route[..., 0].numel())]
        errs = [grad_rel(g, r) for g, r in zip(grads, leaves(ref["grads"]))]
        worst = max(range(len(errs)), key=errs.__getitem__)
        ref_loss = manifest["metadata"]["loss"]
        same = loss == ref_loss and all(
            torch.equal(g, r) for g, r in zip(grads, leaves(ref["grads"])))
        local_gb = sum(g.numel() * g.element_size() for g in grads) / 1e9
        out[label] = {
            "arch": arch, "n_layers": cfg.n_layers, "mesh": mesh.shape,
            "coords": list(mesh.coords), "rows": rows,
            "loss": loss, "ref_loss": ref_loss,
            "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
            "grad_rel_err": max(errs), "grad_norm": gnorm,
            "worst_leaf": leaf_paths(model.param_defs)[worst],
            "local_grad_gb": local_gb, "bit_for_bit": same,
            "expert_leaf_slice": wg, "rerouted_tokens": rerouted,
            "step_ms": ms, "peak_memory_gb": peak_gb,
            "collective": collective, "launches": launches,
            "expected_launches": p16_expected(cfg),
            "syncs": len(sites),
            "sync_sites": {str(k): v for k, v in
                           Counter(sites).most_common()},
            "gloo_thread_syncs": native,
            "seconds": time.perf_counter() - t_run}
        del grads, ref
        gc.collect()          # the step's reference cycles hold tensors
        torch.cuda.empty_cache()
    out["fleet"] = fleet_on_meshes(torch, device, fleet_ref)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def one_device_steps(torch, kernel, ssd_kernel, get_config, label, arch,
                     n_layers, ref_dir, both, dtype=None, unit=False):
    """The one-device step of ``arch`` (seed 0, the global batch of
    P16_BATCH x P16_SEQ): without rules and through the (1, 1) mesh with
    ``make_rules`` (``both``: held equal bit for bit in loss, gradients
    and updated weights), or through the (1, 1) mesh alone.  Saves the
    last step's gradients and loss under ``ref_dir`` (the checkpoint
    format) for the ranks of 16b/16c, and for a MoE config the router's
    first choices beside it (``first_route``); returns its row.  ``dtype``:
    the activations' (``p16_config``); ``unit``: the weights at unit
    score variance (``unit_score_scale``)."""
    from repro_torch.checkpoint import save
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_defs_init
    from repro_torch.optim import state_defs
    from repro_torch.optim.adamw import leaves, unflatten

    from repro_torch.models import moe as moe_mod
    cfg = p16_config(get_config, arch, n_layers, dtype)
    model = build_model(cfg)
    opt = p16_opt()
    sdefs = state_defs(model.param_defs, opt)
    batch = SyntheticLMData(cfg, seq=P16_SEQ, global_batch=P16_BATCH, seed=0,
                            device="cuda").batch(0)
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    ways = [("no rules", {})] if both else []
    ways.append(("(1, 1) mesh", {"rules": make_rules(mesh), "mesh": mesh}))
    runs = {}
    for name, kw in ways:
        params = model.init(0, device="cuda")
        if unit:
            params = unit_score_scale(params, cfg)
        state = tree_defs_init(sdefs, None, "cuda")
        step = make_train_step(model, opt, keep_grads=True, **kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p16_reset(kernel, ssd_kernel)
        routes, unwrap = (first_route(moe_mod) if cfg.moe is not None
                          else ([], lambda: None))
        try:
            params, state, m, ms = p16_step(torch, step, params, state,
                                            batch)
        finally:
            unwrap()
        if routes:
            torch.save(routes[0].cpu(), Path(f"{ref_dir}.route.pt"))
        runs[name] = {"loss": m["loss"], "grad_norm": m["grad_norm"],
                      "grads": leaves(m["grads"]), "params": leaves(params),
                      "ms": ms, "launches": p16_counts(kernel, ssd_kernel),
                      "peak_memory_gb": torch.cuda.max_memory_allocated()
                      / 1e9}
        del params, state, m, step
    expected = p16_expected(cfg)
    for name, r in runs.items():
        print(f"  {label} {name}: loss {float(r['loss']):.6f}, grad norm "
              f"{float(r['grad_norm']):.6f}, step {r['ms']:.1f} ms, peak "
              f"{r['peak_memory_gb']:.2f} GB, launches {r['launches']}",
              flush=True)
        check(r["launches"] == expected,
              f"16 {label} {name}: launches {r['launches']}, expected "
              f"{expected}")
    row = {name: {k: (float(v) if k in ("loss", "grad_norm") else v)
                  for k, v in r.items() if k not in ("grads", "params")}
           for name, r in runs.items()}
    last = runs["(1, 1) mesh"]
    if both:
        a = runs["no rules"]
        same = (torch.equal(a["loss"], last["loss"])
                and torch.equal(a["grad_norm"], last["grad_norm"])
                and all(torch.equal(x, y) for x, y in
                        zip(a["grads"] + a["params"],
                            last["grads"] + last["params"])))
        print(f"  {label}: the (1, 1) mesh step equals the step without "
              f"rules bit for bit (loss, grad norm, {len(a['grads'])} "
              f"gradients, the updated weights): {same}", flush=True)
        check(same, f"16a {label}: the (1, 1) mesh step differs from the "
                    "step without rules")
        row["bit_for_bit"] = same
        del a
    t0 = time.perf_counter()
    save(ref_dir, 0, {"grads": unflatten(model.param_defs, last["grads"])},
         metadata={"loss": float(last["loss"])})
    row["ref_save_s"] = time.perf_counter() - t0
    del runs, last
    # the step leaves reference cycles (its tensors among them) for the
    # collector: free them before the card is handed to the ranks
    gc.collect()
    torch.cuda.empty_cache()
    return row


def print_fleet_mesh(fleet, smi):
    """16d's lines, and its gate: every rank's slices and the gathered
    matrices within EST_TOL of the one-process reference."""
    _, T, N, B = FLEET_BIG
    one = fleet["one_process"]
    print(f"== phase 16d: the fleet, W {P16_FLEET_W} x T {T} x N {N}, "
          f"{B:,} observations a workflow a tick, on the ("
          "\"wf\", \"task\") meshes of the two ranks; " + smi, flush=True)
    print(f"  one process, the card's (1, 1) mesh (the reference): a tick "
          f"{one['steady_host_ms']:.3f} ms host, "
          f"{one['steady_device_ms']:.3f} ms CUDA events (first "
          f"{one['ticks'][0]['host_ms']:.3f} / "
          f"{one['ticks'][0]['device_ms']:.3f}); peak "
          f"{one['peak_memory_gb']:.3f} GB", flush=True)
    for i, shape in enumerate(P16_FLEET_MESHES):
        for r, rows in enumerate(fleet["ranks"]):
            x = rows[i]
            moved = ", ".join(f"{k} {v:,} B in {x['ticks'][-1]['calls'][k]}"
                              for k, v in x["ticks"][-1]["bytes"].items())
            gathered = ", ".join(f"{k} {v:,} B in {x['gather_calls'][k]}"
                                 for k, v in x["gather_bytes"].items())
            print(f"  {tuple(shape)} rank {r} {tuple(x['coords'])}, slice "
                  f"{tuple(x['local_shape'])}: a tick "
                  f"{x['steady_host_ms']:.3f} ms host, "
                  f"{x['steady_device_ms']:.3f} ms CUDA events (first "
                  f"{x['ticks'][0]['host_ms']:.3f} / "
                  f"{x['ticks'][0]['device_ms']:.3f}); collectives a tick: "
                  f"{moved or 'none'}; fleet_gather {x['gather_ms']:.3f} ms "
                  f"host, {x['gather_device_ms']:.3f} ms events, "
                  f"{gathered or 'none'}; peak {x['peak_memory_gb']:.3f} GB; "
                  f"slices {x['rel_err']:.3e}, gathered "
                  f"{x['gather_rel_err']:.3e} off the reference (tol "
                  f"{EST_TOL}); bit for bit: {x['bit_for_bit']}", flush=True)
            check(x["rel_err"] <= EST_TOL and x["gather_rel_err"] <= EST_TOL,
                  f"16d {tuple(shape)} rank {r}: slices {x['rel_err']:.3e}, "
                  f"gathered {x['gather_rel_err']:.3e} (tol {EST_TOL})")


def print_moe_meshes(one, ranks, cfg, smi):
    """16e's lines, and its gate (P16_MOE_RUNS' gated runs): each rank's
    loss and gradient slices within P16_TOL x max of the one-process step
    at its activation dtype, its expert leaves' slices E/tp experts, its
    flash launches those of a step."""
    E = cfg.moe.n_experts
    print(f"== phase 16e: {P16_MOE} at full width, {cfg.n_layers} layer(s), "
          f"fp32 weights, {E} experts top-"
          f"{cfg.moe.top_k}, moe_groups "
          f"{P16_MOE_GROUPS}, {P16_BATCH} x {P16_SEQ} tokens; {smi}",
          flush=True)
    for dtype in sorted({d for _, d, _ in P16_MOE_RUNS}):
        ref = one[p16e_ref(dtype)]["(1, 1) mesh"]
        print(f"  one process at {dtype} activations (the reference): step "
              f"{ref['ms']:.1f} ms, peak {ref['peak_memory_gb']:.2f} GB, "
              f"launches {ref['launches']}", flush=True)
    for shape, dtype, gated in P16_MOE_RUNS:
        label = p16e_label(shape, dtype)
        for r, rank in enumerate(ranks):
            x = rank[label]
            moved, calls = x["collective"]["bytes"], x["collective"]["calls"]
            tp = x["mesh"]["model"]
            print(f"  {label} rank {r} {tuple(x['coords'])} ({x['rows']} "
                  f"rows, expert leaf slice {x['expert_leaf_slice']}): step "
                  f"{x['step_ms']:.1f} ms, peak {x['peak_memory_gb']:.2f} "
                  f"GB; gathered: expert leaves "
                  f"{moved.get('all_gather_experts', 0) / 1e9:.3f} GB, the "
                  f"rest {moved.get('all_gather', 0) / 1e9:.3f} GB; "
                  f"exchange {moved.get('exchange', 0) / 1e9:.3f} GB in "
                  f"{calls.get('exchange', 0)} calls; all collectives (B) "
                  f"{moved}; loss "
                  f"{x['loss']:.6f}, loss {x['loss_rel_err']:.2e} and "
                  f"gradient slices {x['grad_rel_err']:.2e} x max off the "
                  f"one-process step (tol {P16_TOL}; the worst leaf "
                  f"{x['worst_leaf']}); bit for bit: "
                  f"{x['bit_for_bit']} (measured only); tokens routed "
                  f"otherwise {x['rerouted_tokens']} (of the microbatch's); "
                  f"flash launches fwd {x['launches']['flash_fwd']}, bwd "
                  f"{x['launches']['flash_bwd']}"
                  + ("" if gated else "; measured only, the gated (1, 2) "
                     "run is at float32"), flush=True)
            check(not gated or (x["loss_rel_err"] <= P16_TOL
                                and x["grad_rel_err"] <= P16_TOL),
                  f"16e {label} rank {r}: loss {x['loss_rel_err']:.3e}, "
                  f"gradients {x['grad_rel_err']:.3e} (tol {P16_TOL})")
            check(x["expert_leaf_slice"][1] == E // tp,
                  f"16e {label} rank {r}: expert slice "
                  f"{x['expert_leaf_slice']}, expected {E // tp} experts")
            check(x["launches"] == x["expected_launches"],
                  f"16e {label} rank {r}: launches {x['launches']}, "
                  f"expected {x['expected_launches']}")
            check((moved.get("exchange", 0) > 0) == (tp > 1),
                  f"16e {label} rank {r}: exchange "
                  f"{moved.get('exchange', 0)} B on a mesh of tp {tp}")
        check(ranks[0][label]["loss"] == ranks[1][label]["loss"],
              f"16e {label}: the ranks report different losses")


def print_tp_meshes(one, ranks, smi):
    """16f's lines, and its gates: each rank's loss and gradient slices
    within P16_TOL x max of the one-process step, its launches a step's,
    nothing gathered for a dense config and only "all_gather_model" for
    mamba2 (no fsdp axis of more than one rank on (1, 2)), the ranks'
    losses equal."""
    print(f"== phase 16f: tensor-parallel training on the {P16F_MESH} mesh "
          "of the two ranks (heads, KV heads, MLP, vocab and SSM heads "
          f"over \"model\"), {P16_BATCH} x {P16_SEQ} tokens, fp32 weights at "
          f"unit score variance, bf16 activations; {smi}", flush=True)
    for arch, n in P16F:
        label = p16f_label(arch)
        ref = one[p16f_ref(arch)]["(1, 1) mesh"]
        print(f"  {label}, {ranks[0][label]['n_layers']} layer(s): one "
              f"process {ref['ms']:.1f} ms, peak "
              f"{ref['peak_memory_gb']:.2f} GB", flush=True)
        for r, rank in enumerate(ranks):
            x = rank[label]
            moved, calls = x["collective"]["bytes"], x["collective"]["calls"]
            gathered = {k: v for k, v in moved.items()
                        if k.startswith("all_gather")}
            tp = {k: f"{moved[k] / 1e9:.3f} GB in {calls[k]}"
                  for k in TP_KINDS if k in moved}
            print(f"    rank {r} {tuple(x['coords'])}: step "
                  f"{x['step_ms']:.1f} ms, peak {x['peak_memory_gb']:.2f} "
                  f"GB; gathered (B) {gathered or 'none'}; tensor-parallel "
                  f"collectives {tp}; loss {x['loss']:.6f}, loss "
                  f"{x['loss_rel_err']:.2e} and gradient slices "
                  f"{x['grad_rel_err']:.2e} x max off one process (tol "
                  f"{P16_TOL}; the worst leaf {x['worst_leaf']}); launches "
                  f"{x['launches']}; {x['seconds']:.1f} s in the rank",
                  flush=True)
            check(x["loss_rel_err"] <= P16_TOL
                  and x["grad_rel_err"] <= P16_TOL,
                  f"16f {label} rank {r}: loss {x['loss_rel_err']:.3e}, "
                  f"gradients {x['grad_rel_err']:.3e} (tol {P16_TOL})")
            check(x["launches"] == x["expected_launches"],
                  f"16f {label} rank {r}: launches {x['launches']}, "
                  f"expected {x['expected_launches']}")
            want = {"all_gather_model"} if arch == P16_SSM[0] else set()
            check(set(gathered) == want,
                  f"16f {label} rank {r}: gathered {gathered}, expected "
                  f"only {want or 'nothing'}")
            check(all(k in moved for k in ("tp_sum", "tp_grad", "xent")),
                  f"16f {label} rank {r}: collectives {moved}")
        check(ranks[0][label]["loss"] == ranks[1][label]["loss"],
              f"16f {label}: the ranks report different losses")


def census_counts(census) -> tuple[dict, dict]:
    """({kind: calls}, {kind: payload bytes}) of a census
    (``analysis.collectives.Census``)."""
    return census.calls_by_kind(), census.payload_by_kind()


def p16f_census(get_config):
    """16f's steps traced on ``meta`` tensors as rank 0 of the (1, 2) mesh
    over a fake process group of two (``launch.dryrun.fake_group``; no
    card, no data): the same configs, batch, microbatch, dtypes, remat
    and rules as the ranks' steps.  Returns {label: (census, seconds)}."""
    from repro_torch.analysis import collectives
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import sharding
    from repro_torch.launch.dryrun import fake_group, local_meta
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_defs_to_specs
    from repro_torch.optim import state_defs
    opt = p16_opt()
    out = {}
    with fake_group(2, 0):
        mesh = make_mesh(P16F_MESH, ("data", "model"), device="meta")
        rules = make_rules(mesh)
        for arch, n in P16F:
            t0 = time.perf_counter()
            cfg = p16_config(get_config, arch, n)
            model = build_model(cfg)
            sdefs = state_defs(model.param_defs, opt)
            params = local_meta(model.param_defs, sharding.tree_shardings(
                model.param_specs(rules), mesh), mesh)
            state = local_meta(sdefs, sharding.tree_shardings(
                tree_defs_to_specs(sdefs, rules), mesh), mesh)
            batch = SyntheticLMData(cfg, seq=P16_SEQ, global_batch=P16_BATCH,
                                    seed=0, device="cpu").batch(0)
            batch = sharding.local_batch({k: v.to("meta") for k, v in
                                          batch.items()}, mesh, rules)
            step = make_train_step(model, opt, rules=rules, mesh=mesh,
                                   keep_grads=True)
            with collectives.census() as c:
                step(params, state, batch)
            out[p16f_label(arch)] = (c, time.perf_counter() - t0)
    return out


def print_tp_census(census, ranks, smi):
    """16f's census gate: each traced step's calls and payload bytes by
    kind equal what both gloo ranks counted on the card; printed beside
    the census's wire bytes by op and each rank's measured step."""
    print("== phase 16f census: the same steps traced on meta tensors as "
          f"rank 0 of the {P16F_MESH} mesh over a fake process group, "
          "held to the two gloo ranks' counts on the card, kind by kind; "
          f"{smi}", flush=True)
    for label, (c, seconds) in census.items():
        calls, moved = census_counts(c)
        print(f"  {label}: census {c.total_bytes / 1e9:.3f} GB on the wire "
              f"{ {k: f'{v / 1e9:.3f} GB' for k, v in c.bytes_by_op.items()} }"
              f" in {dict(c.counts)}; traced in {seconds:.1f} s; the ranks' "
              f"steps "
              + ", ".join(f"{rank[label]['step_ms']:.1f} ms"
                          for rank in ranks), flush=True)
        for r, rank in enumerate(ranks):
            got = rank[label]["collective"]
            check(calls == got["calls"] and moved == got["bytes"],
                  f"16f census {label} rank {r}: traced {calls} / {moved}, "
                  f"the rank counted {got['calls']} / {got['bytes']}")


def run_sharded_phase(torch, kernel, ssd_kernel, get_config, smi):
    """Phase 16: 16a stablelm-1.6b's one-device step without rules and
    through the (1, 1) mesh, bit for bit; 16b the same step on a (2, 1)
    mesh of two gloo processes sharing the card, each rank's gradient
    slices and the loss within P16_TOL x max of 16a's; 16c mamba2-1.3b at
    2 layers, the (2, 1) mesh against its (1, 1) step; 16d the fleet on
    the (2, 1) and (1, 2) ("wf", "task") meshes of the same two ranks
    against the one-process card fleet (``fleet_reference``); 16e
    qwen3-moe at full width on the (2, 1) and (1, 2) meshes of the same
    ranks against its one-process step at ``moe_groups`` 2
    (``print_moe_meshes``); 16f tensor-parallel training of P16F on the
    (1, 2) mesh of the same ranks (``print_tp_meshes``)."""
    import shutil
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    work = ROOT / "build" / "phase16"
    shutil.rmtree(work, ignore_errors=True)
    (work / "out").mkdir(parents=True)
    cfg = get_config(P16_ARCH)
    print(f"== phase 16a: {P16_ARCH} ({cfg.param_count():,} parameters, "
          f"{cfg.n_layers} layers), one step of {P16_BATCH} x {P16_SEQ} "
          "tokens in one microbatch (fp32 weights and AdamW state, bf16 "
          "activations, full remat): without rules, then through the "
          "(1, 1) mesh and make_rules", flush=True)
    one = {P16_ARCH: one_device_steps(torch, kernel, ssd_kernel, get_config,
                                      P16_ARCH, P16_ARCH, 0,
                                      work / "ref" / P16_ARCH, both=True)}
    arch, n = P16_SSM
    print(f"  ({time.perf_counter() - t0:.1f} s) {arch} at {n} layers "
          "through the (1, 1) mesh, the reference of 16c", flush=True)
    one[arch] = one_device_steps(torch, kernel, ssd_kernel, get_config,
                                 arch, arch, n, work / "ref" / arch,
                                 both=False)
    _, T, N, B = FLEET_BIG
    print(f"  ({time.perf_counter() - t0:.1f} s) 16d's reference: the fleet "
          f"of W {P16_FLEET_W} x T {T} x N {N} ({P16_FLEET_BIAS}), "
          f"{B:,} observations a workflow a tick, on the card's (1, 1) "
          "mesh", flush=True)
    fleet_one = fleet_reference(torch, work / "fleet_ref.pt")
    moe_cfg = p16_config(get_config, P16_MOE, TRAIN_LAYERS)
    print(f"  ({time.perf_counter() - t0:.1f} s) 16e's reference: {P16_MOE} "
          f"at {TRAIN_LAYERS} layer(s) ({moe_cfg.param_count():,} "
          f"parameters, fp32 weights, bf16 and float32 activations, "
          f"{moe_cfg.moe.n_experts} experts, top-"
          f"{moe_cfg.moe.top_k}, moe_groups {P16_MOE_GROUPS}) through the "
          "(1, 1) mesh", flush=True)
    for dtype in sorted({d for _, d, _ in P16_MOE_RUNS}):
        ref_label = p16e_ref(dtype)
        one[ref_label] = one_device_steps(
            torch, kernel, ssd_kernel, get_config, ref_label, P16_MOE,
            TRAIN_LAYERS, work / "ref" / ref_label, both=False,
            dtype=dtype)
    print(f"  ({time.perf_counter() - t0:.1f} s) 16f's references: "
          + ", ".join(f"{a} at {n or 'all'} layer(s)" for a, n in P16F)
          + " through the (1, 1) mesh at unit score variance", flush=True)
    t16f = time.perf_counter()
    for a, n_f in P16F:
        one[p16f_ref(a)] = one_device_steps(
            torch, kernel, ssd_kernel, get_config, p16f_ref(a), a, n_f,
            work / "ref" / p16f_ref(a), both=False, unit=True)
    ref16f_s = time.perf_counter() - t16f
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_reserved() / 1e9
    t_spawn = time.perf_counter()
    print(f"== phase 16b/16c ({t_spawn - t0:.1f} s): {P16_ARCH} and {arch} "
          f"({n} layers) on a (2, 1) (\"data\", \"model\") mesh of two "
          "gloo processes sharing the card; each rank's gradient slices "
          f"and the loss within {P16_TOL} x max of the one-device step "
          f"(this process holds {held_gb:.2f} GB of the card, "
          f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB of it are free)",
          flush=True)
    moe_runs = [(p16e_label(shape, dtype), P16_MOE, TRAIN_LAYERS, shape,
                 p16e_ref(dtype), dtype, False)
                for shape, dtype, _ in P16_MOE_RUNS]
    tp_runs = [(p16f_label(a), a, n, P16F_MESH, p16f_ref(a), None, True)
               for a, n in P16F]
    # two ranks share the card, each near 30 GB at 16b's peak: freed
    # blocks of one size must serve the next sizes, or the cache's
    # fragments take the pair past the card (a chip run ran out with 4.65
    # GB reserved but unallocated in a rank)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        spawn(sharded_worker, 2,
              ([(P16_ARCH, P16_ARCH, 0, (2, 1), P16_ARCH, None, False),
                (arch, arch, n, (2, 1), arch, None, False)]
               + moe_runs + tp_runs,
               work / "ref",
               work / "out", work / "fleet_ref.pt"),
              rendezvous=work / "rendezvous", backend="gloo", device="cuda",
              timeout_s=P16_TIMEOUT)
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    spawn_s = time.perf_counter() - t_spawn
    ranks = [json.loads((work / "out" / f"rank{r}.json").read_text())
             for r in range(2)]
    shutil.rmtree(work)
    out = {"one_device": one, "ranks": ranks, "spawn_seconds": spawn_s,
           "card": smi}
    for label in (P16_ARCH, arch):
        ms_one = one[label]["(1, 1) mesh"]["ms"]
        print(f"  {label}: {smi}; one-device step {ms_one:.1f} ms, peak "
              f"{one[label]['(1, 1) mesh']['peak_memory_gb']:.2f} GB",
              flush=True)
        for r, rank in enumerate(ranks):
            x = rank[label]
            moved = ", ".join(f"{k} {v / 1e9:.3f} GB in "
                              f"{x['collective']['calls'][k]} calls"
                              for k, v in x["collective"]["bytes"].items())
            print(f"    rank {r} {x['coords']} ({x['rows']} rows): loss "
                  f"{x['loss']:.6f}, loss {x['loss_rel_err']:.2e} and "
                  f"gradient slices {x['grad_rel_err']:.2e} x max off the "
                  f"one-device step (tol {P16_TOL}); step "
                  f"{x['step_ms']:.1f} ms; peak "
                  f"{x['peak_memory_gb']:.2f} GB; collectives: {moved}; "
                  f"syncs in the step: {x['syncs']} on the step's "
                  f"thread ({x['sync_sites']}), {x['gloo_thread_syncs']} on "
                  f"gloo's threads (measured only); launches "
                  f"{x['launches']}",
                  flush=True)
            check(x["loss_rel_err"] <= P16_TOL and x["grad_rel_err"] <= P16_TOL,
                  f"16 {label} rank {r}: loss {x['loss_rel_err']:.3e}, "
                  f"gradients {x['grad_rel_err']:.3e} (tol {P16_TOL})")
            check(x["launches"] == x["expected_launches"],
                  f"16 {label} rank {r}: launches {x['launches']}, "
                  f"expected {x['expected_launches']}")
        check(ranks[0][label]["loss"] == ranks[1][label]["loss"],
              f"16 {label}: the ranks report different losses")
    out["fleet"] = {"one_process": fleet_one,
                    "ranks": [r["fleet"] for r in ranks]}
    print_fleet_mesh(out["fleet"], smi)
    print_moe_meshes(one, ranks, moe_cfg, smi)
    print_tp_meshes(one, ranks, smi)
    t_census = time.perf_counter()
    census = p16f_census(get_config)
    print_tp_census(census, ranks, smi)
    out["16f_census"] = {label: {"calls": dict(c.counts),
                                 "wire_bytes_by_op": c.bytes_by_op,
                                 "by_kind": c.by_kind, "seconds": sec}
                         for label, (c, sec) in census.items()}
    out["16f_census_seconds"] = time.perf_counter() - t_census
    print(f"  phase 16f census: {out['16f_census_seconds']:.1f} s",
          flush=True)
    out["16f_seconds"] = ref16f_s + max(
        sum(rank[r[0]]["seconds"] for r in tp_runs) for rank in ranks)
    print(f"  phase 16f: {out['16f_seconds']:.1f} s (its reference "
          f"{ref16f_s:.1f} s, the ranks' steps and checks the rest)",
          flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 16: {out['seconds']:.1f} s (the two ranks "
          f"{spawn_s:.1f} s)", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 17: serving on a ("data", "model") mesh (two gloo processes)
# ---------------------------------------------------------------------------
#: (arch, n_layers (0: the config's), activation dtype, mesh shape,
#: context-parallel) of the ranks' serves.  mamba2-1.3b's 48 layers at
#: bf16 activations carry rounding to ~0.1 x max of the logits (one
#: process at 2 rows against 4: ``scripts/serve_mesh_probe_torch.py``),
#: past any bar, so they run at float32 activations, and the bf16 path at
#: 2 layers.  The last run is phase 17d: qwen2-7b with its KV caches split
#: by sequence over "model" (``P17_CP``), held to the same 17b serve
P17_RUNS = (("qwen2-7b", 0, "bfloat16", (1, 2), False),
            ("qwen2-7b", 0, "bfloat16", (2, 1), False),
            ("mamba2-1.3b", 0, "float32", (1, 2), False),
            ("mamba2-1.3b", 2, "bfloat16", (1, 2), False),
            ("qwen2-7b", 0, "bfloat16", (1, 2), True))
#: 17d's rules: qwen2-7b's 4 KV heads divide over "model" at tp 2, so the
#: split by sequence is forced, the KV heads whole on every rank
P17_CP = {"kv_seq": "model", "kv_heads": None, "act_kv_heads": None}
P17_TOL = 3e-2            # the models' bar at bf16 activations
P17_TIMEOUT = 300         # seconds for the two ranks, then they are ended
P17_REQUESTS, P17_NEW = 8, 12
P17_HELD = 0.55           # at most this share of one process's weights
P17_DEVICE = "cuda"


def p17_config(get_config, arch, n_layers=0, dtype="bfloat16"):
    """``arch`` at full width with bf16 weights and ``dtype``
    activations, cut to ``n_layers`` where given."""
    import torch
    cfg = get_config(arch).with_(param_dtype=torch.bfloat16,
                                 dtype=getattr(torch, dtype))
    return cfg.with_(n_layers=n_layers) if n_layers else cfg


def p17_key(arch, n_layers, dtype) -> str:
    return f"{arch} {n_layers or 'all'} layers {dtype}"


def p17_label(arch, n_layers, dtype, shape, cp) -> str:
    return (f"{p17_key(arch, n_layers, dtype)} {tuple(shape)}"
            + (" kv_seq over model" if cp else ""))


def p17_batches(torch, serve, cfg):
    """The token batches ``serve.main`` forms for P17_REQUESTS requests
    (prompts of 4-16 tokens, numpy seed 0), left-padded with token 0 as
    ``ServeLoop.run_batch`` pads them, on the card."""
    import numpy as np
    out = []
    for reqs in serve.batched(serve.make_requests(cfg.vocab, P17_REQUESTS,
                                                  P17_NEW)):
        T = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), T), np.int64)
        for i, r in enumerate(reqs):
            toks[i, T - len(r.prompt):] = r.prompt
        out.append(torch.from_numpy(toks).to(P17_DEVICE))
    return out


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def p17_serve(torch, sharding, model, prefill, decode, params, toks,
              forced=None, rules=None, mesh=None):
    """One batch: the prefill, then P17_NEW decode steps fed ``forced``
    (the reference's tokens, whole-batch rows) where given, else the
    greedy tokens.  On ``mesh`` this rank's rows, cache slices and vocab
    slice.  Returns the last-position logits (fp32, on the CPU) and the
    greedy tokens of every call, the prefill's and each step's ms (host
    clock, synchronised), the cache bytes and the collectives of the last
    step.  The caches take ``sharding.cache_len`` positions (a multiple of
    the "model" ranks where the rules split their sequence)."""
    from collections import Counter
    B, T = toks.shape
    rows = sharding.serve_rows(mesh, rules, B)
    tp = sharding.model_axis(mesh, rules)
    max_len = sharding.cache_len(T + P17_NEW, rules, mesh)
    caches = model.init_caches(B, max_len, device=P17_DEVICE,
                               rules=rules, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": rows.take(toks)}, caches,
                             rows, max_len)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    tok = sharding.greedy(logits[:, -1], tp, model.cfg.vocab)
    out = {"logits": [logits[:, -1].float().cpu()], "tokens": [tok.cpu()],
           "prefill_ms": prefill_ms, "step_ms": []}
    for s in range(P17_NEW):
        if forced is not None:
            tok = rows.take(forced[s].to(P17_DEVICE))
        calls, moved = Counter(sharding.CALLS), Counter(sharding.BYTES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, logits, caches = decode(params, {"tokens": tok[:, None]},
                                     caches, T + s, rows, max_len)
        torch.cuda.synchronize()
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["logits"].append(logits[:, -1].float().cpu())
        out["tokens"].append(tok.cpu())
    out["step_calls"] = dict(Counter(sharding.CALLS) - calls)
    out["step_bytes"] = dict(Counter(sharding.BYTES) - moved)
    out["cache_bytes"] = tree_bytes(caches)
    # the whole caches of this rank's rows at the same length (no data)
    out["whole_cache_bytes"] = tree_bytes(model.init_caches(
        rows.count, max_len, device="meta"))
    out["max_len"] = max_len
    out["rows"] = (rows.start, rows.count)
    return out


def p17_reset(kernel, ssd_kernel, sharding):
    kernel.LAUNCHES = ssd_kernel.LAUNCHES = 0
    sharding.reset_counts()


def serving_reference(torch, kernel, ssd_kernel, serve, get_config, arch,
                      n_layers, dtype, path):
    """The one-process serve of ``arch`` on the card (weights from seed 0
    at unit score variance, ``unit_score_scale``; greedy tokens), saved
    to ``path`` (each batch's tokens and logits) for the ranks; returns
    its row, with ``floor``: how far the same process's serve of each
    batch's first half of the rows, fed the same tokens, lies from it
    (max |difference| over the whole batch's max |logit|): what a change
    of batch shape alone moves."""
    from repro_torch.launch import sharding
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    cfg = p17_config(get_config, arch, n_layers, dtype)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # unit score variance, as phases 6 and 16 hold deep models: at the
    # init's scores attention is near one-hot and 28 layers carry any
    # rounding difference to the size of the logits
    params = unit_score_scale(model.init(0, device=P17_DEVICE), cfg)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    p17_reset(kernel, ssd_kernel, sharding)
    with torch.inference_mode():
        runs = [p17_serve(torch, sharding, model, prefill, decode, params,
                          toks) for toks in p17_batches(torch, serve, cfg)]
        launches = {"flash_fwd": kernel.LAUNCHES,
                    "ssd_fwd": ssd_kernel.LAUNCHES}
        floor = 0.0
        for toks, r in zip(p17_batches(torch, serve, cfg), runs):
            n = toks.shape[0] // 2
            half = p17_serve(torch, sharding, model, prefill, decode, params,
                             toks[:n], forced=[t[:n] for t in r["tokens"]])
            floor = max([floor] + [float((a - b[:n]).abs().max()
                                         / b.abs().max())
                                   for a, b in zip(half["logits"],
                                                   r["logits"])])
    torch.save([{"tokens": r["tokens"], "logits": r["logits"]}
                for r in runs], path)
    row = {"arch": arch, "n_layers": cfg.n_layers, "dtype": dtype,
           "floor": floor,
           "weights_gb": tree_bytes(params) / 1e9,
           "cache_gb": [r["cache_bytes"] / 1e9 for r in runs],
           "prefill_ms": [r["prefill_ms"] for r in runs],
           "step_ms": statistics.median([ms for r in runs
                                         for ms in r["step_ms"]]),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return row


def serving_mesh_worker(rank, device, runs, ref_dir, out_dir):
    """One rank of phase 17: for each (arch, n_layers, mesh shape) of
    ``runs``, a ``ServeLoop`` on the mesh (weights from seed 0, this
    rank's serving copies, at unit score variance as 17b's), the
    reference's batches served through its
    steps with the reference's tokens fed back (its flash and SSD
    launches and collectives counted, from 0), each step's logits held
    to the reference's rows and vocab slice; then the queue served by the
    loop itself (``serve.serve_queue``).  Writes ``rank<r>.json`` to
    ``out_dir``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.launch import serve, sharding
    from repro_torch.launch.mesh import make_mesh, make_rules

    meshes, out = {}, {}
    for arch, n_layers, dtype, shape, cp in runs:
        shape = tuple(shape)
        key = p17_key(arch, n_layers, dtype)
        label = p17_label(arch, n_layers, dtype, shape, cp)
        if shape not in meshes:       # every rank forms them in one order
            meshes[shape] = make_mesh(shape, ("data", "model"),
                                      device=device)
        mesh = meshes[shape]
        rules = make_rules(mesh, overrides=P17_CP if cp else None)
        tp = sharding.model_axis(mesh, rules)
        cfg = p17_config(get_config, arch, n_layers, dtype)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop = serve.ServeLoop(cfg, rules=rules, mesh=mesh)
        loop.params = unit_score_scale(loop.params, cfg)   # as 17b's
        load_s = time.perf_counter() - t0
        ref = torch.load(Path(ref_dir) / f"{key}.pt")
        batches = p17_batches(torch, serve, cfg)
        p17_reset(kernel, ssd_kernel, sharding)
        runs_ = [p17_serve(torch, sharding, loop.model, loop.prefill,
                           loop.decode, loop.params, toks,
                           forced=r["tokens"], rules=rules, mesh=mesh)
                 for toks, r in zip(batches, ref)]
        launches = {"flash_fwd": kernel.LAUNCHES,
                    "ssd_fwd": ssd_kernel.LAUNCHES}
        totals = {"calls": dict(sharding.CALLS),
                  "bytes": dict(sharding.BYTES)}
        errs, agree, n_tok = [], 0, 0
        V = cfg.vocab
        for r, want in zip(runs_, ref):
            start, count = r["rows"]
            for got, whole, tok, want_tok in zip(r["logits"],
                                                 want["logits"],
                                                 r["tokens"],
                                                 want["tokens"]):
                vl = got.shape[-1]
                v0 = tp.part(V)[0] if vl != V else 0
                part = whole[start:start + count, v0:v0 + vl]
                errs.append(float((got - part).abs().max()
                                  / whole.abs().max()))
                agree += int((tok == want_tok[start:start + count]).sum())
                n_tok += count
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the ServeLoop's own greedy serve of the same queue
        summary = serve.serve_queue(loop, serve.make_requests(
            cfg.vocab, P17_REQUESTS, P17_NEW))
        out[label] = {
            "arch": arch, "n_layers": cfg.n_layers, "mesh": mesh.shape,
            "coords": list(mesh.coords), "tp": tp.size,
            "rows": [r["rows"] for r in runs_],
            "load_s": load_s, "weights_gb": tree_bytes(loop.params) / 1e9,
            "cache_gb": [r["cache_bytes"] / 1e9 for r in runs_],
            "whole_cache_gb": [r["whole_cache_bytes"] / 1e9
                               for r in runs_],
            "max_len": [r["max_len"] for r in runs_], "cp": cp,
            "prefill_ms": [r["prefill_ms"] for r in runs_],
            "step_ms": statistics.median([ms for r in runs_
                                          for ms in r["step_ms"]]),
            "step_calls": runs_[-1]["step_calls"],
            "step_bytes": runs_[-1]["step_bytes"], "totals": totals,
            "launches": launches, "rel_err": max(errs),
            "tokens_agree": agree, "tokens": n_tok,
            "peak_memory_gb": peak_gb,
            "loop_tokens": summary["tokens"],
            "loop_step_ms": summary["median_step_ms"],
            "loop_seconds": summary["seconds"]}
        del loop, runs_, ref, summary
        gc.collect()
        torch.cuda.empty_cache()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def p17_kernel_cases(cfgs, batches, tp):
    """Flash and SSD cases at the head counts a rank of tp ``tp`` runs each
    config with, at its serve batches (``serve_cases``' prefill and
    decode calls; the SSD prefills as the model passes them)."""
    flash, ssd_cases_ = [], []
    for arch, cfg in cfgs.items():
        shapes = [(b.shape[0], b.shape[1], P17_NEW) for b in batches[arch]]
        if cfg.ssm is not None:
            s = cfg.ssm
            H = s.n_ssm_heads(cfg.d_model)
            H = H // tp if H % tp == 0 else H
            ssd_cases_ += [(f"serve {arch} rank of tp {tp} prefill B{B} "
                            f"T{T} H{H}", B, T, H, s.head_dim, s.n_groups,
                            s.d_state, s.chunk, "conv", "zeros")
                           for B, T, _ in shapes]
        else:
            Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
            Hq, Hkv = (Hq // tp if Hq % tp == 0 else Hq,
                       Hkv // tp if Hkv % tp == 0 else Hkv)
            flash += serve_cases(shapes, Hq, cfg.resolved_head_dim(),
                                 Hkv=Hkv, label=f"{arch} rank of tp {tp} ")
    return flash, ssd_cases_


def cp_cases(cfg, batches, tp):
    """The decode calls of each rank of tp ``tp`` where the caches are
    split by sequence (17d): every query head and every KV head over the
    rank's part of L = max_len / tp positions, at its local kv_len
    (clamped to [0, L]) and causal offset (negative before the part), as
    ``layers.split_cache_attention`` passes them; each checked with its
    row lse (``run_kernel_checks``)."""
    cases = []
    for b in batches:
        B, T = b.shape
        L = -(-(T + P17_NEW) // tp)
        for r in range(tp):
            for c in range(T, T + P17_NEW):
                kv = min(max(c + 1 - r * L, 0), L)
                cases.append((f"cp {cfg.arch} rank {r} of {tp} decode B{B} "
                              f"kv_len={kv}/{L} offset {c - r * L}", B,
                              cfg.n_heads, cfg.n_kv_heads, 1, L,
                              cfg.resolved_head_dim(), True, kv, c - r * L,
                              "cache"))
    return cases


def print_serving_mesh(one, ranks, smi):
    """Phase 17's lines and its gates: each rank's logits within P17_TOL
    x max of the one-process serve at every step, its flash and SSD
    launches those of its forwards, a decode step's collectives, the
    weights and caches it holds."""
    for arch, n_layers, dtype, shape, cp in P17_RUNS:
        key = p17_key(arch, n_layers, dtype)
        label = p17_label(arch, n_layers, dtype, shape, cp)
        ref = one[key]
        cfg_layers = ref["n_layers"]
        print(f"  {label}: {smi}; one process: 2-row gap "
              f"{ref['floor']:.3e} x max (its 2-row serve against its "
              f"4-row one; measured only), weights "
              f"{ref['weights_gb']:.3f} GB, prefill "
              f"{', '.join(f'{x:.1f}' for x in ref['prefill_ms'])} ms, "
              f"decode step {ref['step_ms']:.2f} ms (median), peak "
              f"{ref['peak_memory_gb']:.2f} GB, launches {ref['launches']}",
              flush=True)
        for r, rank in enumerate(ranks):
            x = rank[label]
            forwards = len(x["prefill_ms"]) * (1 + P17_NEW)
            print(f"    rank {r} {tuple(x['coords'])} (rows {x['rows']}, "
                  f"load {x['load_s']:.1f} s): weights held "
                  f"{x['weights_gb']:.3f} GB "
                  f"({x['weights_gb'] / ref['weights_gb']:.3f} of one "
                  f"process), caches "
                  f"{', '.join(f'{c:.4f}' for c in x['cache_gb'])} GB "
                  f"(one process "
                  f"{', '.join(f'{c:.4f}' for c in ref['cache_gb'])}); "
                  f"prefill {', '.join(f'{v:.1f}' for v in x['prefill_ms'])}"
                  f" ms, decode step {x['step_ms']:.2f} ms (median), the "
                  f"loop's own serve {x['loop_step_ms']:.2f} ms a step, "
                  f"{x['loop_tokens']} tokens in {x['loop_seconds']:.2f} s; "
                  f"peak {x['peak_memory_gb']:.2f} GB; a decode step's "
                  f"collectives: calls {x['step_calls']}, bytes "
                  f"{x['step_bytes']}; all: {x['totals']}; launches "
                  f"{x['launches']}; logits {x['rel_err']:.3e} x max off "
                  f"one process (tol {P17_TOL}); greedy tokens equal "
                  f"{x['tokens_agree']} of {x['tokens']} (measured only)",
                  flush=True)
            check(x["rel_err"] <= P17_TOL,
                  f"17 {label} rank {r}: logits {x['rel_err']:.3e} x max "
                  f"(tol {P17_TOL})")
            want = ({"flash_fwd": 0, "ssd_fwd": cfg_layers
                     * len(x["prefill_ms"])} if arch.startswith("mamba")
                    else {"flash_fwd": cfg_layers * forwards, "ssd_fwd": 0})
            check(x["launches"] == want,
                  f"17 {label} rank {r}: launches {x['launches']}, "
                  f"expected {want}")
            calls = x["step_calls"]
            if cp:
                # 17d: a rank's K/V cache is half the whole at its length
                # (the length rounded up to whole parts, max_len), against
                # 17b's at the unrounded length
                print(f"    17d rank {r}: K/V cache "
                      f"{', '.join(f'{c:.6f}' for c in x['cache_gb'])} GB "
                      f"at max_len {x['max_len']}, the whole at that length "
                      f"{', '.join(f'{c:.6f}' for c in x['whole_cache_gb'])}"
                      f" GB, 17b's {', '.join(f'{c:.6f}' for c in ref['cache_gb'])}"
                      f" GB; decode step {x['step_ms']:.2f} ms (median), 17b "
                      f"{ref['step_ms']:.2f} ms; collectives by kind "
                      f"{calls}", flush=True)
                check(all(2 * c == w for c, w in zip(x["cache_gb"],
                                                     x["whole_cache_gb"])),
                      f"17d rank {r}: K/V cache {x['cache_gb']} GB, not half "
                      f"of the whole {x['whole_cache_gb']}")
            if x["tp"] > 1:
                per = {"tp_sum": 2 * cfg_layers, "embed_sum": 1,
                       "argmax": 1}
                if cp:
                    per.update(cp_q=cfg_layers, cp_merge=cfg_layers)
                if arch.startswith("mamba"):
                    per = {"tp_sum": cfg_layers, "norm_sum": cfg_layers,
                           "embed_sum": 1, "argmax": 1}
                check(calls == per, f"17 {label} rank {r}: a decode step's "
                                    f"collectives {calls}, expected {per}")
                check(x["weights_gb"] <= P17_HELD * ref["weights_gb"],
                      f"17 {label} rank {r}: holds {x['weights_gb']:.3f} "
                      f"of {ref['weights_gb']:.3f} GB of weights")
                check(all(c <= P17_HELD * w for c, w in
                          zip(x["cache_gb"], ref["cache_gb"])),
                      f"17 {label} rank {r}: caches {x['cache_gb']} GB, "
                      f"one process {ref['cache_gb']}")
            else:
                check(calls == {}, f"17 {label} rank {r}: collectives "
                                   f"{calls} in a decode step on tp 1")
            check(x["loop_tokens"] == P17_REQUESTS * P17_NEW,
                  f"17 {label} rank {r}: the loop served "
                  f"{x['loop_tokens']} tokens")


#: the 17c/17d serves traced for the census: qwen2-7b on (1, 2), without
#: and with its KV caches split by sequence
P17_CENSUS = tuple(r for r in P17_RUNS
                   if r[0] == "qwen2-7b" and tuple(r[3]) == (1, 2))


def p17_census(torch, serve, get_config):
    """The 17c/17d serves of P17_CENSUS traced on ``meta`` tensors as rank 0
    of the (1, 2) mesh over a fake process group of two (no card, no
    data): each batch's prefill, its greedy token and P17_NEW decode
    steps at the ranks' shapes, rules, cache lengths and rows, as
    ``p17_serve`` drives them.  Returns {label: (the serve's census, its
    last decode step's, seconds)}."""
    from repro_torch.analysis import collectives
    from repro_torch.launch import sharding
    from repro_torch.launch.dryrun import fake_group, local_meta
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    out = {}
    with fake_group(2, 0):
        mesh = make_mesh((1, 2), ("data", "model"), device="meta")
        for arch, n_layers, dtype, shape, cp in P17_CENSUS:
            t0 = time.perf_counter()
            cfg = p17_config(get_config, arch, n_layers, dtype)
            model = build_model(cfg)
            rules = make_rules(mesh, overrides=P17_CP if cp else None)
            tp = sharding.model_axis(mesh, rules)
            params = local_meta(model.param_defs,
                                model.serving_layouts(rules, mesh), mesh)
            prefill = make_prefill_step(model, rules, mesh)
            decode = make_decode_step(model, rules, mesh)
            with collectives.census() as whole:
                for toks in p17_batches(torch, serve, cfg):
                    B, T = toks.shape
                    rows = sharding.serve_rows(mesh, rules, B)
                    max_len = sharding.cache_len(T + P17_NEW, rules, mesh)
                    caches = model.init_caches(B, max_len, device="meta",
                                               rules=rules, mesh=mesh)
                    tokens = torch.zeros(rows.count, T, dtype=torch.long,
                                         device="meta")
                    logits, caches = prefill(params, {"tokens": tokens},
                                             caches, rows, max_len)
                    sharding.greedy(logits[:, -1], tp, cfg.vocab)
                    for s in range(P17_NEW):
                        with collectives.census() as last:
                            _, _, caches = decode(
                                params, {"tokens": tokens[:, :1]}, caches,
                                T + s, rows, max_len)
            out[p17_label(arch, n_layers, dtype, shape, cp)] = (
                whole, last, time.perf_counter() - t0)
    return out


def print_serving_census(census, ranks, smi):
    """17c/17d's census gate: the traced serve's calls and payload bytes by
    kind, over all its batches and for its last decode step, equal what
    both gloo ranks counted on the card; printed beside the census's wire
    bytes by op and the ranks' measured decode steps."""
    print("== phase 17c/17d census: the same serves traced on meta tensors "
          "as rank 0 of the (1, 2) mesh over a fake process group, held to "
          f"the two gloo ranks' counts on the card, kind by kind; {smi}",
          flush=True)
    for label, (whole, last, seconds) in census.items():
        calls, moved = census_counts(whole)
        step_calls, step_moved = census_counts(last)
        print(f"  {label}: the serve {whole.total_bytes / 1e9:.4f} GB on "
              f"the wire in {dict(whole.counts)}; a decode step "
              f"{ {k: f'{v / 1e6:.3f} MB' for k, v in last.bytes_by_op.items()} }"
              f" on the wire; traced in {seconds:.1f} s; the ranks' decode "
              "steps "
              + ", ".join(f"{rank[label]['step_ms']:.2f} ms (median)"
                          for rank in ranks), flush=True)
        for r, rank in enumerate(ranks):
            x = rank[label]
            check(calls == x["totals"]["calls"]
                  and moved == x["totals"]["bytes"],
                  f"17 census {label} rank {r}: traced {calls} / {moved}, "
                  f"the rank counted {x['totals']}")
            check(step_calls == x["step_calls"]
                  and step_moved == x["step_bytes"],
                  f"17 census {label} rank {r}: a traced step "
                  f"{step_calls} / {step_moved}, the rank's "
                  f"{x['step_calls']} / {x['step_bytes']}")


def run_serving_mesh_phase(torch, kernel, ssd_kernel, mha, attention_ref,
                           ssd, ssd_chunked, launched_kernels, get_config,
                           smi):
    """Phase 17: 17a the flash and SSD kernels at a rank's head counts
    (tp 2) against their plain versions, and the flash decode at 17d's
    shapes with its row lse; 17b the one-process serve of each config of
    P17_RUNS on the card, saved; 17c the two gloo processes sharing the
    card serve them on their (1, 2) and (2, 1) ("data", "model") meshes,
    teacher-forced, held to 17b, and 17d qwen2-7b on (1, 2) with its KV
    caches split by sequence (``print_serving_mesh``)."""
    import shutil
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    work = ROOT / "build" / "phase17"
    shutil.rmtree(work, ignore_errors=True)
    (work / "out").mkdir(parents=True)
    (work / "ref").mkdir()
    # the kernels at each config's full width (both dtypes, each case)
    cfgs = {a: p17_config(get_config, a) for a, *_ in P17_RUNS}
    batches = {a: p17_batches(torch, serve, c) for a, c in cfgs.items()}
    print("== phase 17a: the kernels at the head counts of a rank of tp 2, "
          "at the serve batches (B, T) "
          + ", ".join(f"{a} {[tuple(b.shape) for b in bs]}"
                      for a, bs in batches.items()), flush=True)
    flash_cases, ssd_cases_ = p17_kernel_cases(cfgs, batches, 2)
    flash_cases += cp_cases(cfgs["qwen2-7b"], batches["qwen2-7b"], 2)
    checks = run_kernel_checks(torch, kernel, mha, attention_ref,
                               flash_cases)
    ssd_checks = run_ssd_checks(torch, ssd_kernel, ssd, ssd_chunked,
                                launched_kernels, ssd_cases_)
    one = {}
    for arch, n, dtype, *_ in P17_RUNS:
        key = p17_key(arch, n, dtype)
        if key in one:
            continue
        cfg = p17_config(get_config, arch, n, dtype)
        print(f"== phase 17b ({time.perf_counter() - t0:.1f} s): {arch} "
              f"({cfg.param_count():,} parameters, {cfg.n_layers} layers, "
              f"bf16 weights, {dtype} activations), one process on the "
              f"card: {P17_REQUESTS} requests, {P17_NEW} new tokens, "
              "greedy", flush=True)
        one[key] = serving_reference(torch, kernel, ssd_kernel, serve,
                                     get_config, arch, n, dtype,
                                     work / "ref" / f"{key}.pt")
    t_spawn = time.perf_counter()
    print(f"== phase 17c/17d ({t_spawn - t0:.1f} s): "
          + ", ".join(p17_label(*r) for r in P17_RUNS)
          + ": two gloo processes sharing the card, their tokens fed back "
          f"from 17b; logits within {P17_TOL} x max (17d: the last, its KV "
          f"caches split by sequence over \"model\", rules {P17_CP})",
          flush=True)
    spawn(serving_mesh_worker, 2,
          ([list(r) for r in P17_RUNS], work / "ref", work / "out"),
          rendezvous=work / "rendezvous", backend="gloo",
          device=P17_DEVICE, timeout_s=P17_TIMEOUT)
    spawn_s = time.perf_counter() - t_spawn
    ranks = [json.loads((work / "out" / f"rank{r}.json").read_text())
             for r in range(2)]
    shutil.rmtree(work)
    print_serving_mesh(one, ranks, smi)
    t_census = time.perf_counter()
    census = p17_census(torch, serve, get_config)
    print_serving_census(census, ranks, smi)
    census_s = time.perf_counter() - t_census
    print(f"  phase 17c/17d census: {census_s:.1f} s", flush=True)
    out = {"one_process": one, "ranks": ranks, "kernel_checks": checks,
           "ssd_checks": ssd_checks, "spawn_seconds": spawn_s,
           "census": {label: {"calls": dict(w.counts),
                              "wire_bytes_by_op": w.bytes_by_op,
                              "by_kind": w.by_kind,
                              "step_wire_bytes_by_op": l.bytes_by_op,
                              "seconds": sec}
                      for label, (w, l, sec) in census.items()},
           "census_seconds": census_s,
           "seconds": time.perf_counter() - t0, "card": smi}
    print(f"  phase 17: {out['seconds']:.1f} s (the two ranks "
          f"{spawn_s:.1f} s)", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 15: the linter against the card's syncs
# ---------------------------------------------------------------------------
def run_sync_phase(sync_log, smi):
    """Phase 15: the syncs that 15a-15d recorded, per tick or step and by
    site, and the gate: no sync in a function that the port's RA001 treats
    as traced at a line where the linter neither reports RA001 nor finds a
    justified ``# repro_torch: ignore[RA001]``."""
    from collections import Counter
    from repro_torch.analysis.syncs import lint_index, missed
    t0 = time.perf_counter()
    index = lint_index()
    lint_s = time.perf_counter() - t0
    summary = sync_log.summary()
    n_traced = sum(len(v) for v in index.traced.values())
    print(f"  {smi}; RA001 treats {n_traced} functions in "
          f"{sum(1 for v in index.traced.values() if v)} files of the port "
          f"as traced ({lint_s:.1f} s to lint {len(index.files)} files)",
          flush=True)
    print(f"  {'path':44s} {'syncs':>6s} {'per':>4s} {'a tick/step':>11s} "
          f"{'trace s':>8s}")
    for label, r in summary.items():
        print(f"  {label:44s} {r['syncs']:6d} {r['per']:4d} "
              f"{r['syncs_per']:11.2f} {r['seconds']:8.2f}", flush=True)
        for site, n in r["sites"].items():
            print(f"      {n:5d}  {site}")
    one, two = (Counter(sync_log.runs[f"15c serve batch, {k} new"]["sites"])
                for k in (1, 2))
    step = two - one
    summary["15c decode step"] = {
        "syncs": sum(step.values()), "per": 1,
        "syncs_per": sum(step.values()),
        "sites": {str(s): n for s, n in step.most_common()}}
    print(f"  15c one decode step (the 2-token batch less the 1-token "
          f"batch): {sum(step.values())} syncs: "
          + ", ".join(f"{n} x {s}" for s, n in step.most_common()),
          flush=True)
    seconds = lint_s + sum(r["seconds"] for r in sync_log.runs.values())
    print(f"  phase 15's cost: {seconds:.1f} s (the traced calls and the "
          "lint)", flush=True)
    for label, run in sync_log.runs.items():
        bad = missed(run["sites"], index)
        check(not bad, f"15 {label}: syncs in traced functions that RA001 "
                       "neither flags nor excuses: "
                       + ", ".join(f"{s} in {fn}" for s, fn in bad))
    print("  gate passed: every sync in a traced function is flagged by "
          "RA001 or covered by a justified ignore", flush=True)
    return {"runs": summary, "seconds": seconds, "lint_seconds": lint_s,
            "traced_functions": {p: v for p, v in index.traced.items() if v},
            "card": smi}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or BF16_FLOPS is None:
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.analysis.syncs import SyncLog
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_ref, kernel, mha
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ssd, ssd_chunked
    from repro_torch.kernels._launches import launched_kernels
    from repro_torch.launch import serve, shapes
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import build_model
    from repro_torch.models import kv_quant as kvq

    cfg = get_config("stablelm-1.6b")
    mcfg = get_config("mamba2-1.3b")
    H, D = cfg.n_heads, cfg.resolved_head_dim()
    n_requests, max_new = 8, 12
    batch_shapes = serve_batches(serve, cfg.vocab, n_requests, max_new)
    mbatch_shapes = serve_batches(serve, mcfg.vocab, n_requests, max_new)
    scfgs = {a: get_config(a) for a in SERVE_ARCHS}
    sbatch_shapes = {a: serve_batches(serve, c.vocab, n_requests, max_new)
                     for a, c in scfgs.items()}
    zcfg, lcfg = scfgs["zamba2-1.2b"], scfgs["stablelm-12b"]
    mcfgs = moe_cuts(torch, get_config)
    mbatches = {a: serve_batches(serve, c.vocab, n_requests, max_new)
                for a, c in mcfgs.items()}
    ecfg = get_config(ENCDEC_ARCH)
    sync_log = SyncLog()

    t_start = time.time()
    clock = PhaseClock()
    clock("phase 1")
    print("== phase 1: card", flush=True)
    smi = nvidia_smi_line()
    print(smi)
    nvcc = _build.nvcc_path()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc_v[-1]}, python {sys.version.split()[0]}", flush=True)
    print(f"host: {len(os.sched_getaffinity(0))} CPUs usable of "
          f"{os.cpu_count()}, torch threads {torch.get_num_threads()}, load "
          f"average {' '.join(f'{x:.2f}' for x in os.getloadavg())}",
          flush=True)

    clock("phase 2")
    print("== phase 2: build (one nvcc per source, started together)",
          flush=True)
    t0 = time.time()
    sources = [kernel.SOURCE, kernel.BWD_SOURCE, ssd_kernel.SOURCE,
               ssd_kernel.BWD_SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_build.build, sources))
    print(f"built {', '.join(str(p.relative_to(ROOT)) for p in libs)} in "
          f"{time.time() - t0:.1f}s")
    for src in sources:
        print(f"-- {Path(src).name}")
        print(_build.build_log(src).strip(), flush=True)

    clock("phase 3")
    print("== phase 3: flash kernel against its plain version; stablelm "
          f"serve batches (B, T, steps) {batch_shapes}; the serve batches of "
          + ", ".join(f"{a} {b}" for a, b in {**sbatch_shapes,
                                               **mbatches}.items())
          + f"; {ENCDEC_ARCH}'s prefill (B {ENC_B}, source and target "
          f"{ENC_T}) and {ENC_STEPS} decode steps", flush=True)
    more_serve = [c for a, sc in {**scfgs, **mcfgs}.items()
                  for c in serve_cases(
                      {**sbatch_shapes, **mbatches}[a], sc.n_heads,
                      sc.resolved_head_dim(), Hkv=sc.n_kv_heads,
                      label=f"{a} ", per_row=sc.mrope)]
    more_serve += encdec_cases(ecfg, ENC_B, ENC_T, ENC_STEPS)
    checks = run_kernel_checks(torch, kernel, mha, attention_ref,
                               kernel_cases(batch_shapes, H, D, more_serve))

    clock("phase 3b")
    print("== phase 3b: SSD kernel against its plain version; mamba2 serve "
          f"batches (B, T, steps) {mbatch_shapes}, zamba2 "
          f"{sbatch_shapes['zamba2-1.2b']} (N {zcfg.ssm.d_state})",
          flush=True)
    ssd_checks = run_ssd_checks(
        torch, ssd_kernel, ssd, ssd_chunked, launched_kernels,
        ssd_cases(mbatch_shapes, mcfg)
        + ssd_cases(sbatch_shapes["zamba2-1.2b"], zcfg, label="zamba2 ",
                    oracle=False))

    clock("phase 4")
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

    clock("phase 5")
    print("== phase 5: profile of decode steps (torch.profiler)", flush=True)
    profile = profile_serve(torch, loop, kernel, "flash_fwd", "flash",
                            *batch_shapes[0][:2])

    clock("phase 6")
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
    clock("phase 15c")
    print("== phase 15c (reported in phase 15): a batch of "
          f"{serve.MAX_BATCH} requests on phase 4's loop at 1 and at 2 new "
          "tokens, under the sync trace", flush=True)
    for new in (1, 2):
        reqs = serve.make_requests(cfg.vocab, serve.MAX_BATCH, new)
        sync_log.run(f"15c serve batch, {new} new",
                     lambda: loop.run_batch(reqs))
    del loop, summary["done"]
    torch.cuda.empty_cache()

    clock("phase 7")
    print("== phase 7: kernel timing (bf16, D 64, then stablelm-12b's D 160 "
          "with 32 query and 8 kv heads; device time from CUDA graph "
          "replays, host time from back-to-back calls)", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = run_timings(torch, kernel, mha, attention_ref, sdpa,
                       batch_shapes[0], H, D)
    rows += run_timings(torch, kernel, mha, attention_ref, sdpa,
                        sbatch_shapes["stablelm-12b"][0], lcfg.n_heads,
                        lcfg.resolved_head_dim(), Hkv=lcfg.n_kv_heads,
                        label="stablelm-12b ")

    clock("phase 4b")
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

    clock("phase 5b")
    print("== phase 5b: profile of a mamba2 prefill and decode steps "
          "(torch.profiler)", flush=True)
    mprofile = profile_serve(torch, mloop, ssd_kernel, "ssd_", "ssd",
                             B0, T0, prefill=True)

    clock("phase 6b")
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

    clock("phase 7b")
    print("== phase 7b: SSD kernel timing (bf16 x/B/C; device time from "
          "CUDA graph replays, host time from back-to-back calls)",
          flush=True)
    ssd_rows = run_ssd_timings(torch, ssd_kernel, ssd, ssd_chunked,
                               launched_kernels, mcfg, mbatch_shapes[0])
    ssd_rows += run_ssd_timings(torch, ssd_kernel, ssd, ssd_chunked,
                                launched_kernels, zcfg,
                                sbatch_shapes["zamba2-1.2b"][0],
                                label="zamba2 ")

    clock("phase 8")
    print("== phase 8: the estimator path (float64; card against the CPU "
          "at 1e-12)", flush=True)
    estimator = run_estimator_phase(torch, smi)

    clock("phase 9")
    print("== phase 9: the online loop (fused tick engine and executor; "
          "float64, card against the CPU at 1e-12)", flush=True)
    online = run_online_phase(torch, smi, sync_log)

    clock("phase 10")
    print("== phase 10: the multi-workflow fleet and LotaruML (float64; "
          "card against the CPU at 1e-12)", flush=True)
    print(f"== phase 10a: the fleet, W {', '.join(map(str, FLEET_WS))} at T "
          f"{FLEET_T} x N {FLEET_N} ({FLEET_BATCH} observations a workflow), "
          f"then W {FLEET_BIG[0]} at T {FLEET_BIG[1]} x N {FLEET_BIG[2]} "
          f"({FLEET_BIG[3]} a workflow); {FLEET_TICKS} ticks, numpy seeds "
          f"1-{FLEET_TICKS}", flush=True)
    fleet = run_fleet_phase(torch, smi, sync_log)
    print(f"== phase 10b: LotaruML, {ML_CELLS} cells x {ML_NODES} target "
          f"nodes, a {ML_STREAM}-observation observe_batch", flush=True)
    ml = run_ml_phase(torch, smi)

    clock("phase 11")
    print("== phase 11: the other serving configs at full width, "
          f"{n_requests} requests of {max_new} new tokens each: "
          + ", ".join(SERVE_ARCHS), flush=True)
    configs, t11 = {}, time.perf_counter()
    for arch in SERVE_ARCHS:
        print(f"== phase 11: {arch} ({scfgs[arch].param_count():,} "
              "parameters, float32)", flush=True)
        configs[arch] = serve_config(torch, serve, kernel, ssd_kernel,
                                     build_model, scfgs[arch], n_requests,
                                     max_new, sbatch_shapes[arch])
    print(f"  {'config':16s} {'tok/s':>8s} {'step ms':>9s} {'busy %':>7s} "
          f"{'peak GB':>8s} {'flash':>6s} {'SSD':>5s}", flush=True)
    for arch, r in configs.items():
        dec = r["profile"]["decode"]
        print(f"  {arch:16s} {r['serve']['tokens'] / r['serve']['seconds']:8.1f}"
              f" {r['serve']['median_step_ms']:9.3f} "
              f"{100 * dec['device_busy_ms_per_step'] / dec['wall_ms_per_step']:7.1f}"
              f" {r['peak_memory_gb']:8.2f} {r['flash_launches']:6d} "
              f"{r['ssd_launches']:5d}", flush=True)
    print(f"  phase 11: {time.perf_counter() - t11:.1f} s", flush=True)

    clock("phase 12")
    print("== phase 12: the MoE configs, the encoder-decoder and the int8 "
          "KV cache", flush=True)
    configs12, t12 = {}, time.perf_counter()
    for arch, mc in mcfgs.items():
        print(f"== phase 12{'ab'[MOE_ARCHS.index(arch)]}: {arch} "
              f"({mc.n_layers} layers, {mc.param_count():,} of "
              f"{get_config(arch).param_count():,} parameters, bf16 "
              "weights)", flush=True)
        configs12[arch] = serve_config(torch, serve, kernel, ssd_kernel,
                                       build_model, mc, n_requests, max_new,
                                       mbatches[arch], cut=True)
    print(f"== phase 12c: {ENCDEC_ARCH} ({ecfg.param_count():,} parameters, "
          f"float32 weights), make_prefill_step / make_decode_step on "
          f"concrete_batch(cfg, 'prefill', {ENC_B}, {ENC_T})", flush=True)
    encdec_run = serve_encdec(torch, kernel, shapes, steps_mod, build_model,
                              ecfg)
    print(f"  phases 12a-12c: {time.perf_counter() - t12:.1f} s", flush=True)
    clock("phase 12d")
    print(f"== phase 12d: kv_quant on the card at qwen2-7b's decode_32k "
          f"cache {KVQ_SHAPE}", flush=True)
    kv_quant_run = kv_quant_on_card(torch, kernel, kvq, mha)
    clock("phase 12e")
    print("== phase 12e: kernel timing at the new shapes (bf16; D 128 GQA 8 "
          "and GQA 5, D 64 H 16 non-causal)", flush=True)
    qcfg, l4cfg = mcfgs["qwen3-moe-30b-a3b"], mcfgs["llama4-maverick-400b-a17b"]
    rows12 = run_timings(torch, kernel, mha, attention_ref, sdpa,
                         mbatches["qwen3-moe-30b-a3b"][0], qcfg.n_heads,
                         qcfg.resolved_head_dim(), Hkv=qcfg.n_kv_heads,
                         label="qwen3-moe ")
    rows12 += run_timings(torch, kernel, mha, attention_ref, sdpa,
                          mbatches["llama4-maverick-400b-a17b"][0],
                          l4cfg.n_heads, l4cfg.resolved_head_dim(),
                          Hkv=l4cfg.n_kv_heads, label="llama4 ")
    rows12 += run_timings(torch, kernel, mha, attention_ref, sdpa, None,
                          ecfg.n_heads, ecfg.resolved_head_dim(),
                          label="seamless ",
                          shapes=encdec_timing_shapes(ENC_B, ENC_T,
                                                      ENC_STEPS))
    rows += rows12
    print(f"  {'config':26s} {'tok/s':>8s} {'step ms':>9s} {'busy %':>7s} "
          f"{'kernels':>8s} {'peak GB':>8s} {'flash':>6s}", flush=True)
    for arch, r in {**configs12, ENCDEC_ARCH: encdec_run}.items():
        dec = r["profile"]["decode"]
        tok_s = (r["serve"]["tokens"] / r["serve"]["seconds"] if "serve" in r
                 else r["tok_per_s"])
        step = (r["serve"]["median_step_ms"] if "serve" in r
                else r["median_step_ms"])
        print(f"  {arch:26s} {tok_s:8.1f} {step:9.3f} "
              f"{100 * dec['device_busy_ms_per_step'] / dec['wall_ms_per_step']:7.1f}"
              f" {dec['kernels_per_step']:8.0f} {r['peak_memory_gb']:8.2f} "
              f"{r['flash_launches']:6d}", flush=True)

    clock("phase 13")
    print("== phase 13: training, the flash and SSD backward kernels",
          flush=True)
    training = run_training_phase(torch, kernel, ssd_kernel, get_config,
                                  build_model, sync_log)

    clock("phase 14")
    print("== phase 14: the dry run and LotaruML against the card",
          flush=True)
    dryrun = run_dryrun_phase(torch, get_config, training, smi)

    clock("phase 15")
    print("== phase 15: the linter against the card's syncs (15a-15d, "
          "traced after their phases' timed work)", flush=True)
    sync_report = run_sync_phase(sync_log, smi)

    clock("phase 16")
    print("== phase 16: the sharded train step on the card (16a the "
          "(1, 1) mesh, 16b/16c a (2, 1) mesh of two gloo processes), "
          "the fleet on the two processes' (\"wf\", \"task\") meshes (16d), "
          "MoE over groups and experts on their (2, 1) and (1, 2) "
          "meshes (16e), and tensor-parallel training on their (1, 2) mesh "
          "(16f)", flush=True)
    sharded = run_sharded_phase(torch, kernel, ssd_kernel, get_config, smi)
    ssm_arch = P16_SSM[0]

    clock("phase 17")
    print("== phase 17: serving on a (\"data\", \"model\") mesh: the "
          "kernels at a rank's head counts (17a), the one-process serves "
          "(17b), two gloo processes sharing the card on their (1, 2) and "
          "(2, 1) meshes (17c)", flush=True)
    serving_mesh = run_serving_mesh_phase(
        torch, kernel, ssd_kernel, mha, attention_ref, ssd, ssd_chunked,
        launched_kernels, get_config, smi)

    def p17_launches(key):
        labels = [p17_label(*r) for r in P17_RUNS]
        return {f"{label} serving mesh, 2 ranks (17)":
                sum(r[label]["launches"][key] for r in serving_mesh["ranks"])
                for label in labels}

    def p16_launches(label, key):
        one = sharded["one_device"][label]
        return {f"{label} one-device steps (16)":
                    sum(r["launches"][key] for name, r in one.items()
                        if isinstance(r, dict) and "launches" in r),
                f"{label} sharded step, 2 ranks (16)":
                    sum(r[label]["launches"][key] for r in sharded["ranks"])}

    def p16f_launches(key):
        rows = {}
        for a, _ in P16F:
            rows[f"{a} one-device step (16f)"] = sharded["one_device"][
                p16f_ref(a)]["(1, 1) mesh"]["launches"][key]
            label = p16f_label(a)
            rows[f"{label} tensor-parallel step, 2 ranks (16f)"] = sum(
                r[label]["launches"][key] for r in sharded["ranks"])
        return {k: v for k, v in rows.items() if v}

    def p16e_launches(key):
        rows = {}
        for dtype in sorted({d for _, d, _ in P16_MOE_RUNS}):
            ref = p16e_ref(dtype)
            rows[f"{ref} one-device step (16e)"] = sharded["one_device"][
                ref]["(1, 1) mesh"]["launches"][key]
        for shape, dtype, _ in P16_MOE_RUNS:
            label = p16e_label(shape, dtype)
            rows[f"{label} sharded step, 2 ranks (16e)"] = sum(
                r[label]["launches"][key] for r in sharded["ranks"])
        return rows

    serve_errs = [c["max_abs_err"]
                  for c in checks + serving_mesh["kernel_checks"]
                  if c["serve"] and c["dtype"] == "bfloat16"]
    main_row = next(r for r in rows if r["shape"] == "serve decode")
    flash_by_path = {"stablelm-1.6b": launches,
                     **{a: r["flash_launches"] for a, r in configs.items()},
                     **{a: r["flash_launches"] for a, r in configs12.items()},
                     ENCDEC_ARCH: encdec_run["flash_launches"],
                     "stablelm-1.6b training (13e)":
                         training["full_width"]["flash_fwd_launches"],
                     **p16_launches(P16_ARCH, "flash_fwd"),
                     **p16e_launches("flash_fwd"),
                     **p16f_launches("flash_fwd"),
                     **p17_launches("flash_fwd")}
    ssd_by_path = {"mamba2-1.3b": ssd_launches,
                   "zamba2-1.2b": configs["zamba2-1.2b"]["ssd_launches"],
                   "mamba2-1.3b training (13h)":
                       training["ssm_full_width"]["ssd_fwd_launches"],
                   **p16_launches(ssm_arch, "ssd_fwd"),
                   **p16f_launches("ssd_fwd"),
                   **p17_launches("ssd_fwd")}
    entry = {"name": "flash_attention_fwd", "route": "cuda",
             "source": KERNEL_SOURCE, "replaces": REPLACES,
             "replaces_function": "_flash_fwd_kernel",
             "launches": sum(flash_by_path.values()),
             "launches_by_path": flash_by_path,
             "max_abs_err": max(serve_errs),
             "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
             "bound_ms": main_row["bound_ms"],
             "bound_by": main_row["bound_by"],
             "library_ms": main_row["library_ms"],
             "host_ms": main_row["host_ms"],
             "timed_shape": "serve decode", "shapes": rows}
    ssd_serve_errs = [c["max_abs_err"]
                      for c in ssd_checks + serving_mesh["ssd_checks"]
                      if c["serve"] and c["dtype"] == "bfloat16"]
    ssd_row = next(r for r in ssd_rows if r["shape"] == "serve prefill")
    ssd_entry = {"name": "ssd_scan_fwd", "route": "cuda",
                 "source": SSD_SOURCE, "replaces": SSD_REPLACES,
                 "replaces_function": "_ssd_kernel",
                 "launches": sum(ssd_by_path.values()),
                 "launches_by_path": ssd_by_path,
                 "max_abs_err": max(ssd_serve_errs),
                 "ms": ssd_row["ms"], "plain_ms": ssd_row["plain_ms"],
                 "bound_ms": ssd_row["bound_ms"],
                 "bound_by": ssd_row["bound_by"],
                 "library_ms": None, "library": ssd_row["library"],
                 "host_ms": ssd_row["host_ms"],
                 "timed_shape": "serve prefill", "shapes": ssd_rows}
    full = training["full_width"]
    bwd_row = training["bwd_timings"][0]
    bwd_entry = {"name": "flash_attention_bwd", "route": "cuda",
                 "source": BWD_SOURCE, "replaces": REPLACES,
                 "replaces_function": "the gradient of _flash_fwd_kernel",
                 "gradient_of": BWD_GRADIENT_OF,
                 "launches": full["flash_bwd_launches"]
                 + sum(p16_launches(P16_ARCH, "flash_bwd").values())
                 + sum(p16e_launches("flash_bwd").values())
                 + sum(p16f_launches("flash_bwd").values()),
                 "launches_by_path": {"stablelm-1.6b training (13e)":
                                      full["flash_bwd_launches"],
                                      **p16_launches(P16_ARCH, "flash_bwd"),
                                      **p16e_launches("flash_bwd"),
                                      **p16f_launches("flash_bwd")},
                 "max_abs_err": bwd_row["max_abs_err"],
                 "ms": bwd_row["ms"], "plain_ms": bwd_row["plain_ms"],
                 "bound_ms": bwd_row["bound_ms"],
                 "bound_by": bwd_row["bound_by"],
                 "library_ms": bwd_row["library_ms"],
                 "library": "torch.autograd.grad through "
                            "scaled_dot_product_attention",
                 "host_ms": bwd_row["host_ms"],
                 "timed_shape": bwd_row["shape"],
                 "shapes": training["bwd_timings"]}
    ssm_full = training["ssm_full_width"]
    ssd_bwd_row = training["ssd_bwd_timings"][0]
    per_call = FULL_STEPS / ssm_full["ssd_bwd_launches"]
    ssd_bwd_entry = {
        "name": "ssd_scan_bwd", "route": "cuda", "source": SSD_BWD_SOURCE,
        "replaces": SSD_REPLACES,
        "replaces_function": "the gradient of _ssd_kernel",
        "gradient_of": SSD_BWD_GRADIENT_OF,
        "launches": ssm_full["ssd_bwd_launches"]
        + sum(p16_launches(ssm_arch, "ssd_bwd").values())
        + sum(p16f_launches("ssd_bwd").values()),
        "launches_by_path": {"mamba2-1.3b training (13h)":
                             ssm_full["ssd_bwd_launches"],
                             **p16_launches(ssm_arch, "ssd_bwd"),
                             **p16f_launches("ssd_bwd")},
        "max_abs_err": ssd_bwd_row["max_abs_err"],
        "ms": ssd_bwd_row["ms"], "plain_ms": ssd_bwd_row["plain_ms"],
        "bound_ms": ssd_bwd_row["bound_ms"],
        "bound_by": ssd_bwd_row["bound_by"], "library_ms": None,
        "library": ssd_bwd_row["library"], "host_ms": ssd_bwd_row["host_ms"],
        "timed_shape": ssd_bwd_row["shape"], "path": ssd_bwd_row["path"],
        "path_kernels": list(ssd_kernel.BWD_KERNELS[ssd_bwd_row["path"]]),
        "kernels_ms": {k: ms * per_call for k, ms
                       in ssm_full["profile"]["parts_ms"].items()
                       if k != "ssd_bwd"},
        "kernels_ms_from": "13h's profiled step, per backward call",
        "shapes": training["ssd_bwd_timings"]}
    clock(None)
    kernels_line = {"kernels": [entry, ssd_entry, bwd_entry, ssd_bwd_entry]}
    report = {**kernels_line, "checks": checks, "ssd_checks": ssd_checks,
              "serve": summary, "batch_shapes": batch_shapes,
              "peak_memory_gb": peak_gb, "decode_profile": profile,
              "model_rel_err": model_errs,
              "mamba2": {"serve": msummary, "batch_shapes": mbatch_shapes,
                         "peak_memory_gb": mpeak_gb,
                         "prefill_ms": prefill_ms, "profile": mprofile,
                         "model_rel_err": mmodel_errs},
              "estimator": estimator, "online": online, "fleet": fleet,
              "ml": ml, "serving_configs": configs,
              "phase12": {"moe": configs12, "encdec": encdec_run,
                          "kv_quant": kv_quant_run, "timings": rows12},
              "training": training, "dryrun": dryrun, "syncs": sync_report,
              "sharded": sharded, "serving_mesh": serving_mesh,
              "card": smi, "phase_seconds": clock.seconds,
              "seconds": time.time() - t_start}
    out_dir = ROOT / "build" / "reports"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                        clock.seconds.items()), flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
