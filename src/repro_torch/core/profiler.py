"""Phase 1: infrastructure profiling with short, uniform microbenchmarks.

Paper analogue:  sysbench CPU  -> prime verification events/s (real, Python)
                 LINPACK       -> torch fp32 matmul GFLOP/s (real, on the
                                  device the caller names; cuda by default)
                 sysbench mem  -> torch streaming bandwidth (real, same
                                  device)
                 fio seq RW    -> tempfile sequential write/read MB/s (real)
plus the accelerator axis the 2022 paper didn't need:
                 collective    -> ICI/DCN link bandwidth (simulated for
                                  remote node types; measured constants).

Remote accelerator nodes cannot be touched from this container, so their
benchmarks are *simulated measurements*: the node's hidden true rates with
multiplicative measurement noise — exactly the information a real
microbenchmark would return.  Single-chip scores (the paper normalises to
single-core for comparability); the resource manager assigns whole chips.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, asdict

import numpy as np
import torch

from repro_torch import resolve_device

from .nodes import NodeType

_BENCH_NOISE = 0.03   # relative measurement noise of a ~1 minute benchmark


@dataclass(frozen=True)
class BenchResult:
    node: str
    cpu_events_s: float       # sysbench analogue
    matmul_gflops: float      # LINPACK analogue (MXU/AVX peak proxy)
    mem_gbps: float           # memory stream
    io_read_mbps: float       # fio seq read
    io_write_mbps: float      # fio seq write
    link_gbps: float          # collective bandwidth (accelerators)

    def to_dict(self) -> dict:
        return asdict(self)


# ---------------------------------------------------------------------------
# Real benchmarks (the local node)
# ---------------------------------------------------------------------------
def _bench_primes(limit: int = 20_000, budget_s: float = 1.0) -> float:
    """sysbench-style: verify primes up to `limit`; return events/s."""
    def count_primes(n: int) -> int:
        cnt = 0
        for c in range(2, n):
            is_p = True
            d = 2
            while d * d <= c:
                if c % d == 0:
                    is_p = False
                    break
                d += 1
            cnt += is_p
        return cnt
    t0 = time.perf_counter()
    events = 0
    while time.perf_counter() - t0 < budget_s:
        count_primes(limit // 10)
        events += 1
    return events / (time.perf_counter() - t0)


def _bench_matmul(n: int = 512, reps: int = 8, device=None) -> float:
    """fp32 GFLOP/s of ``reps`` chained (n, n) products on ``device``.  TF32
    stays off for the probe, so the figure is fp32's."""
    dev = resolve_device(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # repro_torch: ignore[RA002] -- hardware probe measures fp32 matmul throughput; the GFLOP/s figure is defined at this width, independent of the estimator's float64 policy
        x = torch.ones((n, n), dtype=torch.float32, device=dev)
        _sync(dev)
        _ = x @ x                        # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            x = x @ x
        _sync(dev)
        dt = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2.0 * n ** 3 * reps / dt / 1e9


def _bench_memory(mb: int = 256, reps: int = 8, device=None) -> float:
    """Streaming GB/s on ``device``: one read and one write per element and
    pass (``1 + 1.000001 * a`` in one kernel)."""
    dev = resolve_device(device)
    n = mb * 1024 * 1024 // 4
    # repro_torch: ignore[RA002] -- bandwidth probe: the MB->element count above assumes 4-byte lanes, so the buffer must stay fp32 regardless of the float64 policy
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    one = torch.tensor(1.0)        # a 0-dim CPU scalar: no host->device copy

    def f(a):
        return torch.add(one, a, alpha=1.000001)
    f(x)
    _sync(dev)
    t0 = time.perf_counter()
    y = x
    for _ in range(reps):
        y = f(y)
    _sync(dev)
    dt = time.perf_counter() - t0
    return 2.0 * n * 4 * reps / dt / 1e9     # read + write per element


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bench_io(mb: int = 64) -> tuple[float, float]:
    buf = os.urandom(1024 * 1024)
    with tempfile.NamedTemporaryFile(delete=False) as f:
        path = f.name
        t0 = time.perf_counter()
        for _ in range(mb):
            f.write(buf)
        f.flush()
        os.fsync(f.fileno())
        w = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        while f.read(1024 * 1024):
            pass
    r = mb / (time.perf_counter() - t0)
    os.unlink(path)
    return r, w


def profile_local(node_name: str = "local-cpu", fast: bool = True,
                  device=None) -> BenchResult:
    """Run the real microbenchmark suite on this host (sub-minute): the
    prime and I/O probes on the host, the matmul and memory probes on
    ``device`` (the CUDA card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    r, w = _bench_io(16 if fast else 64)
    return BenchResult(
        node=node_name,
        cpu_events_s=_bench_primes(budget_s=0.5 if fast else 2.0),
        matmul_gflops=_bench_matmul(256 if fast else 512, device=dev),
        mem_gbps=_bench_memory(64 if fast else 256, device=dev),
        io_read_mbps=r, io_write_mbps=w,
        link_gbps=0.0)


# ---------------------------------------------------------------------------
# Simulated benchmarks (remote node types)
# ---------------------------------------------------------------------------
def profile_node(node: NodeType, rng: np.random.Generator | None = None,
                 noise: float = _BENCH_NOISE) -> BenchResult:
    rng = rng or np.random.default_rng(0)
    def meas(x):
        return float(x * rng.lognormal(0.0, noise))
    return BenchResult(
        node=node.name,
        cpu_events_s=meas(node.cpu_score),
        matmul_gflops=meas(node.peak_flops / 1e9),
        mem_gbps=meas(node.hbm_bw / 1e9),
        io_read_mbps=meas(node.io_bw),
        io_write_mbps=meas(node.io_bw * 0.98),
        link_gbps=meas(node.link_bw / 1e9))


def profile_cluster(nodes: list[NodeType], seed: int = 0) -> dict[str, BenchResult]:
    rng = np.random.default_rng(seed)
    return {n.name: profile_node(n, rng) for n in nodes}
