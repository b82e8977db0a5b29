"""Phase 4: model adjustment for the target infrastructure (paper §3.4).

    dev  = (t_reducedCPU - t_normal) / t_normal                (per sample)
    w    = clamp( median(dev) / (f_old/f_new - 1), 0, 1 )      (eq. 5)
    f_t  = w * cpu_local/cpu_target + (1-w) * io_local/io_target   (eq. 6)
    t(node) = t(local) * f_t

Beyond-paper extension for the accelerator plane: a *three-term* factor
over (FLOPs, HBM, interconnect) with weights taken from the workload's
roofline shares (derived from the compiled dry-run) — TPUs expose no
userspace DVFS, and the roofline decomposition carries strictly more
information than the paper's single frequency probe (DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .profiler import BenchResult


@dataclass(frozen=True)
class BenchArrays:
    """A stack of N ``BenchResult``s as (N,) arrays.

    Duck-types the ``BenchResult`` fields, so ``runtime_factor`` /
    ``runtime_factor3`` accept it wherever a single bench is accepted and
    broadcast over the node axis — one call yields the whole factor row
    (or the full (T, N) matrix when the weights carry a task axis)."""
    nodes: tuple
    cpu_events_s: np.ndarray
    matmul_gflops: np.ndarray
    mem_gbps: np.ndarray
    io_read_mbps: np.ndarray
    io_write_mbps: np.ndarray
    link_gbps: np.ndarray


def stack_benches(benches: Sequence[BenchResult]) -> BenchArrays:
    return BenchArrays(
        nodes=tuple(b.node for b in benches),
        cpu_events_s=np.array([b.cpu_events_s for b in benches], np.float64),
        matmul_gflops=np.array([b.matmul_gflops for b in benches], np.float64),
        mem_gbps=np.array([b.mem_gbps for b in benches], np.float64),
        io_read_mbps=np.array([b.io_read_mbps for b in benches], np.float64),
        io_write_mbps=np.array([b.io_write_mbps for b in benches], np.float64),
        link_gbps=np.array([b.link_gbps for b in benches], np.float64))


def deviation(t_new: float, t_old: float) -> float:
    return (t_new - t_old) / t_old


def cpu_weight(median_dev: float, freq_old: float, freq_new: float) -> float:
    """Paper eq. 5.  freq_old/freq_new > 1 (CPU was slowed down)."""
    denom = freq_old / freq_new - 1.0
    if denom <= 0:
        return 0.0
    return float(np.clip(median_dev / denom, 0.0, 1.0))


def runtime_factor(w, local: BenchResult, target):
    """Paper eq. 6 — CPU/I-O two-term factor.

    ``w`` may be a scalar or a (T,) array; ``target`` a single
    ``BenchResult`` or a stacked ``BenchArrays``.  Broadcasting yields a
    float, (T,), (N,) or (T, N) — one call per estimate matrix."""
    cpu = np.asarray(local.cpu_events_s) / np.maximum(
        np.asarray(target.cpu_events_s, np.float64), 1e-9)
    io = np.asarray(_io_score(local)) / np.maximum(
        np.asarray(_io_score(target), np.float64), 1e-9)
    w = np.asarray(w, np.float64)
    if w.ndim and cpu.ndim:
        out = np.multiply.outer(w, cpu) + np.multiply.outer(1.0 - w, io)
    else:
        out = w * cpu + (1.0 - w) * io
    return float(out) if np.ndim(out) == 0 else out


def _io_score(b: BenchResult) -> float:
    return 0.5 * (b.io_read_mbps + b.io_write_mbps)


def roofline_weights(compute_s: float, memory_s: float,
                     collective_s: float) -> tuple[float, float, float]:
    """Normalised shares of the three roofline terms."""
    tot = compute_s + memory_s + collective_s
    if tot <= 0:
        return (1.0, 0.0, 0.0)
    return (compute_s / tot, memory_s / tot, collective_s / tot)


def runtime_factor3(weights, local: BenchResult, target):
    """Three-term factor: FLOPs / HBM / interconnect (beyond paper).

    ``weights`` is a (3,) tuple/array or a stacked (T, 3) array; ``target``
    a ``BenchResult`` or ``BenchArrays``.  Returns float, (T,), (N,) or
    (T, N) accordingly."""
    w = np.asarray(weights, np.float64)
    fc = np.asarray(local.matmul_gflops) / np.maximum(
        np.asarray(target.matmul_gflops, np.float64), 1e-9)
    fm = np.asarray(local.mem_gbps) / np.maximum(
        np.asarray(target.mem_gbps, np.float64), 1e-9)
    ln_local = np.where(np.asarray(local.link_gbps) > 0,
                        local.link_gbps, np.asarray(local.mem_gbps) / 10)
    ln_tgt = np.where(np.asarray(target.link_gbps, np.float64) > 0,
                      np.asarray(target.link_gbps, np.float64),
                      np.asarray(target.mem_gbps, np.float64) / 10)
    fn = ln_local / np.maximum(ln_tgt, 1e-9)
    ratios = np.stack(np.broadcast_arrays(fc, fm, fn), axis=-1)  # (..., 3)
    out = np.tensordot(w, ratios, axes=([-1], [-1]))
    return float(out) if np.ndim(out) == 0 else out
