"""Atomic, async checkpointing in the JAX package's on-disk layout.

Counterpart of ``repro.checkpoint.store``:

    <dir>/step_<N>/
        manifest.json           (tree paths, shapes, dtypes, step)
        leaf_<i>.npy            (the whole array of each leaf)
    <dir>/step_<N>.tmp/ ...     (atomic: renamed on completion)
    <dir>/LATEST                (text file: last complete step)

A leaf is a tensor (on any device), a numpy array or a Python number.
numpy has no bfloat16, so a bf16 tensor is stored as its uint16 bit
pattern with "bfloat16" as its dtype in the manifest, and restored bit
for bit; a checkpoint of fp32 leaves written by the JAX package restores
as it is.  ``restore`` returns tensors on the device asked for (default:
the CUDA card).  ``AsyncCheckpointer`` copies the state to host memory
before it returns (the optimizer then updates the tensors in place) and
writes it on a background thread.

Sharded state (each rank holding its slices, ``launch.sharding``) is
saved in the same host-count independent format, whole logical arrays
under the same manifest: rank 0 creates each leaf's ``.npy`` at its full
shape, and every rank that owns its slice (``Sharding.owner``) writes the
slice's bytes into the file, one ``pwrite`` for each contiguous run
(``write_slice``), and syncs them to disk; barriers order the creation,
the writes and rank 0's rename.  No rank gathers a leaf.  The ranks write
disjoint byte ranges and no rank writes a page back whole (as a shared
memmap would), so ranks on several hosts may share the directory over a
network filesystem that keeps byte-range writes apart (NFS, Lustre).  ``restore(shardings=)``
memory-maps each file and reads only the rank's slice, so a checkpoint
restores onto any mesh (elastic restart) and, without ``shardings``,
whole in one process.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device


def _tree_paths(tree, prefix=()):
    """Deterministic (path, leaf) enumeration."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _set_path(out, path, value):
    cur = out
    for p in path[:-1]:
        cur = cur.setdefault(p, {})
    cur[path[-1]] = value


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if dtype == "bfloat16":        # our uint16 bits, or the JAX package's
        bits = arr.view(np.int16)  # bf16 (2 bytes a value either way)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(ckpt_dir: str | Path, step: int, state,
         metadata: dict | None = None) -> Path:
    """Atomic checkpoint write.  Returns the final directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(),
                "metadata": metadata or {}, "leaves": []}
    for i, (path, leaf) in enumerate(_tree_paths(state)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"path": list(path), "file": fname,
                                   "shape": list(arr.shape), "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    (ckpt_dir / "LATEST").write_text(str(step))
    return final


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def write_slice(path: str | Path, shape, slices, arr: np.ndarray) -> None:
    """Write ``arr``, the block ``slices`` (one ``slice`` a dim, step 1) of
    a C-order array of ``shape``, into the ``.npy`` file ``path`` that
    holds that array, then sync the file: one ``os.pwrite`` for each
    contiguous run of the block, so only the block's bytes are written."""
    arr = np.ascontiguousarray(arr)
    with open(path, "r+b") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            np.lib.format.read_array_header_1_0(f)
        else:
            np.lib.format.read_array_header_2_0(f)
        base, fd = f.tell(), f.fileno()
        if arr.size == 0:
            return
        strides = [arr.itemsize * math.prod(shape[d + 1:])
                   for d in range(len(shape))]
        # dims k.. are whole, so a run spans dim k - 1's part of them
        k = len(shape)
        while k > 0 and slices[k - 1] == slice(0, shape[k - 1]):
            k -= 1
        j = max(k - 1, 0)
        outer = [sl.stop - sl.start for sl in slices[:j]]
        run = arr.nbytes // math.prod(outer)
        first = base + sum(sl.start * st for sl, st in
                           zip(slices[:j + 1], strides[:j + 1]))
        buf = memoryview(arr.reshape(-1).view(np.uint8))
        for n, idx in enumerate(np.ndindex(*outer)):
            off = first + sum(i * st for i, st in zip(idx, strides))
            chunk = buf[n * run:(n + 1) * run]
            while chunk:
                done = os.pwrite(fd, chunk, off)
                chunk, off = chunk[done:], off + done
        os.fsync(fd)


def save_sharded(ckpt_dir: str | Path, step: int, state, shardings,
                 metadata: dict | None = None) -> Path:
    """Atomic write of sharded ``state`` (this rank's slices; ``shardings``
    a tree of ``launch.sharding.Sharding`` of the same keys) as whole
    arrays; every rank of the world calls it.  Returns the final
    directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    rank0 = _rank0()
    shard_leaves = dict(_tree_paths(shardings))
    leaves = []
    for i, (path, leaf) in enumerate(_tree_paths(state)):
        sh = shard_leaves[path]
        arr, dtype = _to_numpy(leaf)
        leaves.append((path, f"leaf_{i:05d}.npy", arr, dtype, sh,
                       sh.global_shape(arr.shape)))
    if rank0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(),
                    "metadata": metadata or {}, "leaves": []}
        for path, fname, arr, dtype, _, shape in leaves:
            np.lib.format.open_memmap(tmp / fname, mode="w+",
                                      dtype=arr.dtype, shape=shape)
            manifest["leaves"].append({"path": list(path), "file": fname,
                                       "shape": list(shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
    _barrier()
    for _, fname, arr, _, sh, shape in leaves:
        if sh.owner():
            write_slice(tmp / fname, shape, sh.slices(shape), arr)
    _barrier()
    if rank0:
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        (ckpt_dir / "LATEST").write_text(str(step))
    _barrier()
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    step = int(p.read_text().strip())
    if not (Path(ckpt_dir) / f"step_{step:08d}" / "manifest.json").exists():
        # crashed mid-write with stale LATEST: fall back to newest complete
        steps = sorted(int(d.name.split("_")[1])
                       for d in Path(ckpt_dir).glob("step_*")
                       if d.is_dir() and (d / "manifest.json").exists())
        return steps[-1] if steps else None
    return step


def restore(ckpt_dir: str | Path, step: int | None = None, *, device=None,
            shardings=None):
    """Restore a checkpoint (the latest complete one by default) as a tree
    of tensors on ``device`` (default: the CUDA card).  ``shardings``: a
    tree of ``launch.sharding.Sharding`` (the same paths), onto whose
    mesh the leaves it names are re-sharded: each file is memory-mapped
    and only this rank's slice is read.  Returns (state, manifest)."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    shard_leaves = {} if shardings is None else dict(_tree_paths(shardings))
    out: dict = {}
    for rec in manifest["leaves"]:
        sh = shard_leaves.get(tuple(rec["path"]))
        if sh is None:
            arr = np.load(d / rec["file"])
        else:
            arr = np.load(d / rec["file"], mmap_mode="r")
            arr = np.array(arr[sh.slices(arr.shape)])     # a copy
        _set_path(out, list(rec["path"]), _from_numpy(arr, rec["dtype"], dev))
    return out, manifest


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Overlaps checkpoint serialisation with training compute.  With
    ``shardings`` (a tree of ``launch.sharding.Sharding`` of the saved
    state's paths) every rank calls ``save`` and it writes synchronously
    (``save_sharded``: its barriers are collectives, which a background
    thread would interleave with the step's)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3,
                 shardings=None):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self.shardings = shardings
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, state, metadata: dict | None = None) -> None:
        self.wait()
        if self.shardings is not None:
            save_sharded(self.ckpt_dir, step, state, self.shardings,
                         metadata)
            if _rank0():
                self._gc()
            return
        # snapshot to host memory synchronously, write async
        host_state: dict = {}
        for path, leaf in _tree_paths(state):
            _set_path(host_state, list(path), _host_copy(leaf))

        def work():
            try:
                save(self.ckpt_dir, step, host_state, metadata)
                self._gc()
            except (OSError, ValueError, TypeError) as e:
                # surfaced on the next wait(): disk or permission failures
                # (OSError), np.save on a malformed leaf (ValueError),
                # metadata that JSON cannot hold (TypeError)
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(d.name.split("_")[1])
                       for d in self.ckpt_dir.glob("step_*") if d.is_dir()
                       and not d.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:08d}", ignore_errors=True)
