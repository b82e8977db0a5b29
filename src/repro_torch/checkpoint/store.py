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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

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


def restore(ckpt_dir: str | Path, step: int | None = None, *, device=None):
    """Restore a checkpoint (the latest complete one by default) as a tree
    of tensors on ``device`` (default: the CUDA card).  Returns (state,
    manifest)."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out: dict = {}
    for rec in manifest["leaves"]:
        arr = np.load(d / rec["file"])
        _set_path(out, list(rec["path"]), _from_numpy(arr, rec["dtype"], dev))
    return out, manifest


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Overlaps checkpoint serialisation with training compute."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, state, metadata: dict | None = None) -> None:
        self.wait()
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
