"""Builds the port's CUDA sources with nvcc into ``build/kernels/``.

Each source is compiled at first use into a shared library with a plain C
interface, loaded with ctypes by its wrapper.  A library is rebuilt only
when the source or the flags change (a sha256 stamp beside it); the
compiler's register and shared-memory report (``-Xptxas -v``) is kept in a
``.log`` file beside the library.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA home that PyTorch detects."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build(source: Path) -> Path:
    """Compile ``source`` (a .cu file) into ``build/kernels/lib<stem>.so``
    unless an up-to-date library is there; returns the library's path."""
    source = Path(source)
    out = BUILD_DIR / f"lib{source.stem}.so"
    stamp = out.with_name(out.name + ".sha256")
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    if out.exists() and stamp.exists() and stamp.read_text() == digest:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)      # atomic when several processes build at once
    stamp.write_text(digest)
    return out


def build_log(source: Path) -> str:
    """The compiler's output from the last build of ``source``."""
    log = BUILD_DIR / f"lib{Path(source).stem}.so.log"
    return log.read_text() if log.exists() else ""
