"""Architecture registry of the port: the JAX package's ten.

``get_config(arch)`` returns the full published config; ``smoke_config``
a reduced same-family config for CPU tests.
"""
from __future__ import annotations

import importlib

ARCHS = ["stablelm-1.6b", "mamba2-1.3b", "qwen2-7b", "qwen2-vl-7b",
         "stablelm-12b", "starcoder2-15b", "zamba2-1.2b",
         "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
         "seamless-m4t-large-v2"]


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the archs are {ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str):
    return _module(arch).full_config()


def smoke_config(arch: str):
    return _module(arch).smoke_config()


def list_archs() -> list[str]:
    return list(ARCHS)
