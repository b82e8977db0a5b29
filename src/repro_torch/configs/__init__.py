"""Architecture registry of the port.

``get_config(arch)`` returns the full published config; ``smoke_config``
a reduced same-family config for CPU tests.  Only the architectures whose
model path is ported are listed; the others raise ``NotImplementedError``
naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import importlib

ARCHS = ["stablelm-1.6b", "mamba2-1.3b", "qwen2-7b", "qwen2-vl-7b",
         "stablelm-12b", "starcoder2-15b", "zamba2-1.2b"]

#: architectures of the JAX package still to port -> ROADMAP.md item
PENDING = {
    "qwen3-moe-30b-a3b": "Queue A item 1 (models/moe.py)",
    "llama4-maverick-400b-a17b": "Queue A item 1 (models/moe.py)",
    "seamless-m4t-large-v2": "Queue A item 1 (models/encdec.py)",
}


def _module(arch: str):
    if arch not in ARCHS:
        item = PENDING.get(arch, "no item: the JAX package has no such arch")
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see ROADMAP.md, "
            f"{item}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str):
    return _module(arch).full_config()


def smoke_config(arch: str):
    return _module(arch).smoke_config()


def list_archs() -> list[str]:
    return list(ARCHS)
