"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper cards.

The port mirrors ``repro``'s module layout and public names
(``repro_torch.models.layers.self_attention`` is the counterpart of
``repro.models.layers.self_attention``) and never imports JAX or ``repro``.

Device policy: every entry point runs on ``cuda`` unless the caller asks
for the CPU (``device="cpu"``).  Without a card it raises; it never moves
to the CPU on its own.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  Raises when a CUDA device is asked for and
    no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default, and no CUDA card "
            "is available; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device", "__version__"]
