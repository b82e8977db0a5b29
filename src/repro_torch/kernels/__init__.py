"""Hand-written Hopper kernels of the port, with their plain versions.

Each kernel is built from ``csrc/`` by nvcc at first use."""
from . import flash_attention, ssd

__all__ = ["flash_attention", "ssd"]
