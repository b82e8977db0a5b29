"""Input-shape cells and concrete batches.

Counterpart of ``repro.launch.shapes``: the (arch x shape) cells
(``SHAPES``, ``cell_applicable``) and ``concrete_batch``, the small
concrete batch of a cell's kind that tests and the smoke run feed the
model.  ``input_specs`` (the dry run's sharded stand-ins) is not ported
yet (ROADMAP.md, Queue A, the dry run).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("long_500k skipped: pure full-attention arch "
                       "(DESIGN.md §6)")
    return True, ""


def concrete_batch(cfg: ModelConfig, kind: str, B: int, T: int, *,
                   seed: int = 0, device=None) -> dict:
    """The batch of a ``kind`` cell (train | prefill | decode) at (B, T),
    with the JAX package's keys, shapes and dtypes; random values from a
    ``torch.Generator`` seeded with ``seed`` (other bits than the JAX
    package's), on ``device`` (default: the CUDA card).  encdec: source
    frames ``src_embeds`` (B, T, d_model) of std 0.1 and a target prefix
    of T tokens; vlm: max(2, T // 4) vision embeddings (bf16 0.1), the
    tokens after them, arange positions in all three components."""
    dev = resolve_device(device)
    if kind == "decode":
        batch = {"tokens": torch.zeros(B, 1, dtype=torch.int32, device=dev)}
        if cfg.family == "vlm" and cfg.mrope:
            batch["positions"] = torch.zeros(B, 1, 3, dtype=torch.int32,
                                             device=dev)
        return batch
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen, device=dev,
                           dtype=torch.int32)
    if cfg.family == "encdec":
        batch = {"src_embeds": 0.1 * torch.randn(B, T, cfg.d_model,
                                                 generator=gen, device=dev),
                 "tokens": tokens}
    elif cfg.family == "vlm":
        nv = max(2, T // 4)
        pos = torch.arange(T, dtype=torch.int32, device=dev)
        batch = {"tokens": tokens[:, :T - nv],
                 "vision_embeds": torch.full((B, nv, cfg.d_model), 0.1,
                                             dtype=torch.bfloat16,
                                             device=dev),
                 "positions": pos[None, :, None].expand(B, T, 3)}
    else:
        batch = {"tokens": tokens}
    if kind == "train":
        batch["labels"] = batch["tokens"]
    return batch
