"""Input-shape cells and concrete batches.

Counterpart of ``repro.launch.shapes``: the (arch x shape) cells
(``SHAPES``, ``cell_applicable``), ``input_specs``, the dry run's
stand-ins for a cell's batch, and ``concrete_batch``, the small concrete
batch of a cell's kind that tests and the smoke run feed the model.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.models.common import AxisRules, ModelConfig, abstract_leaf

VLM_VISION_TOKENS = 1024     # patch-embedding stub length inside the seq budget
AUDIO_FRAME_RATIO = 1.0      # encoder frames per "seq_len" unit (stub frontend)


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


def _dp_batch_spec(rules: AxisRules, global_batch: int, mesh) -> tuple:
    """Shard batch over dp axes when divisible, else replicate."""
    dp = 1
    for a in rules.dp_axes:
        dp *= mesh.shape[a]
    if dp > 1 and global_batch % dp == 0:
        axes = rules.dp_axes if len(rules.dp_axes) > 1 else rules.dp_axes[0]
        return (axes,)
    return (None,)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
                rules: AxisRules | None = None, *, device="meta") -> dict:
    """Stand-ins (uninitialised tensors, on ``meta`` unless asked) for the
    step's *batch* argument of a cell, with the JAX package's keys, shapes
    and dtypes.  With a ``mesh`` and ``rules`` each is a
    ``common.Abstract`` (a ``meta`` tensor of the global shape, its spec
    and one rank's local shape): the batch dim over the dp axes where
    they divide it (``_dp_batch_spec``), every other dim replicated."""
    B, T = shape.global_batch, shape.seq
    b_axes = None if mesh is None else _dp_batch_spec(rules, B, mesh)[0]

    def spec(shp, dtype):
        if mesh is not None:
            return abstract_leaf(shp, dtype,
                                 (b_axes,) + (None,) * (len(shp) - 1), mesh)
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind == "decode":
        batch = {"tokens": spec((B, 1), torch.int32)}
        if cfg.family == "vlm" and cfg.mrope:
            batch["positions"] = spec((B, 1, 3), torch.int32)
        return batch
    if cfg.family == "encdec":
        batch = {"src_embeds": spec((B, T, cfg.d_model), torch.bfloat16),
                 "tokens": spec((B, T), torch.int32)}
        text = T
    elif cfg.family == "vlm":
        nv = min(VLM_VISION_TOKENS, T // 4)
        batch = {"tokens": spec((B, T - nv), torch.int32),
                 "vision_embeds": spec((B, nv, cfg.d_model), torch.bfloat16),
                 "positions": spec((B, T, 3), torch.int32)}
        text = T - nv
    else:
        batch = {"tokens": spec((B, T), torch.int32)}
        text = T
    if shape.kind == "train":
        batch["labels"] = spec((B, text), torch.int32)
    return batch


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
