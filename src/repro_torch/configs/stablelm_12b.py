"""stablelm-12b [hf:stabilityai/stablelm-2-12b] — dense decoder-only.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.models.common import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
        vocab=100352, head_dim=160, norm="layernorm", act="swiglu",
        rope_theta=10_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="stablelm-12b", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=128, head_dim=8, norm="layernorm", act="swiglu",
        attn_chunk=16, xent_chunk=32)
