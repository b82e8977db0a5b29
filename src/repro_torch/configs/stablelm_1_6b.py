"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b] — dense (MHA: kv=heads).

24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352.
"""
from repro_torch.models.common import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
        vocab=100352, head_dim=64, norm="layernorm", act="swiglu",
        rope_theta=10_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="stablelm-1.6b", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=128, head_dim=8, norm="layernorm", act="swiglu",
        attn_chunk=16, xent_chunk=32)
