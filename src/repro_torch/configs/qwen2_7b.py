"""qwen2-7b [arXiv:2407.10671; hf] — dense, GQA, QKV bias.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.models.common import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
        vocab=152064, head_dim=128, norm="rmsnorm", act="swiglu",
        qkv_bias=True, rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-7b", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=128, head_dim=8, norm="rmsnorm", act="swiglu",
        qkv_bias=True, attn_chunk=16, xent_chunk=32)
