"""starcoder2-15b [arXiv:2402.19173; hf] — dense, GQA, RoPE, biased projections.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.models.common import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
        vocab=49152, head_dim=128, norm="layernorm", act="gelu",
        qkv_bias=True, rope_theta=100_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="starcoder2-15b", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=128, head_dim=8, norm="layernorm", act="gelu",
        qkv_bias=True, attn_chunk=16, xent_chunk=32)
