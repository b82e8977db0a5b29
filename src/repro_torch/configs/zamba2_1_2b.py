"""zamba2-1.2b [arXiv:2411.15242; hf] — Mamba2 blocks + weight-tied shared
attention block applied every 6 layers.

38L d_model=2048; shared attn 32H (kv=32) d_ff=8192; vocab=32000; ssm_state=64.
"""
from repro_torch.models.common import ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab=32000, head_dim=64, norm="rmsnorm", act="gelu",
        hybrid_attn_every=6,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      chunk=128, n_groups=1))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-1.2b", family="hybrid",
        n_layers=5, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=128, head_dim=8, norm="rmsnorm", act="gelu",
        hybrid_attn_every=2,
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=8,
                      chunk=16, n_groups=1),
        attn_chunk=16, xent_chunk=32)
