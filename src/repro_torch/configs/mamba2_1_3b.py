"""mamba2-1.3b [arXiv:2405.21060] — pure SSM (SSD), attention-free.

48L d_model=2048 vocab=50280 ssm_state=128 (d_inner=4096, 64 SSD heads).
"""
from repro_torch.models.common import ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0,
        # vocab 50280 padded to 50432 (divisible by 256), as the JAX package
        vocab=50_432, head_dim=64, norm="rmsnorm", act="swiglu",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk=128, n_groups=1))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="mamba2-1.3b", family="ssm",
        n_layers=2, d_model=32, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=128, head_dim=8, norm="rmsnorm", act="swiglu",
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=8,
                      chunk=16, n_groups=1),
        attn_chunk=16, xent_chunk=32)
