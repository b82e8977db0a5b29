"""qwen2-vl-7b [arXiv:2409.12191; hf] — qwen2-7b backbone + M-RoPE.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The vision patch
frontend is a stub, as in the JAX package: a caller passes precomputed patch
embeddings (``batch["vision_embeds"]``) and (temporal, h, w) position ids
(``batch["positions"]``).
"""
from repro_torch.models.common import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
        vocab=152064, head_dim=128, norm="rmsnorm", act="swiglu",
        qkv_bias=True, mrope=True, rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-7b", family="vlm",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=128, head_dim=16, norm="rmsnorm", act="swiglu",
        qkv_bias=True, mrope=True, attn_chunk=16, xent_chunk=32)
