"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B] — 128 experts, top-8, all layers.

48L d_model=2048 32H (GQA kv=4) expert d_ff=768 vocab=151936.
"""
from repro_torch.models.common import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
        vocab=151936, head_dim=128, norm="rmsnorm", act="swiglu",
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, every=1,
                      shared_expert=False, capacity_factor=1.25))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-moe-30b-a3b", family="moe",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab=128, head_dim=8, norm="rmsnorm", act="swiglu",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, every=1,
                      shared_expert=False, capacity_factor=1.25),
        attn_chunk=16, xent_chunk=32)
