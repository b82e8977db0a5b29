"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*] — interleaved MoE.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; 128 routed experts
top-1 + shared expert, MoE every 2nd layer (interleaved, per Llama-4).
~400B total / ~17B active parameters.
"""
from repro_torch.models.common import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab=202048, head_dim=128, norm="rmsnorm", act="swiglu",
        rope_theta=500_000.0,
        moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, every=2,
                      shared_expert=True, capacity_factor=2.0))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="llama4-maverick-400b-a17b", family="moe",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=128, head_dim=8, norm="rmsnorm", act="swiglu",
        moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=64, every=2,
                      shared_expert=True, capacity_factor=2.0),
        attn_chunk=16, xent_chunk=32)
