"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — enc-dec multimodal backbone.

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  Interpreted as 24
encoder + 24 decoder layers (text backbone of the M4T v2 stack); the audio
frontend is a stub — ``launch.shapes.concrete_batch`` provides frame
embeddings (B, T_src, d_model) for the encoder.
"""
from repro_torch.models.common import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="seamless-m4t-large-v2", family="encdec",
        n_layers=48, enc_layers=24, dec_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
        # vocab 256206 padded to 256256, as the JAX package pads it
        vocab=256_256, head_dim=64, norm="layernorm", act="gelu",
        rope_theta=10_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="seamless-m4t-large-v2", family="encdec",
        n_layers=4, enc_layers=2, dec_layers=2,
        d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=128, head_dim=8, norm="layernorm", act="gelu",
        attn_chunk=16, xent_chunk=32)
