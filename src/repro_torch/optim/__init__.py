"""The port's optimizer: AdamW and gradient compression."""
from .adamw import AdamWConfig, apply_updates, global_norm, lr_at, state_defs
from .compress import compress_grads, decompress_grads

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "lr_at",
           "state_defs", "compress_grads", "decompress_grads"]
