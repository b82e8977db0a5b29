from .kernel import flash_attention, flash_attention_bwd
from .ops import mha
from .ref import attention_bwd_ref, attention_ref, lse_ref

__all__ = ["flash_attention", "flash_attention_bwd", "mha",
           "attention_bwd_ref", "attention_ref", "lse_ref"]
