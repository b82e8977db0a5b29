from .kernel import flash_attention
from .ops import mha
from .ref import attention_ref

__all__ = ["flash_attention", "mha", "attention_ref"]
