from .common import ModelConfig, MoEConfig, SSMConfig
from .model import Model, build_model

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "Model", "build_model"]
