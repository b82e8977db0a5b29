from .common import (AxisRules, ModelConfig, MoEConfig, SSMConfig,
                     rules_for_mesh)
from .model import Model, build_model

__all__ = ["AxisRules", "ModelConfig", "MoEConfig", "SSMConfig",
           "rules_for_mesh", "Model", "build_model"]
