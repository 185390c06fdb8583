"""The port's model zoo: the decoder-only LM (dense, moe, ssm, hybrid and
vlm families) and the encoder-decoder (encdec)."""
from .api import Model
from .config import ModelConfig, MoEConfig, SSMConfig, active_param_count, param_count

__all__ = [
    "Model",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "param_count",
    "active_param_count",
]
