"""The port's model zoo: the decoder-only LM (dense, moe, ssm and vlm
families) and the encoder-decoder (encdec); the hybrid family waits for
ROADMAP.md queue A #13."""
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
