"""H2O-Danube-3-4B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000, head_dim=120, SWA 4096.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        act="swiglu",
        norm="rmsnorm",
        sliding_window=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        act="swiglu",
        norm="rmsnorm",
        sliding_window=32,
        remat="none",
    )
