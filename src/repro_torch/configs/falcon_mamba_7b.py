"""Falcon-Mamba-7B — pure Mamba-1, attention-free.

[arXiv:2410.05355; unverified]  64L d_model=4096 d_ff=0 vocab=65024,
ssm_state=16.
"""
from ..models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=65024,
        norm="rmsnorm",
        use_rope=False,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=128,
        norm="rmsnorm",
        use_rope=False,
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2, chunk=32),
        remat="none",
    )
