"""Phi-3-Medium-14B — RoPE SwiGLU GQA.

[arXiv:2404.14219; unverified]  40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        act="swiglu",
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-smoke",
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
        remat="none",
    )
