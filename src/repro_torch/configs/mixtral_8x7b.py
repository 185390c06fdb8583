"""Mixtral-8x7B — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, SWA 4096.
"""
from ..models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        act="swiglu",
        norm="rmsnorm",
        sliding_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
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
        moe=MoEConfig(num_experts=4, top_k=2),
        remat="none",
    )
