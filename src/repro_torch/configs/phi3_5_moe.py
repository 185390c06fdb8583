"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]  32L d_model=4096 32H (GQA kv=8)
d_ff=6400 vocab=32064.
"""
from ..models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(num_experts=16, top_k=2),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=128,
        act="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(num_experts=4, top_k=2),
        remat="none",
    )
