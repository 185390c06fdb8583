"""Gemma-7B — GeGLU, head_dim=256, MHA (kv=16), tied embeddings.

[arXiv:2403.08295; hf]  28L d_model=3072 16H (kv=16) d_ff=24576
vocab=256000.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        act="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        embed_scale=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=128,
        vocab_size=128,
        act="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        embed_scale=True,
        remat="none",
    )
