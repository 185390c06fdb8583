"""SmolLM-360M — llama-arch small model.

[hf:HuggingFaceTB/SmolLM-135M; hf]  32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke",
        family="dense",
        num_layers=2,
        d_model=60,
        num_heads=3,
        num_kv_heads=1,
        head_dim=20,
        d_ff=128,
        vocab_size=128,
        act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        remat="none",
    )
