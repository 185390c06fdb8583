"""InternVL2-26B — InternViT frontend (stub) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553.  The vision frontend is a stub: input_specs provides
precomputed patch embeddings (assignment note for [vlm]).
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        # published 92553, padded to a multiple of 256 for TP sharding (an
        # odd vocab cannot shard -> the embedding table replicates and every
        # downstream activation follows; measured 772GB/dev.  Padding the
        # vocab is standard practice; +119 dead rows = +0.9M params).
        vocab_size=92672,
        act="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        num_patches=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        act="swiglu",
        norm="rmsnorm",
        num_patches=8,
        remat="none",
    )
