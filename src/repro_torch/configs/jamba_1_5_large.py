"""Jamba-1.5-Large (398B total / 94B active) — Mamba+attention 1:7, MoE.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2 on every other layer; attention every
8th layer (offset 4); no positional encoding (use_rope=False).
"""
from ..models.config import ModelConfig, MoEConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        act="swiglu",
        norm="rmsnorm",
        use_rope=False,
        attn_period=8,
        attn_offset=4,
        moe=MoEConfig(num_experts=16, top_k=2, every=2, offset=1),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        act="swiglu",
        norm="rmsnorm",
        use_rope=False,
        attn_period=4,
        attn_offset=2,
        moe=MoEConfig(num_experts=4, top_k=2, every=2, offset=1),
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2, chunk=32),
        remat="none",
    )
