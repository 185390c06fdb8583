"""Whisper-large-v3 backbone — encoder-decoder, conv frontend stubbed.

[arXiv:2212.04356; unverified]  32 encoder + 32 decoder layers,
d_model=1280 20H (kv=20) d_ff=5120 vocab=51866, GELU + LayerNorm,
sinusoidal positions (DESIGN.md notes the learned-positional deviation).
input_specs provides precomputed frame embeddings (frontend stub).
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        num_layers=32,
        decoder_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        # published 51866, padded to /256 for TP (see internvl2_26b.py note)
        vocab_size=52224,
        act="gelu",
        norm="layernorm",
        use_rope=False,
        tie_embeddings=True,
        cross_len=1500,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        num_layers=2,
        decoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        act="gelu",
        norm="layernorm",
        use_rope=False,
        tie_embeddings=True,
        cross_len=32,
        remat="none",
    )
