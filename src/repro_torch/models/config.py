"""Model configuration covering all assigned architecture families (a copy of
``repro.models.config``, which imports no JAX; the port keeps its own).

One dataclass parameterizes dense / MoE / SSM / hybrid / enc-dec / VLM
backbones; per-arch files in :mod:`repro_torch.configs` instantiate it with the
exact published dimensions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Sequence, Tuple

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "param_count", "active_param_count"]

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # Layers whose FFN is an MoE: every `every`-th layer starting at `offset`.
    every: int = 1
    offset: int = 0
    # GShard-style dispatch group count multiplier (groups = dp_shards * mult);
    # higher = smaller groups = cheaper one-hot dispatch einsum (see §Perf).
    group_mult: int = 1
    # Groups are sized so each holds ~this many tokens (the dispatch einsum
    # is O(group_size) per token — §Perf: 5.8x less prefill compute on
    # mixtral vs one group per batch element; overrides group_mult).
    # None falls back to group_mult (the naive baseline).
    target_group_tokens: Optional[int] = 4096


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)
    chunk: int = 256  # selective-scan chunk (memory/HLO-size control)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, math.ceil(d_model / 16))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int  # 0 for attn-free (ssm)
    num_kv_heads: int
    d_ff: int  # per-expert width for MoE families
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    sliding_window: Optional[int] = None  # SWA width (mixtral, h2o-danube)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): layer i is attention iff i % attn_period == attn_offset,
    # else SSM.  Non-hybrid families ignore these.
    attn_period: int = 8
    attn_offset: int = 4
    # enc-dec (whisper): decoder layer count; num_layers = encoder layers.
    decoder_layers: int = 0
    cross_len: int = 1500  # encoder-output length seen by a decoding step (stub)
    # vlm: image prefix length (stub patch embeddings provided by input_specs)
    num_patches: int = 0
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    # remat: "none" | "full" | "dots"  (per-layer activation checkpointing)
    remat: str = "full"
    # scan sublayer grouping for hybrids: scan over super-blocks of this many
    # layers so heterogeneous stacks still lower to one compact loop.
    scan_unroll: int = 1

    # ----------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.attn_period == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.every == self.moe.offset

    def layer_kinds(self) -> list[tuple[bool, bool]]:
        """[(is_attn, is_moe)] per layer — the hybrid schedule."""
        return [(self.is_attn_layer(i), self.is_moe_layer(i)) for i in range(self.num_layers)]

    def validate(self) -> None:
        if self.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            if self.num_heads <= 0:
                raise ValueError(f"{self.name}: attention family needs num_heads > 0")
            if self.num_heads % max(1, self.num_kv_heads) != 0:
                raise ValueError(f"{self.name}: num_heads must be a multiple of num_kv_heads")
        if self.family in ("moe",) and self.moe is None:
            raise ValueError(f"{self.name}: moe family needs MoEConfig")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: ssm/hybrid family needs SSMConfig")
        if self.family == "encdec" and self.decoder_layers <= 0:
            raise ValueError(f"{self.name}: encdec needs decoder_layers")


# --------------------------------------------------------------------- counts
def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d


def _ffn_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * cfg.d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dtr = s.resolved_dt_rank(cfg.d_model)
    return (
        cfg.d_model * 2 * d_in  # in_proj (x, z)
        + d_in * s.d_conv  # depthwise conv
        + d_in * (dtr + 2 * s.d_state)  # x_proj -> (dt, B, C)
        + dtr * d_in  # dt_proj
        + d_in * s.d_state  # A_log
        + d_in  # D
        + d_in * cfg.d_model  # out_proj
    )


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (embedding + layers + head), for 6·N·D."""
    n = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model  # lm_head
    norm_per_layer = 2 * cfg.d_model
    for i in range(cfg.num_layers):
        is_attn, is_moe = cfg.is_attn_layer(i), cfg.is_moe_layer(i)
        n += norm_per_layer + cfg.d_model  # final-ish norms amortized
        n += _attn_params(cfg) if is_attn else _ssm_params(cfg)
        if is_moe:
            n += cfg.moe.num_experts * _ffn_params(cfg) + cfg.d_model * cfg.moe.num_experts
        else:
            n += _ffn_params(cfg)
    if cfg.family == "encdec":
        # decoder stack: self-attn + cross-attn + ffn per layer
        for _ in range(cfg.decoder_layers):
            n += 3 * cfg.d_model + 2 * _attn_params(cfg) + _ffn_params(cfg)
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k experts) — for 6·N_active·D."""
    if cfg.moe is None:
        return param_count(cfg)
    n = param_count(cfg)
    for i in range(cfg.num_layers):
        if cfg.is_moe_layer(i):
            n -= (cfg.moe.num_experts - cfg.moe.top_k) * _ffn_params(cfg)
    return n
