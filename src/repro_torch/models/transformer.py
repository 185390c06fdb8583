"""Decoder-only LM, dense, moe, ssm and vlm families: the port of
``repro.models.transformer``.

The model is an ``nn.Module`` with one submodule per layer (the reference
stacks the layers and scans them); the weights keep the reference's
layouts and initial scales, and every parameter is trainable.  Three entry
points, as in the reference:

  forward_lm  -- full-sequence causal logits, differentiable (training)
  prefill_lm  -- fill a KV or SSM cache from a prompt, last-position logits
  decode_lm   -- one token against the cache

The two serving entry points run under ``torch.no_grad()``: serving builds
no graph.  Each of the three computes its float32 products in full float32,
as the reference does, and leaves the caller's TF32 setting as it found
it: one :func:`~repro_torch.precision.full_float32_matmul` block a call
(a backward outside ``forward_lm`` needs its own, as ``train/step.py``
has).  ``forward_lm`` honours ``cfg.remat`` block by block
(:func:`.layers.remat_call`): ``"none"`` keeps every activation,
``"full"`` recomputes each block in the backward (the reference's
``jax.checkpoint`` of each layer), ``"dots"`` keeps each block's products
without a batch dimension and recomputes the rest (the reference's
``checkpoint_dots_with_no_batch_dims``).

Dense family: attention over a full sequence runs through
:func:`.layers.attention`, so on the card it is a flash-attention kernel
(the Hopper kernel at head_dim 64, 120, 128 and gemma's 256): the forward
in serving, the forward with lse, dq and dk/dv kernels under autograd in
training.  Decode attention is plain
tensor code (float32 scores and softmax), as it is plain jnp in the
reference: the kernel has no per-slot ``start`` mask.  The cache is
updated in place.

Moe family (mixtral, phi3.5-moe): the dense layer with the MLP of each
layer where ``cfg.is_moe_layer(i)`` replaced by :func:`.moe.moe_apply`,
the reference's one-hot dispatch in plain products.  ``forward_lm(...,
return_aux=True)`` also gives the router's aux losses, summed over the
layers as the reference sums them; they are differentiable, and the train
step (:mod:`..train.step`) weights them into its loss.  Each block returns
its layer's aux losses beside its output, as the reference's scan carries
``(h, aux)``: under ``remat="full"`` they leave the checkpointed block as
outputs, and its recomputation in the backward changes nothing.

Ssm family (falcon-mamba): each layer is ``norm1`` and the Mamba mixer
(:mod:`.ssm`), with no ``norm2`` or MLP, as in the reference.  A full
sequence runs the selective scan through the Hopper kernel on the card;
decode is one recurrence step per layer in plain tensor code.  The cache
holds each layer's convolution window and scan state, overwritten in
place; positions, ``pos_offset`` and ``start`` do not apply.  Under
autograd the scan's backward is a kernel too (the reference
differentiates its jnp scan): ``forward_lm`` trains the family, each
Mamba layer's scan running once a step forward and once backward, and
once more forward where ``cfg.remat`` recomputes the block.

Hybrid family (jamba): layer i is attention where ``cfg.is_attn_layer(i)``
(``i % attn_period == attn_offset``; jamba has no RoPE) and a Mamba mixer
elsewhere, each followed by ``norm2`` and an MLP, or an MoE where
``cfg.is_moe_layer(i)``.  Its cache is the reference's: one entry per
position of the period, ``sub_i``, attention rings ``{"k", "v"}`` or
Mamba states ``{"conv", "h"}``, stacked over the layers at that position
(layer l is entry l // P of ``sub_{l % P}``).  A prefill continues each
Mamba layer's state and fills each attention layer's ring at
``pos_offset``; decode runs one recurrence step or one cached attention
a layer.  It trains as the ssm and moe families do (the MoE layers' aux
losses weighted in by the train step).  Unlike the reference's stacked
tree, which needs whole periods, ``LM`` takes any depth: jamba is served
on one card at 5 of its 72 layers, which hold every kind of layer it has
(ROADMAP.md queue C #23).

Vlm family (internvl2): the dense layer behind an image prefix.
``forward_lm`` and ``prefill_lm`` take ``patch_embeds`` (B, num_patches,
d), cast to the compute type and placed ahead of the (scaled) token
embeddings, so RoPE, the causal mask and the cache run over
``pos_offset + arange(num_patches + S)``; without them a vlm call raises
the reference's ``ValueError``.  The logits cover the prefix too, as the
reference's ``forward_lm`` does (``Model.forward`` drops them).  The
encoder-decoder family (whisper) is :mod:`.encdec`; :class:`LM` refuses
it.

Dropped from the reference: the sharding annotations (``constrain_act``)
and the one-hot embedding under a sharding context (a gather always).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..precision import full_float32_matmul
from .config import ModelConfig
from .layers import (
    apply_norm,
    apply_rope_tables,
    attention,
    cached_attention,
    dense_init,
    einsum,
    mlp_apply,
    remat_call,
    rope_tables,
)
from .moe import moe_apply, moe_init
from .ssm import ssm_apply, ssm_decode_step, ssm_init, ssm_state_init

__all__ = [
    "LM",
    "Block",
    "init_lm",
    "forward_lm",
    "init_cache",
    "prefill_lm",
    "decode_lm",
    "check_family",
    "stack_period",
]


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")  # encdec: models/encdec.py


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; choose from {_FAMILIES}")


def stack_period(cfg: ModelConfig) -> int:
    """The layers of one period of the schedule, P: the reference stacks
    layer s·P + i as entry s of ``sub_i``.  ``attn_period`` in the hybrid
    family, else 1."""
    return cfg.attn_period if cfg.family == "hybrid" else 1


def _check_decoder_only(cfg: ModelConfig) -> None:
    check_family(cfg)
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the encdec family is models/encdec.py's, not the LM's")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class _Params(nn.Module):
    """A module whose parameters are read as a dict, as the reference's
    functions take them."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, _param(t))

    @property
    def p(self) -> dict:
        return dict(self.named_parameters())


class Block(nn.Module):
    """One layer, a :class:`_Params` per group of weights: ``norm1``,
    ``attn`` (wq wk wv wo), ``norm2`` and ``mlp`` in the dense family, and
    in the moe family ``moe`` (router w_in w_gate w_out) in place of
    ``mlp`` where the layer is an MoE layer; ``norm1`` and ``ssm`` in the
    ssm family; in the hybrid family ``ssm`` in place of ``attn`` where
    the layer is a Mamba layer."""

    def __init__(self, **groups: dict):
        super().__init__()
        for name, tensors in groups.items():
            setattr(self, name, _Params(**tensors))


class LM(nn.Module):
    """``embed`` (vocab, d), ``lm_head`` (d, vocab) unless tied,
    ``final_norm`` and ``blocks``, one :class:`Block` per layer."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, final_norm: dict,
                 blocks: list[Block], lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        _check_decoder_only(cfg)
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers, got {len(blocks)} blocks")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: lm_head must be given iff embeddings are not tied")
        self.cfg = cfg
        self.embed = _param(embed)
        self.lm_head = None if lm_head is None else _param(lm_head)
        self.final_norm = _Params(**final_norm)
        self.blocks = nn.ModuleList(blocks)


# ===================================================================== init
def _norm_init(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def init_lm(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
            device="cuda") -> LM:
    """Random weights with the reference's scales: N(0, 1) times 0.02 for
    the embedding, 1/sqrt(heads x head_dim) for ``wo`` and 1/sqrt(fan-in)
    for every other matrix (the ssm mixer's as :func:`.ssm.ssm_init`);
    norms at one; each layer's kind from ``cfg.is_attn_layer(i)`` and
    ``cfg.is_moe_layer(i)``, at any depth.  Drawn in float32 from ``generator`` (a CPU generator
    seeded 0 by default) on its device, in a fixed order, then cast to
    ``param_dtype`` on ``device``; a generator on the card draws a
    full-size model there."""
    cfg.validate()
    _check_decoder_only(cfg)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg.param_dtype)

    def w(shape, scale=None):
        return dense_init(shape, dt, gen, device, scale)

    embed = w((cfg.vocab_size, d), 0.02)
    lm_head = None if cfg.tie_embeddings else w((d, cfg.vocab_size))
    blocks = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":  # mamba1: the mixer is the layer (no norm2, no FFN)
            blocks.append(Block(norm1=_norm_init(d, cfg.norm, device),
                                ssm=ssm_init(cfg, gen, device)))
            continue
        if cfg.is_attn_layer(i):
            mixer = {"attn": {"wq": w((d, hq, hd)), "wk": w((d, hkv, hd)), "wv": w((d, hkv, hd)),
                              "wo": w((hq, hd, d), 1.0 / math.sqrt(hq * hd))}}
        else:
            mixer = {"ssm": ssm_init(cfg, gen, device)}
        if cfg.is_moe_layer(i):
            ffn = {"moe": moe_init(cfg, gen, device)}
        elif cfg.act in ("swiglu", "geglu"):
            ffn = {"mlp": {"w_in": w((d, cfg.d_ff)), "w_gate": w((d, cfg.d_ff)),
                           "w_out": w((cfg.d_ff, d))}}
        else:
            ffn = {"mlp": {"w_in": w((d, cfg.d_ff)), "w_out": w((cfg.d_ff, d))}}
        blocks.append(Block(norm1=_norm_init(d, cfg.norm, device), **mixer,
                            norm2=_norm_init(d, cfg.norm, device), **ffn))
    return LM(cfg, embed, _norm_init(d, cfg.norm, device), blocks, lm_head)


# ===================================================================== apply
def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE's (sin, cos) at ``positions``, shared by every layer; None
    without RoPE."""
    if not cfg.use_rope or cfg.family == "ssm":
        return None
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, rope):
    """Prefill self-attention over a full (B,S,d) sequence.  ``rope`` places
    the rows at their absolute positions (``q_offset + arange(S)``); the
    mask is relative (the kernel is called with ``q_offset`` 0), as in the
    reference."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if rope is not None:
        q = apply_rope_tables(q, *rope)
        k = apply_rope_tables(k, *rope)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window)
    return einsum("bshk,hkd->bsd", o, p["wo"]), (k, v)


def _embed(lm: LM, tokens: torch.Tensor) -> torch.Tensor:
    cfg = lm.cfg
    cd = _dtype(cfg.compute_dtype)
    h = lm.embed[tokens.long()].to(cd)
    if cfg.embed_scale:
        h = h * torch.full((), math.sqrt(cfg.d_model), dtype=cd, device=h.device)
    return h


def _embed_prompt(lm: LM, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """A prompt's embeddings (B, S, d) in the compute type; in the vlm
    family ``patch_embeds`` (B, num_patches, d) ahead of them (other
    families ignore it, as the reference does)."""
    h = _embed(lm, tokens)
    cfg = lm.cfg
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError(f"{cfg.name}: vlm family requires patch_embeds")
        # image prefix: [patches || text]  (the frontend is a stub, as in the reference)
        h = torch.cat([patch_embeds.to(device=h.device, dtype=h.dtype), h], dim=1)
    return h


def _logits(lm: LM, h: torch.Tensor) -> torch.Tensor:
    cfg = lm.cfg
    h = apply_norm(h, lm.final_norm.p, cfg.norm)
    if cfg.tie_embeddings:
        logits = einsum("bsd,vd->bsv", h, lm.embed.to(_dtype(cfg.compute_dtype)))
    else:
        logits = einsum("bsd,dv->bsv", h, lm.lm_head)
    return logits.to(_dtype(cfg.logit_dtype))


def _ffn(blk: Block, cfg: ModelConfig, h: torch.Tensor) -> tuple[torch.Tensor, Optional[dict]]:
    """``h`` plus the layer's MLP or MoE of ``norm2(h)``, and an MoE
    layer's aux losses (``{"lb_loss", "z_loss"}``; None for an MLP); ``h``
    alone in the ssm family, whose layers have no FFN."""
    if not hasattr(blk, "norm2"):
        return h, None
    x = apply_norm(h, blk.norm2.p, cfg.norm)
    if not hasattr(blk, "moe"):
        return h + mlp_apply(blk.mlp.p, x, cfg.act), None
    f, layer_aux = moe_apply(blk.moe.p, cfg, x)
    return h + f, layer_aux


def _block(blk: Block, cfg: ModelConfig, h: torch.Tensor,
           rope) -> tuple[torch.Tensor, Optional[dict]]:
    """One layer over a full sequence, its attention or Mamba mixer then
    its FFN: ``(h, layer_aux)`` as :func:`_ffn` returns them.  Pure, so a
    checkpoint may run it again."""
    x = apply_norm(h, blk.norm1.p, cfg.norm)
    if hasattr(blk, "ssm"):
        o, _ = ssm_apply(blk.ssm.p, cfg, x)
    else:
        o, _ = _attn_apply(blk.attn.p, cfg, x, rope)
    return _ffn(blk, cfg, h + o)


@full_float32_matmul()
def forward_lm(lm: LM, tokens: torch.Tensor, *, return_aux: bool = False,
               patch_embeds: Optional[torch.Tensor] = None):
    """Full-sequence logits (B, S, vocab) in ``logit_dtype`` ((B,
    num_patches + S, vocab) in the vlm family, after ``patch_embeds``); with
    ``return_aux``, ``(logits, {"lb_loss", "z_loss"})``, the MoE layers'
    aux losses summed over the layers (float32 zeros without MoE layers),
    as the reference returns them, differentiable.  Under autograd each
    block is checkpointed as ``cfg.remat`` says."""
    cfg = lm.cfg
    aux = None
    if return_aux:
        aux = {name: torch.zeros((), dtype=torch.float32, device=lm.embed.device)
               for name in ("lb_loss", "z_loss")}
    h = _embed_prompt(lm, tokens, patch_embeds)
    rope = _rope(cfg, torch.arange(h.shape[1], device=h.device))
    for blk in lm.blocks:
        h, layer_aux = remat_call(cfg.remat, _block, blk, cfg, h, rope)
        if aux is not None and layer_aux is not None:
            for name, value in layer_aux.items():
                aux[name] = aux[name] + value
    logits = _logits(lm, h)
    return (logits, aux) if return_aux else logits


# ===================================================================== cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Decode cache, the reference's layout: one entry ``sub_i`` per
    position i of the period P (:func:`stack_period`; 1 outside the hybrid
    family), each buffer stacked over the ``count_i`` layers at that
    position, layer l being entry l // P of ``sub_{l % P}``.  An attention
    position holds ``{"k", "v"}``, each (count_i, batch, W, kv_heads,
    head_dim) in ``compute_dtype`` with ``W = min(max_len, sliding_window
    or max_len)``: linear buffers, or rings for a sliding window.  A Mamba
    position holds ``{"conv", "h"}``, the convolution windows (count_i,
    batch, d_conv - 1, d_inner) in ``compute_dtype`` and the scan states
    (count_i, batch, d_inner, d_state) in float32, whatever ``max_len``.
    Every buffer has the batch axis at position 1."""
    _check_decoder_only(cfg)
    P, L = stack_period(cfg), cfg.num_layers
    cd = _dtype(cfg.compute_dtype)
    W = max_len if cfg.sliding_window is None else min(max_len, cfg.sliding_window)
    cache = {}
    for i in range(min(P, L)):
        count = len(range(i, L, P))
        if cfg.is_attn_layer(i):
            shape = (count, batch, W, cfg.num_kv_heads, cfg.resolved_head_dim)
            bufs = {"k": (shape, cd), "v": (shape, cd)}
        else:  # one layer's state (shapes only), stacked over the position's layers
            bufs = {k: ((count, *t.shape), t.dtype)
                    for k, t in ssm_state_init(cfg, batch, device="meta").items()}
        cache[f"sub_{i}"] = {k: torch.zeros(shape, dtype=dt, device=device)
                             for k, (shape, dt) in bufs.items()}
    return cache


def _layer_cache(cfg: ModelConfig, cache: dict, layer: int) -> dict:
    """Layer ``layer``'s buffers in ``cache``: views, written in place."""
    P = stack_period(cfg)
    return {k: t[layer // P] for k, t in cache[f"sub_{layer % P}"].items()}


def _decode_mask(cfg: ModelConfig, W: int, pos: int, start: Optional[torch.Tensor], device):
    """(1 or B, W) bool: the ring slots the token at ``pos`` may attend.

    ``start`` (B,) optional: first absolute position owned by each batch
    slot (continuous batching: a slot joined mid-stream must not attend to
    the previous occupant's stale entries).
    """
    # absolute position held by each ring slot i: pos - ((pos - i) mod W)
    slots = torch.arange(W, device=device)
    abs_pos = pos - torch.remainder(pos - slots, W)
    valid = abs_pos >= 0
    if cfg.sliding_window is not None:
        valid &= pos - abs_pos < cfg.sliding_window
    valid = valid[None, :]  # (1, W)
    if start is not None:
        valid = valid & (abs_pos[None, :] >= start[:, None])  # (B, W)
    return valid


def _attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, slot: int, rope, valid: torch.Tensor):
    """x (B,1,d); k_cache, v_cache (B,W,hkv,hd), written in place at ring
    slot ``slot``; ``rope`` and ``valid`` (:func:`_decode_mask`) are the
    new token's, shared by every layer."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if rope is not None:
        q = apply_rope_tables(q, *rope)
        k = apply_rope_tables(k, *rope)
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    return einsum("bshk,hkd->bsd", cached_attention(q, k_cache, v_cache, valid), p["wo"])


def _ssm_step(mixer, blk: Block, cfg: ModelConfig, x: torch.Tensor, state: dict) -> torch.Tensor:
    """``mixer`` (:func:`.ssm.ssm_apply` or :func:`.ssm.ssm_decode_step`)
    of ``x`` from one layer's ``state`` (views of the cache), the new
    state copied into it in place."""
    o, new = mixer(blk.ssm.p, cfg, x, state)
    state["conv"].copy_(new["conv"])
    state["h"].copy_(new["h"])
    return o


def _attn_width(cache: dict) -> Optional[int]:
    """W, the attention rings' length; None without attention layers."""
    return next((bufs["k"].shape[2] for bufs in cache.values() if "k" in bufs), None)


@torch.no_grad()
@full_float32_matmul()
def decode_lm(lm: LM, token: torch.Tensor, cache: dict, pos: int,
              start: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """One serving step: token (B,) at absolute position ``pos`` ->
    next-token logits (B, vocab); the cache is updated in place.
    ``start`` (B,): each batch slot's first owned position (see
    :func:`_decode_mask`).  Mamba layers have no positions: ``pos`` and
    ``start`` do not apply to them (to the ssm family at all)."""
    cfg = lm.cfg
    h = _embed(lm, token[:, None])
    W, rope, valid = _attn_width(cache), None, None
    if W is not None:
        rope = _rope(cfg, torch.full((1,), pos, device=h.device))  # a fill, not a host copy
        valid = _decode_mask(cfg, W, pos, start, h.device)
    for i, blk in enumerate(lm.blocks):
        c = _layer_cache(cfg, cache, i)
        x = apply_norm(h, blk.norm1.p, cfg.norm)
        if hasattr(blk, "ssm"):
            o = _ssm_step(ssm_decode_step, blk, cfg, x, c)
        else:
            o = _attn_decode(blk.attn.p, cfg, x, c["k"], c["v"], pos % W, rope, valid)
        h, _ = _ffn(blk, cfg, h + o)
    return _logits(lm, h)[:, 0], cache


@torch.no_grad()
@full_float32_matmul()
def prefill_lm(lm: LM, tokens: torch.Tensor, cache: dict, pos_offset: int = 0,
               patch_embeds: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """Run the prompt (B, S) through the model, filling the cache in place.

    Returns (last-position logits (B, vocab), cache).  ``pos_offset``
    places the prompt at absolute positions [offset, offset+S): RoPE and
    ring slots follow, so a continuous-batching scheduler can align a
    joining request with the shared decode position.  In the vlm family
    the prompt is ``patch_embeds`` then the tokens, num_patches + S
    positions.  A cache shorter than the prompt (a sliding-window ring)
    keeps its last W positions.  A Mamba layer continues its convolution
    window and scan state from the cache (zeros in a fresh one) and has no
    positions: ``pos_offset`` does not apply to it.
    """
    cfg = lm.cfg
    h = _embed_prompt(lm, tokens, patch_embeds)
    S = h.shape[1]
    rope = _rope(cfg, pos_offset + torch.arange(S, device=h.device))
    for i, blk in enumerate(lm.blocks):
        c = _layer_cache(cfg, cache, i)
        x = apply_norm(h, blk.norm1.p, cfg.norm)
        if hasattr(blk, "ssm"):
            o = _ssm_step(ssm_apply, blk, cfg, x, c)
        else:
            o, (k, v) = _attn_apply(blk.attn.p, cfg, x, rope)
            W = c["k"].shape[1]
            if S >= W:
                # last W tokens; ring slot of token t is (offset+t) % W
                shift = (pos_offset + S - W) % W
                kw, vw = k[:, -W:].roll(shift, dims=1), v[:, -W:].roll(shift, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, W - S)
                kw = F.pad(k, pad).roll(pos_offset % W, dims=1)
                vw = F.pad(v, pad).roll(pos_offset % W, dims=1)
            c["k"].copy_(kw)
            c["v"].copy_(vw)
        h, _ = _ffn(blk, cfg, h + o)
    return _logits(lm, h[:, -1:, :])[:, 0], cache
