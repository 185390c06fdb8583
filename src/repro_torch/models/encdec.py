"""Encoder-decoder backbone (whisper-large-v3's shape): the port of
``repro.models.encdec``.

The audio frontend (log-mel and the convolutions) is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, S_frames,
d_model).  Sinusoidal positions on both stacks, computed in float32 and
cast to the compute type, as the reference does.  The weights keep the
reference's layouts and initial scales; the embedding is tied to the
output head.

Entry points, as in the reference:

  encode             -- frames -> encoder states (B, S, d)
  forward_encdec     -- teacher-forced logits (B, S, vocab), differentiable
  init_decoder_cache -- self_k/self_v (L, B, max_len, kv, hd) and
                        cross_k/cross_v (L, B, cross_len, kv, hd)
  prefill_encdec     -- encode, project each decoder layer's cross K/V
                        into the cache (truncated or zero-padded to its
                        cross_len)
  decode_encdec      -- one decoder step at position ``pos``

Attention over full sequences (the encoder's, the teacher-forced
decoder's causal self-attention and its cross-attention) runs through
:func:`.layers.attention`, so on the card it is the flash-attention
kernel, non-causal where the reference's is.  The reference switches to
``chunked_attention`` past 4,096 queries or 8,192 keys, which computes
the same function (the kernel takes both branches) except where it pads
the keys to a multiple of 1,024 without a causal mask: it then attends
the zero padding too (ROADMAP.md queue C #21), and the port does not.
Decode's self-
and cross-attention are plain tensor code (float32 scores and softmax),
as they are plain jnp in the reference.  The caches are written in
place.

Each entry point runs through ``m(entry, ...)`` and each layer through
``blk(layer, ...)``, as the LM's do (:mod:`.transformer`), so that hooks
on the modules fire around what reads their weights.
:func:`encdec_param_axes` and :func:`decoder_cache_axes` give the
reference's logical axes of the parameters and the cache.

Tensor parallelism: the reference's annotations (q, k and v of every
attention, cross-attention's included, each layer's input, the logits)
are called; on DTensors in a ``sharding_context`` every product, norm and
attention kernel runs on each rank's shards as in :mod:`.transformer`.
The cross cache (``cross_seq`` whole) is written by each rank for its
batch rows; the self cache (``cache_seq`` on "model" under
``RULES_DECODE``) by the rank that holds the position.

One deliberate difference (ROADMAP.md queue C #20): the reference's
``dynamic_update_slice`` clamps a decode position at or past the self
cache's length to its last slot and goes on; :func:`decode_encdec`
raises ``ValueError`` there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tensor_parallel as tp
from ..distributed.context import act_placements, constrain_act
from ..precision import full_float32_matmul
from .config import ModelConfig
from .layers import (
    apply_norm,
    attention,
    cached_attention,
    dense_init,
    einsum,
    mlp_apply,
    remat_call,
)
from .transformer import (
    _ACT_AXES,
    _ATTN_AXES,
    _QKV_AXES,
    _MLP_AXES,
    Block,
    _ffn_axes,
    _flat_axes,
    _norm_axes,
    _Params,
    _dtype,
    _norm_init,
    _param,
)

__all__ = [
    "EncDec",
    "init_encdec",
    "encode",
    "forward_encdec",
    "init_decoder_cache",
    "prefill_encdec",
    "decode_encdec",
    "encdec_param_axes",
    "decoder_cache_axes",
]


def _sinusoid_at(positions: torch.Tensor, d: int, dtype: torch.dtype) -> torch.Tensor:
    """(len(positions), d): [sin | cos] of position x 10000**(-2i/d), in
    float32, then cast to ``dtype``."""
    pos = positions.float()[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoid(S: int, d: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _sinusoid_at(torch.arange(S, device=device), d, dtype)


class EncDec(nn.Module):
    """``embed`` (vocab, d), tied to the output head; ``enc_final_norm``,
    ``dec_final_norm``; ``enc_blocks``, one :class:`~.transformer.Block`
    per encoder layer (``norm1``, ``attn``, ``norm2``, ``mlp``), and
    ``dec_blocks``, one per decoder layer (``norm1``, ``self_attn``,
    ``norm_x``, ``cross_attn``, ``norm2``, ``mlp``)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, enc_final_norm: dict,
                 dec_final_norm: dict, enc_blocks: list[Block], dec_blocks: list[Block]):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDec takes the encdec family, not {cfg.family!r}")
        if len(enc_blocks) != cfg.num_layers or len(dec_blocks) != cfg.decoder_layers:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} + {cfg.decoder_layers} layers, got "
                             f"{len(enc_blocks)} + {len(dec_blocks)} blocks")
        self.cfg = cfg
        self.embed = _param(embed)
        self.enc_final_norm = _Params(**enc_final_norm)
        self.dec_final_norm = _Params(**dec_final_norm)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)

    def forward(self, entry, *args):
        """``entry(self, *args)``: an entry point's body, run through the
        module's call so that the model's hooks fire around it."""
        return entry(self, *args)


def init_encdec(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                device="cuda") -> EncDec:
    """Random weights with the reference's scales: N(0, 1) times 0.02 for
    the embedding, 1/sqrt(heads x head_dim) for each ``wo`` and
    1/sqrt(fan-in) for every other matrix; norms at one (scale) and zero
    (bias).  Drawn in float32 from ``generator`` (a CPU generator seeded 0
    by default) on its device, embedding first, then the encoder's layers
    and the decoder's in order, then cast to ``param_dtype`` on
    ``device``."""
    cfg.validate()
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg.param_dtype)

    def w(shape, scale=None):
        return dense_init(shape, dt, gen, device, scale)

    def attn():
        return {"wq": w((d, hq, hd)), "wk": w((d, hkv, hd)), "wv": w((d, hkv, hd)),
                "wo": w((hq, hd, d), 1.0 / math.sqrt(hq * hd))}

    def mlp():
        if cfg.act in ("swiglu", "geglu"):
            return {"w_in": w((d, cfg.d_ff)), "w_gate": w((d, cfg.d_ff)),
                    "w_out": w((cfg.d_ff, d))}
        return {"w_in": w((d, cfg.d_ff)), "w_out": w((cfg.d_ff, d))}

    def norm():
        return _norm_init(d, cfg.norm, device)

    embed = w((cfg.vocab_size, d), 0.02)
    enc = [Block(norm1=norm(), attn=attn(), norm2=norm(), mlp=mlp())
           for _ in range(cfg.num_layers)]
    dec = [Block(norm1=norm(), self_attn=attn(), norm_x=norm(), cross_attn=attn(),
                 norm2=norm(), mlp=mlp())
           for _ in range(cfg.decoder_layers)]
    return EncDec(cfg, embed, norm(), norm(), enc, dec)


def encdec_param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter of :func:`init_encdec`'s model,
    keyed like ``EncDec.named_parameters()``: the reference's, each
    layer's leaf without the leading ``"stack"``.  Pure Python."""
    norm, mlp = _norm_axes(cfg), _ffn_axes(cfg, _MLP_AXES)
    axes = {"embed": ("vocab", "embed")}
    for name in ("enc_final_norm", "dec_final_norm"):
        axes.update({f"{name}.{k}": ax for k, ax in norm.items()})
    for i in range(cfg.num_layers):
        axes.update(_flat_axes(f"enc_blocks.{i}", {"norm1": norm, "attn": _ATTN_AXES,
                                                   "norm2": norm, "mlp": mlp}))
    for i in range(cfg.decoder_layers):
        axes.update(_flat_axes(f"dec_blocks.{i}", {
            "norm1": norm, "self_attn": _ATTN_AXES, "norm_x": norm, "cross_attn": _ATTN_AXES,
            "norm2": norm, "mlp": mlp}))
    return axes


def decoder_cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_decoder_cache`'s buffers: the
    reference's, ``"stack"`` (the decoder's layers) first."""
    ax_self = ("stack", "batch", "cache_seq", "kv_heads", "head_dim")
    ax_cross = ("stack", "batch", "cross_seq", "kv_heads", "head_dim")
    return {"self_k": ax_self, "self_v": ax_self, "cross_k": ax_cross, "cross_v": ax_cross}


def _proj_qkv(p: dict, x: torch.Tensor):
    return tuple(constrain_act(einsum("bsd,dhk->bshk", x, p[w]), _QKV_AXES)
                 for w in ("wq", "wk", "wv"))


def _plus(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``h`` + ``table`` (a plain tensor every rank holds whole)."""
    return h + (tp.replicate(table) if tp.is_dtensor(h) else table)


def _attn_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return constrain_act(einsum("bshk,hkd->bsd", constrain_act(o, _QKV_AXES), wo), _ACT_AXES)


def _mlp(blk: Block, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return constrain_act(mlp_apply(blk.mlp.p, apply_norm(h, blk.norm2.p, cfg.norm), cfg.act),
                         _ACT_AXES)


def _layers(blocks: nn.ModuleList, cfg: ModelConfig, h: torch.Tensor, layer, *args):
    """``h`` through ``layer(blk, cfg, h, *args)`` for each block; under
    autograd, unless ``cfg.remat`` is ``"none"``, each layer is recomputed
    whole in the backward (:func:`.layers.remat_call`): the reference's
    encoder-decoder takes ``jax.checkpoint`` without a policy for
    ``"dots"`` too."""
    remat = "none" if cfg.remat == "none" else "full"
    for blk in blocks:
        h = remat_call(remat, blk, layer, cfg, h, *args)
    return h


def _enc_layer(blk: Block, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = constrain_act(h, _ACT_AXES)
    q, k, v = _proj_qkv(blk.attn.p, apply_norm(h, blk.norm1.p, cfg.norm))
    h = h + _attn_out(attention(q, k, v, causal=False), blk.attn.wo)
    return h + _mlp(blk, cfg, h)


def _dec_layer(blk: Block, cfg: ModelConfig, h: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    h = constrain_act(h, _ACT_AXES)
    q, k, v = _proj_qkv(blk.self_attn.p, apply_norm(h, blk.norm1.p, cfg.norm))
    h = h + _attn_out(attention(q, k, v, causal=True), blk.self_attn.wo)
    h = constrain_act(h, _ACT_AXES)
    cross = blk.cross_attn.p
    qx = constrain_act(einsum("bsd,dhk->bshk", apply_norm(h, blk.norm_x.p, cfg.norm),
                              cross["wq"]), _QKV_AXES)
    kx = constrain_act(einsum("bsd,dhk->bshk", enc_out, cross["wk"]), _QKV_AXES)
    vx = constrain_act(einsum("bsd,dhk->bshk", enc_out, cross["wv"]), _QKV_AXES)
    h = h + _attn_out(attention(qx, kx, vx, causal=False), cross["wo"])
    return h + _mlp(blk, cfg, h)


def _encode(m: EncDec, frames: torch.Tensor) -> torch.Tensor:
    cfg = m.cfg
    h = frames.to(device=m.embed.device, dtype=_dtype(cfg.compute_dtype))
    if tp.is_dtensor(m.embed):
        h = constrain_act(tp.replicate(h), _ACT_AXES)
    h = _plus(h, _sinusoid(h.shape[1], cfg.d_model, h.dtype, h.device)[None])
    h = _layers(m.enc_blocks, cfg, h, _enc_layer)
    return apply_norm(h, m.enc_final_norm.p, cfg.norm)


@full_float32_matmul()
def encode(m: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames: precomputed (B, S, d_model) embeddings (the frontend stub)
    -> the encoder's states (B, S, d_model) in the compute type."""
    return m(_encode, frames)


def _logits(m: EncDec, h: torch.Tensor) -> torch.Tensor:
    cfg = m.cfg
    h = apply_norm(h, m.dec_final_norm.p, cfg.norm)
    logits = einsum("bsd,vd->bsv", h, m.embed.to(_dtype(cfg.compute_dtype)))
    logits = constrain_act(logits, ("batch", "seq", "act_vocab"))
    return logits.to(_dtype(cfg.logit_dtype))


def _embed(m: EncDec, tokens: torch.Tensor) -> torch.Tensor:
    """The decoder's token embeddings (B, S, d) in the compute type; a
    vocab-sharded table as :func:`.transformer._embed` reads one."""
    cd = _dtype(m.cfg.compute_dtype)
    if tp.is_dtensor(m.embed):
        shape = (*tokens.shape, m.cfg.d_model)
        return constrain_act(tp.embed_tp(m.embed, tokens, act_placements(_ACT_AXES, shape),
                                         post=lambda r: r.to(cd)), _ACT_AXES)
    return m.embed[tokens.long()].to(cd)


@full_float32_matmul()
def forward_encdec(m: EncDec, frames: torch.Tensor, tokens: torch.Tensor, *,
                   return_aux: bool = False):
    """Training: the encoder over ``frames`` (B, S_frames, d), the decoder
    teacher-forced over ``tokens`` (B, S) -> logits (B, S, vocab) in
    ``logit_dtype``; with ``return_aux`` also the reference's aux losses,
    float32 zeros."""
    return m(_forward, frames, tokens, return_aux)


def _forward(m: EncDec, frames: torch.Tensor, tokens: torch.Tensor, return_aux: bool):
    cfg = m.cfg
    enc_out = _encode(m, frames)
    h = _embed(m, tokens)
    h = _plus(h, _sinusoid(h.shape[1], cfg.d_model, h.dtype, h.device)[None])
    h = _layers(m.dec_blocks, cfg, h, _dec_layer, enc_out)
    logits = _logits(m, h)
    if not return_aux:
        return logits
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, {"lb_loss": zero, "z_loss": zero.clone()}


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """The decoder's self-attention cache ``self_k``/``self_v`` (layers,
    batch, max_len, kv_heads, head_dim) and the projected encoder states
    ``cross_k``/``cross_v`` (layers, batch, cross_len, kv_heads,
    head_dim), zeros in ``compute_dtype``."""
    hd, hkv, L = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.decoder_layers
    cd = _dtype(cfg.compute_dtype)

    def zeros(n):
        return torch.zeros((L, batch, n, hkv, hd), dtype=cd, device=device)

    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(cfg.cross_len), "cross_v": zeros(cfg.cross_len)}


@torch.no_grad()
@full_float32_matmul()
def prefill_encdec(m: EncDec, frames: torch.Tensor, cache: dict) -> dict:
    """Serving prefill: encode ``frames`` and project each decoder layer's
    cross-attention K and V into the cache, in place.  Encoder states past
    the cache's cross length are dropped; a shorter encoding is padded with
    zero states (whose K and V are then zero too)."""
    m(_prefill, frames, cache)
    return cache


def _prefill(m: EncDec, frames: torch.Tensor, cache: dict) -> None:
    enc_out = _encode(m, frames)
    Sc = cache["cross_k"].shape[2]
    S = enc_out.shape[1]
    if tp.is_dtensor(enc_out) and S < Sc:  # zero states past the frames: padded whole
        enc_out = tp.replicate(F.pad(enc_out.full_tensor(), (0, 0, 0, Sc - S)))
        S = Sc
    enc_c = enc_out[:, :Sc] if S >= Sc else F.pad(enc_out, (0, 0, 0, Sc - S))
    for i, blk in enumerate(m.dec_blocks):
        blk(_project_cross, enc_c, cache["cross_k"][i], cache["cross_v"][i])


def _project_cross(blk: Block, enc_c: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor) -> None:
    for buf, w in ((ck, blk.cross_attn.wk), (cv, blk.cross_attn.wv)):
        kv = einsum("bsd,dhk->bshk", enc_c, w)
        if tp.is_dtensor(buf):
            tp.assign(buf, kv)
        else:
            buf.copy_(kv)


@torch.no_grad()
@full_float32_matmul()
def decode_encdec(m: EncDec, token: torch.Tensor, cache: dict,
                  pos: int) -> tuple[torch.Tensor, dict]:
    """One decoder step: ``token`` (B,) at position ``pos`` against the self
    cache (keys at positions 0..pos) and the whole cross cache -> next-token
    logits (B, vocab); the self cache is written in place.  Raises
    ``ValueError`` for a position outside the self cache (the reference
    clamps it; ROADMAP.md queue C #20)."""
    return m(_decode, token, cache, pos), cache


def _decode(m: EncDec, token: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
    cfg = m.cfg
    sk, sv, ck, cv = (cache[k] for k in ("self_k", "self_v", "cross_k", "cross_v"))
    W = sk.shape[2]
    if not 0 <= pos < W:
        raise ValueError(f"{cfg.name}: decode position {pos} outside the self cache of {W}")
    h = _embed(m, token[:, None])
    h = _plus(h, _sinusoid_at(torch.full((1,), pos, device=h.device), cfg.d_model, h.dtype)[None])
    valid = (torch.arange(W, device=h.device) <= pos)[None]
    for i, blk in enumerate(m.dec_blocks):
        h = blk(_decode_layer, cfg, h, pos, valid, sk[i], sv[i], ck[i], cv[i])
    return _logits(m, h)[:, 0]


def _decode_layer(blk: Block, cfg: ModelConfig, h: torch.Tensor, pos: int, valid: torch.Tensor,
                  sk: torch.Tensor, sv: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor) -> torch.Tensor:
    h = constrain_act(h, _ACT_AXES)
    q, k, v = _proj_qkv(blk.self_attn.p, apply_norm(h, blk.norm1.p, cfg.norm))
    if tp.is_dtensor(sk):  # the rank holding position pos writes it
        tp.assign_row(sk, 1, pos, k[:, 0])
        tp.assign_row(sv, 1, pos, v[:, 0])
    else:
        sk[:, pos] = k[:, 0]
        sv[:, pos] = v[:, 0]
    h = h + _attn_out(cached_attention(q, sk, sv, valid), blk.self_attn.wo)
    qx = constrain_act(einsum("bsd,dhk->bshk", apply_norm(h, blk.norm_x.p, cfg.norm),
                              blk.cross_attn.wq), _QKV_AXES)
    h = h + _attn_out(cached_attention(qx, ck, cv, None), blk.cross_attn.wo)
    return h + _mlp(blk, cfg, h)
