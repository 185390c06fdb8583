"""The model API: the port of ``repro.models.api``, dispatching by family.

``Model`` wraps a :class:`ModelConfig` with the entry points the trainer
and the server use, whatever the family:

  init(generator, device)               -> the params module: an LM, or
                                           an EncDec for encdec
  param_axes()                          -> {parameter name: logical axes}
  cache_axes()                          -> the cache's tree of logical axes
  forward(params, batch, return_aux)    -> logits (B, S, vocab), or
                                           (logits, {"lb_loss", "z_loss"})
  init_cache(batch, max_len, device)    -> cache
  prefill(params, batch, cache, pos_offset) -> (logits (B, vocab), cache)
  decode(params, token, cache, pos, start)  -> (logits (B, vocab), cache)

Batch contract (tensors on the params' device):
  dense, moe, ssm: {"tokens": (B, S) int64 or int32}
  vlm:             + {"patch_embeds": (B, num_patches, d)}
  encdec:          {"frames": (B, S_frames, d), "tokens": (B, S)}
(``labels`` and ``mask`` too for training, see :mod:`..train.step`).

``forward`` gives the logits alone unless ``return_aux``, then also the
router's aux losses summed over the MoE layers (zeros for the other
families), as the reference's ``forward`` returns them.  The moe family
(mixtral, phi3.5-moe) takes the dense family's calls and cache; its
``forward`` trains, the aux losses differentiable beside the logits (the
train step weights them into its loss).  The
ssm family (falcon-mamba) takes the same calls: its cache holds
convolution windows and scan states instead of keys and values,
``pos_offset``, ``pos`` and ``start`` do not apply to it, and its
``forward`` runs only without a gradient.  The hybrid family (jamba)
takes them too: its cache holds rings for its attention layers and
states for its Mamba layers, and its ``forward`` runs only without a
gradient, as the ssm family's.  The vlm family (internvl2)
puts ``patch_embeds`` ahead of the tokens: its cache and positions cover
num_patches + S, and ``forward`` drops the prefix's logits (text token j
sits at position num_patches + j).  The encdec family (whisper) encodes
``frames``; its ``prefill`` fills the cross cache and decodes a BOS token
0 at position 0 (the prompt's tokens are not read), its ``decode`` takes
the decoder's position, and ``pos_offset`` and ``start`` do not apply to
it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import encdec as _ed
from . import transformer as _tr
from .config import ModelConfig

__all__ = ["Model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator] = None, device="cuda"):
        if self.cfg.family == "encdec":
            return _ed.init_encdec(self.cfg, generator=generator, device=device)
        return _tr.init_lm(self.cfg, generator=generator, device=device)

    def param_axes(self) -> dict:
        """The logical axes of every parameter, keyed like
        ``named_parameters()``; nothing is allocated."""
        if self.cfg.family == "encdec":
            return _ed.encdec_param_axes(self.cfg)
        return _tr.param_axes(self.cfg)

    def cache_axes(self) -> dict:
        """The logical axes of :meth:`init_cache`'s buffers, in its tree."""
        if self.cfg.family == "encdec":
            return _ed.decoder_cache_axes(self.cfg)
        return _tr.cache_axes(self.cfg)

    def forward(self, params, batch: dict, return_aux: bool = False):
        cfg = self.cfg
        if cfg.family == "encdec":
            return _ed.forward_encdec(params, batch["frames"], batch["tokens"],
                                      return_aux=return_aux)
        if cfg.family != "vlm":
            return _tr.forward_lm(params, batch["tokens"], return_aux=return_aux)
        out = _tr.forward_lm(params, batch["tokens"], return_aux=return_aux,
                             patch_embeds=batch["patch_embeds"])
        # text token j sits at position num_patches + j; drop the prefix
        if return_aux:
            return out[0][:, cfg.num_patches:], out[1]
        return out[:, cfg.num_patches:]

    def init_cache(self, batch_size: int, max_len: int, device="cuda") -> dict:
        if self.cfg.family == "encdec":
            return _ed.init_decoder_cache(self.cfg, batch_size, max_len, device=device)
        return _tr.init_cache(self.cfg, batch_size, max_len, device=device)

    def prefill(self, params, batch: dict, cache: dict, pos_offset: int = 0):
        cfg = self.cfg
        if cfg.family == "encdec":
            frames = batch["frames"]
            cache = _ed.prefill_encdec(params, frames, cache)
            bos = torch.zeros(frames.shape[0], dtype=torch.int64, device=params.embed.device)
            return _ed.decode_encdec(params, bos, cache, 0)
        if cfg.family == "vlm":
            return _tr.prefill_lm(params, batch["tokens"], cache, pos_offset=pos_offset,
                                  patch_embeds=batch["patch_embeds"])
        return _tr.prefill_lm(params, batch["tokens"], cache, pos_offset=pos_offset)

    def decode(self, params, token: torch.Tensor, cache: dict, pos: int,
               start: Optional[torch.Tensor] = None):
        if self.cfg.family == "encdec":
            return _ed.decode_encdec(params, token, cache, pos)
        return _tr.decode_lm(params, token, cache, pos, start=start)
