"""The model API: the port of ``repro.models.api`` for the dense, moe and
ssm families.

``Model`` wraps a :class:`ModelConfig` with the entry points the server
uses:

  init(generator, device)               -> LM module (the params)
  forward(params, batch, return_aux)    -> logits (B, S, vocab), or
                                           (logits, {"lb_loss", "z_loss"})
  init_cache(batch, max_len, device)    -> cache
  prefill(params, batch, cache, pos_offset) -> (logits (B, vocab), cache)
  decode(params, token, cache, pos, start)  -> (logits (B, vocab), cache)

Batch contract: ``{"tokens": (B, S) int64 or int32 tensor}`` on the
params' device.  ``forward`` gives the logits alone unless ``return_aux``,
then also the router's aux losses summed over the MoE layers (zeros for
the other families), as the reference's ``forward`` returns them.  The moe
family (mixtral, phi3.5-moe) takes the dense family's calls and cache;
its ``forward`` runs only without a gradient (ROADMAP.md queue A #17).
The ssm family (falcon-mamba) takes the same calls: its cache holds
convolution windows and scan states instead of keys and values,
``pos_offset``, ``pos`` and ``start`` do not apply to it, and its
``forward`` runs only without a gradient.  Other families raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import transformer as _tr
from .config import ModelConfig

__all__ = ["Model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator] = None, device="cuda") -> _tr.LM:
        return _tr.init_lm(self.cfg, generator=generator, device=device)

    def forward(self, params: _tr.LM, batch: dict, return_aux: bool = False):
        return _tr.forward_lm(params, batch["tokens"], return_aux=return_aux)

    def init_cache(self, batch_size: int, max_len: int, device="cuda") -> dict:
        return _tr.init_cache(self.cfg, batch_size, max_len, device=device)

    def prefill(self, params: _tr.LM, batch: dict, cache: dict, pos_offset: int = 0):
        return _tr.prefill_lm(params, batch["tokens"], cache, pos_offset=pos_offset)

    def decode(self, params: _tr.LM, token: torch.Tensor, cache: dict, pos: int,
               start: Optional[torch.Tensor] = None):
        return _tr.decode_lm(params, token, cache, pos, start=start)
