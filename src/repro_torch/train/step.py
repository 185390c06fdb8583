"""Serve-step factories: the port of ``repro.train.step.make_serve_steps``.
The train step (loss, AdamW, microbatching) is not ported yet
(ROADMAP.md queue A)."""
from __future__ import annotations

from typing import Callable

import torch

from ..models import Model

__all__ = ["make_serve_steps"]


def make_serve_steps(model: Model) -> tuple[Callable, Callable]:
    """Returns (prefill_step, decode_step).  ``decode_step`` gives the
    greedy next token (int32), the logits and the cache."""

    def prefill_step(params, batch: dict, cache):
        return model.prefill(params, batch, cache)

    def decode_step(params, token: torch.Tensor, cache, pos: int):
        logits, new_cache = model.decode(params, token, cache, pos)
        return logits.argmax(dim=-1).to(torch.int32), logits, new_cache

    return prefill_step, decode_step
