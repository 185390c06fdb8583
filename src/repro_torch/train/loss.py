"""Losses: stable cross-entropy (+ z-loss) for LM training; the port of
``repro.train.loss``."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["softmax_cross_entropy", "lm_loss"]


def _ce_and_lse(logits: torch.Tensor, labels: torch.Tensor):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, labels.long()[..., None])[..., 0], lse


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE in nats.  logits (..., V), labels (...) int.

    The reference selects the gold logit with an iota-match masked reduce
    (it keeps a vocab-sharded gather local); on one device a gather
    computes the same value.
    """
    return _ce_and_lse(logits, labels)[0]


def lm_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S)
    mask: Optional[torch.Tensor] = None,  # (B, S) 1 = count
    z_loss_weight: float = 1e-4,
    count: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """(total, metrics): the masked mean CE plus ``z_loss_weight`` times
    the masked mean of lse**2; metrics ``ce_loss``, ``z_loss``,
    ``ppl_proxy`` (exp of the CE, capped at 20 nats) and ``tokens``.
    ``count``: the tokens the sums are divided by, if not this batch's
    (a data-parallel rank divides its sums by the global batch's count, so
    that the ranks' losses add up to the global batch's mean)."""
    ce, lse = _ce_and_lse(logits, labels)
    if mask is None:
        mask = torch.ones_like(ce)
    mask = mask.float()
    tokens = mask.sum()
    denom = torch.clamp(tokens if count is None else count, min=1.0)
    loss = (ce * mask).sum() / denom
    zl = (lse * lse * mask).sum() / denom
    total = loss + z_loss_weight * zl
    metrics = {
        "ce_loss": loss,
        "z_loss": zl,
        "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0)),
        "tokens": tokens,
    }
    return total, metrics
