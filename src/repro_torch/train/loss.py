"""Losses: stable cross-entropy (+ z-loss) for LM training; the port of
``repro.train.loss``.

Logits that are a DTensor sharded over the vocabulary (``act_vocab`` on
"model") are never gathered: each rank takes the max, the sum of
exponentials and the gold logit (the reference's iota-match masked
reduce) over its own columns, and the three are reduced over the ranks
(the max without a gradient, the sums as partial sums).  The result is a
plain tensor of each rank's batch rows: its loss is that rank's share."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["softmax_cross_entropy", "lm_loss"]


def _ce_and_lse(logits: torch.Tensor, labels: torch.Tensor):
    if isinstance(logits, DTensor):
        return _ce_and_lse_vocab_parallel(logits, labels)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, labels.long()[..., None])[..., 0], lse


def _ce_and_lse_vocab_parallel(logits: DTensor, labels: torch.Tensor):
    """(ce, lse) of each rank's rows (plain tensors) from vocab-sharded
    logits (..., V): the same values as the whole-row logsumexp and gather
    (on one rank the same bits)."""
    from ..distributed import tensor_parallel as tp

    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    last = logits.ndim - 1
    pls = tp.settled(logits.placements)
    vocab = [n for m, (n, p) in enumerate(zip(names, pls))
             if isinstance(p, Shard) and p.dim == last and mesh.size(m) > 1]
    rows = [Replicate() if n in vocab else p for n, p in zip(names, pls)]
    split = {n: isinstance(p, Shard) for n, p in zip(names, pls)}
    loc = tp.take(logits, pls, split)
    if not vocab:  # each rank holds its rows' whole vocabulary: the plain code
        lab = tp.take(tp.replicate(labels, mesh), [r if isinstance(r, Shard) and r.dim < last
                                             else Replicate() for r in rows], {})
        return _ce_and_lse(loc, lab)
    loc = loc.float()
    v0, v1 = tp.local_range(logits.shape[last], mesh, pls, last)
    row_shape = tuple(logits.shape[:-1])

    def reduced(t: torch.Tensor, op: Partial) -> torch.Tensor:
        """``t`` (this rank's columns' share, rows local) over every rank."""
        return tp.take(tp.wrap(t, mesh, [op if n in vocab else p for n, p in zip(names, rows)],
                               row_shape), rows, {})

    lab = tp.take(tp.replicate(labels, mesh), rows, {}).long()
    m = loc.amax(dim=-1) if loc.shape[-1] else loc.new_full(loc.shape[:-1], float("-inf"))
    m = reduced(m.detach(), Partial("max"))
    se = reduced(torch.exp(loc - m[..., None]).sum(-1), Partial())
    lse = torch.log(se) + m
    cols = torch.arange(v0, v1, device=loc.device)
    gold = reduced(torch.where(cols == lab[..., None], loc, torch.zeros((), device=loc.device))
                   .sum(-1), Partial())
    return lse - gold, lse


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE in nats.  logits (..., V), labels (...) int.

    The reference selects the gold logit with an iota-match masked reduce
    (it keeps a vocab-sharded gather local); on one device a gather
    computes the same value, and vocab-sharded DTensor logits take the
    masked reduce.
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
