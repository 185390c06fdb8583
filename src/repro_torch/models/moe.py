"""Mixture-of-Experts FFN, GShard grouped one-hot dispatch: the port of
``repro.models.moe``.

Tokens are cut into G groups of Sg; within a group each token routes to
its top-k experts (softmax in float32, the k gates renormalised to sum to
one), and each expert takes at most ``C = ceil(Sg k cf / E)`` of the
group's (token, slot) pairs, counted in the flattened (Sg, k) order: a
pair past its expert's capacity is dropped (its gate is zeroed).  The
dispatch and combine tensors (G, Sg, E, C) are one-hot, so moving tokens
to experts and back is a pair of batched matrix products, with no scatter.
The reference computes all of this outside any Pallas kernel, so the port
does too: plain products, through cuBLAS on the card.

The products run in the compute type; the dispatch and combine tensors
are made in it from the start, or in float32 under ``paper_baseline()``
(:mod:`.flags`), as in the reference.  Top-k breaks ties by the lower
expert index, as ``jax.lax.top_k`` does: a stable descending sort.

Capacity is shared by the tokens of a group, earlier pairs first, so a
token's output depends on the tokens before it in its group and on the
group's size: the forward over a sequence and a prefill of its prefix
may drop different pairs, as in the reference.

Every expert runs on all C slots of every group, used or not: in a
decode step (one token a group, C = 1 for mixtral's 8 experts) that is
each expert's weights read for each token, the reference's cost as well.

Router aux losses (switch transformer's load balance and the z-loss) are
returned beside the output, differentiable, for the training step
(:mod:`..train.step`) to weight into its loss as the reference's does.

Expert parallelism (DTensors in a ``sharding_context``): the groups are
the single-process groups (:func:`group_count` of the whole batch), each
"data" rank routing the groups of its batch rows (the whole batch where
its rows do not hold whole groups); the routing runs whole on every
"model" rank.  The reference's annotations place the grouped tokens
(``groups``), the tokens at their experts and the experts' outputs
(``act_experts``, or ``act_mlp`` where the experts do not divide the axis:
the experts' hidden units are then sharded instead); each rank runs its
experts (or its hidden units) on every group's slots, and the combine sums
the ranks' shares.  Where the reference moves the tokens to their experts
with an all-to-all, here every "model" rank holds every token of its rows
and picks its experts' slots locally.  The aux losses are the whole batch's:
where the groups are split over "data", each rank's router statistics
are summed over the ranks first (the same value on every rank).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from ..distributed.context import constrain_act
from .config import ModelConfig, MoEConfig
from .flags import paper_baseline
from .layers import _ACTS, dense_init, einsum, gelu

__all__ = ["moe_init", "moe_apply", "moe_dispatch", "group_count", "Dispatch"]


def moe_init(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """``router`` (d, E), ``w_in`` (and ``w_gate`` for swiglu and geglu)
    (E, d, ff) and ``w_out`` (E, ff, d), the reference's layouts and
    scales (1/sqrt of the leading axis), drawn in that order."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    dt = getattr(torch, cfg.param_dtype)

    def w(shape):
        return dense_init(shape, dt, generator, device)

    p = {"router": w((d, E)), "w_in": w((E, d, ff))}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = w((E, d, ff))
    p["w_out"] = w((E, ff, d))
    return p


def group_count(moe: MoEConfig, B: int, S: int, groups: Optional[int] = None) -> int:
    """The number of dispatch groups G for a (B, S) batch: ``groups`` if
    given; else each sequence cut into the largest power of two of pieces
    that keeps ``target_group_tokens`` tokens a piece (``group_mult``
    groups a sequence under ``paper_baseline()`` or without a target);
    then lowered until it divides B S."""
    T = B * S
    if groups is not None:
        G = groups
    elif moe.target_group_tokens is not None and not paper_baseline():
        mult = 1
        while S % (mult * 2) == 0 and S // (mult * 2) >= moe.target_group_tokens:
            mult *= 2
        G = B * mult
    else:
        G = max(1, B * moe.group_mult)
    while T % G != 0:
        G -= 1
    return G


class Dispatch(NamedTuple):
    """One routing of (G, Sg) grouped tokens."""

    logits: torch.Tensor  # (G, Sg, E) float32
    probs: torch.Tensor  # (G, Sg, E) float32
    expert_ids: torch.Tensor  # (G, Sg, k) int64
    gates: torch.Tensor  # (G, Sg, k) float32, renormalised, 0 where dropped
    keep: torch.Tensor  # (G, Sg, k) bool: the pair fits its expert's capacity
    onehot: torch.Tensor  # (G, Sg, k, E) float32
    disp: torch.Tensor  # (G, Sg, E, C): 1 where token s fills slot c of expert e
    comb: torch.Tensor  # (G, Sg, E, C): that slot's gate


def moe_dispatch(p: dict, cfg: ModelConfig, xg: torch.Tensor) -> Dispatch:
    """Route grouped tokens ``xg`` (G, Sg, d): the reference's steps, one
    for one."""
    moe = cfg.moe
    G, Sg, _ = xg.shape
    E, k, cf = moe.num_experts, moe.top_k, moe.capacity_factor
    logits = einsum("gsd,de->gse", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_ids = ranked[..., :k], order[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    C = int(math.ceil(Sg * k * cf / E))
    oh = F.one_hot(expert_ids, E).float()  # (G, Sg, k, E)
    # each pair's place in its expert's queue, over the flattened (Sg, k)
    # order: an exclusive cumulative sum (GShard §3.2); exact in float32
    ohf = oh.reshape(G, Sg * k, E)
    pos = ((ohf.cumsum(dim=1) - ohf) * ohf).sum(-1).reshape(G, Sg, k)
    keep = pos < C
    gates = gates * keep.float()

    cd = torch.float32 if paper_baseline() else getattr(torch, cfg.compute_dtype)
    oh_c = oh.to(cd)
    # a dropped pair points at slot C, one past the last: a row of zeros
    slot = torch.where(keep, pos, torch.full_like(pos, C)).long()
    pos_oh = F.one_hot(slot, C + 1)[..., :C].to(cd)  # (G, Sg, k, C)
    disp = torch.einsum("gske,gskc->gsec", oh_c, pos_oh)
    comb = torch.einsum("gsk,gske,gskc->gsec", gates.to(cd), oh_c, pos_oh)
    return Dispatch(logits, probs, expert_ids, gates, keep, oh, disp, comb)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              groups: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (y (B, S, d), {"lb_loss", "z_loss"} float32 scalars)."""
    moe = cfg.moe
    B, S, d = x.shape
    G = group_count(moe, B, S, groups)
    if tp.is_dtensor(x):
        return _moe_apply_tp(p, cfg, x, G)
    xg = x.reshape(G, (B * S) // G, d)
    r = moe_dispatch(p, cfg, xg)

    xe = einsum("gsec,gsd->gecd", r.disp, xg)  # (G, E, C, d): tokens to their experts
    if "w_gate" in p:
        h = einsum("gecd,edf->gecf", xe, p["w_in"])
        he = h * _ACTS[cfg.act](einsum("gecd,edf->gecf", xe, p["w_gate"]))
    else:
        he = gelu(einsum("gecd,edf->gecf", xe, p["w_in"]))
    ye = einsum("gecf,efd->gecd", he, p["w_out"])
    y = einsum("gsec,gecd->gsd", r.comb, ye)  # back to the tokens, weighted by their gates

    return y.reshape(B, S, d), _aux_losses(r, moe.top_k)


def _aux_losses(r: Dispatch, k: int, reduce=None) -> dict:
    """Switch transformer's load-balance loss and the router z-loss from
    the routing ``r`` of (G, Sg) tokens.  ``reduce`` (the expert-parallel
    path's, where the groups are split over ranks): sums each statistic's
    per-rank sums over the ranks, whose means then are the whole batch's."""
    E = r.probs.shape[-1]
    z = torch.logsumexp(r.logits, dim=-1).square()
    if reduce is None:
        me = r.probs.mean(dim=(0, 1))  # mean router probability per expert
        ce = r.onehot.sum(dim=2).mean(dim=(0, 1)) / k  # share of pairs sent to each expert
        z_loss = z.mean()
    else:
        stats = reduce(torch.cat([r.probs.sum(dim=(0, 1)), r.onehot.sum(dim=2).sum(dim=(0, 1)),
                                  z.sum()[None]]))
        me, ce, z_loss = stats[:E], stats[E:2 * E] / k, stats[2 * E]
    return {"lb_loss": E * (me * ce).sum(), "z_loss": z_loss}


# ------------------------------------------------------------ expert parallel
_EXP_AXES = ("groups", "act_experts", None, "act_embed")
_EXP_FF = ("groups", "act_experts", None, "act_mlp")
_GROUP_AXES = ("groups", None, "act_embed")


def _moe_apply_tp(p: dict, cfg: ModelConfig, x, G: int):
    """:func:`moe_apply` of a DTensor ``x`` (B, S, d) in ``G`` groups."""
    moe = cfg.moe
    B, S, d = x.shape
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = [q if isinstance(q, tp.Shard) and q.dim == 0 else tp.Replicate()
            for q in tp.settled(x.placements)]
    if B and G % B == 0:  # a data rank's rows must hold whole groups, in chunk order
        b0, b1 = tp.local_range(B, mesh, rows, 0)
        gpl = [tp.Shard(0) if isinstance(q, tp.Shard) else q for q in rows]
        if tp.local_range(G, mesh, gpl, 0) != (b0 * (G // B), b1 * (G // B)):
            rows = gpl = [tp.Replicate()] * len(names)
    else:
        rows = gpl = [tp.Replicate()] * len(names)
    split = {n: isinstance(q, tp.Shard) for n, q in zip(names, rows)}
    Sg = (B * S) // G
    xl = tp.take(x, rows, split)
    xg = tp.wrap(xl.reshape(-1, Sg, d), mesh, gpl, (G, Sg, d))
    xg = constrain_act(xg, _GROUP_AXES)
    # the groups as placed (d_model whole: the weight-stationary rules shard it)
    gpl = [q if isinstance(q, tp.Shard) and q.dim == 0 else tp.Replicate()
           for q in tp.settled(xg.placements)]
    gsplit = {n: isinstance(q, tp.Shard) for n, q in zip(names, gpl)}
    # the routing, whole on every "model" rank: its gradient is the same on each
    r = moe_dispatch({"router": tp.take_weight(p["router"], {}, gsplit)}, cfg,
                     tp.take(xg, gpl, gsplit))
    E, C = moe.num_experts, r.disp.shape[-1]
    disp = tp.wrap(r.disp, mesh, gpl, (G, Sg, E, C))
    comb = tp.wrap(r.comb, mesh, gpl, (G, Sg, E, C))

    xe = constrain_act(einsum("gsec,gsd->gecd", disp, xg), _EXP_AXES)  # the reference's all-to-all
    if "w_gate" in p:
        h = constrain_act(einsum("gecd,edf->gecf", xe, p["w_in"]), _EXP_FF)
        he = h * _ACTS[cfg.act](einsum("gecd,edf->gecf", xe, p["w_gate"]))
    else:
        he = constrain_act(gelu(einsum("gecd,edf->gecf", xe, p["w_in"])), _EXP_FF)
    ye = constrain_act(einsum("gecf,efd->gecd", he, p["w_out"]), _EXP_AXES)
    y = constrain_act(einsum("gsec,gecd->gsd", comb, ye), _GROUP_AXES)
    yl = tp.take(y, [tp.Shard(0) if isinstance(q, tp.Shard) else tp.Replicate() for q in rows],
                 split)
    out = tp.wrap(yl.reshape(-1, S, d), mesh, rows, (B, S, d))

    data = [n for m, n in enumerate(names) if gsplit[n] and mesh.size(m) > 1]
    reduce = None
    if data:  # the whole batch's means: each rank's sums, summed over the ranks

        def reduce(stats: torch.Tensor) -> torch.Tensor:
            pl = [tp.Partial() if n in data else tp.Replicate() for n in names]
            return tp.take(tp.wrap(stats, mesh, pl, stats.shape), [tp.Replicate()] * len(names),
                           {}) / (G * Sg)
    return out, _aux_losses(r, moe.top_k, reduce)
