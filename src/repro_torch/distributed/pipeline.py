"""Pipeline parallelism: a GPipe microbatch pipeline over the ranks of a
process group, point-to-point; the port of ``repro.distributed.pipeline``.

Stage s of S lives on rank s of the group (each rank holds one stage's
parameters, the leading stage dim of ``stage_params`` indexed at its
rank), and activations stream stage to stage.  The schedule is the
reference's GPipe loop: with M microbatches and S stages, M + S - 1 ticks;
rank s computes microbatch t - s at tick t.  As in the reference every
rank computes at every tick (a bubble tick computes on what it holds and
its result is never emitted) and passes its output to the next rank on the
ring (the last rank's to rank 0, unused), here one
``batch_isend_irecv`` a tick: each tick's transfers are uniform over the
ranks.  The last stage emits microbatch t - (S - 1) at tick t; its outputs
are then broadcast to every rank, which returns them all, as the
reference's masked ``psum`` does (a broadcast moves the bits unchanged).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

__all__ = ["pipeline_apply"]


def _leaves(tree: Any) -> list:
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _stage(tree: Any, s: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _stage(v, s) for k, v in tree.items()}
    return tree[s]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   x: torch.Tensor, *, group=None) -> torch.Tensor:
    """``x`` (M, mb, d) through S pipelined stages, S the size of ``group``
    (the default group if None); -> (M, mb, d) outputs on every rank.

    ``stage_params``: a tree of nested dicts of tensors, each (S, ...),
    stage-major (every rank passes the whole tree and uses its own stage);
    ``stage_fn(params_of_one_stage, activations) -> activations`` must keep
    the activations' shape.  Raises ``ValueError`` when the stage dim is
    not S.
    """
    S = dist.get_world_size(group)
    s = dist.get_rank(group)
    leaves = _leaves(stage_params)
    if leaves and leaves[0].shape[0] != S:
        raise ValueError(f"stage_params leading dim {leaves[0].shape[0]} != pipeline size {S}")
    params = _stage(stage_params, s)
    M = x.shape[0]
    nxt = dist.get_global_rank(group, (s + 1) % S) if group is not None else (s + 1) % S
    prv = dist.get_global_rank(group, (s - 1) % S) if group is not None else (s - 1) % S
    state = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(M + S - 1):
        inp = x[min(max(t, 0), M - 1)] if s == 0 else state
        out = stage_fn(params, inp)
        if S > 1:
            incoming = torch.empty_like(out)
            ops = [dist.P2POp(dist.isend, out.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, incoming, prv, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            state = incoming
        if s == S - 1 and t - (S - 1) >= 0:
            outs[t - (S - 1)] = out
    last = dist.get_global_rank(group, S - 1) if group is not None else S - 1
    dist.broadcast(outs, src=last, group=group)
    return outs
