"""AdamW by hand: the port of ``repro.train.optimizer``.

Decoupled weight decay folded into the step before lr scales it,
global-norm clipping, bias correction, lr read at the 1-based count, and
warmup+cosine / constant schedules.  The update is computed in float32 and
cast back to each parameter's type; the moments keep ``moment_dtype``.

The JAX package's update is pure; here parameters and moments are
updated in place (one float32 temporary per tensor at a time), which
keeps the optimizer's memory at the parameters plus two moments.  The
schedules compute in float32 on the host with numpy, as the reference
computes them in float32 on the device.

Sharded parameters (the rule-sharded train step's DTensors, FSDP2 shards
and replicated tensors, on the ("data", "model") mesh or its "model"
submesh) take the same update: :func:`global_norm` sums each shard's
squares and reduces them once over the mesh, so it is the global norm; the moments live sharded like their parameters
(:func:`adamw_init`), and clipping and the update run on each rank's local
shards.  A mix of DTensors and plain tensors is refused.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "warmup_cosine",
    "constant_lr",
    "global_norm",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[int], float] | float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory

    def lr_at(self, count: int) -> np.float32:
        if callable(self.lr):
            return np.float32(self.lr(count))
        return np.float32(self.lr)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """lr(count): linear warmup to ``peak`` over ``warmup`` counts, then a
    cosine to ``floor * peak`` at ``total``; float32 arithmetic."""
    f32 = np.float32

    def f(step) -> np.float32:
        s = f32(step)
        if s < warmup:
            return f32(peak) * s / f32(max(1, warmup))
        prog = min(max((s - f32(warmup)) / f32(max(1, total - warmup)), f32(0)), f32(1))
        cos = f32(1) + np.cos(f32(math.pi) * prog)
        return f32(peak) * (f32(floor) + f32((1 - floor) * 0.5) * cos)

    return f


def constant_lr(v: float):
    return lambda step: np.float32(v)


def _kind(tensors: Mapping[str, torch.Tensor]) -> bool:
    """Whether the tensors are DTensors; raises ``TypeError`` on a mix."""
    kinds = {isinstance(t, DTensor) for t in tensors.values()}
    if len(kinds) > 1:
        raise TypeError("a mix of DTensors and plain tensors: shard every parameter or none")
    return kinds == {True}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writes land in the DTensor), else
    ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t``'s squares in float32 (of a DTensor, its local
    shard's), taken over them in row-major order whatever ``t``'s layout
    (a tied embedding's gradient comes out of autograd transposed, FSDP2
    keeps a shard row-major at an offset), so that a sharded tensor's
    norm on one rank is the plain tensor's bit for bit."""
    return torch.sum(torch.square(_local(t).float()).contiguous())


def _counted_once(t: DTensor, root) -> bool:
    """Whether this rank's shard of ``t`` enters the norm: on every dim of
    ``root`` (the largest mesh) where ``t`` is not sharded (replicated, or
    a dim its submesh lacks), only the dim's first coordinate counts."""
    names = t.device_mesh.mesh_dim_names
    coord = root.get_coordinate()
    for m, name in enumerate(root.mesh_dim_names):
        p = t.placements[names.index(name)] if name in names else None
        if (p is None or p.is_replicate() or p.is_partial()) and coord[m] != 0:
            return False
    return True


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (a 0-d tensor
    on the tensors' device).  DTensors, on one mesh or on it and its
    submeshes (the ("data", "model") mesh and its "model" dim): each
    tensor's local sum, kept on the ranks that hold a distinct shard of it
    (:func:`_counted_once`), summed over the mesh, then added in the
    tensors' order as for plain tensors (the same value on every rank; on
    one rank the plain sum bit for bit)."""
    if not _kind(tensors):
        total = None
        for t in tensors.values():
            sq = _square_sum(t)
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    ts = list(tensors.values())
    root = max((t.device_mesh for t in ts), key=lambda m: m.ndim)
    names = set(root.mesh_dim_names or ())
    if any(not set(t.device_mesh.mesh_dim_names or ()) <= names for t in ts):
        raise ValueError("global_norm takes DTensors on one mesh and its submeshes")
    sq = torch.stack([_square_sum(t) if _counted_once(t, root)
                      else torch.zeros((), dtype=torch.float32, device=_local(t).device)
                      for t in ts])
    for m in range(root.ndim):
        dist.all_reduce(sq, group=root.get_group(m))
    total = sq[0]
    for x in sq[1:]:
        total = total + x
    return torch.sqrt(total)


def clip_by_global_norm(tensors: Mapping[str, torch.Tensor], max_norm: float, norm=None):
    """(clipped, norm): each tensor times min(1, max_norm / norm), computed
    in float32 and cast back to the tensor's type (a DTensor's local shard
    for a DTensor).  ``norm``: the tensors' :func:`global_norm` if known."""
    g = global_norm(tensors) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return {k: (_local(t).float() * scale).to(t.dtype) for k, t in tensors.items()}, g


@dataclasses.dataclass
class AdamWState:
    """First and second moments keyed like the parameters, and the number
    of updates taken."""

    m: dict
    v: dict
    count: int = 0


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``moment_dtype``; a DTensor parameter's sharded as
    it is."""
    md = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=md)
        return torch.zeros(p.shape, dtype=md, device=p.device)

    return AdamWState(m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()}, count=0)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``state``.  Returns the
    metrics ``grad_norm`` (before clipping, float32 0-d tensor) and ``lr``."""
    if set(grads) != set(params) or set(state.m) != set(params):
        raise ValueError("grads, moments and params must have the same keys")
    if _kind(grads) != _kind(params):
        raise TypeError("grads and params must be both DTensors or both plain tensors")
    count = state.count + 1
    grad_norm = global_norm(grads)
    if cfg.clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.clip_norm, norm=grad_norm)
    b1, b2 = cfg.b1, cfg.b2
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    lr = cfg.lr_at(count)
    for k, p in params.items():
        p, m, v = _local(p), _local(state.m[k]), _local(state.v[k])
        gf = _local(grads[k]).float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf * gf * (1 - b2)
        step = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - float(lr) * step)
        m.copy_(mf)
        v.copy_(vf)
    state.count = count
    return {"grad_norm": grad_norm, "lr": torch.tensor(lr, dtype=torch.float32)}
