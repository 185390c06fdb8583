"""Sharding context for activation constraints: the port of
``repro.distributed.context``.

Models are mesh-agnostic: they name an activation's dims with *logical*
axes and call :func:`constrain_act`.  Inside ``sharding_context(mesh,
rules)`` a DTensor activation is redistributed to the placements that
:func:`~.sharding.spec_for_axes` (``strict=False``) gives on that
``DeviceMesh``; with no context, or for a plain tensor, the call is the
identity, so single-device runs and tests are unchanged.  The context is
per thread, as the reference's.  The models call it at the reference's
sites (q, k, v and o, each layer's input, the embedding, the FFN's hidden
layer, the MoE's dispatch and combine, the Mamba mixer's inner channels,
the logits); :func:`act_placements` gives the placements an activation of
some shape takes under the context, for the tensor-parallel regions of
:mod:`.tensor_parallel` that build their outputs on them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from .sharding import ShardingRules, placements_for_spec, spec_for_axes

__all__ = ["sharding_context", "constrain_act", "current_context", "act_placements"]

_TLS = threading.local()


def current_context():
    """``(device_mesh, rules)`` of the innermost context, or None."""
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def sharding_context(device_mesh, rules: ShardingRules):
    prev = current_context()
    _TLS.ctx = (device_mesh, rules)
    try:
        yield
    finally:
        _TLS.ctx = prev


def constrain_act(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` placed as its logical ``axes`` resolve under the current
    context; identity with no context.  Raises ``ValueError`` when
    ``axes`` does not name every dim of ``x``, as the reference does."""
    ctx = current_context()
    if ctx is None:
        return x
    mesh, rules = ctx
    if len(axes) != x.ndim:
        raise ValueError(f"axes {tuple(axes)} vs rank-{x.ndim} tensor {tuple(x.shape)}")
    if not isinstance(x, DTensor):
        return x
    spec = spec_for_axes(axes, rules, mesh, tuple(x.shape), strict=False)
    return x.redistribute(mesh, placements_for_spec(spec, mesh))


def act_placements(axes: Sequence[Optional[str]], shape: Sequence[int]) -> tuple:
    """The placements :func:`constrain_act` gives an activation of
    ``shape`` named ``axes`` under the current context (``strict=False``);
    raises without a context."""
    ctx = current_context()
    if ctx is None:
        raise RuntimeError("act_placements needs a sharding_context")
    mesh, rules = ctx
    return placements_for_spec(spec_for_axes(axes, rules, mesh, tuple(shape), strict=False), mesh)
