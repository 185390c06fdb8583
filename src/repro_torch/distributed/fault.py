"""Restart supervision, the elastic re-mesh and liveness: the port of
``repro.distributed.fault`` (``run_with_restarts``, ``reshard_for_mesh``
and ``HeartbeatMonitor``).

:func:`run_with_restarts` catches a worker failure and runs the work again
with ``resume=True``; the training driver resumes from its latest
checkpoint, loader cursor included, so the restarted run continues the
uninterrupted one bitwise (``tests/test_torch_train.py``).  Unlike the
reference, which restarts on any ``BaseException``, it restarts on
``Exception`` only: an interrupt or a ``SystemExit`` ends the run.

:class:`LivenessMonitor` (the reference's ``HeartbeatMonitor``, renamed
because ``tools/analyze`` resolves classes by bare name) flags members whose
last beat is older than its timeout, on ``time.monotonic``; a
:class:`~repro_torch.core.prefetch.FetchPool` takes it as ``heartbeat=``.
:func:`reshard_for_mesh` restores a checkpoint onto a ``DeviceMesh``,
possibly another than the one that saved it (the elastic path for lost or
added devices): checkpoints hold unsharded arrays, so each leaf is read
whole and placed as the sharding rules resolve it on the new mesh
(``distribute_tensor``); the loader state in the manifest comes back as it
was saved, and the loader re-partitions its fetches by the new world size
over the same global order.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Mapping, Optional

import torch
from torch.distributed.tensor import distribute_tensor

from ..checkpoint.manager import CheckpointManager
from .sharding import (
    ShardingRules,
    _axis_size,
    _present,
    mesh_view,
    placements_for_spec,
    spec_for_axes,
)

__all__ = ["run_with_restarts", "reshard_for_mesh", "LivenessMonitor"]


class LivenessMonitor:
    """Tracks the liveness of named members; flags those past their deadline."""

    def __init__(self, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self._last: dict[str, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def beat(self, member: str) -> None:
        with self._lock:
            self._last[member] = time.monotonic()

    def suspects(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [m for m, t in self._last.items() if now - t > self.timeout_s]

    def alive(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [m for m, t in self._last.items() if now - t <= self.timeout_s]


def run_with_restarts(
    work: Callable[[bool], Any],
    *,
    max_restarts: int = 3,
    backoff_s: float = 0.0,
    max_backoff_s: Optional[float] = None,
    jitter: float = 0.0,
    seed: int = 0,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    on_give_up: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run ``work(resume: bool)``; restart on failure up to ``max_restarts``.

    ``work`` must be checkpoint-resumable (the training driver is: state +
    loader cursor ride in the checkpoint).  Returns work's result.

    The backoff before restart ``k`` is ``min(backoff_s * 2**(k-1),
    max_backoff_s) * (1 + jitter * u_k)`` with ``u_k`` a seeded uniform draw
    in ``[0, 1)`` — exponential growth, capped (``max_backoff_s=None`` =
    uncapped), and desynchronized across supervisors restarting off one
    shared failure (jitter=0 keeps a deterministic schedule; the jittered
    schedule is deterministic in ``seed``).  ``on_give_up(restarts_used,
    last_exc)`` fires once when the budget is exhausted, before the final
    exception propagates — the hook for paging/cleanup.  ``sleep`` is
    injectable so tests assert the schedule without waiting it.
    """
    rng = random.Random(seed)
    attempt = 0
    while True:
        try:
            return work(attempt > 0)
        except Exception as e:  # supervisor boundary; an interrupt or exit propagates
            attempt += 1
            if attempt > max_restarts:
                if on_give_up:
                    on_give_up(attempt - 1, e)
                raise
            if on_restart:
                on_restart(attempt, e)
            if backoff_s:
                delay = backoff_s * (2.0 ** (attempt - 1))
                if max_backoff_s is not None:
                    delay = min(delay, max_backoff_s)
                if jitter:
                    delay *= 1.0 + jitter * rng.random()
                sleep(delay)


def _tensor_leaves(template: Any, axes_tree: Any, path: str = ""):
    """(path, template tensor, its axes) for every tensor leaf of
    ``template``; ``axes_tree`` holds the same dicts down to them."""
    if isinstance(template, Mapping):
        for k, v in template.items():
            sub = axes_tree.get(k) if isinstance(axes_tree, Mapping) else None
            yield from _tensor_leaves(v, sub, f"{path}/{k}" if path else str(k))
    elif isinstance(template, torch.Tensor):
        if axes_tree is None:
            raise KeyError(f"no logical axes for the tensor leaf {path!r}")
        yield path, template, axes_tree


def _undivisible_dims(template: Any, axes_tree: Any, rules: ShardingRules, mesh) -> list[str]:
    """Dims whose rule maps to mesh axes that do not divide the dim: the
    strict resolution would quietly replicate them."""
    bad = []
    for _, t, axes in _tensor_leaves(template, axes_tree):
        shape = tuple(t.shape)
        for i, logical in enumerate(axes):
            a = _present(mesh, rules.get(logical)) if logical else None
            if a is None:
                continue
            n = _axis_size(mesh, a)
            if n > 1 and shape[i] % n != 0:
                bad.append(f"dim '{logical}' of shape {shape} (size {shape[i]}) is not "
                           f"divisible by mesh axes {a!r} (={n} devices)")
    return bad


def reshard_for_mesh(mgr: CheckpointManager, template: Any, axes_tree: Any, device_mesh,
                     rules: ShardingRules, step: Optional[int] = None, *, strict: bool = True):
    """(tree, manifest): checkpoint ``step`` (the latest by default)
    restored in ``template``'s structure, every tensor leaf a DTensor on
    ``device_mesh`` placed as its spec resolves there (a dim its mesh axes
    do not divide replicated), other leaves as the checkpoint manager
    gives them.  Every rank of the mesh calls it and reads the whole
    checkpoint.

    ``strict=True`` (the default) refuses, with ``ValueError``, a mesh
    whose axes do not divide the logical dims they shard: an elastic
    restore that quietly changes the layout a job was sized for.
    ``strict=False`` accepts the replication instead.
    """
    mesh = mesh_view(device_mesh)
    if strict:
        bad = _undivisible_dims(template, axes_tree, rules, mesh)
        if bad:
            raise ValueError(
                "reshard_for_mesh: target mesh does not divide the logical dims it shards "
                "(the sharding rules would silently fall back to replication):\n  - "
                + "\n  - ".join(bad)
                + "\nPick a mesh whose axes divide these dims, change the rules, or pass "
                "strict=False to accept replication.")
    tree, manifest = mgr.restore(template, step)

    def place(node, axes):
        if isinstance(node, Mapping):
            return {k: place(v, axes.get(k) if isinstance(axes, Mapping) else None)
                    for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return node
        spec = spec_for_axes(axes, rules, mesh, tuple(node.shape))
        return distribute_tensor(node, device_mesh, placements_for_spec(spec, device_mesh))

    return place(tree, axes_tree), manifest
