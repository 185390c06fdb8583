"""Parameters and optimizer state of the JAX package, as the port's.

The JAX probe keeps its heads as ``{task: {"w": (n_genes, classes), "b":
(classes,)}}`` and Adam's state as ``{"m": heads-tree, "v": heads-tree,
"count": int}``.  Passed as numpy arrays, they become a
:class:`~repro_torch.train.probe.ProbeHeads` and an
:class:`~repro_torch.train.probe.AdamState` with equal values, so both
packages can start from the same point.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .train.probe import TASKS, AdamState, LinearHead, ProbeHeads

__all__ = ["heads_from_jax", "adam_from_jax"]


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _check_tree(tree: Mapping, what: str) -> None:
    if set(tree) != set(TASKS):
        raise ValueError(f"{what}: need tasks {sorted(TASKS)}, got {sorted(tree)}")
    for t, c in TASKS.items():
        w, b = np.shape(tree[t]["w"]), np.shape(tree[t]["b"])
        if len(w) != 2 or w[1] != c or b != (c,):
            raise ValueError(f"{what}[{t!r}]: w {w} and b {b} do not fit {c} classes")


def heads_from_jax(heads_np: Mapping, *, device="cuda") -> ProbeHeads:
    """``{task: {"w", "b"}}`` numpy arrays -> :class:`ProbeHeads` on ``device``."""
    _check_tree(heads_np, "heads")
    return ProbeHeads({
        t: LinearHead(_f32(heads_np[t]["w"], device), _f32(heads_np[t]["b"], device))
        for t in TASKS
    })


def adam_from_jax(opt_np: Mapping, *, device="cuda") -> AdamState:
    """``{"m", "v", "count"}`` numpy trees -> :class:`AdamState` on ``device``,
    keyed like ``ProbeHeads.named_parameters()``."""
    moments = {}
    for key in ("m", "v"):
        _check_tree(opt_np[key], key)
        moments[key] = {
            f"heads.{t}.{p}": _f32(opt_np[key][t][p], device) for t in TASKS for p in ("w", "b")
        }
    return AdamState(m=moments["m"], v=moments["v"], count=int(opt_np["count"]))
