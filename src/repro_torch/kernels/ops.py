"""Kernel entry points with device dispatch: a CUDA tensor goes to the
Hopper kernel, a CPU tensor to the plain PyTorch version.  Nothing falls
back: a failed launch raises."""
from __future__ import annotations

import torch

from . import ref
from .csr_to_dense import ell_to_dense as _ell_to_dense_kernel

__all__ = ["ell_to_dense"]


def ell_to_dense(vals: torch.Tensor, cols: torch.Tensor, *, n_cols: int) -> torch.Tensor:
    """ELL (R, K) -> dense (R, n_cols); see :func:`.ref.ell_to_dense_ref`."""
    if vals.device.type == "cuda":
        return _ell_to_dense_kernel(vals, cols, n_cols=n_cols)
    if vals.device.type == "cpu":
        return ref.ell_to_dense_ref(vals, cols, n_cols)
    raise ValueError(f"no ell_to_dense for tensors on {vals.device}")
