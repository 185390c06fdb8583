"""Plain PyTorch versions of the port's kernels: the semantic spec each
kernel is held against, and what the dispatch in :mod:`.ops` runs for
tensors on the CPU."""
from __future__ import annotations

import torch

__all__ = ["ell_to_dense_ref"]


def ell_to_dense_ref(vals: torch.Tensor, cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """ELL (padded CSR) -> dense.

    ``vals`` (R, K) float; ``cols`` (R, K) int32, -1 = padding.  Columns
    outside ``[0, n_cols)`` add nothing.  Duplicate columns add up in
    float32.  Returns (R, n_cols) in ``vals.dtype``.
    """
    R, K = vals.shape
    valid = (cols >= 0) & (cols < n_cols)
    rows = torch.arange(R, device=vals.device).unsqueeze(1).expand(R, K)
    out = torch.zeros((R, n_cols), dtype=torch.float32, device=vals.device)
    out.index_put_(
        (rows[valid], cols[valid].long()), vals[valid].float(), accumulate=True
    )
    return out.to(vals.dtype)
