"""Plain PyTorch versions of the port's kernels: the semantic spec each
kernel is held against, and what the dispatch in :mod:`.ops` runs for
tensors on the CPU."""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["ell_to_dense_ref", "flash_attention_ref"]


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


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention with GQA head-grouping, causal and SWA masks.

    Query head ``h`` reads kv head ``h // (H // Hkv)`` (K and V repeated).
    Query row ``s`` sits at absolute position ``q_offset + s``; key ``t``
    at ``t``.  Scores in float32, masked to -1e30, softmax in float32;
    the probabilities are cast to ``v.dtype`` before P·V.  Returns
    (B, H, S, D) in ``v.dtype``.  A row with no valid key softmaxes over
    -1e30 everywhere: the mean of V.
    """
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    kk = k.repeat_interleave(g, dim=1) if g > 1 else k
    vv = v.repeat_interleave(g, dim=1) if g > 1 else v
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk.float()) / math.sqrt(D)
    qpos = q_offset + torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype), vv)
