"""Plain PyTorch versions of the port's kernels: the semantic spec each
kernel is held against, and what the dispatch in :mod:`.ops` runs for
tensors on the CPU."""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "ell_to_dense_ref",
    "flash_attention_ref",
    "flash_attention_fwd_lse_ref",
    "flash_attention_bwd_ref",
    "ssm_scan_ref",
]


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


def _train_mask(S: int, T: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(S, T) bool, True where query ``s`` may see key ``t`` (q_offset 0)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def _expand(x: torch.Tensor, g: int) -> torch.Tensor:
    return x.repeat_interleave(g, dim=1) if g > 1 else x


def flash_attention_fwd_lse_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: ``(out, lse)``.

    ``lse`` (B, H, S) float32 is each row's logsumexp of its visible scaled
    scores, the one residual the backward keeps; ``out`` = exp(S - lse)
    over the visible keys, cast to ``v.dtype``, times V, summed in float32
    and cast to ``v.dtype``.  A row with no visible key (never in
    training: causal rows see themselves) gives zeros and ``lse = -inf``,
    as the kernel does.
    """
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), _expand(k, g).float()) / math.sqrt(D)
    mask = _train_mask(S, T, causal, window, q.device)
    s = s.masked_fill(~mask, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), _expand(v, g).float())
    return out.to(v.dtype), lse


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    out: torch.Tensor,  # (B, H, S, D)
    lse: torch.Tensor,  # (B, H, S) float32
    dout: torch.Tensor,  # (B, H, S, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the training forward, written out from the
    formulas of ``repro.kernels.flash_attention_bwd``::

        p  = exp(q.k^T * scale - lse)   (0 where the mask hides the pair)
        dv = p^T . dO;  dp = dO . v^T;  ds = p * (dp - delta)
        dq = ds . k * scale;  dk = ds^T . q * scale;  delta = rowsum(dO * O)

    with K and V repeated over the GQA group and dk, dv summed back over
    it.  Every sum in float32; results in the inputs' types.
    """
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), _expand(k, g).float(), _expand(v, g).float(), dout.float()
    mask = _train_mask(S, T, causal, window, q.device)
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * out.float()).sum(dim=-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dk = dk.reshape(B, Hkv, g, T, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, g, T, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssm_scan_ref(
    x: torch.Tensor,  # (B, S, D)
    dt: torch.Tensor,  # (B, S, D) float32
    A: torch.Tensor,  # (D, N) float32 (negative)
    Bc: torch.Tensor,  # (B, S, N) float32
    Cc: torch.Tensor,  # (B, S, N) float32
    D: torch.Tensor,  # (D,)
    h0: Optional[torch.Tensor] = None,  # (B, D, N) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 selective scan as a sequential recurrence, state in float32::

        h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
        y_t = C_t . h_t + D * x_t

    as the TPU kernel ``repro.kernels.ssm_scan`` computes it: ``D * x`` is
    added to ``C . h`` in float32 and y is rounded to ``x.dtype`` once.
    (The JAX package's own oracle rounds ``C . h`` to ``x.dtype`` first and
    adds ``x * D`` in ``x.dtype``; in float32 the two agree.)  Zeros stand
    in for an absent ``h0``.  Returns (y (B, S, D) in ``x.dtype``, h_final
    (B, D, N) float32).  Any strides.
    """
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    A, dt, Bc, Cc, xf = A.float(), dt.float(), Bc.float(), Cc.float(), x.float()
    if h0 is None:
        h = torch.zeros((Bsz, Dm, N), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    y = torch.empty((Bsz, S, Dm), dtype=torch.float32, device=x.device)
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)  # (B, D, N)
        dBx = (dt[:, t] * xf[:, t])[:, :, None] * Bc[:, t, None, :]
        h = dA * h + dBx
        y[:, t] = torch.einsum("bdn,bn->bd", h, Cc[:, t])
    y = y + xf * D.float()
    return y.to(x.dtype), h
