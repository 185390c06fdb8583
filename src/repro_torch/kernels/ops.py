"""Kernel entry points with device dispatch: a CUDA tensor goes to the
Hopper kernel, a CPU tensor to the plain PyTorch version.  Nothing falls
back: a failed launch raises.  Attention that needs a gradient goes
through :func:`.flash_attention_bwd.flash_attention_vjp`, whose forward
and backward dispatch the same way; the selective scan that needs a
gradient through :class:`SsmScanFn`, whose forward is the scan's kernel
and whose backward is the scan's backward kernel on the card (their
plain versions on the CPU)."""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .csr_to_dense import ell_to_dense as _ell_to_dense_kernel
from .flash_attention import flash_attention as _flash_attention_kernel
from .flash_attention_bwd import flash_attention_vjp
from .ssm_scan import ssm_scan as _ssm_scan_kernel
from .ssm_scan import ssm_scan_bwd as _ssm_scan_bwd_kernel

__all__ = ["ell_to_dense", "flash_attention", "ssm_scan", "ssm_scan_vjp", "SsmScanFn"]


def ell_to_dense(vals: torch.Tensor, cols: torch.Tensor, *, n_cols: int,
                 log1p: bool = False) -> torch.Tensor:
    """ELL (R, K) -> dense (R, n_cols), or with ``log1p`` its ``log1p``
    (one fused pass on the card); see :func:`.ref.ell_to_dense_ref`."""
    if not isinstance(log1p, bool):
        raise TypeError(f"log1p must be a bool, got {log1p!r}")
    if vals.device.type == "cuda":
        return _ell_to_dense_kernel(vals, cols, n_cols=n_cols, log1p=log1p)
    if vals.device.type == "cpu":
        out = ref.ell_to_dense_ref(vals, cols, n_cols)
        return out.log1p_() if log1p else out
    raise ValueError(f"no ell_to_dense for tensors on {vals.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """(B, H, S, D) attention over (B, Hkv, T, D) keys and values; see
    :func:`.ref.flash_attention_ref`.  With grad enabled and any of q, k,
    v requiring it, the differentiable :func:`flash_attention_vjp`
    (training: ``q_offset`` must be 0)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q_offset != 0:
            raise ValueError(f"the differentiable attention has no q_offset, got {q_offset}")
        return flash_attention_vjp(q, k, v, causal, window)
    if q.device.type == "cuda":
        return _flash_attention_kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    raise ValueError(f"no flash_attention for tensors on {q.device}")


def _scan(x, dt, A, Bc, Cc, D, h0):
    if x.device.type == "cuda":
        return _ssm_scan_kernel(x, dt, A, Bc, Cc, D, h0)
    if x.device.type == "cpu":
        return ref.ssm_scan_ref(x, dt, A, Bc, Cc, D, h0)
    raise ValueError(f"no ssm_scan for tensors on {x.device}")


def _scan_bwd(x, dt, A, Bc, Cc, D, h0, dy, dh_final):
    if x.device.type == "cuda":
        return _ssm_scan_bwd_kernel(x, dt, A, Bc, Cc, D, h0, dy, dh_final)
    if x.device.type == "cpu":
        return ref.ssm_scan_bwd_ref(x, dt, A, Bc, Cc, D, h0, dy, dh_final)
    raise ValueError(f"no ssm_scan backward for tensors on {x.device}")


class SsmScanFn(torch.autograd.Function):
    """The differentiable selective scan: ``(y, h_final)`` of
    :func:`ssm_scan`, its inputs kept for the backward (which recomputes
    the states from ``h0``).  A gradient that reaches neither output
    arrives as None, not as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, D, h0):
        ctx.set_materialize_grads(False)
        y, h_final = _scan(x, dt, A, Bc, Cc, D, h0)
        ctx.save_for_backward(x, dt, A, Bc, Cc, D, h0)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, Bc, Cc, D, h0 = ctx.saved_tensors
        if dy is None and dh_final is None:
            return (None,) * 7
        if dy is None:
            dy = torch.zeros_like(x)
        grads = _scan_bwd(x, dt, A, Bc, Cc, D, h0, dy, dh_final)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def ssm_scan_vjp(x, dt, A, Bc, Cc, D, h0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The differentiable selective scan; the entry point of
    :class:`SsmScanFn`, as :func:`flash_attention_vjp` is of attention's."""
    return SsmScanFn.apply(x, dt, A, Bc, Cc, D, h0)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
             Cc: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan: (y (B, S, D) in ``x.dtype``, h_final (B, D, N)
    float32); see :func:`.ref.ssm_scan_ref`.  With grad enabled and an
    input that requires it, the differentiable :func:`ssm_scan_vjp`
    (training), whose forward launches the same kernel; else the kernel
    alone (serving)."""
    inputs = (x, dt, A, Bc, Cc, D, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return ssm_scan_vjp(*inputs)
    return _scan(*inputs)
