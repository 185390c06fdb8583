"""Kernel entry points with device dispatch: a CUDA tensor goes to the
Hopper kernel, a CPU tensor to the plain PyTorch version.  Nothing falls
back: a failed launch raises.  Attention that needs a gradient goes
through :func:`.flash_attention_bwd.flash_attention_vjp`, whose forward
and backward dispatch the same way; the selective scan that needs a
gradient through :class:`SsmScanFn`, whose forward is the scan's kernel
and whose backward is the scan's backward kernel on the card (their
plain versions on the CPU).

No DTensor reaches a kernel: a DTensor reports its mesh's device while
its ``data_ptr`` is its local shard's, not the whole tensor's, so a launch
would read the wrong memory.  Every dispatcher here raises ``TypeError``
naming the op for one, and never gathers it quietly.  Under FSDP2 (the
rule-sharded train step) a layer's weights are gathered before its
forward, so the kernels see plain activations."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from . import ref
from .csr_to_dense import ell_to_dense as _ell_to_dense_kernel
from .flash_attention import flash_attention as _flash_attention_kernel
from .flash_attention_bwd import flash_attention_vjp
from .ssm_scan import ssm_scan as _ssm_scan_kernel
from .ssm_scan import bwd_route as _ssm_scan_bwd_route
from .ssm_scan import ssm_scan_bwd as _ssm_scan_bwd_kernel
from .ssm_scan import ssm_scan_train as _ssm_scan_train_kernel

__all__ = ["ell_to_dense", "flash_attention", "ssm_scan", "ssm_scan_vjp", "SsmScanFn"]


def _plain(op: str, *tensors) -> None:
    """Raises ``TypeError`` if any of ``tensors`` is a DTensor."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{op} takes plain tensors, got a DTensor: the kernel would read its "
                        f"local shard as the whole tensor (gather it with full_tensor() or "
                        f"pass its to_local() shard deliberately)")


def ell_to_dense(vals: torch.Tensor, cols: torch.Tensor, *, n_cols: int,
                 log1p: bool = False) -> torch.Tensor:
    """ELL (R, K) -> dense (R, n_cols), or with ``log1p`` its ``log1p``
    (one fused pass on the card); see :func:`.ref.ell_to_dense_ref`."""
    _plain("ell_to_dense", vals, cols)
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
    _plain("flash_attention", q, k, v)
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


def _scan_train(x, dt, A, Bc, Cc, D, h0):
    """(y, h_final, the backward's checkpoints or None)."""
    if x.device.type == "cuda":
        return _ssm_scan_train_kernel(x, dt, A, Bc, Cc, D, h0)
    return (*_scan(x, dt, A, Bc, Cc, D, h0), None)


def _scan_bwd(x, dt, A, Bc, Cc, D, h0, dy, dh_final, ckpt=None):
    if x.device.type == "cuda":
        return _ssm_scan_bwd_kernel(x, dt, A, Bc, Cc, D, h0, dy, dh_final, ckpt)
    if x.device.type == "cpu":
        return ref.ssm_scan_bwd_ref(x, dt, A, Bc, Cc, D, h0, dy, dh_final)
    raise ValueError(f"no ssm_scan backward for tensors on {x.device}")


class SsmScanFn(torch.autograd.Function):
    """The differentiable selective scan: ``(y, h_final)`` of
    :func:`ssm_scan`, its inputs kept for the backward, and on the card's
    hopper route the state at the start of every 8-step segment, which the
    forward writes (``ssm_scan_train``) and the backward's hopper kernel
    recomputes the states from (N / 2 B S D bytes a layer, 8 B S D at N 16,
    held from the layer's forward to its backward: for every Mamba layer at
    once under ``remat="none"``; elsewhere the strided backward recomputes
    the states from ``h0``).  A gradient that reaches neither output
    arrives as None, not as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, D, h0):
        _plain("ssm_scan_vjp", x, dt, A, Bc, Cc, D, h0)
        ctx.set_materialize_grads(False)
        y, h_final, ckpt = _scan_train(x, dt, A, Bc, Cc, D, h0)
        ctx.save_for_backward(x, dt, A, Bc, Cc, D, h0, ckpt)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, Bc, Cc, D, h0, ckpt = ctx.saved_tensors
        if dy is None and dh_final is None:
            return (None,) * 7
        _plain("ssm_scan_vjp's backward", dy, dh_final)
        if dy is None:
            dy = torch.zeros_like(x)
        if ckpt is not None and _ssm_scan_bwd_route(x, dt, Bc, Cc, dy) != "hopper":
            ckpt = None  # a dy the hopper route does not take: the strided kernel recomputes
        grads = _scan_bwd(x, dt, A, Bc, Cc, D, h0, dy, dh_final, ckpt)
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
    _plain("ssm_scan", *inputs)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return ssm_scan_vjp(*inputs)
    return _scan(*inputs)
