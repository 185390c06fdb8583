"""Flash attention with a gradient: the port of
``repro.kernels.flash_attention_bwd``.

:class:`FlashAttentionFn` is a ``torch.autograd.Function`` whose forward
keeps only ``(q, k, v, out, lse)``, as ``_vjp_fwd`` does, and whose
backward recomputes the probabilities tile by tile.  On the card its three
pieces are Hopper kernels:

- the forward with ``lse``: :func:`.flash_attention.flash_attention_fwd_lse`
  (``csrc/flash_attention.cu``), replacing ``_fwd_kernel``;
- dq: :func:`flash_attention_bwd_dq` (``csrc/flash_attention_bwd.cu``),
  replacing ``_dq_kernel``;
- dk and dv: :func:`flash_attention_bwd_dkv` (the same source), replacing
  ``_dkv_kernel`` and the group sum after it: one block per key tile and kv
  head sums over its query heads in registers, so the step is
  deterministic.

On the CPU each piece is its plain version
(:func:`~repro_torch.kernels.ref.flash_attention_fwd_lse_ref`,
:func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`), so the CPU tests
run the same autograd wiring as the card.  ``delta = rowsum(dO * O)`` is
one PyTorch expression, as the JAX package computes it outside any Pallas
call.  ``flash_attention_bwd_dq.launches`` and
``flash_attention_bwd_dkv.launches`` count the backward kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, ref
from .flash_attention import (
    _DTYPES,
    check_inputs,
    empty_like_rows,
    flash_attention_fwd_lse,
    raise_on_error,
)

__all__ = [
    "FlashAttentionFn",
    "flash_attention_vjp",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
]

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v dout
    ctypes.c_void_p, ctypes.c_void_p,  # lse, delta
]
_TAIL = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # dtype, dims, strides
    ctypes.c_int, ctypes.c_int, ctypes.c_int64,  # causal, window
    ctypes.c_float, ctypes.c_void_p,  # scale, stream
]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd_dq.argtypes = [*_ARGS, ctypes.c_void_p, *_TAIL]  # + dq
    lib.flash_attention_bwd_dq.restype = ctypes.c_int
    lib.flash_attention_bwd_dkv.argtypes = [*_ARGS, ctypes.c_void_p, ctypes.c_void_p, *_TAIL]
    lib.flash_attention_bwd_dkv.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_bwd(q, k, v, dout, lse, delta, window) -> None:
    check_inputs(q, k, v, window)
    B, H, S, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not fit q {tuple(q.shape)}")
    if dout.stride(3) != 1:
        raise ValueError("dout needs a contiguous last axis")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be ({B}, {H}, {S}) float32 on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_args(q, k, v, dout, lse, delta, outs, causal, window):
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    dims = (ctypes.c_int64 * 6)(B, H, Hkv, S, T, D)
    tensors = (q, k, v, dout, *outs)
    strides = (ctypes.c_int64 * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))
    head = [t.data_ptr() for t in (q, k, v, dout, lse, delta, *outs)]
    tail = [_DTYPES[q.dtype], dims, strides, int(causal), int(window is not None), window or 0,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream]
    return head + tail


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """dq (B, H, S, D) in q's type and memory layout, on the card.

    ``q`` (B, H, S, D), ``k``/``v`` (B, Hkv, T, D) and ``dout`` as
    :func:`.flash_attention.flash_attention` takes them; ``lse`` and
    ``delta`` (B, H, S) float32 contiguous.  Raises on anything else.
    """
    _check_bwd(q, k, v, dout, lse, delta, window)
    dq = empty_like_rows(q)
    if dq.numel() == 0 or k.shape[2] == 0:
        return dq.zero_()
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq(
            *_launch_args(q, k, v, dout, lse, delta, (dq,), causal, window))
    raise_on_error(lib, err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                            window: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Hkv, T, D) in k's type and memory layout, summed
    over the query heads of each kv head, on the card.  Takes what
    :func:`flash_attention_bwd_dq` takes."""
    _check_bwd(q, k, v, dout, lse, delta, window)
    dk, dv = empty_like_rows(k), empty_like_rows(v)
    if dk.numel() == 0 or q.shape[2] == 0:
        return dk.zero_(), dv.zero_()
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkv(
            *_launch_args(q, k, v, dout, lse, delta, (dk, dv), causal, window))
    raise_on_error(lib, err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def _forward(q, k, v, causal, window):
    if q.device.type == "cuda":
        return flash_attention_fwd_lse(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return ref.flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash attention for tensors on {q.device}")


def _backward(q, k, v, out, lse, dout, causal, window):
    if q.device.type == "cuda":
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal, window=window)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal, window=window)
        return dq, dk, dv
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    raise ValueError(f"no flash attention for tensors on {q.device}")


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention over (B, H, S, D) queries and
    (B, Hkv, T, D) keys and values, query rows at positions 0..S-1."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention, (B, H, S, D) out; the entry point of
    :class:`FlashAttentionFn`, as ``repro``'s ``flash_attention_vjp`` is of
    its ``custom_vjp``."""
    return FlashAttentionFn.apply(q, k, v, causal, window)
