"""Flash attention with a gradient: the port of
``repro.kernels.flash_attention_bwd``.

:class:`FlashAttentionFn` is a ``torch.autograd.Function`` whose forward
keeps only ``(q, k, v, out, lse)``, as ``_vjp_fwd`` does, and whose
backward recomputes the probabilities tile by tile.  On the card its three
pieces are kernels written for Hopper:

- the forward with ``lse``: :func:`.flash_attention.flash_attention_fwd_lse`
  (``csrc/flash_attention.cu``), replacing ``_fwd_kernel``;
- dq: :func:`flash_attention_bwd_dq` (``csrc/flash_attention_bwd.cu``),
  replacing ``_dq_kernel``;
- dk and dv: :func:`flash_attention_bwd_dkv` (the same source), replacing
  ``_dkv_kernel`` and the group sum after it: each work item of 128 keys
  (64 at head_dim 256) of one kv head sums over its query heads in
  registers, so the step is deterministic.

Which backward kernels take which inputs is :func:`route`, a pure function
of type, shape, strides and base addresses (never a trial launch):

- ``"hopper"``: bfloat16 with head_dim 64, 128 or 256, q, k, v and dout
  each addressable by TMA (a 16-byte-aligned base, every stride of an
  axis longer than 1 a multiple of 16 bytes), and at most 2**30 work
  items of each kernel.  The training path's strided (B, S, H, D) views
  are.  Persistent blocks, TMA loads into an mbarrier ring, ``wgmma``
  products, a producer warp and two consumer warpgroups (see the
  source).  At 256 (gemma-7b) dq's key tiles are 32 keys, and dk/dv's
  items are 64 keys whose dV and dK the two consumers split.
- ``"bf16"``: every other bfloat16 input (head_dim 16, 20 or 32 in the
  sweeps and the smoke configs, h2o-danube-3-4b's 120, widths between
  129 and 255; strides TMA refuses, 256 included): ``mma.sync`` on
  64-row tiles, head_dim padded to 32, 64, 128 or 256.
- ``"f32"``: float32, on the CUDA cores in full float32.

The backward kernels take head_dim up to 256, as the forward does:
:func:`check_head_dim` raises on more.  The plain versions on the CPU take
any head_dim.

On the CPU each piece is its plain version
(:func:`~repro_torch.kernels.ref.flash_attention_fwd_lse_ref`,
:func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`), so the CPU tests
run the same autograd wiring as the card.  ``delta = rowsum(dO * O)`` is
one PyTorch expression, as the JAX package computes it outside any Pallas
call.  ``flash_attention_bwd_dq.launches`` and
``flash_attention_bwd_dkv.launches`` count the backward kernels' launches,
whichever route they take; each entry point's ``hopper_launches`` counts
the launches of its Hopper kernel, and the module's ``hopper_launches``
those of both, so a run can show which route its path took.  A wrapper
adds one where it launches and nowhere else.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, ref
from .flash_attention import (
    _DTYPES,
    HOPPER_MAX_ITEMS,
    _tma_ready,
    check_device,
    check_layout,
    empty_like_rows,
    flash_attention_fwd_lse,
    raise_on_error,
)

__all__ = [
    "FlashAttentionFn",
    "flash_attention_vjp",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
    "route",
    "check_head_dim",
    "MAX_HEAD_DIM",
    "HOPPER_HEAD_DIMS",
]

MAX_HEAD_DIM = 256  # the backward kernels' widest tile
DQ_ROWS = 128  # query rows of one work item of the Hopper dq kernel
HOPPER_HEAD_DIMS = (64, 128, 256)

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v dout
    ctypes.c_void_p, ctypes.c_void_p,  # lse, delta
]
_TAIL = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # dtype, dims, strides
    ctypes.c_int, ctypes.c_int, ctypes.c_int64,  # causal, window
    ctypes.c_float, ctypes.c_void_p,  # scale, stream
]
_DIMS = ctypes.c_int64 * 6  # (B, H, Hkv, S, T, D)

hopper_launches = 0  # launches of the Hopper kernels, dq and dk/dv


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded library of
    ``csrc/flash_attention_bwd.cu`` (or of a build of an edited copy)."""
    for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dq_hopper):
        fn.argtypes = [*_ARGS, ctypes.c_void_p, *_TAIL]  # + dq
        fn.restype = ctypes.c_int
    for fn in (lib.flash_attention_bwd_dkv, lib.flash_attention_bwd_dkv_hopper):
        fn.argtypes = [*_ARGS, ctypes.c_void_p, ctypes.c_void_p, *_TAIL]  # + dk, dv
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.load("flash_attention_bwd"))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
          window: Optional[int] = None) -> str:
    """The backward kernels that take these inputs: ``"hopper"``,
    ``"bf16"`` or ``"f32"`` (see the module's docstring).  A pure function
    of type, shape, strides and base addresses: it needs no card, and
    raises where :func:`.flash_attention.check_layout` and
    :func:`check_head_dim` do and on a ``dout`` that does not fit ``q``."""
    check_layout(q, k, v, window)
    check_head_dim(q.shape[3])
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not fit q {tuple(q.shape)}")
    if dout.stride(3) != 1:
        raise ValueError("dout needs a contiguous last axis")
    if q.dtype == torch.float32:
        return "f32"
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    items = max(-(-S // DQ_ROWS) * B * H, -(-T // dkv_keys(D)) * B * Hkv)
    if (D in HOPPER_HEAD_DIMS and items <= HOPPER_MAX_ITEMS
            and all(_tma_ready(t) for t in (q, k, v, dout))):
        return "hopper"
    return "bf16"


def dkv_keys(D: int) -> int:
    """Keys of one work item of the Hopper dk/dv kernel at head_dim ``D``."""
    return 64 if D == 256 else 128


def check_head_dim(D: int) -> None:
    """Raise ``ValueError`` on a head_dim the backward kernels do not take
    (over 256, as the forward)."""
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the backward kernels take head_dim up to {MAX_HEAD_DIM}, got {D}")


def launch(lib: Optional[ctypes.CDLL], dkv: bool, q, k, v, dout, lse, delta, causal: bool,
           window: Optional[int]):
    """Check the inputs, allocate the outputs and launch, from ``lib`` (a
    library bound by :func:`bind`; None: the package's own, built at first
    use), the dq kernel or (``dkv``) the dk/dv kernel that :func:`route`
    names; returns ``(outputs, kernel or None)``, None where an empty shape
    launched nothing.  Counts nothing: the entry points do."""
    kernel = route(q, k, v, dout, window)
    check_device(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if dout.device != q.device:
        raise ValueError(f"dout lies on {dout.device}, q on {q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be ({B}, {H}, {S}) float32 on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outs = (empty_like_rows(k), empty_like_rows(v)) if dkv else (empty_like_rows(q),)
    if outs[0].numel() == 0 or (T if not dkv else S) == 0:
        return tuple(o.zero_() for o in outs), None
    tensors = (q, k, v, dout, *outs)
    strides = (ctypes.c_int64 * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))
    if lib is None:
        lib = _library()
    name = "flash_attention_bwd_dkv" if dkv else "flash_attention_bwd_dq"
    fn = getattr(lib, name + "_hopper" if kernel == "hopper" else name)
    # As flash_attention.launch: the device's raw current stream, and a
    # device guard only for a tensor off the current device.
    device = q.device.index
    guard = (contextlib.nullcontext() if device == torch.cuda.current_device()
             else torch.cuda.device(device))
    with guard:
        err = fn(
            *(t.data_ptr() for t in (q, k, v, dout, lse, delta, *outs)), _DTYPES[q.dtype],
            _DIMS(B, H, Hkv, S, T, D), strides, int(causal), int(window is not None), window or 0,
            1.0 / math.sqrt(D), torch._C._cuda_getCurrentRawStream(device),
        )
    raise_on_error(lib, err, name)
    return outs, kernel


def _count(entry, kernel: Optional[str]) -> None:
    """Add one to ``entry``'s counts for a launch of ``kernel`` (None:
    nothing launched), and to the module's ``hopper_launches`` where it was
    a Hopper kernel."""
    global hopper_launches
    if kernel is None:
        return
    entry.launches += 1
    if kernel == "hopper":
        entry.hopper_launches += 1
        hopper_launches += 1


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """dq (B, H, S, D) in q's type and memory layout, on the card.

    ``q`` (B, H, S, D), ``k``/``v`` (B, Hkv, T, D) and ``dout`` as
    :func:`.flash_attention.flash_attention` takes them; ``lse`` and
    ``delta`` (B, H, S) float32 contiguous.  Raises on anything else.
    """
    (dq,), kernel = launch(None, False, q, k, v, dout, lse, delta, causal, window)
    _count(flash_attention_bwd_dq, kernel)
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.hopper_launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                            window: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Hkv, T, D) in k's type and memory layout, summed
    over the query heads of each kv head, on the card.  Takes what
    :func:`flash_attention_bwd_dq` takes."""
    (dk, dv), kernel = launch(None, True, q, k, v, dout, lse, delta, causal, window)
    _count(flash_attention_bwd_dkv, kernel)
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.hopper_launches = 0


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
