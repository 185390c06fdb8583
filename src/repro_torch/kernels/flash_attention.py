"""Flash attention, forward, on the card: the wrappers of the Hopper kernel
``csrc/flash_attention.cu``, which replaces the TPU kernels
``repro.kernels.flash_attention.flash_attention`` (serving:
:func:`flash_attention`) and
``repro.kernels.flash_attention_bwd.flash_attention_fwd_lse`` (training:
:func:`flash_attention_fwd_lse`, which also returns each row's logsumexp).

One thread block per (64-row query tile, batch x query head) walks the
key tiles that its rows can see, with an online softmax in float32: bf16
on the tensor cores (``mma.sync``), float32 on the CUDA cores in full
float32.  K and V stay at their kv-head width (GQA by head index).  The
plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`.

The wrapper takes the JAX kernel's (B, H, S, D) layout and strided views
of it, so the model's (B, S, H, D) projections pass without a copy; only
the last axis must be contiguous.  The output has the memory layout of
``q``.  A row with no valid key gives zeros (see the source).

``flash_attention.launches`` and ``flash_attention_fwd_lse.launches``
count the kernel's launches through each entry point: a wrapper adds one
where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd_lse", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # lse, dtype, dims, strides
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,  # causal, window, q_offset
        ctypes.c_float, ctypes.c_void_p,  # scale, stream
    ]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
    """Raise on any input the kernels do not take (shared by the forward
    and backward wrappers)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, H, S, D) and k, v (B, Hkv, T, D), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {Hkv}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in 1..{MAX_HEAD_DIM}, got {D}")
    if window is not None and (not isinstance(window, int) or window <= 0):
        raise ValueError(f"window must be a positive int or None, got {window!r}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"the kernel takes tensors on one CUDA device, got {q.device}, {k.device}, {v.device}"
        )
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last axis")
    if B * H >= 2**16 or max(S, T) >= 2**31:
        raise ValueError(f"at most 65,535 batch x heads and 2**31 - 1 rows, got {B * H}, {S}, {T}")


def empty_like_rows(x: torch.Tensor) -> torch.Tensor:
    """An output with ``x``'s memory layout (e.g. (B, S, H, D) under a
    (B, H, S, D) view) where that has a contiguous last axis, else
    contiguous."""
    out = torch.empty_like(x)
    if out.stride(3) != 1:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return out


def raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.cuda_error_string(err).decode()} ({err})")


def _launch(q, k, v, causal: bool, window: Optional[int], q_offset: int, with_lse: bool):
    """Check the inputs, allocate the outputs and launch the kernel;
    returns ``(out, lse or None, launched)``, ``launched`` false for an
    empty shape."""
    check_inputs(q, k, v, window)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = empty_like_rows(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    if B * H * S == 0:
        return out, lse, False
    if T == 0:  # no key: every row is empty
        return out.zero_(), None if lse is None else lse.fill_(-math.inf), False
    dims = (ctypes.c_int64 * 6)(B, H, Hkv, S, T, D)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[q.dtype], dims, strides,
            int(causal), int(window is not None), window or 0, int(q_offset),
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream,
        )
    raise_on_error(lib, err, "flash_attention_fwd_lse" if with_lse else "flash_attention")
    return out, lse, True


def flash_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """(B, H, S, D) attention output on the card; GQA via ``Hkv < H``.

    ``q``, ``k`` and ``v`` float32 or bfloat16, all of one type, on one
    CUDA device, with a contiguous last axis and ``D <= 128``.  Query row
    ``s`` sits at absolute position ``q_offset + s``, key ``t`` at ``t``.
    Raises on any other input: there is no fallback to the plain version.
    """
    out, _, launched = _launch(q, k, v, causal, window, q_offset, False)
    if launched:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_fwd_lse(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward on the card: ``(out, lse)``, ``lse`` (B, H, S)
    float32 contiguous, each row's logsumexp of its visible scaled scores
    (-inf for a row with no key).  Query rows at positions 0..S-1.  Takes
    what :func:`flash_attention` takes and raises on anything else; the
    plain version is :func:`repro_torch.kernels.ref.flash_attention_fwd_lse_ref`.

    ``flash_attention_fwd_lse.launches`` counts its launches, apart from
    the serving forward's.
    """
    out, lse, launched = _launch(q, k, v, causal, window, 0, True)
    if launched:
        flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0
