"""Flash attention, forward, on the card: the wrappers of the Hopper kernels
in ``csrc/flash_attention.cu``, which replace the TPU kernels
``repro.kernels.flash_attention.flash_attention`` (serving:
:func:`flash_attention`) and
``repro.kernels.flash_attention_bwd.flash_attention_fwd_lse`` (training:
:func:`flash_attention_fwd_lse`, which also returns each row's logsumexp).

Each block walks the key tiles that its query rows can see, with an
online softmax in float32; K and V stay at their kv-head width (GQA by
head index).  Three kernels, chosen by :func:`route` from the inputs'
type, head_dim, base addresses and strides alone (never by trying one):

- ``"hopper"``: bfloat16 with head_dim 64 or 128, q, k and v each at a
  16-byte-aligned address with every stride of an axis longer than 1 a
  multiple of 16 bytes (what TMA takes), and at most 2**30 blocks of 128
  query rows (ceil(S / 128) x B x H).  Every path shape of smollm-360m is
  one.  Persistent blocks, TMA loads into an mbarrier ring, ``wgmma``
  products, a producer warp and two consumer warpgroups (see the
  source).
- ``"bf16"``: every other bfloat16 input (head_dim 16, 20 or 32 in the
  sweeps and the smoke config; strides TMA refuses): ``mma.sync`` on
  64-row tiles.
- ``"f32"``: float32, on the CUDA cores in full float32.

The plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`.
The wrapper takes the JAX kernel's (B, H, S, D) layout and strided views
of it, so the model's (B, S, H, D) projections pass without a copy; only
the last axis must be contiguous.  The output has the memory layout of
``q``.  A row with no valid key gives zeros (see the source).

``flash_attention.launches`` and ``flash_attention_fwd_lse.launches``
count the launches through each entry point, whichever kernel they take;
the module's ``hopper_launches`` counts the launches of the Hopper
kernel through either, so a run can show which route its path took.  A
wrapper adds one where it launches and nowhere else.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd_lse", "route", "MAX_HEAD_DIM",
           "HOPPER_HEAD_DIMS"]

MAX_HEAD_DIM = 128
HOPPER_HEAD_DIMS = (64, 128)
HOPPER_MAX_ITEMS = 2**30  # blocks of 128 query rows: the kernel's work items
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DIMS, _STRIDES = ctypes.c_int64 * 6, ctypes.c_int64 * 12  # (B, H, Hkv, S, T, D); q, k, v, o

hopper_launches = 0  # launches of the Hopper kernel, through either entry point


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded library of
    ``csrc/flash_attention.cu`` (or of a build of an edited copy)."""
    args = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # lse, dtype, dims, strides
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,  # causal, window, q_offset
        ctypes.c_float, ctypes.c_void_p,  # scale, stream
    ]
    for fn in (lib.flash_attention_fwd, lib.flash_attention_fwd_hopper):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.load("flash_attention"))


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
    """Raise on a type, shape or layout the kernels do not take, on any
    device."""
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    if k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"q, k and v must share a type, got {dtype}, {k.dtype}, {v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(
            f"need q (B, H, S, D) and k, v (B, Hkv, T, D), got {tuple(qs)}, "
            f"{tuple(ks)}, {tuple(v.shape)}"
        )
    B, H, S, D = qs
    _, Hkv, T, _ = ks
    if ks[0] != B or ks[3] != D:
        raise ValueError(f"k, v {tuple(ks)} do not fit q {tuple(qs)}")
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {Hkv}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in 1..{MAX_HEAD_DIM}, got {D}")
    if window is not None and (not isinstance(window, int) or window <= 0):
        raise ValueError(f"window must be a positive int or None, got {window!r}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a contiguous last axis")
    if B * H >= 2**16 or S >= 2**31 or T >= 2**31:
        raise ValueError(f"at most 65,535 batch x heads and 2**31 - 1 rows, got {B * H}, {S}, {T}")


def check_device(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k and v lie on one CUDA device."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"the kernel takes tensors on one CUDA device, got {q.device}, {k.device}, {v.device}"
        )


def _tma_ready(t: torch.Tensor) -> bool:
    """True where TMA can address the bfloat16 ``t``: a 16-byte-aligned
    base, and every stride of an axis longer than 1 a multiple of 8 values
    (16 bytes; an axis of length 1 is never stepped along)."""
    if t.data_ptr() % 16:
        return False
    (s0, s1, s2, _), (n0, n1, n2, _) = t.stride(), t.shape
    return (n0 == 1 or s0 % 8 == 0) and (n1 == 1 or s1 % 8 == 0) and (n2 == 1 or s2 % 8 == 0)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          window: Optional[int] = None) -> str:
    """The kernel that takes these inputs: ``"hopper"``, ``"bf16"`` or
    ``"f32"`` (see the module's docstring).  A pure function of type,
    shape, strides and base addresses: it needs no card, and raises where
    :func:`check_layout` does (on ``window`` too)."""
    check_layout(q, k, v, window)
    if q.dtype == torch.float32:
        return "f32"
    B, H, S, D = q.shape
    if (D in HOPPER_HEAD_DIMS and -(-S // 128) * B * H <= HOPPER_MAX_ITEMS
            and _tma_ready(q) and _tma_ready(k) and _tma_ready(v)):
        return "hopper"
    return "bf16"


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


def launch(lib: Optional[ctypes.CDLL], q, k, v, causal: bool, window: Optional[int],
           q_offset: int, with_lse: bool):
    """Check the inputs, allocate the outputs and launch, from ``lib`` (a
    library bound by :func:`bind`; None: the package's own, built at first
    use), the kernel that :func:`route` names; returns ``(out, lse or None,
    kernel or None)``, None for an empty shape, which launches nothing.
    Counts nothing: the entry points do."""
    check_device(q, k, v)
    kernel = route(q, k, v, window)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = empty_like_rows(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    if B * H * S == 0:
        return out, lse, None
    if T == 0:  # no key: every row is empty
        return out.zero_(), None if lse is None else lse.fill_(-math.inf), None
    dims = _DIMS(B, H, Hkv, S, T, D)
    strides = _STRIDES(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    if lib is None:
        lib = _library()
    fn = lib.flash_attention_fwd_hopper if kernel == "hopper" else lib.flash_attention_fwd
    # The paths call on the current device, where a device guard and a
    # Stream object would cost more host time than the C call: read the
    # device's raw current stream, and enter a guard only for another device.
    device = q.device.index
    guard = (contextlib.nullcontext() if device == torch.cuda.current_device()
             else torch.cuda.device(device))
    with guard:
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[q.dtype], dims, strides,
            int(causal), int(window is not None), window or 0, int(q_offset),
            1.0 / math.sqrt(D), torch._C._cuda_getCurrentRawStream(device),
        )
    raise_on_error(lib, err, "flash_attention_fwd_lse" if with_lse else "flash_attention")
    return out, lse, kernel


def _count(kernel: Optional[str]) -> bool:
    """Add one to ``hopper_launches`` where the Hopper kernel launched;
    True where any kernel launched."""
    global hopper_launches
    if kernel == "hopper":
        hopper_launches += 1
    return kernel is not None


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
    out, _, kernel = launch(None, q, k, v, causal, window, q_offset, False)
    if _count(kernel):
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
    out, lse, kernel = launch(None, q, k, v, causal, window, 0, True)
    if _count(kernel):
        flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0
