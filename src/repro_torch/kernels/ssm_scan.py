"""The Mamba-1 selective scan on the card: the wrapper of the Hopper kernel
``csrc/ssm_scan.cu``, which replaces the TPU kernel
``repro.kernels.ssm_scan.ssm_scan``.

One thread per (batch, channel) walks the whole sequence with its N
states in registers; a block of 128 channels stages each 16-step chunk of
B and C in shared memory once (see the source).  The plain version is
:func:`repro_torch.kernels.ref.ssm_scan_ref`; both add ``D * x`` in
float32 and round y to ``x``'s type once, as the TPU kernel does.

Layouts: ``x``, ``dt``, ``Bc`` and ``Cc`` are read through their strides,
so the model's splits and column slices pass without a copy (any strides,
the last axis included); ``A``, ``D`` and ``h0`` must be contiguous (the
model's are) and are never copied.  ``y`` and ``h_final`` come out
contiguous.

``ssm_scan.launches`` counts the kernel's launches: the wrapper adds one
where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["ssm_scan", "STATE_SIZES", "bind", "launch"]

STATE_SIZES = (4, 16)  # the N compiled in: falcon-mamba-7b's smoke config and its own
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's argument types on a loaded library of
    ``csrc/ssm_scan.cu`` (or of a build of an edited copy)."""
    lib.ssm_scan_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x dt A B
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # C D h0 y
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # h_final dtype dims strides
        ctypes.c_void_p,  # stream
    ]
    lib.ssm_scan_fwd.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.load("ssm_scan"))


def _check_inputs(x, dt, A, Bc, Cc, D, h0) -> None:
    """Raise on any input the kernel does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    named = {"dt": dt, "A": A, "Bc": Bc, "Cc": Cc, "D": D}
    if h0 is not None:
        named["h0"] = h0
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2 or A.shape[0] != x.shape[2]:
        raise ValueError(f"need x, dt (B, S, D) and A (D, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    Bsz, S, Dm = x.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"the state size N must be one of {STATE_SIZES}, got {N}")
    if Bc.shape != (Bsz, S, N) or Cc.shape != (Bsz, S, N):
        raise ValueError(f"need B and C ({Bsz}, {S}, {N}), got {tuple(Bc.shape)}, {tuple(Cc.shape)}")
    if D.shape != (Dm,):
        raise ValueError(f"need D ({Dm},), got {tuple(D.shape)}")
    if h0 is not None and h0.shape != (Bsz, Dm, N):
        raise ValueError(f"need h0 ({Bsz}, {Dm}, {N}), got {tuple(h0.shape)}")
    tensors = [x, *named.values()]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"the kernel takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    for name in ("A", "D", "h0"):
        if name in named and not named[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Bsz >= 2**16:
        raise ValueError(f"at most 65,535 batch rows per launch, got {Bsz}")


def launch(lib: ctypes.CDLL, x, dt, A, Bc, Cc, D, h0, y, h_final) -> None:
    """Launch the kernel of ``lib`` on checked inputs into ``y`` (B, S, D)
    and ``h_final`` (B, D, N), both contiguous; raises if the launch fails."""
    Bsz, S, Dm = x.shape
    dims = (ctypes.c_int64 * 4)(Bsz, S, Dm, A.shape[1])
    strides = (ctypes.c_int64 * 12)(*(s for t in (x, dt, Bc, Cc) for s in t.stride()))
    with torch.cuda.device(x.device):
        err = lib.ssm_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), _DTYPES[x.dtype], dims, strides,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: {lib.cuda_error_string(err).decode()} ({err})")


def ssm_scan(
    x: torch.Tensor,  # (B, S, D) float32 or bf16
    dt: torch.Tensor,  # (B, S, D) float32
    A: torch.Tensor,  # (D, N) float32
    Bc: torch.Tensor,  # (B, S, N) float32
    Cc: torch.Tensor,  # (B, S, N) float32
    D: torch.Tensor,  # (D,) float32
    h0: Optional[torch.Tensor] = None,  # (B, D, N) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, D) in ``x``'s type, h_final (B, D, N) float32) on the card.

    Any S, 0 and 1 included; N one of :data:`STATE_SIZES`; zeros stand in for
    an absent ``h0``.  Raises on any input the kernel does not take (see
    the module's note on layouts): there is no fallback to the plain
    version.
    """
    _check_inputs(x, dt, A, Bc, Cc, D, h0)
    Bsz, S, Dm = x.shape
    y = torch.empty((Bsz, S, Dm), dtype=x.dtype, device=x.device)
    h_final = torch.empty((Bsz, Dm, A.shape[1]), dtype=torch.float32, device=x.device)
    if Bsz * Dm == 0:
        return y, h_final
    launch(_library(), x, dt, A, Bc, Cc, D, h0, y, h_final)
    ssm_scan.launches += 1
    return y, h_final


ssm_scan.launches = 0
