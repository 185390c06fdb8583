"""ELL -> dense on the card: the wrapper of the Hopper kernel
``csrc/ell_to_dense.cu``, which replaces the TPU kernel
``repro.kernels.csr_to_dense.ell_to_dense``.

The kernel gives each (row, 8,192-column tile) one thread block: it zeroes
the tile in shared memory, scatters the row's entries that fall in it with
shared-memory f32 atomics (duplicate columns add up) and writes the tile
once, through an optional ``log1p`` epilogue.  So the work is
O(R·(n_cols + tiles·K)) instead of the TPU's O(R·K·n_cols)
compare-and-accumulate, and it is bound by writing the dense output.  The
plain version is :func:`repro_torch.kernels.ref.ell_to_dense_ref`,
followed by ``log1p_`` for the fused epilogue.

``ell_to_dense.launches`` counts the kernel's launches: the wrapper adds
one where it launches and nowhere else.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["bind", "ell_to_dense", "launch"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument types on a loaded library of
    ``csrc/ell_to_dense.cu`` (or of a build of an edited copy)."""
    ptrs = [ctypes.c_void_p] * 3  # vals, cols, out
    dims = [ctypes.c_int64] * 3  # R, K, n_cols
    lib.ell_to_dense_f32.argtypes = [*ptrs, *dims, ctypes.c_int, ctypes.c_void_p]
    lib.ell_to_dense_rowblock_f32.argtypes = [*ptrs, *dims, ctypes.c_void_p]
    lib.ell_to_dense_f32.restype = lib.ell_to_dense_rowblock_f32.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_build.load("ell_to_dense"))


def _check_inputs(vals: torch.Tensor, cols: torch.Tensor, n_cols: int, log1p: bool,
                  out: Optional[torch.Tensor]) -> None:
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if not isinstance(log1p, bool):
        raise TypeError(f"log1p must be a bool, got {log1p!r}")
    if vals.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(
            f"vals and cols must be (R, K) of one shape, got {tuple(vals.shape)} "
            f"and {tuple(cols.shape)}"
        )
    if not (isinstance(n_cols, int) and n_cols > 0):
        raise ValueError(f"n_cols must be a positive int, got {n_cols!r}")
    if not (vals.is_contiguous() and cols.is_contiguous()):
        raise ValueError("vals and cols must be contiguous")
    # the kernel writes R * n_cols floats from out's first element
    if out is not None and not (out.dtype == torch.float32 and out.is_contiguous()
                                and out.shape == (vals.shape[0], n_cols)
                                and out.device == vals.device):
        raise ValueError(
            f"out must be ({vals.shape[0]}, {n_cols}) float32, contiguous, on {vals.device}; "
            f"got {tuple(out.shape)} {out.dtype} on {out.device}"
            f"{'' if out.is_contiguous() else ', not contiguous'}"
        )
    if vals.device.type != "cuda" or cols.device != vals.device:
        raise ValueError(
            f"the kernel takes tensors on one CUDA device, got {vals.device} and {cols.device}"
        )
    if vals.shape[0] >= 2**31:
        raise ValueError(f"at most 2**31 - 1 rows per launch, got {vals.shape[0]}")


def launch(lib: Optional[ctypes.CDLL], vals: torch.Tensor, cols: torch.Tensor, n_cols: int,
           log1p: bool, out: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, bool]:
    """Check the inputs and launch the kernel from ``lib`` (a library bound
    by :func:`bind`; None: the package's own, built at first use) into
    ``out`` ((R, n_cols) float32, contiguous, on the inputs' device) or a
    new output.  Returns ``(out, launched)``: an empty batch launches
    nothing.  Raises if the launch fails.  Counts nothing:
    :func:`ell_to_dense` does."""
    _check_inputs(vals, cols, n_cols, log1p, out)
    R, K = vals.shape
    if out is None:
        out = torch.empty((R, n_cols), dtype=torch.float32, device=vals.device)
    if R == 0:
        return out, False
    if lib is None:
        lib = _library()
    # The path calls on the current device, where a device guard and a
    # Stream object would cost more host time than the C call: read the
    # device's raw current stream, and enter a guard only for another device.
    device = vals.device.index
    guard = (contextlib.nullcontext() if device == torch.cuda.current_device()
             else torch.cuda.device(device))
    with guard:
        err = lib.ell_to_dense_f32(
            vals.data_ptr(), cols.data_ptr(), out.data_ptr(), R, K, n_cols, int(log1p),
            torch._C._cuda_getCurrentRawStream(device),
        )
    if err != 0:
        raise RuntimeError(
            f"ell_to_dense launch failed: {lib.cuda_error_string(err).decode()} ({err})"
        )
    return out, True


def ell_to_dense(vals: torch.Tensor, cols: torch.Tensor, *, n_cols: int,
                 log1p: bool = False) -> torch.Tensor:
    """Decompress an ELL slab on the card to a dense (R, n_cols) float32
    matrix, or, with ``log1p``, to its ``log1p`` in the same single pass.

    ``vals`` (R, K) float32 and ``cols`` (R, K) int32, both contiguous and
    on one CUDA device; -1 in ``cols`` is padding, and a column outside
    ``[0, n_cols)`` adds nothing.  Raises on any other input: there is no
    fallback to the plain version.
    """
    out, launched = launch(None, vals, cols, n_cols, log1p)
    if launched:
        ell_to_dense.launches += 1
    return out


ell_to_dense.launches = 0
