"""ELL -> dense on the card: the wrapper of the Hopper kernel
``csrc/ell_to_dense.cu``, which replaces the TPU kernel
``repro.kernels.csr_to_dense.ell_to_dense``.

The kernel gives each row one thread block: zero-fill the row, then
scatter its K entries with f32 atomics (duplicate columns add up), so the
work is O(R·(n_cols + K)) instead of the TPU's O(R·K·n_cols)
compare-and-accumulate; it is bound by writing the dense output.  The
plain version is :func:`repro_torch.kernels.ref.ell_to_dense_ref`.

``ell_to_dense.launches`` counts the kernel's launches: the wrapper adds
one where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["ell_to_dense"]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("ell_to_dense")
    lib.ell_to_dense_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.ell_to_dense_f32.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def ell_to_dense(vals: torch.Tensor, cols: torch.Tensor, *, n_cols: int) -> torch.Tensor:
    """Decompress an ELL slab on the card to a dense (R, n_cols) float32 matrix.

    ``vals`` (R, K) float32 and ``cols`` (R, K) int32, both contiguous and
    on one CUDA device; -1 in ``cols`` is padding, and a column outside
    ``[0, n_cols)`` adds nothing.  Raises on any other input: there is no
    fallback to the plain version.
    """
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(
            f"vals and cols must be (R, K) of one shape, got {tuple(vals.shape)} "
            f"and {tuple(cols.shape)}"
        )
    if not (isinstance(n_cols, int) and n_cols > 0):
        raise ValueError(f"n_cols must be a positive int, got {n_cols!r}")
    if not (vals.is_contiguous() and cols.is_contiguous()):
        raise ValueError("vals and cols must be contiguous")
    if vals.device.type != "cuda" or cols.device != vals.device:
        raise ValueError(
            f"the kernel takes tensors on one CUDA device, got {vals.device} and {cols.device}"
        )
    R, K = vals.shape
    if R >= 2**31:
        raise ValueError(f"at most 2**31 - 1 rows per launch, got {R}")
    out = torch.empty((R, n_cols), dtype=torch.float32, device=vals.device)
    if R == 0:
        return out
    lib = _library()
    with torch.cuda.device(vals.device):
        err = lib.ell_to_dense_f32(
            vals.data_ptr(), cols.data_ptr(), out.data_ptr(), R, K, n_cols,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ell_to_dense launch failed: {lib.cuda_error_string(err).decode()} ({err})"
        )
    ell_to_dense.launches += 1
    return out


ell_to_dense.launches = 0
