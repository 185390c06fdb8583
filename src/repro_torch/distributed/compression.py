"""Error-feedback int8 quantization in numpy: the port of the numpy half of
``repro.distributed.compression``.

:func:`quantize_ef_np` splits an array into blocks of 256 values (the last
one zero-padded), scales each block by its largest magnitude over 127 and
rounds to int8; the residual (what the codes fail to deliver, in float32)
can be fed back into the next call so that the quantization bias does not
accumulate.  :func:`dequantize_np` inverts the codes.  The op sequence is
the reference's: float32 throughout, round-half-to-even, clip to ±127, a
scale floor of 1e-12.  So codes, scales and residual are the reference's bit
for bit, and a payload quantized on either side decodes identically on the
other.  The batch server's ``qint8`` wire codec
(:mod:`repro_torch.serve.data.protocol`) encodes float arrays with it.

The reference's JAX half (``quantize_ef``, ``dequantize``,
``compress_tree``, ``decompress_tree``), which compresses gradient trees for
a cross-pod reduction, has no counterpart here: in the port it becomes a
DDP communication hook (ROADMAP.md queue A #13).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["quantize_ef_np", "dequantize_np"]

_BLOCK = 256


def quantize_ef_np(
    g: np.ndarray, residual: Optional[np.ndarray] = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (int8 codes (N/256, 256), float32 scales (N/256,), float32
    residual of ``g``'s shape).  ``residual`` from the previous call is
    added to ``g`` first."""
    gf = np.asarray(g, dtype=np.float32)
    if residual is not None:
        gf = gf + np.asarray(residual, dtype=np.float32)
    flat = gf.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = np.abs(blocks).max(axis=1, initial=0.0) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.round(blocks / scale[:, None]), -127, 127).astype(np.int8)
    deq = (q.astype(np.float32) * scale[:, None]).reshape(-1)[: gf.size]
    new_residual = (gf - deq.reshape(gf.shape)).astype(np.float32)
    return q, scale, new_residual


def dequantize_np(q: np.ndarray, scale: np.ndarray, shape: tuple, dtype) -> np.ndarray:
    """The values the codes stand for, in ``shape`` and ``dtype``."""
    q = np.asarray(q)
    scale = np.asarray(scale, dtype=np.float32)
    flat = (q.astype(np.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).astype(dtype)
