"""Error-feedback int8 quantization: the port of
``repro.distributed.compression``, its numpy half and its JAX half (here
on tensors), and a DDP communication hook built on them.

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

The reference's JAX half becomes functions on tensors with the same op
sequence: :func:`quantize_ef` and :func:`dequantize` give the numpy
functions' codes, scales, residuals and values bit for bit, on the CPU and
on the card; :func:`compress_tree` and :func:`decompress_tree` map them
over a tree of nested dicts.  :func:`ef_int8_hook` is a
``DistributedDataParallel`` communication hook for the reference's
documented use (a cross-pod gradient reduction): each rank quantizes its
bucket with error feedback (the residual, per bucket, lives in the hook's
:class:`EFInt8State`), the ranks all-gather codes and scales, and each
rank returns the mean of the dequantized payloads.  Int8 codes under
different scales cannot be summed, so the codes are gathered, never
all-reduced.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = [
    "quantize_ef", "dequantize", "compress_tree", "decompress_tree", "quantize_ef_np",
    "dequantize_np", "EFInt8State", "ef_int8_hook",
]

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


def quantize_ef(g: torch.Tensor, residual: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 codes (N/256, 256), float32 scales (N/256,), float32
    residual of ``g``'s shape), on ``g``'s device.  The residual stays
    float32 whatever ``g``'s type, so that error feedback accumulates at
    the quantizer's precision; it is taken back as it is."""
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual.to(torch.float32)
    flat = gf.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    deq = (q.to(torch.float32) * scale[:, None]).reshape(-1)[: gf.numel()]
    return q, scale, gf - deq.reshape(gf.shape)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    """The values the codes stand for, in ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= d
    flat = (q.to(torch.float32) * scale.to(torch.float32)[:, None]).reshape(-1)
    return flat[:n].reshape(shape).to(dtype)


def compress_tree(grads: Any, residuals: Any = None):
    """Every tensor leaf of a tree of nested dicts quantized; -> (codes,
    scales, residuals) trees of the same structure."""
    if isinstance(grads, Mapping):
        parts = {k: compress_tree(v, None if residuals is None else residuals[k])
                 for k, v in grads.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(3))
    return quantize_ef(grads, residuals)


def decompress_tree(codes: Any, scales: Any, template: Any):
    """``template``'s tree of tensors from ``codes`` and ``scales``, each
    leaf in its template leaf's shape and type."""
    if isinstance(template, Mapping):
        return {k: decompress_tree(codes[k], scales[k], v) for k, v in template.items()}
    return dequantize(codes, scales, tuple(template.shape), template.dtype)


class EFInt8State:
    """:func:`ef_int8_hook`'s state: the process group (None for the
    default) and each bucket's residual, keyed by the bucket's index."""

    def __init__(self, process_group=None):
        self.process_group = process_group
        self.residuals: dict[int, torch.Tensor] = {}


def ef_int8_hook(state: EFInt8State, bucket):  # unannotated: DDP checks annotations
    """DDP communication hook: the bucket's gradients, quantized with error
    feedback, all-gathered as codes and scales, and replaced by the mean
    of every rank's dequantized payload (summed in rank order, then
    divided by the world size, in float32) in the bucket's type.
    Register with ``ddp.register_comm_hook(EFInt8State(group),
    ef_int8_hook)``."""
    group = state.process_group
    world = dist.get_world_size(group)
    grad = bucket.buffer()
    q, scale, state.residuals[bucket.index()] = quantize_ef(grad, state.residuals.get(bucket.index()))
    codes = [torch.empty_like(q) for _ in range(world)]
    scales = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(codes, q, group=group)
    dist.all_gather(scales, scale, group=group)
    total = None
    for c, sc in zip(codes, scales):
        d = dequantize(c, sc, tuple(grad.shape), torch.float32)
        total = d if total is None else total + d
    fut: torch.futures.Future = torch.futures.Future()
    fut.set_result((total / world).to(grad.dtype))
    return fut
