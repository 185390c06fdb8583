"""Full float32 matrix products without touching the caller's setting.

The JAX package computes its float32 products in full float32.  On the
card PyTorch may compute them in TF32 instead (10 bits of mantissa, about
three decimal digits) when the process-wide flag
``torch.backends.cuda.matmul.allow_tf32`` is on, and that flag belongs to
whoever runs the program.  :func:`full_float32_matmul` turns it off for the
products inside it and gives the caller's value back on the way out, on an
exception too.  The flag is global to the process (the autograd engine's
device threads read the same one), so a backward pass inside the block
multiplies in full float32 as well.  Products of other types (bf16, float16)
are not affected by it.

PyTorch has two spellings of the setting: ``allow_tf32`` and the newer
``fp32_precision``, and it raises on reading ``allow_tf32`` once the newer
one was set to something else.  The port sets ``allow_tf32``; only where
reading it raises, because the caller set ``fp32_precision``, does the block
save, set and restore that one instead, so that neither spelling is mixed
into the other's state.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__all__ = ["full_float32_matmul"]


@contextlib.contextmanager
def full_float32_matmul() -> Iterator[None]:
    """Float32 matrix products in full float32 inside the block; the
    caller's setting restored after it.  Also a decorator:
    ``@full_float32_matmul()``."""
    flag = torch.backends.cuda.matmul
    try:
        name, caller, full = "allow_tf32", flag.allow_tf32, False
    except RuntimeError:  # the caller set fp32_precision to disagree with allow_tf32
        name, caller, full = "fp32_precision", flag.fp32_precision, "ieee"
    setattr(flag, name, full)
    try:
        yield
    finally:
        setattr(flag, name, caller)
