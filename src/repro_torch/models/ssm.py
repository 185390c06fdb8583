"""Mamba-1 selective SSM block (the falcon-mamba mixer): the port of
``repro.models.ssm``.

A full sequence (forward and prefill) runs the selective scan through
:func:`repro_torch.kernels.ops.ssm_scan`: on the card the Hopper kernel,
on the CPU its plain version.  Under autograd (training) the scan is
differentiable: its backward is the scan's backward kernel on the card
and its plain reverse recurrence on the CPU, where the reference
differentiates its jnp scan with ``jax.vjp``.  Decode is a single
recurrence step, ``h' = exp(dt A) h + dt B x`` (O(1) in the sequence
length), in plain tensor code as in the reference: no kernel.

Where the port and the reference compute differently:

- **Rounding of y.**  The reference's model path rounds ``C . h`` to x's
  type per chunk and then adds ``x * D`` in x's type (two roundings); the
  port goes through the kernel's function, which adds ``D * x`` in
  float32 and rounds once, as the TPU kernel does.  In bf16 the port's y
  can differ from the reference model's by a bf16 ulp; in float32 the two
  agree up to the order of sums.
- **Chunking.**  The reference scans ``cfg.ssm.chunk``-step chunks with
  an associative scan inside each (one chunk of S when S is not a
  multiple of it); the port's scan is sequential and takes no chunk.  The
  function is the same (held equal at S = 1, 37 and 300 in
  ``tests/test_torch_ssm.py``).
- **Float32 products.**  dt is computed in float32 with ``w_dt`` cast to
  float32, as in the reference.  The model's entry points
  (:mod:`.transformer`) compute every float32 product in full float32
  whatever the caller's TF32 setting, and leave that setting as they found
  it (:mod:`repro_torch.precision`).  The causal convolution is K
  unrolled multiply-adds, as in the reference, not ``F.conv1d``, whose
  float32 path goes through cuDNN in TF32 by default.
- The sharding annotations (``constrain_act``) are dropped: one device.

Types: the decode state keeps ``h`` in float32 and the convolution window
in the compute type, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import dense_init, einsum, silu

__all__ = ["ssm_init", "ssm_state_init", "ssm_apply", "ssm_decode_step"]


def ssm_init(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """One layer's mixer weights with the reference's shapes, types and
    scales: ``w_in`` (d, 2 d_in), ``w_conv`` (K, d_in) N(0, 1/K), ``w_x``
    (d_in, dt_rank + 2N), ``w_dt`` (dt_rank, d_in), ``w_out`` (d_in, d) at
    1/sqrt(fan-in), in ``param_dtype``; ``dt_bias`` (softplus of it
    log-uniform in [1e-3, 1e-1]), ``A_log`` = log(1..N) per channel and
    ``D`` = 1, in float32.  Drawn from ``generator`` in a fixed order."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dtr = s.resolved_dt_rank(d)
    n = s.d_state
    dt = getattr(torch, cfg.param_dtype)

    def w(shape, scale=None):
        return dense_init(shape, dt, generator, device, scale)

    w_in = w((d, 2 * d_in))
    w_conv = w((s.d_conv, d_in), 1.0 / math.sqrt(s.d_conv))
    w_x = w((d_in, dtr + 2 * n))
    w_dt = w((dtr, d_in))
    u = torch.rand((d_in,), generator=generator, dtype=torch.float32, device=generator.device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    A_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(d_in, 1)
    w_out = w((d_in, d))
    return {"w_in": w_in, "w_conv": w_conv, "w_x": w_x, "w_dt": w_dt,
            "dt_bias": dt_bias.to(device), "A_log": A_log.to(device),
            "D": torch.ones((d_in,), dtype=torch.float32, device=device), "w_out": w_out}


def ssm_state_init(cfg: ModelConfig, batch: int, *, device="cuda") -> dict:
    """One layer's decode state: ``conv`` (B, K-1, d_in) in the compute
    type and ``h`` (B, d_in, N) float32, zeros."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_in),
                                dtype=getattr(torch, cfg.compute_dtype), device=device),
            "h": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32, device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over the sequence: x (B, S, d_in),
    w (K, d_in); ``out[t] = sum_k w[k] x[t - K + 1 + k]`` as K unrolled
    multiply-adds."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + x.shape[1], :] * w[k][None, None, :]
    return out


def _dt_b_c(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The input-dependent step sizes and projections from the convolved
    x: dt (..., d_in) float32 after softplus, and B, C (..., N) float32
    (column slices of one float32 projection: views, not copies)."""
    s = cfg.ssm
    dtr = s.resolved_dt_rank(cfg.d_model)
    xdb = einsum("bse,ef->bsf", x, p["w_x"]).float()
    dt_r, Bc, Cc = torch.split(xdb, [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(einsum("bsr,re->bse", dt_r, p["w_dt"].float()) + p["dt_bias"])
    return dt, Bc, Cc


def ssm_apply(p: dict, cfg: ModelConfig, h: torch.Tensor,
              state: Optional[dict] = None) -> tuple[torch.Tensor, Optional[dict]]:
    """The mixer over a full sequence h (B, S, d_model).  With ``state``
    (``{"conv", "h"}``, one layer's), the convolution continues from its
    window and the scan from its h, and the new state is returned
    (prefill); without, both start from zeros and None is returned."""
    s = cfg.ssm
    xz = einsum("bsd,de->bse", h, p["w_in"])
    x, z = xz.chunk(2, dim=-1)
    if state is not None:
        full = torch.cat([state["conv"].to(x.dtype), x], dim=1)
        new_conv = full[:, -(s.d_conv - 1):, :]
        x = _causal_conv(full, p["w_conv"])[:, state["conv"].shape[1]:, :]
    else:
        new_conv = None
        x = _causal_conv(x, p["w_conv"])
    x = silu(x)
    dt, Bc, Cc = _dt_b_c(p, cfg, x)
    A = -torch.exp(p["A_log"])
    y, h_final = ops.ssm_scan(x, dt, A, Bc, Cc, p["D"],
                              state["h"] if state is not None else None)
    y = y * silu(z)
    # the output projection is read by a backward only where a norm follows
    # it inside the layer (the hybrid family's norm2): under remat="dots"
    # the reference keeps it there, and drops it in the ssm family, whose
    # layer ends in the residual add
    out = einsum("bse,ed->bsd", y, p["w_out"], saveable=cfg.family == "hybrid")
    return out, ({"conv": new_conv, "h": h_final} if state is not None else None)


def ssm_decode_step(p: dict, cfg: ModelConfig, h: torch.Tensor,
                    state: dict) -> tuple[torch.Tensor, dict]:
    """One token h (B, 1, d_model) against one layer's state ``{"conv"
    (B, K-1, d_in), "h" (B, d_in, N)}``: (out (B, 1, d_model), new state)."""
    xz = einsum("bsd,de->bse", h, p["w_in"])
    x, z = xz.chunk(2, dim=-1)  # (B, 1, d_in)
    window = torch.cat([state["conv"].to(x.dtype), x], dim=1)  # (B, K, d_in)
    xc = einsum("bkd,kd->bd", window, p["w_conv"])[:, None, :]
    new_conv = window[:, 1:, :]
    xc = silu(xc)
    dt, Bc, Cc = _dt_b_c(p, cfg, xc)  # (B, 1, d_in), (B, 1, N)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A[None])  # (B, d_in, N)
    dBx = (dt * xc.float())[:, 0, :, None] * Bc[:, 0][:, None, :]
    h_new = dA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h_new, Cc[:, 0])[:, None, :]
    y = y.to(x.dtype) + xc * p["D"][None, None].to(x.dtype)
    y = y * silu(z)
    out = einsum("bse,ed->bsd", y, p["w_out"])
    return out, {"conv": new_conv, "h": h_new}
