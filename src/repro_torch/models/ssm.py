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
- Tensor parallelism: ``w_in``'s output is annotated ``act_dinner``, the
  reference's site.  On DTensors (a ``sharding_context`` on a ("data",
  "model") mesh) each rank runs the convolution, the scan (the kernel on
  its channels) and the gating on its inner channels; the products of
  ``w_x`` contract over the sharded channels, so dt's rank, B and C are
  partial sums, reduced before the scan reads them whole; ``w_out`` is
  row-parallel.  The scan's B and C (and dt's rank) come back to each rank
  whole, so their gradient is a partial sum over the ranks' channels
  (``grad_placements`` ``Partial()``).  The decode state (B, d_in, N) and
  window are sharded on the channels too.

Types: the decode state keeps ``h`` in float32 and the convolution window
in the compute type, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from ..distributed.context import constrain_act
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


def _conv_from(x: torch.Tensor, w: torch.Tensor, conv: Optional[torch.Tensor]):
    """The causal convolution of x (B, S, d_in) by w (K, d_in), continued
    from the window ``conv`` (B, K-1, d_in) where given (else from zeros),
    and the new window (None without ``conv``)."""
    if conv is None:
        return _causal_conv(x, w), None
    full = torch.cat([conv.to(x.dtype), x], dim=1)
    return _causal_conv(full, w)[:, conv.shape[1]:, :], full[:, -(w.shape[0] - 1):, :]


def _dt_b_c(cfg: ModelConfig, xdb: torch.Tensor, w_dt: torch.Tensor, dt_bias: torch.Tensor):
    """The input-dependent step sizes and projections from ``x_proj``'s
    float32 output xdb (..., dt_rank + 2N): dt (..., d_in) float32 after
    softplus, and B, C (..., N) float32 (column slices of xdb: views, not
    copies)."""
    s = cfg.ssm
    dtr = s.resolved_dt_rank(cfg.d_model)
    dt_r, Bc, Cc = torch.split(xdb, [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(einsum("bsr,re->bse", dt_r, w_dt.float()) + dt_bias)
    return dt, Bc, Cc


def _mix(p: dict, cfg: ModelConfig, x: torch.Tensor, z: torch.Tensor,
         state: Optional[dict], project):
    """The mixer between ``w_in`` and ``w_out`` over a sequence: x, z
    (B, S, d_in) the halves of ``w_in``'s output, ``p``'s ``w_conv``,
    ``w_dt``, ``dt_bias``, ``A_log`` and ``D`` on the same channels,
    ``project(xc)`` the float32 ``x_proj`` output of the convolved x,
    ``state`` one layer's ``{"conv", "h"}`` or None -> (y (B, S, d_in)
    gated, the new window, the scan's final h)."""
    xc, new_conv = _conv_from(x, p["w_conv"], None if state is None else state["conv"])
    xc = silu(xc)
    dt, Bc, Cc = _dt_b_c(cfg, project(xc), p["w_dt"], p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_final = ops.ssm_scan(xc, dt, A, Bc, Cc, p["D"],
                              state["h"] if state is not None else None)
    return y * silu(z), new_conv, h_final


def _mix_step(p: dict, cfg: ModelConfig, x: torch.Tensor, z: torch.Tensor, state: dict,
              project):
    """:func:`_mix` for one token x, z (B, 1, d_in) against ``state``
    ``{"conv" (B, K-1, d_in), "h" (B, d_in, N)}``: the recurrence's one
    step -> (y (B, 1, d_in) gated, the new window, the new h)."""
    window = torch.cat([state["conv"].to(x.dtype), x], dim=1)  # (B, K, d_in)
    xc = einsum("bkd,kd->bd", window, p["w_conv"])[:, None, :]
    xc = silu(xc)
    dt, Bc, Cc = _dt_b_c(cfg, project(xc), p["w_dt"], p["dt_bias"])  # (B, 1, d_in), (B, 1, N)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A[None])  # (B, d_in, N)
    dBx = (dt * xc.float())[:, 0, :, None] * Bc[:, 0][:, None, :]
    h_new = dA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h_new, Cc[:, 0])[:, None, :]
    y = y.to(x.dtype) + xc * p["D"][None, None].to(x.dtype)
    return y * silu(z), window[:, 1:, :], h_new


def _projection(p: dict):
    """``x_proj`` on whole channels: the plain path's ``project``."""
    return lambda xc: einsum("bse,ef->bsf", xc, p["w_x"]).float()


_DIN_AXES = ("batch", "seq", "act_dinner")


def ssm_apply(p: dict, cfg: ModelConfig, h: torch.Tensor,
              state: Optional[dict] = None) -> tuple[torch.Tensor, Optional[dict]]:
    """The mixer over a full sequence h (B, S, d_model).  With ``state``
    (``{"conv", "h"}``, one layer's), the convolution continues from its
    window and the scan from its h, and the new state is returned
    (prefill); without, both start from zeros and None is returned."""
    # the output projection is read by a backward only where a norm follows
    # it inside the layer (the hybrid family's norm2): under remat="dots"
    # the reference keeps it there, and drops it in the ssm family, whose
    # layer ends in the residual add
    saveable = cfg.family == "hybrid"
    xz = constrain_act(einsum("bsd,de->bse", h, p["w_in"]), _DIN_AXES)
    if tp.is_dtensor(xz):
        return _ssm_tp(p, cfg, xz, state, _mix, saveable)
    x, z = xz.chunk(2, dim=-1)
    y, new_conv, h_final = _mix(p, cfg, x, z, state, _projection(p))
    out = einsum("bse,ed->bsd", y, p["w_out"], saveable=saveable)
    return out, ({"conv": new_conv, "h": h_final} if state is not None else None)


def ssm_decode_step(p: dict, cfg: ModelConfig, h: torch.Tensor,
                    state: dict) -> tuple[torch.Tensor, dict]:
    """One token h (B, 1, d_model) against one layer's state ``{"conv"
    (B, K-1, d_in), "h" (B, d_in, N)}``: (out (B, 1, d_model), new state)."""
    xz = einsum("bsd,de->bse", h, p["w_in"])
    if tp.is_dtensor(xz):
        return _ssm_tp(p, cfg, constrain_act(xz, _DIN_AXES), state, _mix_step, True)
    x, z = xz.chunk(2, dim=-1)  # (B, 1, d_in)
    y, new_conv, h_new = _mix_step(p, cfg, x, z, state, _projection(p))
    out = einsum("bse,ed->bsd", y, p["w_out"])
    return out, {"conv": new_conv, "h": h_new}


# ------------------------------------------------------------ tensor parallel
def _halves(xz):
    """x and z, each (B, S, d_in) on its own channels: ``xz``'s inner dim
    gathered, cut in two, each half placed by ``act_dinner``."""
    mesh = xz.device_mesh
    whole = [tp.Replicate() if isinstance(q, tp.Shard) and q.dim == 2 else q
             for q in tp.settled(xz.placements)]
    x, z = xz.redistribute(mesh, whole).chunk(2, dim=-1)
    return constrain_act(x, _DIN_AXES), constrain_act(z, _DIN_AXES)


def _state_local(t, pls: list, dims: tuple) -> tuple:
    """A state buffer's shard for a region placed as ``pls`` (x's): the
    buffer's batch dim 0 and channel dim ``dims[1]`` sharded as x's batch
    and channels -> (the shard, its placements)."""
    tgt = []
    for q in pls:
        if isinstance(q, tp.Shard) and q.dim == 0:
            tgt.append(tp.Shard(dims[0]))
        elif isinstance(q, tp.Shard) and q.dim == 2:
            tgt.append(tp.Shard(dims[1]))
        else:
            tgt.append(tp.Replicate())
    return tp.take(t, tgt, {}), tgt


def _ssm_tp(p: dict, cfg: ModelConfig, xz, state: Optional[dict], mix, saveable: bool):
    """``mix`` (:func:`_mix` or :func:`_mix_step`) on each rank's inner
    channels, ``xz`` a DTensor: the halves, the channel weights and the
    state taken on the rank's channels; ``x_proj`` contracts over them, so
    its output is a partial sum, reduced and read whole (its gradient a
    partial sum over the ranks' channels); ``w_out`` row-parallel."""
    x, z = _halves(xz)
    mesh = x.device_mesh
    pls = tp.settled(x.placements)
    split = {n: isinstance(q, tp.Shard) for n, q in zip(mesh.mesh_dim_names, pls)}
    ch = tp.local_range(x.shape[2], mesh, pls, 2)
    rows = [q if isinstance(q, tp.Shard) and q.dim == 0 else tp.Replicate() for q in pls]
    local = {"w_conv": tp.take_weight(p["w_conv"], {1: ch}, split),
             "w_dt": tp.take_weight(p["w_dt"], {1: ch}, split),
             **{k: tp.take_weight(p[k], {0: ch}, split) for k in ("dt_bias", "A_log", "D")}}
    st = placed = None
    if state is not None:
        (conv, conv_pl), (h, h_pl) = (_state_local(state["conv"], pls, (0, 2)),
                                      _state_local(state["h"], pls, (0, 1)))
        st, placed = {"conv": conv, "h": h}, {"conv": conv_pl, "h": h_pl}

    def project(xc: torch.Tensor) -> torch.Tensor:
        xdb = einsum("bse,ef->bsf", tp.wrap(xc, mesh, pls, x.shape), p["w_x"])
        xdb = constrain_act(xdb, ("batch", "seq", "ssm_proj"))
        return tp.take(xdb.float(), rows, split)

    y, new_conv, h_new = mix(local, cfg, tp.take(x, pls, split), tp.take(z, pls, split), st,
                             project)
    out = einsum("bse,ed->bsd", tp.wrap(y, mesh, pls, x.shape), p["w_out"], saveable=saveable)
    if state is None:
        return out, None
    return out, {"conv": tp.wrap(new_conv, mesh, placed["conv"], state["conv"].shape),
                 "h": tp.wrap(h_new, mesh, placed["h"], state["h"].shape)}
