"""Shared neural building blocks: the port of ``repro.models.layers``.

Plain PyTorch with the JAX package's float32 upcasts (norms, RoPE and
softmax in float32, results cast back to the input type) and its weight
layouts (``wq`` (d, heads, head_dim), ``w_in`` (d, d_ff), ...).
Attention goes through :func:`repro_torch.kernels.ops.flash_attention`:
on the card the Hopper kernel, on the CPU its plain version.  The logical
axes trees of the reference are :func:`.transformer.param_axes` and
``cache_axes``, resolved by :mod:`repro_torch.distributed.sharding`.  The
FFN's activation annotation (``constrain_act`` on ``act_mlp``, the
reference's) is called here.  Given DTensors on a ("data", "model") mesh
(inside a ``sharding_context``), :func:`einsum`, the norms, RoPE,
:func:`attention` and :func:`cached_attention` run as the
tensor-parallel regions of :mod:`repro_torch.distributed.tensor_parallel`:
each rank's products on its shards, each attention kernel on the rank's
query heads; given plain tensors they are the plain code, unchanged.

Activation checkpointing (:func:`remat_call`) follows the reference's
``cfg.remat``: ``"none"`` keeps every activation, ``"full"`` recomputes a
whole block in the backward, ``"dots"`` keeps the block's products that
have no batch dimension and recomputes the rest, as
``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` does.
``torch.einsum`` lowers every product to a ``bmm``, one with no batch
dimension to a ``bmm`` of batch 1, and so does a batched product whose
batch is 1 (an MoE dispatch in one group): the op and its shapes cannot
tell them apart.  So :func:`einsum` reads the equation and marks, for the
thread that runs it, the products that have no batch dimension, and the
policy keeps exactly the ``bmm`` run under that mark.  The products
themselves are ``torch.einsum``'s, the same ops as without the mark.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..distributed import tensor_parallel as tp
from ..distributed.context import constrain_act, current_context, sharding_context
from ..kernels import ops

__all__ = [
    "rmsnorm",
    "layernorm",
    "apply_norm",
    "rope_freqs",
    "rope_tables",
    "apply_rope",
    "apply_rope_tables",
    "attention",
    "cached_attention",
    "mlp_apply",
    "silu",
    "gelu",
    "einsum",
    "has_batch_dim",
    "remat_call",
]

# set while einsum runs a product without a batch dimension, per thread: the
# backward recomputes a block on autograd's device thread
_PRODUCT = threading.local()


def has_batch_dim(eq: str) -> bool:
    """Whether the two-operand product ``eq`` has a batch dimension: an
    index (``...`` counts as one) in both operands and in the output, as
    ``jnp.einsum`` makes it a batch dimension of ``dot_general``."""
    ins, out = eq.replace("...", ".").split("->")
    a, b = ins.split(",")
    return bool(set(a) & set(b) & set(out))


def einsum(eq: str, *xs: torch.Tensor, saveable: bool = True) -> torch.Tensor:
    """``torch.einsum`` after promoting the operands to one type, as
    ``jnp.einsum`` does (torch refuses mixed types).  A product of two
    operands without a batch dimension runs under this thread's mark, which
    :func:`remat_call`'s ``"dots"`` policy reads; ``saveable=False`` leaves
    it unmarked where the backward never reads its output (a block's last
    product, added into the residual stream), which the reference's partial
    evaluation does not keep either."""
    if len(xs) == 2 and tp.is_dtensor(*xs):
        return tp.einsum_tp(eq, *xs, saveable=saveable)
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    xs = tuple(x.to(dt) for x in xs)
    if not saveable or len(xs) != 2 or has_batch_dim(eq):
        return torch.einsum(eq, *xs)
    _PRODUCT.no_batch = True
    try:
        return torch.einsum(eq, *xs)
    finally:
        _PRODUCT.no_batch = False


def _dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """Keep the products :func:`einsum` marks (no batch dimension);
    recompute every other op: batched products (the MoE's experts,
    dispatch and combine), norms, activations and the attention kernels."""
    if func is torch.ops.aten.bmm.default and getattr(_PRODUCT, "no_batch", False):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat: str, fn, *args):
    """``fn(*args)``, under autograd checkpointed as ``remat`` says (the
    reference's ``_remat``): ``"none"`` keeps every activation, ``"dots"``
    keeps the products without a batch dimension and recomputes the rest in
    the backward, anything else (``"full"``) recomputes everything.  ``fn``
    must be pure: it draws nothing, so no RNG state is stashed.  The
    sharding context ``fn`` runs under is taken along into the backward's
    recomputation (which runs after the caller's context has closed, or on
    autograd's device thread)."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    ctx = current_context()
    if ctx is not None:
        inner = fn

        def fn(*a):
            with sharding_context(*ctx):
                return inner(*a)
    kw = {}
    if remat == "dots":  # _dots_policy read at each call, so a test may stand in for it
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


# ----------------------------------------------------------------- norms
def _own(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 as a node of its own: the gradient of a norm's
    several reads of it adds up there before it meets the gradients of
    ``x``'s other readers (the residual stream), in float32 as in bf16
    (where ``.float()`` alone is ``x`` itself), and as it does where a
    tensor-parallel region takes ``x``'s shard."""
    return x.float() if x.dtype != torch.float32 else x.view_as(x)


def rmsnorm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    xf = _own(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    xf = _own(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    norm = rmsnorm if kind == "rmsnorm" else layernorm
    if tp.is_dtensor(x):
        return tp.norm_tp(norm, x, p)
    return norm(x, p)


# ----------------------------------------------------------------- activations
def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTS = {"swiglu": silu, "geglu": gelu}


# ----------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (float(theta) ** exps)  # float32 pow on the device: no host copy


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(sin, cos), each (..., S, 1, D/2) in float32, for positions (..., S):
    computed once and shared by every layer's q and k."""
    inv = rope_freqs(head_dim, theta, device=positions.device)  # (D/2,)
    ang = positions[..., None].float() * inv  # (..., S, D/2)
    return torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]  # broadcast over heads


def apply_rope_tables(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    if tp.is_dtensor(x):  # per head and position: on each rank's heads
        return tp.pointwise(apply_rope_tables, x, sin, cos)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


# ----------------------------------------------------------------- attention
def _expand_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B,T,Hkv,D) -> (B,T,Hq,D) by repeating each kv head G times."""
    hkv = k.shape[2]
    if hkv == num_q_heads:
        return k
    head_map = torch.arange(num_q_heads, device=k.device) // (num_q_heads // hkv)
    return k.index_select(2, head_map)


def attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-softmax attention (float32 softmax, GQA), (B, S, Hq, D) out.

    It stands in for all three of the reference's prefill branches
    (``attention``, ``local_attention`` for a window under S/2 and
    ``chunked_attention`` past 4,096 tokens), which compute one function:
    the kernel skips the tiles a window leaves empty and streams long S
    itself.  The (B, H, S, D) views it passes are strided, not copies.
    DTensors: the kernel on each rank's query heads and the kv heads they
    read (:func:`~repro_torch.distributed.tensor_parallel.attention_tp`).
    """
    if tp.is_dtensor(q, k, v):
        return tp.attention_tp(q, k, v, lambda a, b, c: attention(
            a, b, c, causal=causal, window=window, q_offset=q_offset))
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window, q_offset=q_offset)
    return o.transpose(1, 2)


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Decode's attention, plain tensor code as the reference's: one query
    row (B, 1, Hq, D) over cached (B, T, Hkv, D) keys and values, float32
    scores and softmax, P cast to q's type; ``valid`` (1 or B, T) bool
    masks keys out (None: every key).  A DTensor cache:
    :func:`~repro_torch.distributed.tensor_parallel.cached_attention_tp`."""
    if tp.is_dtensor(q, k, v):
        return tp.cached_attention_tp(q, k, v, valid, cached_attention)
    ke, ve = _expand_kv(k, q.shape[2]), _expand_kv(v, q.shape[2])
    s = _scores(q, ke, valid)
    return einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1).to(q.dtype), ve)


def _scores(q: torch.Tensor, k: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Decode's float32 scores (B, H, 1, T) of the query row q (B, 1, H, D)
    against keys k (B, T, H, D) with a key head per query head, -1e30
    where ``valid`` (1 or B, T) is False."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if valid is not None:
        s = s.masked_fill(~valid[:, None, None, :], -1e30)
    return s


# ----------------------------------------------------------------- MLP
def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    ff_axes = ("batch", "seq", "act_mlp") if x.ndim == 3 else ("batch", "act_mlp")
    if "w_gate" in p:
        h = constrain_act(einsum("...d,df->...f", x, p["w_in"]), ff_axes)
        g = _ACTS[act](einsum("...d,df->...f", x, p["w_gate"]))
        return einsum("...f,fd->...d", h * g, p["w_out"], saveable=False)
    h = constrain_act(gelu(einsum("...d,df->...f", x, p["w_in"])), ff_axes)
    return einsum("...f,fd->...d", h, p["w_out"], saveable=False)


def dense_init(shape: tuple, dtype: torch.dtype, generator: torch.Generator, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Weight of ``shape``: N(0, 1) drawn in float32 on the generator's
    device, times ``scale`` (default 1/sqrt(shape[0]), the fan-in)."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (w * s).to(device=device, dtype=dtype)
