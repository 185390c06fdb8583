"""Train-state, train-step and serve-step factories: the port of
``repro.train.step``; the train step and the serve steps for every
family: dense, moe, ssm, hybrid, vlm and encdec.

``make_train_step`` builds ``(state, batch) -> (state, metrics)`` with:

- optional microbatching (gradient accumulation over the leading axis in
  float32, as the reference's ``lax.scan``; memory ∝ 1/n_micro),
- the loss and backward (attention through the Hopper kernels on the card,
  the selective scan through its forward and backward kernels),
- MoE aux-loss weighting: where ``cfg.moe`` is set, the router's load
  balance and z-losses, summed over the MoE layers, join the loss as
  ``moe_lb_weight * lb_loss + moe_z_weight * z_loss``, as in the
  reference,
- the AdamW update (in place),
- metrics as float32 0-d tensors on the device: ``loss``, ``ce_loss``,
  ``z_loss``, ``ppl_proxy``, ``tokens``, ``grad_norm`` and ``lr``, and
  ``moe_lb_loss`` where ``cfg.moe`` is set (averaged over the
  microbatches as the others are).

The state is ``{"params": LM, "opt": AdamWState, "step": int}``; the
reference's is the same tree of arrays.

The rule-sharded step (the reference's ``grad_shardings`` path, ZeRO-2
and FSDP over the "data" mesh axis): :func:`shard_lm` wraps each block and
then the model in FSDP2's ``fully_shard`` on the mesh's "data" dim, each
weight sharded on the dim that ``RULES_TRAIN`` puts on "data" (the
d_model dim, "embed"; dim 0 where it has none), the float32 parameters of
a model in another type whole on every rank, and the state built after
it holds moments placed likewise.  The step sees DTensor parameters and
takes the sharded route: each rank's batch is its share of the global
batch (its own ``shard(rank, world)`` stream), the token count is summed
over the ranks first and each rank divides its sums by it, so the ranks'
losses add up to the global batch's mean as the reference's loss is; the
backward fills the sharded ``.grad`` through FSDP2's reduce-scatter (a
sum: the divide factor is set to 1), AdamW updates each rank's shards
(:mod:`.optimizer`), and the metrics are the global batch's.  The MoE aux
losses enter as the mean of the ranks' (each rank's router statistics are
its own batch's).  FSDP2 gathers a layer's weights as plain tensors before
its forward, so the attention and scan kernels see plain tensors, never a
DTensor.  The sharded route takes one microbatch.

On a ("data", "model") mesh :func:`shard_lm` first places every parameter
on the "model" dim by the rules (tensor and expert parallelism: heads,
mlp, vocabulary, inner channels and experts; a dim the axis does not
divide stays whole), then FSDP2 shards them over "data": torch's FSDP2 x
TP composition.  The step then runs the model inside a
``sharding_context`` on the whole mesh under the step's ``rules``, its
batch tensors DTensors of the global batch (each rank's rows its "data"
shard): the layers' products,
norms and kernels run on each rank's shards
(:mod:`repro_torch.distributed.tensor_parallel`), the loss takes the
vocab-sharded logits without gathering them (:mod:`.loss`), and the
gradients come back placed as the parameters: sharded on "model" where
they are, summed over "model" where a rank read a replicated weight for
its own heads or channels, reduced over "data" by FSDP2, as the
reference's ``grad_shardings`` place them.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ..distributed import tensor_parallel as tp
from ..distributed.context import current_context, sharding_context
from ..distributed.sharding import (
    RULES_TRAIN,
    ShardingRules,
    distribute_params,
    fsdp_placement_fn,
    tp_sharded_dims,
)
from ..models import Model
from ..precision import full_float32_matmul
from .loss import lm_loss
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = [
    "TrainState",
    "make_train_state",
    "make_loss_fn",
    "make_train_step",
    "make_serve_steps",
    "train_state_tree",
    "load_train_state_tree",
    "shard_lm",
]

TrainState = dict  # {"params": LM, "opt": AdamWState, "step": int}


def make_train_state(model: Model, opt_cfg: AdamWConfig, *,
                     generator: Optional[torch.Generator] = None, device="cuda",
                     params=None) -> TrainState:
    """Fresh state: ``params`` (an LM module) or weights drawn by
    ``model.init(generator)``, zero moments, step 0."""
    if params is None:
        params = model.init(generator=generator, device=device)
    return {"params": params, "opt": adamw_init(dict(params.named_parameters()), opt_cfg),
            "step": 0}


def train_state_tree(state: TrainState) -> dict:
    """The state as the checkpoint manager stores it: ``params`` and the
    moments ``opt/m``, ``opt/v`` keyed by parameter name, ``opt/count`` and
    ``step`` as int32, as the reference keeps them.  A sharded state's
    tensors are gathered whole (a collective: every rank of the mesh calls
    it), so a checkpoint holds unsharded arrays whatever the mesh."""
    opt = state["opt"]

    def whole(tensors) -> dict:
        return {k: t.full_tensor() if isinstance(t, DTensor) else t for k, t in tensors}

    return {"params": whole(state["params"].named_parameters()),
            "opt": {"m": whole(opt.m.items()), "v": whole(opt.v.items()),
                    "count": np.int32(opt.count)},
            "step": np.int32(state["step"])}


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` (whole) into ``dst``; into a DTensor's local shard, the
    same shard of ``src``."""
    if isinstance(dst, DTensor):
        src = distribute_tensor(src.to(dst.device), dst.device_mesh, dst.placements).to_local()
        dst = dst.to_local()
    dst.copy_(src)


@torch.no_grad()
def load_train_state_tree(state: TrainState, tree: dict) -> None:
    """Copy a restored :func:`train_state_tree` into ``state`` in place
    (into each rank's shards where the state is sharded)."""
    params = dict(state["params"].named_parameters())
    for name, p in params.items():
        _copy_into(p, tree["params"][name])
    opt = state["opt"]
    for name in params:
        _copy_into(opt.m[name], tree["opt"]["m"][name])
        _copy_into(opt.v[name], tree["opt"]["v"][name])
    opt.count = int(np.asarray(tree["opt"]["count"]).item())
    state["step"] = int(np.asarray(tree["step"]).item())


def make_loss_fn(model: Model, *, moe_lb_weight: float = 0.01, moe_z_weight: float = 1e-3,
                 z_loss_weight: float = 1e-4) -> Callable:
    """The train step's loss: ``loss_fn(lm, batch) -> (total, metrics,
    aux)``, ``aux`` the router's ``{"lb_loss", "z_loss"}`` where
    ``cfg.moe`` is set (weighted into ``total``), else None."""
    cfg = model.cfg

    def loss_fn(lm, batch: dict, count: Optional[torch.Tensor] = None, ranks: int = 1):
        """``count``: the global batch's tokens, on a rank of ``ranks``
        (the aux losses then enter divided by ``ranks``).  Inside a
        ``sharding_context`` (the tensor-parallel forward) the aux losses
        are the global batch's, the same on every rank: each rank's share
        of their value is 1 / ``ranks`` and their whole gradient (it
        reaches each rank's router only through that rank's own
        statistics)."""
        aux = None
        if cfg.moe is None:
            logits = model.forward(lm, batch)
        else:
            logits, aux = model.forward(lm, batch, return_aux=True)
        total, metrics = lm_loss(logits, batch["labels"], batch.get("mask"),
                                 z_loss_weight=z_loss_weight, count=count)
        if aux is not None:
            if ranks > 1 and current_context() is not None:
                aux = {k: v / ranks + (v - v.detach()) * (1 - 1 / ranks) for k, v in aux.items()}
            elif ranks > 1:
                aux = {k: v / ranks for k, v in aux.items()}
            total = total + moe_lb_weight * aux["lb_loss"] + moe_z_weight * aux["z_loss"]
            metrics["moe_lb_loss"] = aux["lb_loss"]
        metrics["loss"] = total
        return total, metrics, aux

    return loss_fn


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    *,
    num_microbatches: int = 1,
    moe_lb_weight: float = 0.01,
    moe_z_weight: float = 1e-3,
    z_loss_weight: float = 1e-4,
    rules: ShardingRules = RULES_TRAIN,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``batch`` holds ``tokens`` and ``labels`` (B, S) and optionally
    ``mask`` (B, S), with ``patch_embeds`` (vlm) or ``frames`` (encdec)
    as :class:`~repro_torch.models.Model` takes them, on the params'
    device; B divisible by ``num_microbatches``.  ``rules``: the rule set
    the parameters were placed by on a ("data", "model") mesh
    (:func:`shard_lm`'s), under which the model's activations are placed;
    the mesh is read from the parameters."""
    loss_fn = make_loss_fn(model, moe_lb_weight=moe_lb_weight, moe_z_weight=moe_z_weight,
                           z_loss_weight=z_loss_weight)

    def single(lm, params: dict, batch: dict):
        # the backward's float32 products in full float32 too, as the forward's
        with torch.enable_grad(), full_float32_matmul():
            total, metrics, _ = loss_fn(lm, batch)
            grads = torch.autograd.grad(total, list(params.values()))
        return dict(zip(params, grads)), {k: v.detach() for k, v in metrics.items()}

    def accumulated(lm, params: dict, batch: dict):
        n = num_microbatches
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by microbatches {n}")
        g_acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        m_acc: dict = {}
        for i in range(n):
            mb = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
            g, m = single(lm, params, mb)
            for k in g_acc:
                g_acc[k] += g[k].float()
            for k, v in m.items():
                m_acc[k] = m_acc.get(k, 0.0) + v.float()
        return ({k: v / n for k, v in g_acc.items()}, {k: v / n for k, v in m_acc.items()})

    def sharded(lm, params: dict, batch: dict):
        """(grads, params) as DTensors on the data mesh (the replicated
        parameters as replicated DTensors over their own storage), and the
        global batch's metrics."""
        if num_microbatches > 1:
            raise ValueError("the rule-sharded step takes one microbatch")
        # the widest parameter mesh: FSDP2's (the kept parameters of the
        # FSDP2 x TP route lie on its "model" submesh)
        mesh = max((p.device_mesh for p in params.values() if isinstance(p, DTensor)),
                   key=lambda m: m.ndim)
        ctx = (mesh, rules) if "model" in mesh.mesh_dim_names else None
        group = mesh.get_group("data") if mesh.ndim > 1 else mesh.get_group()
        ranks = dist.get_world_size(group)
        mask = batch.get("mask")
        count = (mask.float() if mask is not None else
                 torch.ones(batch["labels"].shape, dtype=torch.float32,
                            device=batch["labels"].device)).sum()
        dist.all_reduce(count, group=group)
        with torch.enable_grad(), full_float32_matmul():
            if ctx is None:
                total, metrics, _ = loss_fn(lm, batch, count, ranks)
            else:  # each rank's rows as its "data" shard of the global batch
                rows = [tp.Shard(0) if n == "data" else tp.Replicate()
                        for n in mesh.mesh_dim_names]
                glob = {k: v if k == "mask" else tp.wrap(v, mesh, rows, (v.shape[0] * ranks,
                                                                         *v.shape[1:]))
                        for k, v in batch.items()}
                with sharding_context(*ctx):
                    total, metrics, _ = loss_fn(lm, glob, count, ranks)
            total.backward()
        for p in params.values():
            if ctx is not None and p.grad is not None and not _fsdp_managed(p, mesh):
                # outside FSDP2 (on the "model" dim): settle "model", sum over "data"
                g = p.grad.redistribute(p.device_mesh, p.placements)
                if ranks > 1:
                    dist.all_reduce(g.to_local(), group=group)
                p.grad = g
            elif ranks > 1 and not isinstance(p, DTensor):
                # FSDP2 reduced the shards; sum the whole ones
                dist.all_reduce(p.grad, group=group)
        names = sorted(k for k in metrics if k != "ppl_proxy")
        summed = torch.stack([metrics[k].detach().float() for k in names])
        dist.all_reduce(summed, group=group)  # each rank's share of the global values
        metrics = dict(zip(names, summed.unbind()))
        metrics["ppl_proxy"] = torch.exp(torch.clamp(metrics["ce_loss"], max=20.0))

        def on_mesh(t: torch.Tensor) -> torch.Tensor:
            if isinstance(t, DTensor):
                return t
            return DTensor.from_local(t.detach(), mesh, (Replicate(),), run_check=False)

        return ({k: on_mesh(p.grad) for k, p in params.items()},
                {k: on_mesh(p) for k, p in params.items()}, metrics)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        lm = state["params"]
        params = dict(lm.named_parameters())
        if any(isinstance(p, DTensor) for p in params.values()):
            grads, on_mesh, metrics = sharded(lm, params, batch)
            metrics.update(adamw_update(grads, state["opt"], on_mesh, opt_cfg))
            for p in params.values():
                p.grad = None
            state["step"] += 1
            return state, metrics
        if num_microbatches > 1:
            grads, metrics = accumulated(lm, params, batch)
        else:
            grads, metrics = single(lm, params, batch)
        metrics.update(adamw_update(grads, state["opt"], params, opt_cfg))
        state["step"] += 1
        return state, metrics

    return train_step


def _fsdp_managed(p: torch.Tensor, mesh) -> bool:
    """Whether FSDP2 holds ``p`` (a DTensor on the whole 2-D mesh)."""
    return isinstance(p, DTensor) and p.device_mesh.ndim == mesh.ndim


def shard_lm(model: Model, params: torch.nn.Module, device_mesh,
             rules: ShardingRules = RULES_TRAIN) -> torch.nn.Module:
    """``params`` (the model's module) sharded in place over
    ``device_mesh``'s "data" dim, and returned: each block of its block
    lists, then the model itself, wrapped in FSDP2's ``fully_shard``, each
    parameter in ``cfg.param_dtype`` sharded on the dim that ``rules``
    put on "data" as its spec resolves on that dim (dim 0 where none;
    :func:`~repro_torch.distributed.sharding.fsdp_placement_fn`).  FSDP2
    gathers one dtype a unit, so the parameters the model keeps in float32
    whatever ``param_dtype`` (the norms, the scan's ``dt_bias``, ``A_log``
    and ``D``) stay whole on every rank, as ``RULES_TRAIN`` leaves the
    norms, and the step sums their gradients over the ranks.  The shards'
    reduce-scatter sums (divide factor 1): the step divides by the global
    token count itself.

    On a ("data",) mesh that is the whole route, FSDP2 alone: the model
    runs on the plain tensors FSDP2 gathers.  On a ("data", "model") mesh
    (any "model" size, 1 included: one rank's TP costs DTensor's host
    dispatch, so a mesh that shards nothing on "model" is better left
    without that dim) the
    parameters are first placed on the "model" dim as ``rules`` resolve
    their axes there (:func:`~repro_torch.distributed.sharding.distribute_params`
    on ``device_mesh["model"]``), then sharded over "data" as above: FSDP2
    x TP.  The float32 parameters of a model in another type stay outside
    FSDP2, on the "model" dim (the scan's ``A_log``, ``D`` and
    ``dt_bias`` sharded on its inner channels, the norms whole).  The step
    (:func:`make_train_step`) finds the route by the parameters' mesh and
    takes the same ``rules``."""
    from torch.distributed.fsdp import fully_shard

    names = device_mesh.mesh_dim_names or ()
    if "data" not in names:
        raise ValueError(f"the mesh needs a 'data' dim, has {names}")
    for name in names:
        if name not in ("data", "model") and device_mesh[name].size() > 1:
            raise ValueError(f"mesh dim {name!r} of size {device_mesh[name].size()}: the train "
                             f"step shards over 'data' and 'model'")
    dp = device_mesh if names == ("data",) else device_mesh["data"]
    if "model" in names:
        distribute_params(model, params, rules, device_mesh["model"], contiguous=True)
    dtype = getattr(torch, model.cfg.param_dtype)
    named = dict(params.named_parameters())
    # outside FSDP2: the float32 parameters of a model in another type, and a
    # parameter tensor parallelism shards on every dim (the scan's D and dt_bias)
    kept = {p for p in named.values()
            if p.dtype != dtype or len(tp_sharded_dims(p)) == p.ndim}
    place = fsdp_placement_fn(model.param_axes(), rules, dp,
                              {n: p for n, p in named.items() if p not in kept})
    wrapped = [blk for child in params.children() if isinstance(child, torch.nn.ModuleList)
               for blk in child]
    for module in (*wrapped, params):
        fully_shard(module, mesh=dp, shard_placement_fn=place, ignored_params=kept)
        module.set_gradient_divide_factor(1.0)
        module.set_force_sum_reduction_for_comms(True)  # a plain sum: gloo has no PREMUL_SUM
    return params


def make_serve_steps(model: Model) -> tuple[Callable, Callable]:
    """Returns (prefill_step, decode_step) for any family: dense, moe,
    ssm, hybrid, vlm or encdec.  ``prefill_step`` passes the batch through
    whole (``tokens``, and ``patch_embeds`` or ``frames``); ``decode_step``
    gives the greedy next token (int32), the logits and the cache.  Both
    give whole logits: vocab-sharded ones (the tensor-parallel path) are
    gathered."""

    def prefill_step(params, batch: dict, cache):
        logits, cache = model.prefill(params, batch, cache)
        if isinstance(logits, DTensor):  # vocab-sharded: every rank takes the whole row
            logits = logits.full_tensor()
        return logits, cache

    def decode_step(params, token: torch.Tensor, cache, pos: int):
        logits, new_cache = model.decode(params, token, cache, pos)
        if isinstance(logits, DTensor):  # vocab-sharded: every rank takes the whole row
            logits = logits.full_tensor()
        return logits.argmax(dim=-1).to(torch.int32), logits, new_cache

    return prefill_step, decode_step
