"""Train-state, train-step and serve-step factories: the port of
``repro.train.step``; the train step for the dense, moe, vlm and encdec
families (the ssm and hybrid families raise in their forward under a
gradient, ROADMAP.md queue A #9), the serve steps for every family.

``make_train_step`` builds ``(state, batch) -> (state, metrics)`` with:

- optional microbatching (gradient accumulation over the leading axis in
  float32, as the reference's ``lax.scan``; memory ∝ 1/n_micro),
- the loss and backward (attention through the Hopper kernels on the card),
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
reference's is the same tree of arrays.  The ZeRO-2 gradient shardings
have no counterpart here (one device).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

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
    ``step`` as int32, as the reference keeps them."""
    opt = state["opt"]
    return {"params": dict(state["params"].named_parameters()),
            "opt": {"m": dict(opt.m), "v": dict(opt.v), "count": np.int32(opt.count)},
            "step": np.int32(state["step"])}


@torch.no_grad()
def load_train_state_tree(state: TrainState, tree: dict) -> None:
    """Copy a restored :func:`train_state_tree` into ``state`` in place."""
    params = dict(state["params"].named_parameters())
    for name, p in params.items():
        p.copy_(tree["params"][name])
    opt = state["opt"]
    for name in params:
        opt.m[name].copy_(tree["opt"]["m"][name])
        opt.v[name].copy_(tree["opt"]["v"][name])
    opt.count = int(np.asarray(tree["opt"]["count"]).item())
    state["step"] = int(np.asarray(tree["step"]).item())


def make_loss_fn(model: Model, *, moe_lb_weight: float = 0.01, moe_z_weight: float = 1e-3,
                 z_loss_weight: float = 1e-4) -> Callable:
    """The train step's loss: ``loss_fn(lm, batch) -> (total, metrics,
    aux)``, ``aux`` the router's ``{"lb_loss", "z_loss"}`` where
    ``cfg.moe`` is set (weighted into ``total``), else None."""
    cfg = model.cfg

    def loss_fn(lm, batch: dict):
        aux = None
        if cfg.moe is None:
            logits = model.forward(lm, batch)
        else:
            logits, aux = model.forward(lm, batch, return_aux=True)
        total, metrics = lm_loss(logits, batch["labels"], batch.get("mask"),
                                 z_loss_weight=z_loss_weight)
        if aux is not None:
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
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``batch`` holds ``tokens`` and ``labels`` (B, S) and optionally
    ``mask`` (B, S), with ``patch_embeds`` (vlm) or ``frames`` (encdec)
    as :class:`~repro_torch.models.Model` takes them, on the params'
    device; B divisible by ``num_microbatches``."""
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

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        lm = state["params"]
        params = dict(lm.named_parameters())
        if num_microbatches > 1:
            grads, metrics = accumulated(lm, params, batch)
        else:
            grads, metrics = single(lm, params, batch)
        metrics.update(adamw_update(grads, state["opt"], params, opt_cfg))
        state["step"] += 1
        return state, metrics

    return train_step


def make_serve_steps(model: Model) -> tuple[Callable, Callable]:
    """Returns (prefill_step, decode_step) for any family: dense, moe,
    ssm, hybrid, vlm or encdec.  ``prefill_step`` passes the batch through
    whole (``tokens``, and ``patch_embeds`` or ``frames``); ``decode_step``
    gives the greedy next token (int32), the logits and the cache."""

    def prefill_step(params, batch: dict, cache):
        return model.prefill(params, batch, cache)

    def decode_step(params, token: torch.Tensor, cache, pos: int):
        logits, new_cache = model.decode(params, token, cache, pos)
        return logits.argmax(dim=-1).to(torch.int32), logits, new_cache

    return prefill_step, decode_step
