"""Parameters and optimizer state of the JAX package, as the port's.

The LM: ``repro``'s params tree (numpy leaves, blocks stacked on a leading
layer axis) becomes the port's :class:`~repro_torch.models.transformer.LM`
(or, for the encdec family, :class:`~repro_torch.models.encdec.EncDec`),
one block per layer, each weight in its own layout (:func:`lm_from_jax`);
``repro``'s LM train state (params, AdamW moments, count and step) becomes
the port's (:func:`train_state_from_jax`).

The JAX probe keeps its heads as ``{task: {"w": (n_genes, classes), "b":
(classes,)}}`` and Adam's state as ``{"m": heads-tree, "v": heads-tree,
"count": int}``.  Passed as numpy arrays, they become a
:class:`~repro_torch.train.probe.ProbeHeads` and an
:class:`~repro_torch.train.probe.AdamState` with equal values, so both
packages can start from the same point.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .models.config import ModelConfig
from .models.encdec import EncDec
from .models.transformer import LM, Block, check_family, stack_period
from .train.optimizer import AdamWState
from .train.probe import TASKS, AdamState, LinearHead, ProbeHeads

__all__ = ["heads_from_jax", "adam_from_jax", "lm_from_jax", "train_state_from_jax"]


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy leaf (float32, or ``ml_dtypes`` bfloat16 as JAX gives it)
    as a tensor of ``dtype`` on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def _check_tree(tree: Mapping, what: str) -> None:
    if set(tree) != set(TASKS):
        raise ValueError(f"{what}: need tasks {sorted(TASKS)}, got {sorted(tree)}")
    for t, c in TASKS.items():
        w, b = np.shape(tree[t]["w"]), np.shape(tree[t]["b"])
        if len(w) != 2 or w[1] != c or b != (c,):
            raise ValueError(f"{what}[{t!r}]: w {w} and b {b} do not fit {c} classes")


def heads_from_jax(heads_np: Mapping, *, device="cuda") -> ProbeHeads:
    """``{task: {"w", "b"}}`` numpy arrays -> :class:`ProbeHeads` on ``device``."""
    _check_tree(heads_np, "heads")
    return ProbeHeads({
        t: LinearHead(_tensor(heads_np[t]["w"], torch.float32, device),
                      _tensor(heads_np[t]["b"], torch.float32, device))
        for t in TASKS
    })


def adam_from_jax(opt_np: Mapping, *, device="cuda") -> AdamState:
    """``{"m", "v", "count"}`` numpy trees -> :class:`AdamState` on ``device``,
    keyed like ``ProbeHeads.named_parameters()``."""
    moments = {}
    for key in ("m", "v"):
        _check_tree(opt_np[key], key)
        moments[key] = {
            f"heads.{t}.{p}": _tensor(opt_np[key][t][p], torch.float32, device)
            for t in TASKS for p in ("w", "b")
        }
    return AdamState(m=moments["m"], v=moments["v"], count=int(opt_np["count"]))


def _expect(tree: Mapping, shapes: dict, where: str) -> None:
    if not isinstance(tree, Mapping) or set(tree) != set(shapes):
        got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
        raise ValueError(f"{where}: need keys {sorted(shapes)}, got {got}")
    for k, shape in shapes.items():
        if isinstance(shape, dict):
            _expect(tree[k], shape, f"{where}/{k}")
        elif tuple(np.shape(tree[k])) != shape:
            raise ValueError(f"{where}/{k}: need shape {shape}, got {tuple(np.shape(tree[k]))}")


# the ssm mixer's weights that the reference keeps in float32 whatever
# param_dtype (repro/models/ssm.py: dt_bias, A_log, D)
_SSM_FLOAT32 = ("dt_bias", "A_log", "D")


def _ssm_shapes(cfg: ModelConfig, L: int) -> dict:
    s, d = cfg.ssm, cfg.d_model
    d_in, dtr, n = s.expand * d, s.resolved_dt_rank(d), s.d_state
    return {"w_in": (L, d, 2 * d_in), "w_conv": (L, s.d_conv, d_in),
            "w_x": (L, d_in, dtr + 2 * n), "w_dt": (L, dtr, d_in), "dt_bias": (L, d_in),
            "A_log": (L, d_in, n), "D": (L, d_in), "w_out": (L, d_in, d)}


def _ffn_shapes(cfg: ModelConfig, layers: range) -> tuple[str, dict]:
    """The FFN group of ``layers``, one position of the period stacked in
    the tree (``sub_i``), ``mlp`` or ``moe``, and its shapes.  A stack
    holds one kind, so a position whose layers mix them has none."""
    L, d, ff = len(layers), cfg.d_model, cfg.d_ff
    kinds = {cfg.is_moe_layer(i) for i in layers}
    if len(kinds) != 1:
        raise ValueError(f"{cfg.name}: layers mix MoE and MLP, which one stacked tree cannot hold")
    gated = cfg.act in ("swiglu", "geglu")
    if kinds.pop():
        E = cfg.moe.num_experts
        moe = {"router": (L, d, E), "w_in": (L, E, d, ff), "w_out": (L, E, ff, d)}
        if gated:
            moe["w_gate"] = (L, E, d, ff)
        return "moe", moe
    mlp = {"w_in": (L, d, ff), "w_out": (L, ff, d)}
    if gated:
        mlp["w_gate"] = (L, d, ff)
    return "mlp", mlp


def _norm_shapes(cfg: ModelConfig, L: int = 0) -> dict:
    """A norm's shapes, stacked over ``L`` layers where L > 0."""
    lead = (L,) if L else ()
    keys = ("scale",) if cfg.norm == "rmsnorm" else ("scale", "bias")
    return {k: (*lead, cfg.d_model) for k in keys}


def _attn_shapes(cfg: ModelConfig, L: int) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {"wq": (L, d, hq, hd), "wk": (L, d, hkv, hd), "wv": (L, d, hkv, hd),
            "wo": (L, hq, hd, d)}


def _blocks(stacked: Mapping, groups: Mapping, L: int, wdt: torch.dtype, device) -> list[Block]:
    """One :class:`Block` per layer of the stacked tree ``stacked``: each
    group of ``groups`` sliced at the layer; the norms, and the ssm's
    ``dt_bias``, ``A_log`` and ``D``, float32, the rest ``wdt``."""
    def layer(group: str, i: int) -> dict:
        def dtype(k: str) -> torch.dtype:
            if group.startswith("norm") or (group == "ssm" and k in _SSM_FLOAT32):
                return torch.float32
            return wdt

        return {k: _tensor(np.asarray(a)[i], dtype(k), device) for k, a in stacked[group].items()}

    return [Block(**{g: layer(g, i) for g in groups}) for i in range(L)]


def _encdec_from_jax(params_np: Mapping, cfg: ModelConfig, device) -> EncDec:
    L, Ld = cfg.num_layers, cfg.decoder_layers

    def mlp(n: int) -> dict:
        shapes = {"w_in": (n, cfg.d_model, cfg.d_ff), "w_out": (n, cfg.d_ff, cfg.d_model)}
        if cfg.act in ("swiglu", "geglu"):
            shapes["w_gate"] = (n, cfg.d_model, cfg.d_ff)
        return shapes

    enc = {"norm1": _norm_shapes(cfg, L), "attn": _attn_shapes(cfg, L),
           "norm2": _norm_shapes(cfg, L), "mlp": mlp(L)}
    dec = {"norm1": _norm_shapes(cfg, Ld), "self_attn": _attn_shapes(cfg, Ld),
           "norm_x": _norm_shapes(cfg, Ld), "cross_attn": _attn_shapes(cfg, Ld),
           "norm2": _norm_shapes(cfg, Ld), "mlp": mlp(Ld)}
    _expect(params_np, {"embed": (cfg.vocab_size, cfg.d_model), "enc_final_norm": _norm_shapes(cfg),
                        "dec_final_norm": _norm_shapes(cfg), "enc_blocks": enc,
                        "dec_blocks": dec}, "params")
    wdt = getattr(torch, cfg.param_dtype)

    def norm(name: str) -> dict:
        return {k: _tensor(a, torch.float32, device) for k, a in params_np[name].items()}

    return EncDec(cfg, _tensor(params_np["embed"], wdt, device), norm("enc_final_norm"),
                  norm("dec_final_norm"), _blocks(params_np["enc_blocks"], enc, L, wdt, device),
                  _blocks(params_np["dec_blocks"], dec, Ld, wdt, device))


def _position_shapes(cfg: ModelConfig, i: int, layers: range) -> dict:
    """The groups of position ``i`` of the period, stacked over ``layers``:
    ``norm1`` and the mixer (``attn`` or ``ssm``), then, outside the ssm
    family, ``norm2`` and the FFN (``mlp`` or ``moe``)."""
    n = len(layers)
    if cfg.family == "ssm":
        return {"norm1": _norm_shapes(cfg, n), "ssm": _ssm_shapes(cfg, n)}
    mixer = ("attn", _attn_shapes(cfg, n)) if cfg.is_attn_layer(i) else ("ssm", _ssm_shapes(cfg, n))
    ffn, ffn_shapes = _ffn_shapes(cfg, layers)
    return {"norm1": _norm_shapes(cfg, n), mixer[0]: mixer[1], "norm2": _norm_shapes(cfg, n),
            ffn: ffn_shapes}


def lm_from_jax(params_np: Mapping, cfg: ModelConfig, *, device="cuda"):
    """``repro``'s params tree as numpy arrays -> the port's LM (dense,
    moe, ssm, hybrid or vlm family) or EncDec (encdec).

    The tree is ``embed`` (vocab, d), ``lm_head`` (d, vocab) unless the
    embeddings are tied, ``final_norm``, and ``blocks/sub_0``, each leaf
    stacked (layers, ...): dense ``norm1``, ``attn`` {wq, wk, wv, wo},
    ``norm2`` and ``mlp`` {w_in, w_gate, w_out}; moe the same with ``moe``
    {router (d, E), w_in, w_gate (E, d, ff), w_out (E, ff, d)} in place of
    ``mlp``; ssm ``norm1`` and ``ssm`` {w_in, w_conv, w_x, w_dt, dt_bias,
    A_log, D, w_out}; vlm the dense tree; hybrid one tree per position i
    of the period P (``attn_period``), ``blocks/sub_i``, each leaf stacked
    (num_layers / P, ...), ``attn`` or ``ssm`` and ``mlp`` or ``moe`` as
    layer i's kinds: entry s of ``sub_i`` becomes layer s·P + i.  The
    reference's tree holds whole periods only, so a hybrid config whose
    ``num_layers`` is not a multiple of P raises ``ValueError``, as the
    reference's ``init_lm`` does.  The encdec tree is ``embed``
    (tied), ``enc_final_norm``, ``dec_final_norm``, ``enc_blocks`` {norm1,
    attn, norm2, mlp {w_in, w_out}} stacked (num_layers, ...) and
    ``dec_blocks`` {norm1, self_attn, norm_x, cross_attn, norm2, mlp}
    stacked (decoder_layers, ...).  Each layer becomes one block; each
    weight keeps its layout (``wq`` stays (d, heads, head_dim)) and takes
    ``cfg.param_dtype``, the norms and the ssm's ``dt_bias``, ``A_log``
    and ``D`` float32, as in the reference.  Raises ``ValueError`` on a
    missing or extra key or a wrong shape.
    """
    check_family(cfg)
    if cfg.family == "encdec":
        return _encdec_from_jax(params_np, cfg, device)
    L, d, P = cfg.num_layers, cfg.d_model, stack_period(cfg)
    if L % P:
        raise ValueError(f"{cfg.name}: num_layers {L} % period {P} != 0")
    positions = {i: _position_shapes(cfg, i, range(i, L, P)) for i in range(P)}
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": _norm_shapes(cfg),
              "blocks": {f"sub_{i}": g for i, g in positions.items()}}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    _expect(params_np, shapes, "params")

    wdt = getattr(torch, cfg.param_dtype)
    stacks = [_blocks(params_np["blocks"][f"sub_{i}"], g, L // P, wdt, device)
              for i, g in positions.items()]
    blocks = [stacks[layer % P][layer // P] for layer in range(L)]
    final_norm = {k: _tensor(a, torch.float32, device) for k, a in params_np["final_norm"].items()}
    lm_head = None if cfg.tie_embeddings else _tensor(params_np["lm_head"], wdt, device)
    return LM(cfg, _tensor(params_np["embed"], wdt, device), final_norm, blocks, lm_head)


def train_state_from_jax(state_np: Mapping, cfg: ModelConfig, *, device="cuda") -> dict:
    """``repro``'s ``make_train_state`` tree as numpy arrays -> the port's
    train state ``{"params": LM, "opt": AdamWState, "step": int}``.

    ``params`` goes through :func:`lm_from_jax`; the moments ``opt.m`` and
    ``opt.v`` have the params' tree and shapes, keep their type (float32,
    or bf16 under ``moment_dtype="bfloat16"``) and are keyed like
    ``LM.named_parameters()``.  Raises ``ValueError`` on a missing or extra
    key or a wrong shape.
    """
    for where, tree, keys in (("state", state_np, {"params", "opt", "step"}),
                              ("state/opt", state_np.get("opt") if isinstance(state_np, Mapping)
                               else None, {"m", "v", "count"})):
        if not isinstance(tree, Mapping) or set(tree) != keys:
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
            raise ValueError(f"{where}: need keys {sorted(keys)}, got {got}")
    for where, x in (("state/step", state_np["step"]), ("state/opt/count", state_np["opt"]["count"])):
        if np.shape(x) != ():
            raise ValueError(f"{where}: need a scalar, got shape {np.shape(x)}")
    lm = lm_from_jax(state_np["params"], cfg, device=device)
    moments = {}
    for key in ("m", "v"):
        tree = state_np["opt"][key]
        embed = tree.get("embed") if isinstance(tree, Mapping) else None
        dtype = "float32" if embed is None else np.asarray(embed).dtype.name
        as_lm = lm_from_jax(tree, dataclasses.replace(cfg, param_dtype=dtype), device=device)
        moments[key] = {name: t.detach().to(getattr(torch, dtype))
                        for name, t in as_lm.named_parameters()}
    opt = AdamWState(m=moments["m"], v=moments["v"], count=int(state_np["opt"]["count"]))
    return {"params": lm, "opt": opt, "step": int(state_np["step"])}
