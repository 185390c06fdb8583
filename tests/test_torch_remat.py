"""``remat="dots"``, port against the JAX package on the CPU: which
products have a batch dimension (read from the einsum's equation, never
from a size); the mark leaves ``torch.einsum``'s bits as they are; the
products a checkpointed block keeps under ``"dots"`` against the
residuals that ``jax.checkpoint`` with ``checkpoint_dots_with_no_batch_dims``
keeps for the reference's layer (by shape, at batch 1, where the MoE's
dispatch runs one group, and at batch 2); three train steps under
``"dots"`` on both sides; and the encoder-decoder, whose reference takes
``jax.checkpoint`` without a policy under ``"dots"``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.models import transformer as jtr
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import Model, layers
from repro_torch.models import transformer as tr
from repro_torch.train import optimizer, step

F32 = dict(param_dtype="float32", compute_dtype="float32")
# tests/test_torch_train.py's test_three_train_steps_match_reference: the
# metrics are float32 sums in another order; the parameters after 3 AdamW
# steps at least 99.9% of each tensor within 2e-6 and every element within
# 1e-4; the schedule's float32 cosine one ulp apart
METRIC_RTOL, LR_RTOL = 1e-4, 2.4e-7
PARAM_TOL, PARAM_SHARE, PARAM_MAX = 2e-6, 0.999, 1e-4
# dense with GQA (v's residual is its expansion), dense without, and moe
ARCHS = ["smollm-360m", "gemma-7b", "mixtral-8x7b"]


@pytest.mark.parametrize("eq,batched", [
    ("bsd,dhk->bshk", False), ("bshk,hkd->bsd", False), ("...d,df->...f", False),
    ("bsd,vd->bsv", False), ("bsd,dv->bsv", False), ("gsd,de->gse", False),
    ("bse,ef->bsf", False), ("bsr,re->bse", False),
    ("gsec,gsd->gecd", True), ("gecd,edf->gecf", True), ("gecf,efd->gecd", True),
    ("gsec,gecd->gsd", True), ("gske,gskc->gsec", True), ("bhst,bthd->bshd", True),
    ("...d,...d->...", True)])
def test_batch_dims_come_from_the_equation(eq, batched):
    assert layers.has_batch_dim(eq) == batched


@pytest.mark.parametrize("shape", [(1, 1, 8, 2, 3), (1, 3, 8, 2, 3), (2, 16, 64, 4, 16)])
def test_the_mark_keeps_torch_einsums_bits(shape):
    """The marked product is ``torch.einsum``'s own, forward and backward,
    at the tiny shapes where a 2-D ``torch.mm`` would round otherwise; the
    mark is down again after it."""
    B, S, d, h, k = shape
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, d, generator=gen, requires_grad=True)
    w = torch.randn(d, h, k, generator=gen, requires_grad=True)
    got = layers.einsum("bsd,dhk->bshk", x, w)
    want = torch.einsum("bsd,dhk->bshk", x, w)
    assert torch.equal(got, want) and not getattr(layers._PRODUCT, "no_batch", False)
    dy = torch.randn(want.shape, generator=gen)
    for a, b in zip(torch.autograd.grad(got, (x, w), dy), torch.autograd.grad(want, (x, w), dy)):
        assert torch.equal(a, b)


def _reference_residuals(arch: str, B: int) -> list:
    """The shapes of what ``jax.checkpoint`` under the reference's dots
    policy keeps for one layer (``_remat`` of ``_sublayer_fwd``), its
    parameters and constants left out, under the gradient of its output's
    sum and its aux losses."""
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), remat="dots", **F32)
    params, _ = jtr.init_lm(jax.random.PRNGKey(0), ref_cfg)
    layer = jax.tree.map(lambda a: a[0], params["blocks"]["sub_0"])
    body = jtr._remat(lambda p, h: jtr._sublayer_fwd(p, ref_cfg, h, {}), ref_cfg)

    def loss(p, h):
        out, aux = body(p, h)
        return out.sum() + sum(aux.values())

    h = jnp.ones((B, 16, ref_cfg.d_model), jnp.float32)
    return sorted(tuple(aval.shape) for aval, src in saved_residuals(loss, layer, h)
                  if "argument" not in src and "constant" not in src)


@pytest.mark.parametrize("B", [1, 2], ids=["batch_1", "batch_2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_the_references_residuals(monkeypatch, arch, B):
    """One block checkpointed under ``"dots"``: the policy keeps exactly
    the ``bmm`` of each product :func:`layers.einsum` marks, the marked
    products' shapes are the reference's residuals (q, k and v, the
    attention's output projection, the FFN's input projections or the
    router; never the expert products, the dispatch or the combine, also
    at batch 1 where the dispatch runs one group).  Not the FFN's output
    projection, which the backward never reads: ``mlp_apply`` leaves it
    unmarked, as the reference's partial evaluation drops it."""
    cfg = dataclasses.replace(smoke_config(arch), num_layers=1, remat="dots", **F32)
    lm = tr.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    marked, kept = [], []
    einsum, policy = torch.einsum, layers._dots_policy
    backward = False

    def recording_einsum(eq, *ops):
        out = einsum(eq, *ops)
        if getattr(layers._PRODUCT, "no_batch", False) and not backward:
            marked.append(tuple(out.shape))
        return out

    def recording_policy(ctx, func, *args, **kwargs):
        decision = policy(ctx, func, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(args[0].shape[0] * args[0].shape[1] * args[1].shape[2])  # the bmm's output
        return decision

    monkeypatch.setattr(torch, "einsum", recording_einsum)
    monkeypatch.setattr(layers, "_dots_policy", recording_policy)
    h = torch.randn((B, 16, cfg.d_model), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    rope = tr._rope(cfg, torch.arange(16))
    out, aux = layers.remat_call("dots", tr._block, lm.blocks[0], cfg, h, rope)
    loss = out.sum() + (sum(aux.values()) if aux is not None else 0)
    backward = True  # the recomputation runs the marked products again
    torch.autograd.grad(loss, [h, *lm.blocks[0].parameters()])
    assert kept == [int(np.prod(s)) for s in marked]
    assert sorted(marked) == _reference_residuals(arch, B)


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x7b"])
def test_three_train_steps_under_dots_match_the_references(arch):
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), remat="dots", **F32)
    cfg = dataclasses.replace(smoke_config(arch), remat="dots", **F32)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    jmodel, model = RefModel(ref_cfg), Model(cfg)
    kw = dict(weight_decay=0.01, clip_norm=1.0)
    jcfg = jopt.AdamWConfig(lr=jopt.warmup_cosine(1e-3, warmup=1, total=3), **kw)
    tcfg = optimizer.AdamWConfig(lr=optimizer.warmup_cosine(1e-3, warmup=1, total=3), **kw)
    jstate = jstep.make_train_state(jmodel, jax.random.PRNGKey(0), jcfg)
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg))
    tfn = step.make_train_step(model, tcfg)
    rng = np.random.default_rng(1)  # test_three_train_steps_match_reference's batches
    for i in range(3):
        seq = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = tfn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm)
        for k in m:
            rtol = LR_RTOL if k == "lr" else METRIC_RTOL
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, err_msg=f"{k} step {i}")
    want = dict(convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                             device="cpu")["params"].named_parameters())
    for name, p in state["params"].named_parameters():
        err = (p.detach() - want[name].detach()).abs()
        assert float((err <= PARAM_TOL).float().mean()) >= PARAM_SHARE, name
        assert float(err.max()) <= PARAM_MAX, (name, float(err.max()))


def test_encdec_recomputes_whole_layers_under_dots(monkeypatch):
    """The reference's encoder-decoder checkpoints each layer without a
    policy whatever ``cfg.remat`` but ``"none"`` (``jax.checkpoint(layer)``
    in its ``encode`` and ``_decoder_stack``), so the port's keeps nothing
    under ``"dots"`` either: the policy is never asked, and the gradients
    of ``"dots"`` and ``"full"`` are bitwise those of ``"none"``."""
    cfg = dataclasses.replace(smoke_config("whisper-large-v3"), **F32)
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    asked = []
    monkeypatch.setattr(layers, "_dots_policy", lambda *a, **k: asked.append(a) or
                        CheckpointPolicy.PREFER_RECOMPUTE)
    grads = {}
    for remat in ("none", "full", "dots"):
        model = Model(dataclasses.replace(cfg, remat=remat))
        m = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
        logits = model.forward(m, {"frames": frames, "tokens": tokens})
        grads[remat] = torch.autograd.grad(logits.square().mean(), list(m.parameters()))
    assert not asked
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat])), remat
