"""Training in the ssm and hybrid families, port against the JAX package on
the CPU: the selective scan's plain backward (``ssm_scan_bwd_ref``, the
reverse recurrence that is the CPU route of ``ops.SsmScanFn`` and the
yardstick of the backward kernel) against ``torch.autograd`` of the plain
scan; the differentiable ``ops.ssm_scan`` against ``jax.vjp`` of the
reference's ``selective_scan`` (with its chunk dividing S and not), and
two edited copies of the plain backward that must fail that check; three
train steps of falcon-mamba's and jamba's smoke configs against
``repro.train.step.make_train_step`` from the same weights (drawn by
``repro``, carried over by ``convert``) and batches (numpy, seeded); and
remat ``"full"`` and ``"dots"`` against ``"none"``, bitwise."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.models import ssm as jssm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model
from repro_torch.train import optimizer, step

# The plain backward against autograd of the plain scan: both float32, the
# same recurrence with sums in another order over up to 300 steps; each
# tensor within 2**-16 of its largest magnitude (measured: about 2**-22)
AUTOGRAD_TOL = 2**-16
# ops.ssm_scan's gradients against jax.vjp of the reference's chunked scan
# (an associative scan inside each chunk, so products of the a_t in another
# order and grouping): each tensor within 2**-17 of its largest magnitude
# (measured: about 2**-21.5)
JAX_TOL = 2**-17
# tests/test_torch_train.py's test_three_train_steps_match_reference: the
# metrics are float32 sums in another order; the parameters after 3 AdamW
# steps at least 99.9% of each tensor within 2e-6 and every element within
# 1e-4; the schedule's float32 cosine one ulp apart
METRIC_RTOL, LR_RTOL = 1e-4, 2.4e-7
PARAM_TOL, PARAM_SHARE, PARAM_MAX = 2e-6, 0.999, 1e-4
ARCHS = ["falcon-mamba-7b", "jamba-1.5-large-398b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
# edited copies of the plain backward (old text -> new): each must fail the
# check against jax.vjp
MUTANTS = {
    "drops_A_a_h_of_ddt": ("xf[:, t, :, None] * Bc[:, t, None, :] + A * ah",
                           "xf[:, t, :, None] * Bc[:, t, None, :]"),
    "drops_the_carried_adjoint": ("dh = g[:, t, :, None] * Cc[:, t, None, :] + carry",
                                  "dh = g[:, t, :, None] * Cc[:, t, None, :]"),
}


def _scan_inputs(rng, B, S, Dm, N):
    """tests/test_torch_ssm.py's distributions: x ~ N(0, 1), dt
    log-uniform in [1e-3, 1e-1], A near -(1..N), B, C ~ N(0, 1), D near 1,
    h0 ~ N(0, 0.3); and the cotangents of y and h_final ~ N(0, 1)."""
    x = rng.normal(0, 1, (B, S, Dm)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, Dm))).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, N + 1))[None] + rng.normal(0, 0.1, (Dm, N))).astype(np.float32)
    Bc = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    Cc = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    D = rng.normal(1, 0.1, (Dm,)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (B, Dm, N)).astype(np.float32)
    gy = rng.normal(0, 1, (B, S, Dm)).astype(np.float32)
    gh = rng.normal(0, 1, (B, Dm, N)).astype(np.float32)
    return (x, dt, A, Bc, Cc, D, h0), gy, gh


def _within(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size:
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (what, err, scale)


# ------------------------------------------------- the plain backward
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("S", [0, 1, 37, 300])
def test_plain_backward_matches_autograd_of_the_plain_scan(S, N, with_h0):
    """``ssm_scan_bwd_ref`` against ``torch.autograd`` through
    ``ssm_scan_ref`` (a loop of differentiable tensor ops), with cotangents
    on y and on h_final; dh0 where h0 was given, and zeros' gradient where
    it was not (what autograd gives for an explicit zero h0)."""
    inputs, gy, gh = _scan_inputs(np.random.default_rng(S * 10 + N), 2, S, 24, N)
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y, h = ref.ssm_scan_ref(*ts[:6], ts[6] if with_h0 else torch.zeros_like(ts[6]))
    want = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum(),
                               ts[:6] + ([ts[6]] if with_h0 else []), allow_unused=True)
    if not with_h0:  # the gradient of the zeros that stood in for h0
        z = torch.zeros_like(ts[6], requires_grad=True)
        y, h = ref.ssm_scan_ref(*ts[:6], z)
        want = want + torch.autograd.grad(
            (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum(), [z])
    got = ref.ssm_scan_bwd_ref(*(t.detach() for t in ts[:6]), ts[6].detach() if with_h0 else None,
                               torch.from_numpy(gy), torch.from_numpy(gh))
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32, name
        _within(g.numpy(), torch.zeros_like(g).numpy() if w is None else w.numpy(),
                AUTOGRAD_TOL, name)


def test_plain_backward_takes_absent_cotangents_as_zeros():
    """None for dy or dh_final is a zero cotangent, as autograd's undefined
    gradients are; x of bf16 gives dx in bf16 and the rest in float32."""
    inputs, gy, gh = _scan_inputs(np.random.default_rng(4), 2, 9, 8, 4)
    ts = [torch.from_numpy(a) for a in inputs]
    zero_y = ref.ssm_scan_bwd_ref(*ts, torch.zeros(gy.shape), torch.from_numpy(gh))
    none_y = ref.ssm_scan_bwd_ref(*ts, None, torch.from_numpy(gh))
    zero_h = ref.ssm_scan_bwd_ref(*ts, torch.from_numpy(gy), torch.zeros(gh.shape))
    none_h = ref.ssm_scan_bwd_ref(*ts, torch.from_numpy(gy), None)
    assert all(torch.equal(a, b) for a, b in zip(zero_y, none_y))
    assert all(torch.equal(a, b) for a, b in zip(zero_h, none_h))
    bf = ref.ssm_scan_bwd_ref(ts[0].bfloat16(), *ts[1:], torch.from_numpy(gy).bfloat16())
    assert bf[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in bf[1:])


# --------------------------------------------- ops.ssm_scan against jax.vjp
def _jax_vjp(inputs, gy, gh, chunk):
    x, dt, A, Bc, Cc, D, h0 = map(jnp.asarray, inputs)
    _, vjp = jax.vjp(lambda *a: jssm.selective_scan(*a[:6], chunk, a[6]), x, dt, A, Bc, Cc, D, h0)
    return [np.asarray(g) for g in vjp((jnp.asarray(gy), jnp.asarray(gh)))]


def _port_grads(inputs, gy, gh):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y, h = ops.ssm_scan(*ts)
    loss = (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


# (S, the reference's chunk): 16 divides 64 (four chunks carry the state);
# 16 does not divide 37 (the reference scans one chunk of 37)
CHUNKS = [(64, 16), (37, 16)]


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("S,chunk", CHUNKS, ids=["chunk_divides", "chunk_does_not"])
def test_gradients_match_jax_vjp_of_the_reference_scan(S, chunk, N):
    """Every input's gradient of ``ops.ssm_scan`` under autograd (the
    plain backward through ``SsmScanFn``) within JAX_TOL of ``jax.vjp`` of
    ``repro.models.ssm.selective_scan``, cotangents on y and h_final."""
    inputs, gy, gh = _scan_inputs(np.random.default_rng(S + N), 2, S, 24, N)
    for name, g, w in zip(GRADS, _port_grads(inputs, gy, gh), _jax_vjp(inputs, gy, gh, chunk)):
        _within(g, w, JAX_TOL, name)


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_edited_plain_backwards_fail_the_jax_check(monkeypatch, mutant):
    """The check above has teeth: a copy of ``ssm_scan_bwd_ref`` without
    ddt's A a_t h_{t-1} term, and one that does not carry the state's
    adjoint from step to step, each fail it."""
    old, new = MUTANTS[mutant]
    src = inspect.getsource(ref.ssm_scan_bwd_ref)
    assert src.count(old) == 1
    namespace = dict(vars(ref))
    exec(compile(src.replace(old, new), ref.__file__, "exec"), namespace)
    monkeypatch.setattr(ref, "ssm_scan_bwd_ref", namespace["ssm_scan_bwd_ref"])
    S, chunk = CHUNKS[0]
    inputs, gy, gh = _scan_inputs(np.random.default_rng(S + 4), 2, S, 24, 4)
    with pytest.raises(AssertionError):
        for name, g, w in zip(GRADS, _port_grads(inputs, gy, gh), _jax_vjp(inputs, gy, gh, chunk)):
            _within(g, w, JAX_TOL, name)


def test_the_scan_without_a_gradient_builds_no_graph():
    """Serving is unchanged: without a gradient ``ops.ssm_scan`` gives the
    plain scan's outputs with no graph; under autograd the same values."""
    inputs, _, _ = _scan_inputs(np.random.default_rng(7), 2, 12, 8, 4)
    ts = [torch.from_numpy(a) for a in inputs]
    y, h = ops.ssm_scan(*ts)
    assert y.grad_fn is None and h.grad_fn is None
    yg, hg = ops.ssm_scan(ts[0].clone().requires_grad_(), *ts[1:])
    assert yg.grad_fn is not None and hg.grad_fn is not None
    assert torch.equal(y, yg.detach()) and torch.equal(h, hg.detach())


# ------------------------------------------------------- the train step
def _pair(arch: str):
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), **F32)
    cfg = dataclasses.replace(smoke_config(arch), **F32)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    return ref_cfg, cfg


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch, micro):
    """Three AdamW steps of the smoke config in float32 (falcon-mamba: two
    Mamba layers; jamba: one period of four, Mamba, Mamba with MoE,
    attention, Mamba with MoE, the router's aux losses weighted in), the
    reference's scan chunked at its config's 32 over 32 tokens: metrics
    and parameters at tests/test_torch_train.py's tolerances."""
    ref_cfg, cfg = _pair(arch)
    jmodel, model = RefModel(ref_cfg), Model(cfg)
    kw = dict(weight_decay=0.01, clip_norm=1.0)
    jcfg = jopt.AdamWConfig(lr=jopt.warmup_cosine(1e-3, warmup=1, total=3), **kw)
    tcfg = optimizer.AdamWConfig(lr=optimizer.warmup_cosine(1e-3, warmup=1, total=3), **kw)
    jstate = jstep.make_train_state(jmodel, jax.random.PRNGKey(0), jcfg)
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg, num_microbatches=micro))
    tfn = step.make_train_step(model, tcfg, num_microbatches=micro)
    rng = np.random.default_rng(micro)
    for i in range(3):
        seq = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = tfn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm)
        assert ("moe_lb_loss" in m) == (cfg.moe is not None)
        for k in m:
            rtol = LR_RTOL if k == "lr" else METRIC_RTOL
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, err_msg=f"{k} step {i}")
    assert state["step"] == int(jstate["step"]) == 3
    want = dict(convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                             device="cpu")["params"].named_parameters())
    for name, p in state["params"].named_parameters():
        err = (p.detach() - want[name].detach()).abs()
        assert float((err <= PARAM_TOL).float().mean()) >= PARAM_SHARE, name
        assert float(err.max()) <= PARAM_MAX, (name, float(err.max()))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_gradients_without_remat_bitwise(monkeypatch, arch, remat):
    """``"full"`` recomputes each block in the backward (the scan's
    forward runs again), ``"dots"`` keeps the products without a batch
    dimension and recomputes the rest: the loss and every gradient
    bitwise those of ``"none"``, the scan's backward once a Mamba layer
    either way."""
    _, cfg = _pair(arch)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)))
    got, calls = {}, {}
    bwd, counted = ref.ssm_scan_bwd_ref, []
    monkeypatch.setattr(ref, "ssm_scan_bwd_ref", lambda *a: counted.append(1) or bwd(*a))
    for kind in ("none", remat):
        model = Model(dataclasses.replace(cfg, remat=kind))
        lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
        counted.clear()
        total, _, _ = step.make_loss_fn(model)(lm, {"tokens": tokens, "labels": tokens})
        got[kind] = (total.detach(), torch.autograd.grad(total, list(lm.parameters())))
        calls[kind] = len(counted)
    mamba = sum(1 for blk in lm.blocks if hasattr(blk, "ssm"))
    assert calls == {"none": mamba, remat: mamba}
    assert torch.equal(got["none"][0], got[remat][0])
    assert all(torch.equal(a, b) for a, b in zip(got["none"][1], got[remat][1]))


# ROADMAP.md queue C #22's mechanism, met again: three steps of jamba's
# smoke config under remat="dots" on both sides (batches rng(1)) leave one
# element of blocks.0.ssm.w_in 1.04e-4 from the reference's, over PARAM_MAX.
# The port's dots run is its none run bitwise (above); the reference's dots
# run moves that element by 2.9e-5 from its own none run (XLA's sums in
# another order), against which the port is within PARAM_MAX.
C22_JAMBA_ELEMENT = ("blocks.0.ssm.w_in", (25, 246))
# a gradient under this share of its tensor's rms is near zero (C #22's
# bound, tests/test_torch_moe_train.py)
C22_NEAR_ZERO = 1e-4


def test_jambas_element_off_under_dots_starts_from_a_gradient_near_zero():
    """That element's first-step gradient (the loss with the weighted aux
    losses, from the reference's weights, batch rng(1)) is the least of
    its tensor in magnitude on both sides, under C22_NEAR_ZERO of the
    tensor's rms: Adam's first update there, lr g / (|g| + eps), turns
    float32 noise in g into a move of the update, as in C #22."""
    from repro.train.loss import lm_loss as jlm_loss
    from repro_torch.precision import full_float32_matmul

    name, idx = C22_JAMBA_ELEMENT
    ref_cfg, cfg = _pair("jamba-1.5-large-398b")
    jmodel, model = RefModel(ref_cfg), Model(cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    seq = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def jloss(params, b):
        logits, aux = jmodel.forward(params, b)
        total, _ = jlm_loss(logits, b["labels"], None, z_loss_weight=1e-4)
        return total + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]

    jgrads = jax.grad(jloss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = dict(convert.lm_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                    device="cpu").named_parameters())[name].detach()
    with torch.enable_grad(), full_float32_matmul():
        total, _, _ = step.make_loss_fn(model)(lm, {k: torch.from_numpy(v) for k, v in batch.items()})
        got = torch.autograd.grad(total, [dict(lm.named_parameters())[name]])[0]
    rms = float(want.square().mean().sqrt())
    for side in (got, want):
        assert abs(float(side[idx])) <= C22_NEAR_ZERO * rms, (float(side[idx]), rms)
        assert int(side.abs().flatten().argmin()) == int(np.ravel_multi_index(idx, side.shape))
