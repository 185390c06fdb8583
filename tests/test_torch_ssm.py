"""The Mamba serving slice, port against the JAX package on the CPU: the
selective scan (the kernel's plain version against the Pallas kernel in
interpret mode, the JAX oracle and the JAX model's chunked scan), the
mixer, the falcon-mamba LM's forward, prefill and decode, short prompts,
``serve_batch`` and the continuous batcher, on the same inputs (numpy,
seeded) and the same weights (drawn by ``repro``, carried over by
``convert.lm_from_jax``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm_scan
from repro.launch.serve import serve_batch as ref_serve_batch
from repro.models import Model as RefModel
from repro.models import ssm as jssm
from repro.serve.scheduler import ContinuousBatcher
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tr
from repro_torch.serve.scheduler import SlotBatcher

ARCH = "falcon-mamba-7b"
# float32 scans: up to 300 sequential steps, each rounding the state once
# (2**-24 relative), summed and exponentiated in another order by XLA and
# PyTorch; 2e-5 of the values' scale (the JAX package holds its own kernel
# to its oracle at 2e-4)
SCAN_TOL = 2e-5
# bf16 y: both sides add D*x in float32 and round once, so y differs only
# where float32 noise moves a value across a rounding boundary: one bf16
# ulp, at most 2**-7 of the value, which is half of the relative term; the
# rms term covers values near zero
BF16_RMS, BF16_REL = 2**-8, 2**-6
# whole models in float32: thousands of float32 sums per logit in another
# order, through 1-2 layers of norms and projections (as tests/test_torch_lm.py)
MODEL_TOL = 2e-4
# greedy tokens agree until two logits tie within what the two frameworks'
# rounding can move them (the rule of tests/test_torch_serve.py)
TIE_F32, TIE_BF16 = 2e-4, 2.5e-2
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _scan_inputs(rng, B, S, Dm, N):
    """The model's distributions: x ~ N(0, 1), dt log-uniform in [1e-3,
    1e-1] (mamba's dt init), A near -(1..N) (S4D-real), B, C ~ N(0, 1),
    D near 1, h0 ~ N(0, 0.3)."""
    x = rng.normal(0, 1, (B, S, Dm)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, Dm))).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, N + 1))[None] + rng.normal(0, 0.1, (Dm, N))).astype(np.float32)
    Bc = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    Cc = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    D = rng.normal(1, 0.1, (Dm,)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (B, Dm, N)).astype(np.float32)
    return x, dt, A, Bc, Cc, D, h0


def _close(got, want, tol=SCAN_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------- the scan
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("S", [1, 37, 300])
def test_ssm_scan_matches_pallas_oracle_and_model_scan(S, N, with_h0):
    """The plain version against the Pallas kernel in interpret mode
    (chunk 32: S = 37 and 300 are padded with dt = 0), the JAX oracle and
    the JAX model's chunked scan at chunk 256 and 32 (one chunk of S where
    S is not a multiple), for y and h_final."""
    x, dt, A, Bc, Cc, D, h0 = _scan_inputs(np.random.default_rng(S * 10 + N), 2, S, 32, N)
    h0 = h0 if with_h0 else None
    got_y, got_h = ops.ssm_scan(*(None if a is None else torch.from_numpy(a)
                                  for a in (x, dt, A, Bc, Cc, D, h0)))
    assert got_y.dtype == torch.float32 and got_y.shape == (2, S, 32)
    assert got_h.dtype == torch.float32 and got_h.shape == (2, 32, N)
    j = [None if a is None else jnp.asarray(a) for a in (x, dt, A, Bc, Cc, D, h0)]
    wants = [pallas_ssm_scan(*j, block_d=16, chunk=32, interpret=True),
             jref.ssm_scan_ref(*j),
             jssm.selective_scan(*j[:6], chunk=256, h0=j[6]),
             jssm.selective_scan(*j[:6], chunk=32, h0=j[6])]
    for want_y, want_h in wants:
        _close(got_y.numpy(), want_y)
        _close(got_h.numpy(), want_h)


@pytest.mark.parametrize("S", [37, 300])
def test_ssm_scan_bf16_rounds_once_as_the_pallas_kernel(S):
    """In bf16 both the plain version and the Pallas kernel add D*x in
    float32 and round y once; h_final stays float32."""
    x, dt, A, Bc, Cc, D, h0 = _scan_inputs(np.random.default_rng(S), 2, S, 32, 16)
    got_y, got_h = ops.ssm_scan(torch.from_numpy(x).bfloat16(),
                                *map(torch.from_numpy, (dt, A, Bc, Cc, D, h0)))
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    want_y, want_h = pallas_ssm_scan(jnp.asarray(x, jnp.bfloat16),
                                     *map(jnp.asarray, (dt, A, Bc, Cc, D, h0)),
                                     block_d=16, chunk=32, interpret=True)
    want = np.asarray(want_y, np.float32)
    rms = float(np.sqrt(np.mean(want ** 2)))
    err = np.abs(got_y.float().numpy() - want)
    assert (err <= BF16_RMS * rms + BF16_REL * np.abs(want)).all(), err.max()
    _close(got_h.numpy(), want_h)


def test_ssm_scan_takes_the_models_strided_views():
    """x as one half of a wider projection, B and C as column slices of
    x_proj's output, as the model hands them: equal bitwise to contiguous
    copies."""
    rng = np.random.default_rng(5)
    x, dt, A, Bc, Cc, D, h0 = _scan_inputs(rng, 2, 37, 24, 4)
    xz = torch.from_numpy(np.concatenate([x, rng.normal(0, 1, x.shape).astype(np.float32)], -1))
    xdb = torch.from_numpy(np.concatenate([rng.normal(0, 1, (2, 37, 3)).astype(np.float32),
                                           Bc, Cc], -1))
    xv, _ = xz.chunk(2, dim=-1)
    _, Bv, Cv = torch.split(xdb, [3, 4, 4], dim=-1)
    assert not (xv.is_contiguous() or Bv.is_contiguous() or Cv.is_contiguous())
    args = [torch.from_numpy(a) for a in (dt, A)]
    got = ops.ssm_scan(xv, args[0], args[1], Bv, Cv, torch.from_numpy(D), torch.from_numpy(h0))
    want = ops.ssm_scan(*map(torch.from_numpy, (x, dt, A, Bc, Cc, D, h0)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ssm_scan_has_no_backward():
    """Named when the scan had no backward and raised under a gradient;
    since ROADMAP.md queue A #9 it has one: under a gradient ``ops.ssm_scan``
    gives the values it gives without one, bitwise, and its gradient
    reaches every input (against the reference's ``jax.vjp`` in
    tests/test_torch_ssm_train.py)."""
    x, dt, A, Bc, Cc, D, h0 = map(torch.from_numpy, _scan_inputs(np.random.default_rng(6), 1, 4, 8, 4))
    inputs = [t.clone().requires_grad_() for t in (x, dt, A, Bc, Cc, D, h0)]
    y, h = ops.ssm_scan(*inputs)
    with torch.no_grad():
        want = ops.ssm_scan(x, dt, A, Bc, Cc, D, h0)
    assert torch.equal(y.detach(), want[0]) and torch.equal(h.detach(), want[1])
    grads = torch.autograd.grad(y.square().sum() + h.sum(), inputs)
    assert all(g.shape == t.shape and bool(g.abs().sum() > 0) for g, t in zip(grads, inputs))


# ---------------------------------------------------------------- the mixer
def _ref_pair(cfg_ref, cfg, key=0):
    """JAX model and params, and the port's model and the same weights."""
    jmodel = RefModel(cfg_ref)
    jparams, _ = jmodel.init(jax.random.PRNGKey(key))
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jmodel, jparams, Model(cfg), lm


def _smoke(f32=True):
    ref_cfg, cfg = ref_smoke_config(ARCH), smoke_config(ARCH)
    if f32:
        ref_cfg, cfg = dataclasses.replace(ref_cfg, **F32), dataclasses.replace(cfg, **F32)
    return ref_cfg, cfg


def _full_width_one_layer():
    """falcon-mamba-7b's mixer at its full width (d_model 4,096, d_inner
    8,192, d_state 16, dt_rank 256) with one layer, in float32; the
    vocabulary cut from 65,024 to 4,096 keeps both packages' copies of
    the weights under half a GB each on the CPU."""
    kw = dict(F32, num_layers=1, vocab_size=4096)
    return (dataclasses.replace(ref_get_config(ARCH), **kw),
            dataclasses.replace(get_config(ARCH), **kw))


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_ssm_apply_matches_reference(with_state):
    ref_cfg, cfg = _smoke()
    _, jparams, _, lm = _ref_pair(ref_cfg, cfg)
    p_np = jax.tree.map(lambda a: np.asarray(a)[0], jparams["blocks"]["sub_0"]["ssm"])
    rng = np.random.default_rng(7)
    h = rng.normal(0, 1, (2, 37, cfg.d_model)).astype(np.float32)
    d_in = cfg.ssm.expand * cfg.d_model
    state = None
    if with_state:
        state = {"conv": rng.normal(0, 1, (2, cfg.ssm.d_conv - 1, d_in)).astype(np.float32),
                 "h": rng.normal(0, 0.3, (2, d_in, cfg.ssm.d_state)).astype(np.float32)}
    want, want_state = jssm.ssm_apply(jax.tree.map(jnp.asarray, p_np), ref_cfg, jnp.asarray(h),
                                      None if state is None else jax.tree.map(jnp.asarray, state))
    with torch.no_grad():  # the scan has no backward
        got, got_state = tssm.ssm_apply(lm.blocks[0].ssm.p, cfg, torch.from_numpy(h),
                                        None if state is None else
                                        {k: torch.from_numpy(v) for k, v in state.items()})
    _close(got.detach().numpy(), want, MODEL_TOL)
    if with_state:
        for k in ("conv", "h"):
            _close(got_state[k].detach().numpy(), want_state[k], MODEL_TOL)
    else:
        assert got_state is None and want_state is None


# ---------------------------------------------------------------- the LM
def _prefill_decode(jmodel, jparams, model, lm, tokens, steps):
    """Both packages: prefill ``tokens`` (B, S), then ``steps`` decode
    steps on the JAX side's greedy tokens; each step's logits and the
    final caches."""
    B, S = tokens.shape
    jcache = jmodel.init_cache(B, S + steps)
    cache = model.init_cache(B, S + steps, device="cpu")
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
    tl, cache = model.prefill(lm, {"tokens": torch.from_numpy(tokens.astype(np.int64))}, cache)
    pairs = [(tl, jl)]
    tok = np.asarray(jl).argmax(-1)
    for i in range(steps):
        jl, jcache = jmodel.decode(jparams, jnp.asarray(tok, jnp.int32), jcache,
                                   jnp.asarray(S + i, jnp.int32))
        tl, cache = model.decode(lm, torch.from_numpy(tok.astype(np.int64)), cache, S + i)
        pairs.append((tl, jl))
        tok = np.asarray(jl).argmax(-1)
    return pairs, cache, jcache


@pytest.mark.parametrize("which", ["smoke", "full_width_1_layer"])
def test_lm_prefill_decode_and_forward_match_reference(which):
    ref_cfg, cfg = _smoke() if which == "smoke" else _full_width_one_layer()
    jmodel, jparams, model, lm = _ref_pair(ref_cfg, cfg)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    pairs, cache, jcache = _prefill_decode(jmodel, jparams, model, lm, tokens, 4)
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_size)
        _close(got.numpy(), want, MODEL_TOL)
    for k in ("conv", "h"):
        _close(cache["sub_0"][k].numpy(), jcache["sub_0"][k], MODEL_TOL)
    with torch.no_grad():
        got = model.forward(lm, {"tokens": torch.from_numpy(tokens.astype(np.int64))})
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)})
    _close(got.numpy(), want, MODEL_TOL)


def test_bf16_prefill_and_decode_stay_within_bf16_of_reference():
    """The smoke config in bf16: the port's scan rounds y once where the
    JAX model rounds it twice (see models/ssm.py), so logits agree to bf16
    rounding through the layers, not to float32."""
    jmodel, jparams, model, lm = _ref_pair(*_smoke(f32=False))
    tokens = np.random.default_rng(9).integers(0, 128, (2, 20)).astype(np.int32)
    pairs, _, _ = _prefill_decode(jmodel, jparams, model, lm, tokens, 3)
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-2, rtol=3e-2)


def test_prefill_then_decode_equals_forward():
    """prefill(S - 1) + decode == forward(S), as tests/test_arch_smoke.py
    holds the JAX package."""
    _, cfg = _smoke()
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        full = model.forward(lm, {"tokens": tokens})
    cache = model.init_cache(2, 12, device="cpu")
    logits, cache = model.prefill(lm, {"tokens": tokens[:, :11]}, cache)
    torch.testing.assert_close(logits, full[:, 10], atol=MODEL_TOL, rtol=MODEL_TOL)
    logits, cache = model.decode(lm, tokens[:, 11], cache, 11)
    torch.testing.assert_close(logits, full[:, 11], atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.mark.parametrize("length", [1, 2, 3])
def test_short_prompts_continue_the_previous_window(length):
    """A second prefill shorter than d_conv - 1 = 3 keeps part of the
    previous convolution window (reference ``full[:, -(K-1):]``): the port
    and the JAX package agree, and both equal the forward over the whole
    stream."""
    ref_cfg, cfg = _smoke()
    jmodel, jparams, model, lm = _ref_pair(ref_cfg, cfg, key=2)
    rng = np.random.default_rng(length)
    first = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    second = rng.integers(0, cfg.vocab_size, (2, length)).astype(np.int32)
    jcache = jmodel.init_cache(2, 16)
    cache = model.init_cache(2, 16, device="cpu")
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(first)}, jcache)
    _, cache = model.prefill(lm, {"tokens": torch.from_numpy(first.astype(np.int64))}, cache)
    want, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(second)}, jcache)
    got, cache = model.prefill(lm, {"tokens": torch.from_numpy(second.astype(np.int64))}, cache)
    _close(got.numpy(), want, MODEL_TOL)
    for k in ("conv", "h"):
        _close(cache["sub_0"][k].numpy(), jcache["sub_0"][k], MODEL_TOL)
    both = np.concatenate([first, second], axis=1).astype(np.int64)
    with torch.no_grad():
        full = model.forward(lm, {"tokens": torch.from_numpy(both)})
    torch.testing.assert_close(got, full[:, -1], atol=MODEL_TOL, rtol=MODEL_TOL)


def test_forward_with_a_gradient_raises():
    """Named when the forward raised under a gradient; since ROADMAP.md
    queue A #9 it trains: the logits under a gradient equal those without
    one bitwise, and the loss's gradient reaches every parameter."""
    _, cfg = _smoke()
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 5)))
    logits = model.forward(lm, {"tokens": tokens})
    assert all(p.requires_grad for p in lm.parameters()) and logits.grad_fn is not None
    with torch.no_grad():
        want = model.forward(lm, {"tokens": tokens})
    assert logits.shape == (1, 5, cfg.vocab_size) and torch.equal(logits.detach(), want)
    grads = torch.autograd.grad(logits.square().mean(), list(lm.parameters()))
    assert all(bool(g.abs().sum() > 0) for g in grads)


def test_init_matches_the_reference_tree():
    """The port draws its own weights (torch's generator), but every
    tensor has the reference's shape, type and initial values where those
    are fixed (A_log, D, norms)."""
    ref_cfg, cfg = ref_smoke_config(ARCH), smoke_config(ARCH)
    jparams, _ = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    lm = tr.init_lm(cfg, device="cpu")
    assert sum(p.numel() for p in lm.parameters()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(jparams))
    carried = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    def layout(m):
        return {name: (p.shape, p.dtype) for name, p in m.named_parameters()}

    assert layout(lm) == layout(carried)
    blk = lm.blocks[0].ssm
    assert blk.w_in.dtype == torch.bfloat16 and blk.w_conv.dtype == torch.bfloat16
    assert {blk.dt_bias.dtype, blk.A_log.dtype, blk.D.dtype} == {torch.float32}
    assert torch.equal(blk.A_log, torch.from_numpy(np.array(
        jparams["blocks"]["sub_0"]["ssm"]["A_log"][0])))
    dt = torch.nn.functional.softplus(blk.dt_bias.detach())
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    cache = tr.init_cache(cfg, 3, 99, device="cpu")["sub_0"]
    assert cache["conv"].shape == (2, 3, 3, 128) and cache["conv"].dtype == torch.bfloat16
    assert cache["h"].shape == (2, 3, 128, 4) and cache["h"].dtype == torch.float32


def test_lm_from_jax_refuses_a_wrong_ssm_tree():
    ref_cfg, cfg = ref_smoke_config(ARCH), smoke_config(ARCH)
    jparams, _ = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    good = jax.tree.map(np.asarray, jparams)
    lm = convert.lm_from_jax(good, cfg, device="cpu")
    assert lm.blocks[1].ssm.A_log.dtype == torch.float32
    assert torch.equal(lm.blocks[1].ssm.w_x.float(), torch.from_numpy(
        np.asarray(good["blocks"]["sub_0"]["ssm"]["w_x"][1], np.float32)))

    def broken(edit):
        tree = jax.tree.map(lambda a: a, good)
        edit(tree)
        return tree

    ssm = lambda t: t["blocks"]["sub_0"]["ssm"]  # noqa: E731
    bad = [
        broken(lambda t: ssm(t).pop("A_log")),
        broken(lambda t: ssm(t).update(w_dt=ssm(t)["w_dt"][:, :3])),
        broken(lambda t: t.pop("lm_head")),
        broken(lambda t: t["blocks"]["sub_0"].update(norm2=t["blocks"]["sub_0"]["norm1"])),
    ]
    for tree in bad:
        with pytest.raises(ValueError):
            convert.lm_from_jax(tree, cfg, device="cpu")


# ---------------------------------------------------------------- serving
def _assert_matches(got, want, lgs, tie, ctx):
    """Equal sequences, except that at an exact tie (two logits of the step
    within ``tie``) the rest is not compared."""
    for j, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        gap = abs(float(lgs[j][g]) - float(lgs[j][w]))
        assert gap < tie, (ctx, j, g, w, gap)
        return
    assert len(got) == len(want), ctx


def _standalone(model, lm, prompt, max_new, max_len):
    cache = model.init_cache(1, max_len, device="cpu")
    logits, cache = model.prefill(lm, {"tokens": torch.from_numpy(prompt[None].astype(np.int64))},
                                  cache)
    toks, lgs = [int(logits[0].argmax())], [logits[0].float().numpy()]
    while len(toks) < max_new:
        logits, cache = model.decode(lm, torch.tensor([toks[-1]]), cache,
                                     len(prompt) + len(toks) - 1)
        toks.append(int(logits[0].argmax()))
        lgs.append(logits[0].float().numpy())
    return toks, lgs


@pytest.fixture(scope="module", params=[True, False], ids=["f32", "bf16"])
def serving_pair(request):
    ref_cfg, cfg = _smoke(request.param)
    return (*_ref_pair(ref_cfg, cfg), TIE_F32 if request.param else TIE_BF16)


def test_serve_batch_matches_reference(serving_pair):
    jmodel, _, model, lm, tie = serving_pair
    prompts = np.random.default_rng(11).integers(0, 128, (3, 10)).astype(np.int32)
    want = ref_serve_batch(jmodel, prompts, 8)  # PRNGKey(0)'s weights, as lm's
    timings = {}
    got = serve.serve_batch(model, prompts, 8, params=lm, device="cpu", timings=timings)
    assert got.shape == (3, 8) and timings["decode_steps"] == 7
    for b in range(3):
        _, lgs = _standalone(model, lm, prompts[b], 8, 18)
        _assert_matches(got[b].tolist(), want[b].tolist(), lgs, tie, b)


def test_batcher_over_ssm_caches_matches_standalone_and_reference(serving_pair):
    """2 slots, 5 requests of mixed prompt lengths joining mid-stream: the
    SSM state is written wholesale into the slot at admission."""
    jmodel, jparams, model, lm, tie = serving_pair
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 128, int(n)).astype(np.int32) for n in (8, 12, 2, 9, 5)]
    max_new = [6, 4, 5, 3, 6]
    batcher = SlotBatcher(model, lm, batch_slots=2, max_len=64)
    ref_batcher = ContinuousBatcher(jmodel, jparams, batch_slots=2, max_len=64)
    for p, m in zip(prompts, max_new):
        batcher.submit(p, m)
        ref_batcher.submit(p, m)
    done, ref_done = batcher.run(), ref_batcher.run()
    assert [r.rid for r in done] == [r.rid for r in ref_done] == list(range(5))
    for req, ref_req, p, m in zip(done, ref_done, prompts, max_new):
        want, lgs = _standalone(model, lm, p, m, 64)
        _assert_matches(req.out, want, lgs, tie, ("standalone", req.rid))
        _assert_matches(req.out, ref_req.out, lgs, tie, ("reference batcher", req.rid))


def test_serve_cli_serves_mamba_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "9", "--gen", "4"]) == 0
    assert "generated shape (2, 4)" in capsys.readouterr().out


# ---------------------------------------------------------------- registry
def test_registry_serves_falcon_mamba_at_the_references_config():
    assert ARCH in ARCHS
    for ours, theirs in ((get_config(ARCH), ref_get_config(ARCH)),
                         (smoke_config(ARCH), ref_smoke_config(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.ssm.d_state, cfg.ssm.d_conv, cfg.ssm.expand,
            cfg.vocab_size, cfg.tie_embeddings) == (64, 4096, 16, 4, 2, 65024, False)
    # the hybrid family's Mamba layers are this family's mixer (the
    # registry refused jamba until ROADMAP.md queue A #13's first half)
    jamba = get_config("jamba-1.5-large-398b")
    assert dataclasses.asdict(jamba) == dataclasses.asdict(ref_get_config("jamba-1.5-large-398b"))
    lm = tr.init_lm(ref_smoke_config("jamba-1.5-large-398b"), device="cpu")
    mamba = [b for b in lm.blocks if hasattr(b, "ssm")]
    assert len(mamba) == 3 and all(hasattr(b, "norm2") for b in mamba)
    assert {k: v.shape for k, v in mamba[0].ssm.p.items()} == \
        {k: v.shape for k, v in tr.init_lm(smoke_config(ARCH), device="cpu").blocks[0].ssm.p.items()}
