"""The training slice, port against the JAX package on the CPU: the
training attention (the forward with lse and the backward through
``FlashAttentionFn`` against the Pallas kernels in interpret mode and
``jax.grad`` of their oracle), the loss, AdamW, three train steps, the
checkpoint manager and the training driver (loss falls, crash and resume is bitwise,
the command line runs), on the same inputs (numpy, seeded) and the same
weights (drawn by ``repro``, carried over by ``convert``)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.configs import smoke_config as ref_smoke_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention_bwd import flash_attention_fwd_lse as pallas_fwd_lse
from repro.kernels.flash_attention_bwd import flash_attention_vjp as pallas_vjp
from repro.models import Model as RefModel
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.distributed.fault import run_with_restarts
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention_bwd import flash_attention_vjp
from repro_torch.launch.train import build_loader, train_loop
from repro_torch.models import Model
from repro_torch.train import loss, optimizer, step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_kernels_bwd.py's sweep: (B, H, Hkv, S, T, D, block_q, block_k)
BWD_SWEEP = [(1, 2, 2, 64, 64, 16, 32, 32), (2, 4, 2, 64, 64, 32, 32, 32),
             (1, 2, 1, 96, 96, 16, 32, 48),
             # gemma-7b's head_dim 256: GQA 2:1, and 4:1 with T != S
             (1, 4, 2, 64, 64, 256, 32, 32), (1, 4, 1, 48, 80, 256, 16, 16)]
BWD_MASKS = [(True, None), (True, 32), (False, None)]
# float32 on both sides, sums in another order: the JAX package's own
# tolerances, 3e-5 for the forward (tests/test_kernels_bwd.py's forward
# check) and 2e-4 for the gradients (its backward check)
FWD_TOL, BWD_TOL = 3e-5, 2e-4
LSE_TOL = 1e-5  # a logsumexp of at most 96 float32 terms, summed in another order
# a train step in float32: the forward agrees to 2e-4 (tests/test_torch_lm.py);
# loss and grad norm are sums over every logit and gradient in another order
METRIC_RTOL = 1e-4
# parameters after 3 AdamW steps of lr <= 1e-3 (each moves by up to 3e-3):
# at least 99.9% of each tensor within 2e-6, and every element within 1e-4.
# Where a gradient lies within float32 noise of zero, Adam's m / sqrt(v) is
# ill-conditioned, and sums in another order move that element's update by
# a few percent of lr
PARAM_TOL, PARAM_SHARE, PARAM_MAX = 2e-6, 0.999, 1e-4
LR_RTOL = 2.4e-7  # the schedule's float32 cosine: numpy's and XLA's differ by an ulp


def _qkv(rng, B, H, Hkv, S, T, D):
    return (rng.normal(0, 1, (B, H, S, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, T, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, T, D)).astype(np.float32))


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,window", BWD_MASKS)
@pytest.mark.parametrize("B,H,Hkv,S,T,D,bq,bk", BWD_SWEEP)
def test_training_attention_matches_pallas_and_autodiff(B, H, Hkv, S, T, D, bq, bk, causal,
                                                        window):
    q, k, v = _qkv(np.random.default_rng(7 + S + H), B, H, Hkv, S, T, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    # the forward with lse against the Pallas kernel
    out, lse = ref.flash_attention_fwd_lse_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                               window=window)
    p_out, p_lse = pallas_fwd_lse(jq.reshape(B * H, S, D), jk, jv, causal=causal, window=window,
                                  block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out).reshape(B, H, S, D), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(p_lse).reshape(B, H, S), atol=LSE_TOL,
                               rtol=LSE_TOL)

    # the gradients with the cotangent of sum(o * cos(o))
    def jloss_of(attn):
        def f(q, k, v):
            o = attn(q, k, v)
            return jnp.sum(o * jnp.cos(o))
        return jax.jit(jax.grad(f, argnums=(0, 1, 2)))

    want = jloss_of(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal=causal,
                                                             window=window))(jq, jk, jv)
    pallas = jloss_of(lambda q, k, v: pallas_vjp(q, k, v, causal, window, bq, bk, True))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_vjp(tq, tk, tv, causal, window)
    got = torch.autograd.grad((o * torch.cos(o)).sum(), (tq, tk, tv))
    for name, g, w, p in zip("qkv", got, want, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name} vs jax.grad of the oracle")
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name} vs the Pallas backward")


def test_rows_without_keys_give_zeros_and_no_gradient():
    """A key axis shorter than the query axis under a window leaves rows
    past T + window - 1 with no key: their output is 0 and lse -inf, and
    they add nothing to any gradient (the kernels do the same on the card,
    tests/test_torch_cuda.py)."""
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(11), 1, 2, 1, 40, 8, 16))
    cot = torch.from_numpy(np.random.default_rng(12).normal(0, 1, (1, 2, 40, 16)).astype(np.float32))
    grads = []
    for rows in (40, 11):  # rows 11.. see no key (s - t < 4 needs t > s - 4 >= 8)
        tq, tk, tv = (t.clone().requires_grad_() for t in (q[:, :, :rows], k, v))
        o = flash_attention_vjp(tq, tk, tv, False, 4)
        grads.append(torch.autograd.grad((o * cot[:, :, :rows]).sum(), (tq, tk, tv)))
        if rows == 40:
            out, lse = ref.flash_attention_fwd_lse_ref(q, k, v, causal=False, window=4)
            assert not out[:, :, 11:].any() and torch.equal(o.detach(), out)
            assert bool(torch.isneginf(lse[:, :, 11:]).all()) and bool(torch.isfinite(lse[:, :, :11]).all())
    (fq, fk, fv), (tq, tk, tv) = grads
    assert not fq[:, :, 11:].any()
    for got, want in ((fq[:, :, :11], tq), (fk, tk), (fv, tv)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- loss, AdamW
def test_lm_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 9, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.7).astype(np.float32)
    for m in (None, mask):
        total, metrics = loss.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                      None if m is None else torch.from_numpy(m), z_loss_weight=1e-3)
        jtotal, jmetrics = jloss.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                         None if m is None else jnp.asarray(m), z_loss_weight=1e-3)
        # float32 sums over 18 positions in another order; exp (ppl_proxy)
        # multiplies the loss's relative error by the loss, about 7 here
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
        assert set(metrics) == set(jmetrics)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    ce = loss.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(ce.numpy(), np.asarray(jloss.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6, atol=1e-6)


def test_adamw_update_matches_reference():
    """Three updates with clipping (the norm is above 1), weight decay and
    the warmup-cosine schedule, float32 and bf16 parameters."""
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01, clip_norm=1.0)
    jcfg = jopt.AdamWConfig(lr=jopt.warmup_cosine(1e-2, warmup=2, total=6), **kw)
    cfg = optimizer.AdamWConfig(lr=optimizer.warmup_cosine(1e-2, warmup=2, total=6), **kw)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16, 0)):
        # bf16: the same float32 update rounded to bf16 on both sides, equal
        # unless a value lands within float32 noise of a rounding boundary
        jp = {k: jnp.asarray(v, jdtype) for k, v in params.items()}
        tp = {k: torch.from_numpy(v).to(dtype) for k, v in params.items()}
        jstate = jopt.adamw_init(jp, jcfg)
        tstate = optimizer.adamw_init(tp, cfg)
        for i in range(3):
            g = {k: rng.normal(0, 2, s).astype(np.float32) for k, s in shapes.items()}
            jp, jstate, jm = jopt.adamw_update({k: jnp.asarray(v, jdtype) for k, v in g.items()},
                                               jstate, jp, jcfg)
            tm = optimizer.adamw_update({k: torch.from_numpy(v).to(dtype) for k, v in g.items()},
                                        tstate, tp, cfg)
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
            np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=LR_RTOL)
        assert tstate.count == int(jstate["count"]) == 3
        for k in shapes:
            got, want = tp[k].float().numpy(), np.asarray(jp[k], np.float32)
            if tol:
                np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=k)
            else:
                assert np.mean(got != want) < 0.02, k
            np.testing.assert_allclose(tstate.m[k].numpy(), np.asarray(jstate["m"][k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_allclose(tstate.v[k].numpy(), np.asarray(jstate["v"][k]), rtol=1e-5,
                                       atol=1e-9, err_msg=k)


def test_schedules_match_reference():
    f, g = optimizer.warmup_cosine(3e-4, 5, 100), jopt.warmup_cosine(3e-4, 5, 100)
    for count in range(0, 120, 3):
        np.testing.assert_allclose(f(count), float(g(jnp.asarray(count, jnp.int32))), rtol=LR_RTOL)
    assert optimizer.constant_lr(0.5)(7) == np.float32(0.5)


# ------------------------------------------------------------- train steps
def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def smoke_pair():
    ref_cfg, cfg = _f32(ref_smoke_config("smollm-360m")), _f32(smoke_config("smollm-360m"))
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    return ref_cfg, cfg


@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_match_reference(smoke_pair, micro):
    ref_cfg, cfg = smoke_pair
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
        assert set(m) == set(jm) == {"loss", "ce_loss", "z_loss", "ppl_proxy", "tokens",
                                     "grad_norm", "lr"}
        for k in m:
            rtol = LR_RTOL if k == "lr" else METRIC_RTOL
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, err_msg=f"{k} step {i}")
    assert state["step"] == int(jstate["step"]) == 3 and state["opt"].count == 3
    want = dict(convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                             device="cpu")["params"].named_parameters())
    for name, p in state["params"].named_parameters():
        err = (p.detach() - want[name].detach()).abs()
        assert float((err <= PARAM_TOL).float().mean()) >= PARAM_SHARE, name
        assert float(err.max()) <= PARAM_MAX, (name, float(err.max()))


def test_remat_full_gives_the_same_gradients_and_dots_is_refused(smoke_pair):
    """Named when ``"dots"`` was refused; since it is ported (ROADMAP.md
    queue A #7) it runs, and ``"full"`` and ``"dots"`` both give the
    gradients of ``"none"`` bitwise: the recomputed ops are the forward's,
    and what ``"dots"`` keeps is the forward's own tensors."""
    _, cfg = smoke_pair
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)))
    grads = {}
    for remat in ("none", "full", "dots"):
        model = Model(dataclasses.replace(cfg, remat=remat))
        lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
        logits = model.forward(lm, {"tokens": tokens})
        grads[remat] = torch.autograd.grad(logits.square().mean(), list(lm.parameters()))
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat])), remat


def test_serving_builds_no_graph_with_trainable_parameters(smoke_pair):
    _, cfg = smoke_pair
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(p.requires_grad for p in lm.parameters())
    cache = model.init_cache(2, 24, device="cpu")
    logits, cache = model.prefill(lm, {"tokens": torch.zeros((2, 8), dtype=torch.int64)}, cache)
    assert logits.grad_fn is None and not logits.requires_grad
    assert not cache["sub_0"]["k"].requires_grad
    logits, cache = model.decode(lm, torch.zeros(2, dtype=torch.int64), cache, 8)
    assert logits.grad_fn is None and not logits.requires_grad


def test_train_state_from_jax_refuses_a_wrong_tree(smoke_pair):
    ref_cfg, cfg = smoke_pair
    jcfg = jopt.AdamWConfig()
    good = jax.tree.map(np.asarray, jstep.make_train_state(RefModel(ref_cfg),
                                                           jax.random.PRNGKey(0), jcfg))
    state = convert.train_state_from_jax(good, cfg, device="cpu")
    assert set(state["opt"].m) == {n for n, _ in state["params"].named_parameters()}
    bad = [
        {k: v for k, v in good.items() if k != "step"},
        {**good, "opt": {k: v for k, v in good["opt"].items() if k != "v"}},
        {**good, "extra": 1},
        {**good, "opt": {**good["opt"], "m": {**good["opt"]["m"], "embed": good["opt"]["m"]["embed"][:3]}}},
        {**good, "step": np.zeros(2, np.int32)},
    ]
    for tree in bad:
        with pytest.raises(ValueError):
            convert.train_state_from_jax(tree, cfg, device="cpu")


# ------------------------------------------------------------- checkpoints
def test_checkpoint_keep_n_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    state = {"w": torch.arange(8, dtype=torch.float32)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state, loader_state={"seed": 0, "epoch": 0, "fetch_cursor": s})
    assert mgr.all_steps() == [3, 4]
    restored, manifest = mgr.restore({"w": torch.zeros(8)})
    assert manifest["step"] == 4
    assert manifest["loader_state"]["fetch_cursor"] == 4
    assert torch.equal(restored["w"], torch.arange(8, dtype=torch.float32))
    # no tmp dirs left behind
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros(5)})
    with pytest.raises(KeyError):
        mgr.restore({"w": torch.zeros(8), "u": torch.zeros(1)})
    async_mgr = CheckpointManager(str(tmp_path / "async"))
    async_mgr.save(1, state, blocking=False)
    state["w"].add_(1)  # the save took a host copy first
    async_mgr.wait()
    assert torch.equal(async_mgr.restore({"w": torch.zeros(8)})[0]["w"], torch.arange(8.0))


def test_checkpoint_files_have_the_reference_layout(tmp_path):
    """The same tree saved by both managers: the same files, manifest keys,
    array keys and bits, bf16 as uint16 views named in ``ext_dtypes``."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 1, (3, 4)).astype(np.float32)
    b = rng.normal(0, 1, (6,)).astype(np.float32)
    RefCheckpointManager(str(tmp_path / "ref")).save(
        7, {"opt": {"count": np.int32(2)}, "w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)},
        loader_state={"seed": 1}, extra={"arch": "x"})
    CheckpointManager(str(tmp_path / "port")).save(
        7, {"opt": {"count": np.int32(2)}, "w": torch.from_numpy(w),
            "b": torch.from_numpy(b).to(torch.bfloat16)},
        loader_state={"seed": 1}, extra={"arch": "x"})
    dirs = [tmp_path / side / "step_0000000007" for side in ("ref", "port")]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1])) == ["arrays.npz",
                                                                            "manifest.json"]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    for m in manifests:
        m.pop("time")
    assert manifests[0] == manifests[1]
    arrays = [dict(np.load(d / "arrays.npz")) for d in dirs]
    assert arrays[0].keys() == arrays[1].keys()
    for k in arrays[0]:
        assert arrays[0][k].dtype == arrays[1][k].dtype and np.array_equal(arrays[0][k], arrays[1][k]), k


# ------------------------------------------------------------- the training driver
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return str(tmp_path_factory.mktemp("corpus"))


def test_end_to_end_training_loss_decreases(tmp_path):
    model = Model(smoke_config("smollm-360m"))
    loader = build_loader(str(tmp_path / "corpus"), seq_len=64, batch=8, block_size=8,
                          fetch_factor=2, n_tokens=200_000, vocab_size=64)
    timings = {}
    res = train_loop(model, loader, steps=40, lr=3e-3, log_every=5, device="cpu",
                     timings=timings)
    losses = [m["ce_loss"] for m in res["metrics"]]
    assert losses[-1] < losses[0] - 0.1, losses
    # one entry per step; each step's fetch and update lie within its iteration
    assert [len(timings[k]) for k in ("fetch_s", "step_s", "end")] == [40, 40, 40]
    ends = timings["end"]
    assert all(b > a for a, b in zip(ends, ends[1:]))
    assert all(f >= 0 and f + s <= e - a for f, s, a, e in
               zip(timings["fetch_s"][1:], timings["step_s"][1:], ends, ends[1:]))


def _loader(corpus):
    return build_loader(corpus, seq_len=32, batch=4, block_size=4, fetch_factor=2,
                        n_tokens=60_000, vocab_size=128)


def test_crash_restart_bitwise_equal(corpus, tmp_path):
    model = Model(smoke_config("smollm-360m"))
    steps = 14
    ref_run = train_loop(model, _loader(corpus), steps=steps, ckpt_dir=str(tmp_path / "ref"),
                         ckpt_every=4, log_every=100, device="cpu")
    ckpt = str(tmp_path / "crashy")

    def work(resume: bool):
        return train_loop(model, _loader(corpus), steps=steps, ckpt_dir=ckpt, ckpt_every=4,
                          log_every=100, resume=resume, crash_after=None if resume else 9,
                          device="cpu")

    restarts = []
    res = run_with_restarts(work, max_restarts=2, on_restart=lambda n, e: restarts.append(str(e)))
    assert len(restarts) == 1 and "injected crash" in restarts[0]
    want = dict(ref_run["final_state"]["params"].named_parameters())
    got = dict(res["final_state"]["params"].named_parameters())
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for k in want:
        assert torch.equal(ref_run["final_state"]["opt"].m[k], res["final_state"]["opt"].m[k]), k
    manifest = json.loads(open(os.path.join(ckpt, "step_0000000014", "manifest.json")).read())
    assert manifest["extra"]["data_spec"]["uri"].startswith("tokens://")
    assert manifest["loader_state"]["fingerprint"] == _loader(corpus).spec.fingerprint()


def test_run_with_restarts_gives_up_and_backs_off():
    def work(resume):
        raise RuntimeError("always broken")

    slept, gave_up = [], []
    with pytest.raises(RuntimeError):
        run_with_restarts(work, max_restarts=2, backoff_s=0.5, max_backoff_s=0.8,
                          sleep=slept.append, on_give_up=lambda n, e: gave_up.append(n))
    assert slept == [0.5, 0.8] and gave_up == [2]


def test_train_command_line_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "4", "--corpus", str(tmp_path / "corpus"), "--ckpt-dir", str(tmp_path / "ck")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[train] done at step 4" in res.stdout
    assert os.path.isdir(tmp_path / "ck" / "step_0000000004")
