"""The port's optimizer and loss, the counterpart of
``tests/test_optim_and_loss.py``: its eight tests on the port
(``repro_torch.train.loss`` and ``.optimizer``), each held to the JAX
package's function on the same inputs where the reference test checks a
formula; then the vocab-parallel cross-entropy and ``global_norm`` over
DTensors on a (2, 2) ("data", "model") mesh of gloo ranks, equal to the
plain ones: the loss's sums and its gradient within float32 rounding (the
logsumexp of a row adds its two halves' sums), the norm of tensors placed
on both dims, on the "model" dim alone and replicated."""

import jax.numpy as jnp
import numpy as np
import torch
from _hypothesis_compat import given, settings, st

from _torch_gloo import run_ranks
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.train.loss import lm_loss, softmax_cross_entropy
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    warmup_cosine,
)
from repro_torch.train.step import make_train_state, make_train_step


def test_ce_matches_naive():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 7)).astype(np.int32)
    got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    p = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    want = -p.gather(-1, torch.from_numpy(labels).long()[..., None])[..., 0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    ref = jloss.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_lm_loss_mask():
    logits = torch.zeros((1, 4, 8))
    labels = torch.zeros((1, 4), dtype=torch.int32)
    mask = torch.tensor([[1, 1, 0, 0]], dtype=torch.float32)
    loss, metrics = lm_loss(logits, labels, mask, z_loss_weight=0.0)
    assert abs(float(loss) - np.log(8)) < 1e-5
    assert float(metrics["tokens"]) == 2


def test_adamw_first_step_is_lr_sized():
    """After step 1, |update| ~ lr for every param (bias-corrected Adam)."""
    params = {"w": torch.ones(8)}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=None)
    state = adamw_init(params, cfg)
    adamw_update({"w": torch.full((8,), 0.5)}, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), 1.0 - 0.1, atol=1e-4)


def test_adamw_weight_decay_decoupled():
    params = {"w": torch.full((4,), 2.0)}
    cfg = AdamWConfig(lr=0.01, weight_decay=0.5, clip_norm=None)
    state = adamw_init(params, cfg)
    adamw_update({"w": torch.zeros(4)}, state, params, cfg)
    # zero grad -> pure decay: w - lr*wd*w
    np.testing.assert_allclose(params["w"].numpy(), 2.0 - 0.01 * 0.5 * 2.0, atol=1e-6)


@given(scale=st.floats(0.1, 100.0), max_norm=st.floats(0.1, 10.0))
@settings(max_examples=25, deadline=None)
def test_clip_bounds_norm(scale, max_norm):
    tree = {"a": torch.full((16,), scale), "b": torch.full((4, 4), -scale)}
    clipped, g = clip_by_global_norm(tree, max_norm)
    n = float(global_norm(clipped))
    assert n <= max_norm * 1.001
    if float(g) <= max_norm:  # under the cap: untouched
        np.testing.assert_allclose(clipped["a"].numpy(), tree["a"].numpy(), rtol=1e-5)
    want = jopt.global_norm({k: jnp.asarray(v.numpy()) for k, v in tree.items()})
    np.testing.assert_allclose(float(g), float(want), rtol=1e-6)


def test_warmup_cosine_shape():
    f = warmup_cosine(1.0, warmup=10, total=100, floor=0.1)
    assert float(f(0)) == 0.0
    assert abs(float(f(10)) - 1.0) < 0.01
    assert float(f(100)) >= 0.099
    assert float(f(55)) < float(f(20))
    jf = jopt.warmup_cosine(1.0, warmup=10, total=100, floor=0.1)
    for s in (0, 5, 10, 55, 100):
        assert float(f(s)) == float(jf(jnp.asarray(s))), s


def test_bf16_moments_halve_memory():
    params = {"w": torch.ones(1024, dtype=torch.bfloat16)}
    s32 = adamw_init(params, AdamWConfig(moment_dtype="float32"))
    s16 = adamw_init(params, AdamWConfig(moment_dtype="bfloat16"))
    assert s32.m["w"].dtype == torch.float32
    assert s16.m["w"].dtype == torch.bfloat16


def test_microbatch_equivalence():
    """Grad accumulation over n microbatches == full-batch step (same math)."""
    model = Model(smoke_config("smollm-360m"))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 100, (4, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    cfg = AdamWConfig(lr=1e-2)
    s1 = make_train_state(model, cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    s2 = make_train_state(model, cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    s1, m1 = make_train_step(model, cfg, num_microbatches=1)(s1, batch)
    s2, m2 = make_train_step(model, cfg, num_microbatches=2)(s2, batch)
    # losses agree; params agree to accumulation-order tolerance
    assert abs(float(m1["ce_loss"]) - float(m2["ce_loss"])) < 5e-3
    for a, b in zip(s1["params"].parameters(), s2["params"].parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   atol=5e-2)


def test_vocab_parallel_loss_and_global_norm_equal_the_plain_ones(tmp_path):
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(0, 3, (4, 6, 10)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (4, 6)).astype(np.int64))
    mask = torch.from_numpy((rng.random((4, 6)) < 0.8).astype(np.float32))
    ranks = run_ranks("vocab_parallel_loss", 4, tmp_path, (2, 2), logits, labels, mask)

    x = logits.clone().requires_grad_()
    total, metrics = lm_loss(x, labels, mask, z_loss_weight=1e-4)
    total.backward()
    want = torch.stack([total.detach(), metrics["ce_loss"], metrics["z_loss"]])
    norm = torch.sqrt(logits.square().sum() + logits[0].square().sum()
                      + labels.float().square().sum())
    for r in ranks:
        assert r["local_vocab"] == 5  # each "model" rank holds half the vocabulary
        torch.testing.assert_close(r["sums"], want, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(r["grad"], x.grad, atol=1e-7, rtol=1e-5)
        torch.testing.assert_close(r["norm"], norm, atol=0, rtol=1e-6)
