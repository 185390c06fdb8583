"""Per-architecture smoke tests of the port, the counterpart of
``tests/test_arch_smoke.py`` for the ids the port registers (all ten):
the full configs and their parameter counts against the JAX
package's, and each smoke config's forward, prefill and decode on the CPU
(shapes, finite values, decode tracking the forward), the vlm's with its
image prefix and the encdec's with its frames."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.models import active_param_count as ref_active_param_count
from repro.models import param_count as ref_param_count
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch.serve import decode_span
from repro_torch.models import Model, active_param_count, param_count
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import make_train_state, make_train_step

# the published sizes, in billions (tests/test_arch_smoke.py's, with its
# 12% for the embedding and norm bookkeeping)
_EXPECT_B = {"falcon-mamba-7b": 7.3, "mixtral-8x7b": 46.7, "phi3.5-moe-42b-a6.6b": 42.0,
             "gemma-7b": 8.5, "phi3-medium-14b": 14.0, "smollm-360m": 0.36,
             "h2o-danube-3-4b": 4.0, "internvl2-26b": 20.0, "whisper-large-v3": 1.55,
             "jamba-1.5-large-398b": 398.0}
_EXPECT_ACTIVE_B = {"mixtral-8x7b": 12.9, "phi3.5-moe-42b-a6.6b": 6.6,
                    "jamba-1.5-large-398b": 94.0}
# the families whose training is not ported, and the ROADMAP.md item that ports it
_NO_TRAINING = {"ssm": "queue A #9", "hybrid": "queue A #9"}


def test_the_port_registers_every_reference_id_but_three():
    """Named when three ids waited; since the hybrid family was ported
    (ROADMAP.md queue A #13's first half) none does: the registries are
    equal."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(ref_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count(arch):
    cfg = get_config(arch)
    cfg.validate()
    n, na = param_count(cfg), active_param_count(cfg)
    assert n == ref_param_count(ref_get_config(arch))
    assert na == ref_active_param_count(ref_get_config(arch))
    assert abs(n / 1e9 - _EXPECT_B[arch]) / _EXPECT_B[arch] < 0.12, (arch, n)
    if arch in _EXPECT_ACTIVE_B:
        assert abs(na / 1e9 - _EXPECT_ACTIVE_B[arch]) / _EXPECT_ACTIVE_B[arch] < 0.12, (arch, na)
    else:
        assert na == n


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_init_has_the_references_weights(arch):
    """The port's LM holds as many weights as the reference's params tree,
    in the same types (the norms, and the ssm's dt_bias, A_log and D, in
    float32)."""
    cfg = smoke_config(arch)
    lm = Model(cfg).init(generator=torch.Generator().manual_seed(0), device="cpu")
    jparams, _ = RefModel(ref_smoke_config(arch)).init(jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(jparams)
    assert sum(p.numel() for p in lm.parameters()) == sum(int(np.size(a)) for a in leaves)
    dtypes = sorted(str(p.dtype).removeprefix("torch.") for p in lm.parameters())
    assert set(dtypes) == {np.dtype(a.dtype).name for a in leaves}


def _tokens(cfg, B, S, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)))


def _batch(cfg, B, S, seed=0) -> dict:
    """``tokens`` (B, S), with the vlm's ``patch_embeds`` (B, num_patches,
    d) or encdec's ``frames`` (B, S, d), as ``launch/serve.py``'s main
    draws them."""
    batch = {"tokens": _tokens(cfg, B, S, seed)}
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_prefill_and_decode(arch):
    cfg = smoke_config(arch)
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 32
    batch = _batch(cfg, B, S)
    with torch.no_grad():
        logits, aux = model.forward(lm, batch, return_aux=True)
    assert logits.shape == (B, S, cfg.vocab_size) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert set(aux) == {"lb_loss", "z_loss"}
    assert (float(aux["lb_loss"]) > 0) == (cfg.moe is not None)

    max_len, start = decode_span(cfg, S // 2, 4)  # the prefill's token, 2 steps, a spare slot
    cache = model.init_cache(B, max_len=max_len, device="cpu")
    prompt = {**batch, "tokens": batch["tokens"][:, :S // 2]}
    logits, cache = model.prefill(lm, prompt, cache)
    assert logits.shape == (B, cfg.vocab_size)
    tok = logits.argmax(-1)
    for i in range(2):
        logits, cache = model.decode(lm, tok, cache, start + i)
        assert logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_or_its_item(arch):
    """One AdamW step of the smoke config where its family trains; else
    ``NotImplementedError`` naming the item that ports its training."""
    cfg = smoke_config(arch)
    model = Model(cfg)
    state = make_train_state(model, AdamWConfig(lr=1e-3), device="cpu",
                             generator=torch.Generator().manual_seed(1))
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    batch = _batch(cfg, 2, 32, seed=2)
    batch["labels"] = batch["tokens"]
    if cfg.family in _NO_TRAINING:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {_NO_TRAINING[cfg.family]}"):
            step(state, batch)
        return
    state, metrics = step(state, batch)
    assert state["step"] == 1
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert ("moe_lb_loss" in metrics) == (cfg.moe is not None)


# Not the moe family: a token's expert capacity is shared with the other
# tokens of its group, so the forward over 12 tokens (one group, capacity
# 8 an expert) keeps pairs that a prefill of the first 4 (capacity 3)
# drops: a prefix's outputs are not the forward's, in the reference too.
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma-7b"])
def test_decode_consistent_with_forward(arch):
    """Greedy decode logits track the teacher-forced forward's (causal LM):
    a prefill of 4 tokens, then the gold tokens one by one (through the
    sliding-window ring for danube); bf16, the reference test's tolerance."""
    cfg = smoke_config(arch)
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    B, S = 1, 12
    tokens = _tokens(cfg, B, S, seed=3)
    with torch.no_grad():
        full = model.forward(lm, {"tokens": tokens}).float()
    cache = model.init_cache(B, max_len=S, device="cpu")
    lg, cache = model.prefill(lm, {"tokens": tokens[:, :4]}, cache)
    torch.testing.assert_close(lg.float(), full[:, 3], atol=2e-2, rtol=2e-2)
    for pos in range(4, S):
        lg, cache = model.decode(lm, tokens[:, pos], cache, pos)
        torch.testing.assert_close(lg.float(), full[:, pos], atol=2e-2, rtol=2e-2)


def test_ssm_prefill_decode_consistency():
    """SSM state threading: prefill(S - 1) then one decode step equals the
    forward over S tokens."""
    cfg = smoke_config("falcon-mamba-7b")
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    B, S = 1, 10
    tokens = _tokens(cfg, B, S, seed=4)
    with torch.no_grad():
        full = model.forward(lm, {"tokens": tokens}).float()
    cache = model.init_cache(B, max_len=S, device="cpu")
    lg, cache = model.prefill(lm, {"tokens": tokens[:, :S - 1]}, cache)
    torch.testing.assert_close(lg.float(), full[:, S - 2], atol=2e-2, rtol=2e-2)
    lg, cache = model.decode(lm, tokens[:, S - 1], cache, S - 1)
    torch.testing.assert_close(lg.float(), full[:, S - 1], atol=2e-2, rtol=2e-2)
