"""The hybrid family (jamba), port against the JAX package on the CPU:
jamba's smoke config (Mamba layers 0, 1 and 3 of each period of 4,
attention at 2, MoE on the odd layers, no RoPE) at 4 layers (one period)
and 8 (two, so that the reference's ``sub_i`` entry s is the port's layer
s·P + i), with the reference's weights carried over by ``convert``: the
forward's logits without a gradient, the prefill's logits and the whole
cache key by key, 4 decode steps, ``serve_batch`` and ``SlotBatcher``
against standalone serves and the reference's batcher; a depth that is
not a whole number of periods (the port's LM takes it, the reference's
tree does not); and training, refused (ROADMAP.md queue A #9)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.launch.serve import serve_batch as ref_serve_batch
from repro.models import Model as RefModel
from repro.models import param_count as ref_param_count
from repro.models import transformer as jtr
from repro.serve.scheduler import ContinuousBatcher
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import Model, param_count
from repro_torch.models import transformer as tr
from repro_torch.serve.scheduler import SlotBatcher
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import make_train_state, make_train_step

ARCH = "jamba-1.5-large-398b"
# float32, sums in another order through up to 8 layers (the ssm family's
# MODEL_TOL, tests/test_torch_ssm.py)
MODEL_TOL = 2e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
# greedy tokens agree until two logits tie within what float32 sums in
# another order can move them (tests/test_torch_serve.py's rule)
TIE_F32 = 2e-4
DEPTHS = [4, 8]


def _cfgs(layers: int, dtypes: dict):
    ref_cfg = dataclasses.replace(ref_smoke_config(ARCH), num_layers=layers, **dtypes)
    cfg = dataclasses.replace(smoke_config(ARCH), num_layers=layers, **dtypes)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    return ref_cfg, cfg


def _pair(layers: int, dtypes: dict, jparams=None):
    """The reference's model and params (drawn from PRNGKey(0), or
    ``jparams`` cast to ``dtypes``), the port's model and the same
    weights."""
    ref_cfg, cfg = _cfgs(layers, dtypes)
    jmodel = RefModel(ref_cfg)
    fresh, _ = jmodel.init(jax.random.PRNGKey(0))
    if jparams is not None:
        fresh = jax.tree.map(lambda a, b: b.astype(a.dtype), fresh, jparams)
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, fresh), cfg, device="cpu")
    return jmodel, fresh, Model(cfg), lm


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _run(jmodel, jparams, model, lm, tokens, prompt_len, steps):
    """Both packages: the forward's logits over ``tokens``, then a prefill
    of the first ``prompt_len`` and ``steps`` decode steps on the JAX
    side's greedy tokens; each call's logits as float32 numpy, and the
    final caches."""
    B = tokens.shape[0]
    want = {"forward": np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})[0],
                                  np.float32)}
    with torch.no_grad():
        got = {"forward": model.forward(lm, {"tokens": torch.from_numpy(tokens)}).float().numpy()}
    jcache = jmodel.init_cache(B, prompt_len + steps)
    cache = model.init_cache(B, prompt_len + steps, device="cpu")
    prompt = tokens[:, :prompt_len]
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    tl, cache = model.prefill(lm, {"tokens": torch.from_numpy(prompt.astype(np.int64))}, cache)
    want["prefill"], got["prefill"] = np.asarray(jl, np.float32), tl.float().numpy()
    tok = np.asarray(jl).argmax(-1)
    for i in range(steps):
        jl, jcache = jmodel.decode(jparams, jnp.asarray(tok, jnp.int32), jcache,
                                   jnp.asarray(prompt_len + i, jnp.int32))
        tl, cache = model.decode(lm, torch.from_numpy(tok.astype(np.int64)), cache, prompt_len + i)
        want[f"decode_{i}"], got[f"decode_{i}"] = np.asarray(jl, np.float32), tl.float().numpy()
        tok = np.asarray(jl).argmax(-1)
    return got, want, cache, jcache


@pytest.mark.parametrize("layers", DEPTHS, ids=["4_layers", "8_layers"])
def test_forward_prefill_cache_and_decode_match_reference(layers):
    """float32: the forward's logits, the prefill's last-position logits,
    its cache entry by entry (the Mamba positions' windows and states, the
    attention position's ring) and 4 decode steps."""
    jmodel, jparams, model, lm = _pair(layers, F32)
    tokens = _tokens(model.cfg, 2, 24, seed=1)
    got, want, cache, jcache = _run(jmodel, jparams, model, lm, tokens, 20, 4)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=MODEL_TOL, rtol=MODEL_TOL, err_msg=key)
    assert sorted(cache) == sorted(jcache) == ["sub_0", "sub_1", "sub_2", "sub_3"]
    for sub in jcache:
        assert sorted(cache[sub]) == sorted(jcache[sub]), sub
        for name, want_t in jcache[sub].items():
            t = cache[sub][name]
            assert t.shape == want_t.shape and str(t.dtype).removeprefix("torch.") == \
                np.dtype(want_t.dtype).name, (sub, name)
            np.testing.assert_allclose(t.numpy(), np.asarray(want_t), atol=MODEL_TOL,
                                       rtol=MODEL_TOL, err_msg=f"{sub}/{name}")
    assert sorted(cache["sub_2"]) == ["k", "v"] and sorted(cache["sub_0"]) == ["conv", "h"]


# bf16: the port's scan rounds y once where the reference's model rounds it
# twice (ROADMAP.md queue C #7), and the MoE layers route on bf16 inputs: a
# token whose two best experts lie within bf16 noise of the third may take
# another expert on either side (a logit then moves by up to about 2).  So
# neither bf16 run is held to the other; each is held to the float32
# function from the same (bf16) weights, and the port's rms error there
# may be at most BF16_RMS_FACTOR times the reference's.
BF16_RMS_FACTOR = 2.0


@pytest.mark.parametrize("layers", DEPTHS, ids=["4_layers", "8_layers"])
def test_bf16_is_as_close_to_float32_as_the_reference(layers):
    jmodel, jparams, model, lm = _pair(layers, BF16)
    j32, p32, m32, lm32 = _pair(layers, F32, jparams=jparams)
    tokens = _tokens(model.cfg, 2, 24, seed=2)
    got, want, cache, _ = _run(jmodel, jparams, model, lm, tokens, 20, 4)
    _, exact, _, _ = _run(j32, p32, m32, lm32, tokens, 20, 4)
    assert cache["sub_2"]["k"].dtype == torch.bfloat16 and cache["sub_0"]["h"].dtype == torch.float32

    def rms(x):
        return float(np.sqrt(np.mean(np.square(x))))

    for key in want:
        port, ref = rms(got[key] - exact[key]), rms(want[key] - exact[key])
        assert np.isfinite(got[key]).all() and port <= BF16_RMS_FACTOR * ref, (key, port, ref)


def test_the_periods_interleave_and_any_depth_builds():
    """The reference's entry s of ``sub_i`` is the port's layer s·P + i
    (P = attn_period = 4), each with its kinds; a depth that is not a
    whole number of periods (jamba's 5 of 72 on the card) builds and
    caches in the port, while the reference's stacked tree refuses it, and
    so does ``lm_from_jax``."""
    jmodel, jparams, model, lm = _pair(8, F32)
    P = model.cfg.attn_period
    for layer, blk in enumerate(lm.blocks):
        sub = jparams["blocks"][f"sub_{layer % P}"]
        mixer = "attn" if model.cfg.is_attn_layer(layer) else "ssm"
        ffn = "moe" if model.cfg.is_moe_layer(layer) else "mlp"
        assert hasattr(blk, mixer) and hasattr(blk, ffn), layer
        for group in (mixer, ffn):
            for name, t in getattr(blk, group).p.items():
                np.testing.assert_array_equal(t.detach().numpy(),
                                              np.asarray(sub[group][name][layer // P]))
    ref_cfg, cfg = _cfgs(5, F32)
    with pytest.raises(ValueError, match="period"):
        jtr.init_lm(jax.random.PRNGKey(0), ref_cfg)
    with pytest.raises(ValueError, match="period"):
        convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    five = Model(cfg).init(generator=torch.Generator().manual_seed(0), device="cpu")
    assert [(hasattr(b, "attn"), hasattr(b, "moe")) for b in five.blocks] == cfg.layer_kinds()
    # the eight-layer model's first five layers, and its embedding, head and norm
    n_params = sum(p.numel() for p in five.parameters())
    assert n_params == sum(p.numel() for p in lm.parameters()) - sum(
        p.numel() for b in lm.blocks[5:] for p in b.parameters())
    cache = Model(cfg).init_cache(3, 16, device="cpu")
    assert {sub: tuple(t.shape[:2] for t in bufs.values()) for sub, bufs in cache.items()} == \
        {"sub_0": ((2, 3), (2, 3)), "sub_1": ((1, 3), (1, 3)), "sub_2": ((1, 3), (1, 3)),
         "sub_3": ((1, 3), (1, 3))}
    tokens = torch.from_numpy(_tokens(cfg, 3, 12, seed=3))
    logits, cache = Model(cfg).prefill(five, {"tokens": tokens}, cache)
    assert logits.shape == (3, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_full_config_at_five_layers_holds_every_kind():
    """jamba-1.5-large at 5 of its 72 layers, as the card serves it: by
    the reference's own count, 24.0 B weights, and the five layers hold
    the three kinds of layer it has."""
    full = get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_get_config(ARCH))
    five = dataclasses.replace(full, num_layers=5)
    assert round(ref_param_count(dataclasses.replace(ref_get_config(ARCH), num_layers=5)) / 1e9,
                 1) == 24.0
    assert param_count(five) == ref_param_count(dataclasses.replace(ref_get_config(ARCH),
                                                                    num_layers=5))
    assert set(five.layer_kinds()) == {(False, False), (False, True), (True, False)}
    assert set(full.layer_kinds()) == set(five.layer_kinds())


# ---------------------------------------------------------------- serving
def _assert_matches(got, want, lgs, tie, ctx):
    """Equal sequences, except that at a tie (two logits of the step within
    ``tie``) the rest is not compared."""
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


@pytest.fixture(scope="module")
def serving_pair():
    return _pair(4, F32)


def test_serve_batch_matches_reference(serving_pair):
    jmodel, _, model, lm = serving_pair
    prompts = _tokens(model.cfg, 3, 10, seed=11)
    want = ref_serve_batch(jmodel, prompts, 8)  # PRNGKey(0)'s weights, as lm's
    got = serve.serve_batch(model, prompts, 8, params=lm, device="cpu")
    assert got.shape == (3, 8)
    for b in range(3):
        _, lgs = _standalone(model, lm, prompts[b], 8, 18)
        _assert_matches(got[b].tolist(), want[b].tolist(), lgs, TIE_F32, b)


def test_batcher_over_hybrid_caches_matches_standalone_and_reference(serving_pair):
    """2 slots, 5 requests of mixed prompt lengths joining mid-stream: at
    admission the Mamba positions' states overwrite the slot wholesale and
    the attention position's ring is filled at the shared cursor's offset,
    masked by the slot's ``start``."""
    jmodel, jparams, model, lm = serving_pair
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, model.cfg.vocab_size, int(n)).astype(np.int32)
               for n in (8, 12, 2, 9, 5)]
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
        _assert_matches(req.out, want, lgs, TIE_F32, ("standalone", req.rid))
        _assert_matches(req.out, ref_req.out, lgs, TIE_F32, ("reference batcher", req.rid))


def test_training_is_refused_naming_its_item():
    """The scan has no backward yet: the forward under a gradient and the
    train step raise ``NotImplementedError`` naming ROADMAP.md queue A #9;
    without a gradient the forward runs."""
    cfg = smoke_config(ARCH)
    model = Model(cfg)
    state = make_train_state(model, AdamWConfig(lr=1e-3), device="cpu",
                             generator=torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(_tokens(cfg, 2, 16, seed=4).astype(np.int64))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A #9"):
        make_train_step(model, AdamWConfig(lr=1e-3))(state, {"tokens": tokens, "labels": tokens})
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A #9"):
        model.forward(state["params"], {"tokens": tokens})
    with torch.no_grad():
        logits, aux = model.forward(state["params"], {"tokens": tokens}, return_aux=True)
    assert logits.shape == (2, 16, cfg.vocab_size) and float(aux["lb_loss"]) > 0
