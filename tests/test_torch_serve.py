"""The serving slice as a whole, port against the JAX package on the CPU:
``serve_batch`` and the continuous batcher on the same prompts (numpy,
seeded) and the same weights (drawn by ``repro``, carried over by
``convert.lm_from_jax``), and the batcher's admission contract; for the
vlm and encdec families ``serve_batch`` against the reference's model
driven at their positions, where the reference's launcher differs
(ROADMAP.md queue C #20)."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.launch.serve import serve_batch as ref_serve_batch
from repro.models import Model as RefModel
from repro.serve.scheduler import ContinuousBatcher
from repro.train.step import make_serve_steps as ref_make_serve_steps
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.serve.scheduler import SlotBatcher

# Greedy tokens agree until two logits tie within what the two frameworks'
# rounding can move them; after such a tie the continuations may diverge.
# float32: the forward agrees to 2e-4 (tests/test_torch_lm.py).  bf16: one
# bf16 ulp of a logit near 3 is 0.016 (the rule of tests/test_scheduler.py).
TIE_F32, TIE_BF16 = 2e-4, 2.5e-2


def _configs(f32: bool, arch: str = "smollm-360m"):
    ref_cfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    if f32:
        kw = dict(param_dtype="float32", compute_dtype="float32")
        ref_cfg, cfg = dataclasses.replace(ref_cfg, **kw), dataclasses.replace(cfg, **kw)
    return ref_cfg, cfg


# smollm-360m's smoke config, and mixtral-8x7b's in float32: the moe
# family, whose decode steps route each slot's token in a group of its own.
# Not mixtral in bf16: there the first layer's router ranks the second and
# third expert of one prompt's token 8e-4 apart in probability, and the
# batcher, which places the prompt at another absolute position, rounds
# its RoPE'd queries and keys otherwise, which swaps the two and moves the
# first token's logits by 0.3: the logit tie rule cannot cover a flip of
# the routing, and which near-ties flip depends on where each framework
# rounds in bf16
@pytest.fixture(scope="module", params=[(True, "smollm-360m"), (False, "smollm-360m"),
                                        (True, "mixtral-8x7b")],
                ids=["f32", "bf16", "mixtral-f32"])
def pair(request):
    """(cfg, JAX model, JAX params, port model, port params, tie tolerance);
    the weights are ``repro``'s PRNGKey(0) draw, which its serve_batch uses."""
    f32, arch = request.param
    ref_cfg, cfg = _configs(f32, arch)
    jmodel = RefModel(ref_cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), lm, TIE_F32 if f32 else TIE_BF16


def _standalone(model, lm, prompt, max_new, max_len):
    """The port's greedy continuation of one prompt, and each step's logits."""
    cache = model.init_cache(1, max_len, device="cpu")
    logits, cache = model.prefill(lm, {"tokens": torch.from_numpy(prompt[None].astype(np.int64))},
                                  cache)
    toks, lgs = [int(logits[0].argmax())], [logits[0].float().numpy()]
    pos = len(prompt)
    while len(toks) < max_new:
        logits, cache = model.decode(lm, torch.tensor([toks[-1]]), cache, pos)
        toks.append(int(logits[0].argmax()))
        lgs.append(logits[0].float().numpy())
        pos += 1
    return toks, lgs


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


def test_serve_batch_matches_reference(pair):
    cfg, jmodel, _, model, lm, tie = pair
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    want = ref_serve_batch(jmodel, prompts, 8)
    timings = {}
    got = serve.serve_batch(model, prompts, 8, params=lm, device="cpu", timings=timings)
    assert got.shape == (3, 8) and timings["decode_steps"] == 7
    for b in range(3):
        _, lgs = _standalone(model, lm, prompts[b], 8, 18)
        _assert_matches(got[b].tolist(), want[b].tolist(), lgs, tie, b)


def _requests(cfg, seed=11):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in (8, 12, 5, 9, 7)]
    return prompts, [6, 4, 5, 3, 6]


def test_batcher_matches_standalone_and_reference_batcher(pair):
    """Each request of the port's batcher (2 slots, 5 requests joining
    mid-stream) equals the port's standalone serve of its prompt and the
    JAX package's ContinuousBatcher's answer to it."""
    cfg, jmodel, jparams, model, lm, tie = pair
    prompts, max_new = _requests(cfg)
    batcher = SlotBatcher(model, lm, batch_slots=2, max_len=96)
    ref_batcher = ContinuousBatcher(jmodel, jparams, batch_slots=2, max_len=96)
    for p, m in zip(prompts, max_new):
        batcher.submit(p, m)
        ref_batcher.submit(p, m)
    done, ref_done = batcher.run(), ref_batcher.run()
    assert [r.rid for r in done] == [r.rid for r in ref_done] == list(range(5))
    for req, ref_req, p, m in zip(done, ref_done, prompts, max_new):
        want, lgs = _standalone(model, lm, p, m, 96)
        _assert_matches(req.out, want, lgs, tie, ("standalone", req.rid))
        _assert_matches(req.out, ref_req.out, lgs, tie, ("reference batcher", req.rid))


def test_batcher_with_a_sliding_window_matches_standalone():
    """A ring cache shorter than the stream: slots that join mid-stream
    land at wrapped ring offsets."""
    _, cfg = _configs(True)
    cfg = dataclasses.replace(cfg, sliding_window=10)
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(3), device="cpu")
    prompts, max_new = _requests(cfg, seed=12)
    batcher = SlotBatcher(model, lm, batch_slots=2, max_len=96)
    for p, m in zip(prompts, max_new):
        batcher.submit(p, m + 8)
    for req, p, m in zip(batcher.run(), prompts, max_new):
        want, lgs = _standalone(model, lm, p, m + 8, 96)
        _assert_matches(req.out, want, lgs, TIE_F32, req.rid)


# ------------------------------------------------ admission-control contract
# The counterparts of tests/test_scheduler.py's: exhausted slots queue
# instead of overcommitting, the queue drains FIFO, and rids are stable
# under concurrent submission.

def _batcher(batch_slots):
    cfg = smoke_config("smollm-360m")
    model = Model(cfg)
    lm = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    return cfg, SlotBatcher(model, lm, batch_slots=batch_slots, max_len=64)


def test_admission_stops_at_slot_exhaustion():
    cfg, batcher = _batcher(2)
    rng = np.random.default_rng(7)
    for _ in range(5):
        batcher.submit(rng.integers(0, cfg.vocab_size, 6).astype(np.int32), 4)
    batcher.step()
    assert sum(r is not None for r in batcher.slots) == 2
    assert len(batcher.queue) == 3
    assert all(len(r.out) == 0 for r in batcher.queue)
    done = batcher.run()
    assert len(done) == 5
    assert all(len(r.out) == 4 for r in done)


def test_admission_is_fifo():
    cfg, batcher = _batcher(1)
    rng = np.random.default_rng(9)
    for m in (5, 2, 4, 3):
        batcher.submit(rng.integers(0, cfg.vocab_size, 6).astype(np.int32), m)
    done = batcher.run()
    assert [r.rid for r in done] == [0, 1, 2, 3]
    assert [r.rid for r in batcher.completed] == [0, 1, 2, 3]
    assert [len(r.out) for r in done] == [5, 2, 4, 3]


def test_rids_stable_under_concurrent_submission():
    cfg, batcher = _batcher(2)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32) for _ in range(40)]

    def submit(k):
        for p in prompts[k * 5:(k + 1) * 5]:
            batcher.submit(p, 2)

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(r.rid for r in batcher.queue) == list(range(40))


def test_rids_account_for_completed_requests():
    cfg, batcher = _batcher(1)
    prompt = np.random.default_rng(17).integers(0, cfg.vocab_size, 6).astype(np.int32)
    batcher.submit(prompt, 2)
    batcher.submit(prompt, 2)
    assert len(batcher.run()) == 2
    batcher.submit(prompt, 2)
    batcher.submit(prompt, 2, rid=99)
    assert [r.rid for r in batcher.run()] == [0, 1, 2, 99]


# ------------------------------------------------ the vlm and encdec families

FAMILY_ARCHS = ["internvl2-26b", "whisper-large-v3"]


def _extra(cfg, B, seed):
    """The frontends' stubs: the vlm's patch embeddings, or encdec's frames
    of ``cross_len`` rows (fewer would leave zero states in the cross
    cache, which the teacher-forced forward does not attend)."""
    rng = np.random.default_rng(seed)
    rows = cfg.num_patches if cfg.family == "vlm" else cfg.cross_len
    key = "patch_embeds" if cfg.family == "vlm" else "frames"
    return {key: rng.normal(0, 1, (B, rows, cfg.d_model)).astype(np.float32)}


def _reference_greedy(jmodel, jparams, prompts, extra, gen_len, max_len, start):
    """The reference's Model driven greedily through its serve steps,
    jitted as its launcher jits them: a prefill, then decode steps at
    ``start + i``; the tokens (B, gen_len) and each step's logits."""
    prefill_step, decode_step = ref_make_serve_steps(jmodel)
    cache = jmodel.init_cache(prompts.shape[0], max_len)
    batch = {"tokens": jnp.asarray(prompts), **{k: jnp.asarray(v) for k, v in extra.items()}}
    logits, cache = jax.jit(prefill_step)(jparams, batch, cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, lgs = [np.asarray(tok)], [np.asarray(logits)]
    decode = jax.jit(decode_step, donate_argnums=(2,))
    for i in range(gen_len - 1):
        tok, logits, cache = decode(jparams, tok, cache, jnp.asarray(start + i, jnp.int32))
        toks.append(np.asarray(tok))
        lgs.append(np.asarray(logits))
    return np.stack(toks, axis=1), lgs


def _right_span(cfg, P, gen_len):
    """(cache length, first decode position): after the image prefix and
    the prompt for vlm; after the BOS token for encdec."""
    if cfg.family == "encdec":
        return gen_len, 1
    return cfg.num_patches + P + gen_len, cfg.num_patches + P


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family_pair(request):
    ref_cfg, cfg = _configs(True, request.param)
    jmodel = RefModel(ref_cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), lm


def test_serve_batch_of_new_families_matches_reference_model(family_pair):
    """The port's serve_batch equals a greedy loop over the reference's
    Model.prefill and decode at the model's positions (vlm: num_patches +
    P + i; encdec: 1 + i), float32."""
    cfg, jmodel, jparams, model, lm = family_pair
    B, P, gen = 3, 10, 8
    prompts = np.random.default_rng(20).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    extra = _extra(cfg, B, seed=21)
    timings = {}
    got = serve.serve_batch(model, prompts, gen, extra=extra, params=lm, device="cpu",
                            timings=timings)
    assert got.shape == (B, gen) and timings["decode_steps"] == gen - 1
    assert serve.decode_span(cfg, P, gen) == _right_span(cfg, P, gen)
    want, lgs = _reference_greedy(jmodel, jparams, prompts, extra, gen, *_right_span(cfg, P, gen))
    for b in range(B):
        _assert_matches(got[b].tolist(), want[b].tolist(), [lg[b] for lg in lgs], TIE_F32, b)


def test_reference_launcher_decodes_the_new_families_at_text_positions(family_pair):
    """ROADMAP.md queue C #20: the reference's serve_batch sizes the cache
    P + gen_len and decodes at P + i for every family.  Its tokens are the
    greedy loop's at those positions; there the first decode step's logits
    are off the teacher-forced forward's (by 3.0 and 0.36 at these smoke
    configs), where the model's own positions give them within float32
    rounding."""
    cfg, jmodel, jparams, _, _ = family_pair
    B, P, gen = 3, 10, 8
    prompts = np.random.default_rng(22).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    extra = _extra(cfg, B, seed=23)
    launched = ref_serve_batch(jmodel, prompts, gen, extra=extra)
    at_text, lgs_text = _reference_greedy(jmodel, jparams, prompts, extra, gen, P + gen, P)
    np.testing.assert_array_equal(launched, at_text)
    _, lgs_right = _reference_greedy(jmodel, jparams, prompts, extra, gen,
                                     *_right_span(cfg, P, gen))
    tok0 = at_text[:, 0]  # the prefill's token: the same at both positions
    if cfg.family == "vlm":
        tokens = np.concatenate([prompts, tok0[:, None]], axis=1)
        teacher, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens),
                                              "patch_embeds": jnp.asarray(extra["patch_embeds"])})
        want = np.asarray(teacher)[:, P]
    else:
        tokens = np.stack([np.zeros(B, np.int32), tok0], axis=1)  # BOS, then the first token
        teacher, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens),
                                              "frames": jnp.asarray(extra["frames"])})
        want = np.asarray(teacher)[:, 1]
    np.testing.assert_allclose(lgs_right[1], want, atol=1e-4, rtol=1e-4)
    assert np.abs(lgs_text[1] - want).max() > 100 * TIE_F32


def test_batcher_refuses_the_new_families_as_the_reference(family_pair):
    """Decoder-only text families only: encdec is refused at construction
    with the reference's ValueError; a vlm request fails at its first
    prefill with the reference's KeyError (the batch holds no image
    prefix)."""
    cfg, jmodel, jparams, model, lm = family_pair
    prompt = np.arange(6, dtype=np.int32)
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="decoder-only") as want:
            ContinuousBatcher(jmodel, jparams, batch_slots=2, max_len=32)
        with pytest.raises(ValueError) as got:
            SlotBatcher(model, lm, batch_slots=2, max_len=32)
        assert str(got.value) == str(want.value)
        return
    for batcher in (ContinuousBatcher(jmodel, jparams, batch_slots=2, max_len=32),
                    SlotBatcher(model, lm, batch_slots=2, max_len=32)):
        batcher.submit(prompt, 3)
        with pytest.raises(KeyError, match="patch_embeds"):
            batcher.step()


@pytest.mark.parametrize("arch", [None, "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "gemma-7b",
                                  "phi3-medium-14b", "h2o-danube-3-4b", *FAMILY_ARCHS],
                         ids=lambda a: a or "default")
def test_serve_main_runs_the_smoke_config_on_the_cpu(capsys, arch):
    argv = [] if arch is None else ["--arch", arch]
    assert serve.main([*argv, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated shape (2, 4)" in out and "on cpu" in out
