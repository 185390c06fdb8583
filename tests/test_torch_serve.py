"""The serving slice as a whole, port against the JAX package on the CPU:
``serve_batch`` and the continuous batcher on the same prompts (numpy,
seeded) and the same weights (drawn by ``repro``, carried over by
``convert.lm_from_jax``), and the batcher's admission contract."""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.launch.serve import serve_batch as ref_serve_batch
from repro.models import Model as RefModel
from repro.serve.scheduler import ContinuousBatcher
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


@pytest.mark.parametrize("arch", [None, "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "gemma-7b",
                                  "phi3-medium-14b", "h2o-danube-3-4b"],
                         ids=lambda a: a or "default")
def test_serve_main_runs_the_smoke_config_on_the_cpu(capsys, arch):
    argv = [] if arch is None else ["--arch", arch]
    assert serve.main([*argv, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated shape (2, 4)" in out and "on cpu" in out
