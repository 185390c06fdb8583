"""The tensor- and expert-parallel forward on gloo ranks on the CPU: every
family's smoke config (dense smollm, moe mixtral, ssm falcon-mamba, hybrid
jamba, encdec whisper, vlm internvl2) in float32, its weights drawn by the
JAX package and carried over, placed by ``distribute_params`` on a
("data", "model") mesh of (1, 2) and (2, 2) ranks, its cache by
``distribute_cache``; the forward, the prefill and 4 decode steps run
inside ``sharding_context`` under ``RULES_DECODE`` on both meshes, and on
(2, 2) under the batch-1 rule sets ``RULES_DECODE_LONG`` and
``RULES_DECODE_WS`` too (``RULES_TRAIN``, whose activations are
``RULES_DECODE``'s and whose cache keeps its positions whole, for smollm
and whisper).  Each is held against the port's
single-process call on the same inputs (the row-parallel sums add in
another order: 1e-5 absolute plus 1e-5 relative; greedy tokens equal
unless the top two logits lie within 1e-4), and the forward against the
JAX package's unsharded forward at the model tests' 2e-4.  smollm at
15 query heads over 5 kv heads (its published ratio) splits 8 / 7 and
3 / 2 over two "model" ranks, so rank 1's query heads read a kv head of
rank 0's; mixtral's 4 over 2 divide."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gloo import run_ranks
from repro.configs import smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.distributed.tensor_parallel import attention_heads, chunk_range
from repro_torch.models import Model

ARCHS = ("smollm-360m", "mixtral-8x7b", "falcon-mamba-7b", "jamba-1.5-large-398b",
         "whisper-large-v3", "internvl2-26b")
RULES = ("RULES_DECODE", "RULES_TRAIN", "RULES_DECODE_LONG", "RULES_DECODE_WS")
TRAIN_RULES_ARCHS = ("smollm-360m", "whisper-large-v3")
BOTH_AXES = [(n, r) for r in RULES for n in ARCHS
             if r != "RULES_TRAIN" or n in TRAIN_RULES_ARCHS]
B, S, MAX_LEN, STEPS = 4, 16, 32, 4
ATOL = RTOL = 1e-5  # against the single-process port
MODEL_TOL = 2e-4  # against the JAX package (tests/test_torch_lm.py's MODEL_RTOL, MODEL_ATOL)
TIE = 1e-4
UNEVEN = "smollm-15-5"


def _cfg(name, smoke):
    if name == UNEVEN:  # smollm's 15 heads over 5, narrowed
        cfg = smoke("smollm-360m")
        return dataclasses.replace(cfg, num_heads=15, num_kv_heads=5, head_dim=4,
                                   param_dtype="float32", compute_dtype="float32")
    return dataclasses.replace(smoke(name), param_dtype="float32", compute_dtype="float32")


def _batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (B, 24, cfg.d_model)).astype(np.float32)
    return batch


def _pos0(cfg) -> int:
    """The first decode position after the prefill."""
    if cfg.family == "encdec":
        return 1  # the prefill decodes BOS at 0
    return S + (cfg.num_patches if cfg.family == "vlm" else 0)


@pytest.fixture(scope="module")
def cases():
    """name -> (cfg, params, torch batch, JAX forward logits, the plain
    port's forward, prefill and decode logits, the greedy tokens)."""
    out = {}
    for name in (*ARCHS, UNEVEN):
        ref_cfg, cfg = _cfg(name, ref_smoke_config), _cfg(name, smoke_config)
        jmodel = RefModel(ref_cfg)
        jparams = jax.jit(lambda key, m=jmodel: m.init(key)[0])(jax.random.PRNGKey(0))
        batch = _batch(cfg)
        want, _ = jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        lm = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        params = {n: p.detach().clone() for n, p in lm.named_parameters()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        model = Model(cfg)
        with torch.no_grad():
            fwd = model.forward(lm, tb)
            cache = model.init_cache(B, MAX_LEN, device="cpu")
            logits, cache = model.prefill(lm, tb, cache)
            steps, tokens = [logits], []
            for i in range(STEPS):
                tokens.append(steps[-1].argmax(-1))
                logits, cache = model.decode(lm, tokens[-1], cache, _pos0(cfg) + i)
                steps.append(logits)
        out[name] = (cfg, params, tb, np.asarray(want, np.float32), fwd, steps, tokens)
    return out


def _case(cases, name, rules):
    cfg, params, tb, _, _, _, tokens = cases[name]
    return {"cfg": cfg, "params": params, "batch": tb, "rules": rules, "max_len": MAX_LEN,
            "pos0": _pos0(cfg), "tokens": tokens}


@pytest.fixture(scope="module")
def model_axis(cases, tmp_path_factory):
    """(1, 2): every family and the uneven heads under RULES_DECODE."""
    names = (*ARCHS, UNEVEN)
    ranks = run_ranks("tp_serve", 2, tmp_path_factory.mktemp("tp12"), (1, 2),
                      [_case(cases, n, "RULES_DECODE") for n in names])
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def both_axes(cases, tmp_path_factory):
    """(2, 2): every family under each decode rule set, two under
    RULES_TRAIN."""
    keys = BOTH_AXES
    ranks = run_ranks("tp_serve", 4, tmp_path_factory.mktemp("tp22"), (2, 2),
                      [_case(cases, n, r) for n, r in keys])
    return {k: [r[i] for r in ranks] for i, k in enumerate(keys)}


def _check(cases, name, got):
    cfg, _, _, want_jax, fwd, steps, _ = cases[name]
    torch.testing.assert_close(got["forward"], fwd, atol=ATOL, rtol=RTOL)
    if name != UNEVEN:  # the JAX package's unsharded forward
        np.testing.assert_allclose(got["forward"].numpy(), want_jax, atol=MODEL_TOL,
                                   rtol=MODEL_TOL)
    assert len(got["steps"]) == len(steps) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["steps"], steps)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL, msg=f"{name} step {i}")
        top2 = w.topk(2, dim=-1).values
        near_tie = (top2[:, 0] - top2[:, 1]) < TIE
        assert bool(((g.argmax(-1) == w.argmax(-1)) | near_tie).all()), (name, i)
    assert got["shared"], "a shard is not a view of its parameter's storage"


@pytest.mark.parametrize("name", (*ARCHS, UNEVEN))
def test_each_family_on_a_model_axis_of_two(cases, model_axis, name):
    for got in model_axis[name]:
        _check(cases, name, got)


@pytest.mark.parametrize("name,rules", BOTH_AXES)
def test_each_family_and_rule_set_on_two_by_two(cases, both_axes, name, rules):
    for got in both_axes[(name, rules)]:
        _check(cases, name, got)


def test_uneven_heads_run_each_rank_on_its_own_heads(model_axis):
    """15 query heads over 2 ranks: 8 and 7, each with one gathered kv head
    per query head (its heads are not whole groups of 3)."""
    kernels = [r["kernels"] for r in model_axis[UNEVEN]]
    assert kernels == [[("attention", 8, 8)], [("attention", 7, 7)]]
    assert attention_heads(8, 15, 15, 5) == ("index", [2, 3, 3, 3, 4, 4, 4])
    assert attention_heads(0, 8, 15, 5) == ("index", [0, 0, 0, 1, 1, 1, 2, 2])
    assert chunk_range(15, 2, 1) == (8, 15) and chunk_range(5, 2, 1) == (3, 5)


def test_divisible_heads_and_channels_run_on_whole_groups(model_axis):
    """mixtral's 4 query heads over 2 kv heads: one group a rank, its own kv
    head; falcon-mamba's 128 inner channels: 64 a rank's scan."""
    for r in model_axis["mixtral-8x7b"]:
        assert r["kernels"] == [("attention", 2, 1)]
    for r in model_axis["falcon-mamba-7b"]:
        assert r["kernels"] == [("scan", 64)]
    for r in model_axis["jamba-1.5-large-398b"]:
        assert r["kernels"] == [("attention", 2, 1), ("scan", 64)]


def test_caches_are_placed_by_the_rule_sets(both_axes):
    from torch.distributed.tensor import Replicate, Shard

    # (stack, batch, cache_seq, kv_heads, head_dim): batch on "data", positions on "model"
    assert both_axes[("smollm-360m", "RULES_DECODE")][0]["cache"]["sub_0/k"] == (Shard(1),
                                                                                   Shard(2))
    # batch 1 rules: the positions over both dims
    assert both_axes[("smollm-360m", "RULES_DECODE_LONG")][0]["cache"]["sub_0/k"] == (
        Shard(2), Shard(2))
    # the Mamba state (stack, batch, dinner, state): channels on "model"
    assert both_axes[("falcon-mamba-7b", "RULES_DECODE")][0]["cache"]["sub_0/h"] == (
        Shard(1), Shard(2))
    # whisper's cross cache keeps its positions whole
    assert both_axes[("whisper-large-v3", "RULES_DECODE")][0]["cache"]["cross_k"] == (
        Shard(1), Replicate())


def test_wrap_keeps_uneven_shards_where_local_map_does_not(tmp_path):
    """Why the regions wrap their outputs themselves: torch's ``local_map``
    wraps them without their global shape, so an uneven shard (smollm's 15
    heads over 2 ranks: 8 / 7) comes back as 16 heads on rank 0 and 14 on
    rank 1; ``tensor_parallel.wrap`` gives 15 on both and gathers whole."""
    ranks = run_ranks("uneven_wrap", 2, tmp_path)
    assert [r["local"] for r in ranks] == [(2, 8, 3), (2, 7, 3)]
    assert [r["wrap"] for r in ranks] == [(2, 15, 3)] * 2
    assert [r["local_map"] for r in ranks] == [(2, 16, 3), (2, 14, 3)]
    want = torch.arange(2 * 15 * 3, dtype=torch.float32).reshape(2, 15, 3) * 2
    for r in ranks:
        assert torch.equal(r["whole"], want)
