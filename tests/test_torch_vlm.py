"""The image-prefix family (internvl2-26b), port against the JAX package
on the CPU: ``Model.forward`` (the prefix's logits dropped), the prefill
with ``patch_embeds`` at offset 0 and past it, into caches longer and
shorter than its positions, and the decode steps after it, on the same
inputs (numpy, seeded) and the same weights (drawn by ``repro``, carried
over by ``convert.lm_from_jax``), in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import Model
from repro_torch.models import transformer as tr

# whole models in float32, as tests/test_torch_lm.py holds them
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-4
ARCH = "internvl2-26b"


def _cut(name, smoke, full):
    cfg = smoke(ARCH) if name == "smoke" else full(ARCH)
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    if name == "smoke":  # 2 layers, 4 heads of 16 over 2, 8 patches
        return cfg
    # internvl2's 48 heads of 128 over 8 and its 256 patches at 2 layers,
    # with d_model, d_ff and the vocabulary narrowed
    return dataclasses.replace(cfg, num_layers=2, d_model=256, d_ff=512, vocab_size=512,
                               remat="none")


@pytest.fixture(scope="module", params=["smoke", "internvl2_d128"])
def pair(request):
    ref_cfg = _cut(request.param, ref_smoke_config, ref_get_config)
    cfg = _cut(request.param, smoke_config, get_config)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    jmodel = RefModel(ref_cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    jprefill = jax.jit(jmodel.prefill, static_argnums=(3,))
    jdecode = jax.jit(jmodel.decode)
    return cfg, jmodel, jparams, Model(cfg), lm, jprefill, jdecode


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL, err_msg=what)


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return tokens, patches


def test_forward_matches_reference(pair):
    """The text positions' logits: the prefix's are dropped on both sides."""
    cfg, jmodel, jparams, model, lm, _, _ = pair
    tokens, patches = _inputs(cfg, 2, 24, seed=5)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens),
                                       "patch_embeds": jnp.asarray(patches)})
    with torch.no_grad():
        got = model.forward(lm, {"tokens": torch.from_numpy(tokens),
                                 "patch_embeds": torch.from_numpy(patches)})
        whole = tr.forward_lm(lm, torch.from_numpy(tokens), patch_embeds=torch.from_numpy(patches))
    assert got.shape == (2, 24, cfg.vocab_size) and got.dtype == torch.float32
    assert whole.shape == (2, cfg.num_patches + 24, cfg.vocab_size)
    assert torch.equal(whole[:, cfg.num_patches:], got)
    _close(got, want, "forward logits")


# (S, the cache's length past the prefix, offset): caches longer than the
# num_patches + S positions, as long, and shorter (ring semantics: the last
# positions kept, the decode wrapping), at offset 0 and past it
@pytest.mark.parametrize("S,extra_len,offset", [(16, 32, 0), (16, 32, 9), (16, 16, 5),
                                                (20, 12, 7)])
def test_prefill_and_decode_match_reference(pair, S, extra_len, offset):
    """A prefill with ``patch_embeds`` (both caches, every slot), then 8
    decode steps at ``offset + num_patches + S + i`` with per-slot
    ``start``, and both caches after them."""
    cfg, jmodel, jparams, model, lm, jprefill, jdecode = pair
    max_len = cfg.num_patches + extra_len
    tokens, patches = _inputs(cfg, 2, S, seed=S * 31 + extra_len + offset)
    jcache = jmodel.init_cache(2, max_len)
    want, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens),
                                      "patch_embeds": jnp.asarray(patches)}, jcache, offset)
    cache = model.init_cache(2, max_len, device="cpu")
    got, cache = model.prefill(lm, {"tokens": torch.from_numpy(tokens),
                                    "patch_embeds": torch.from_numpy(patches)}, cache,
                               pos_offset=offset)
    _close(got, want, "prefill logits")
    for name in ("k", "v"):
        _close(cache["sub_0"][name], jcache["sub_0"][name], f"prefill cache {name}")
    start = np.array([offset, offset + 3], np.int32)  # slot 1 ignores its first 3 positions
    toks = np.random.default_rng(offset).integers(0, cfg.vocab_size, (8, 2)).astype(np.int32)
    for i in range(8):
        pos = offset + cfg.num_patches + S + i
        want, jcache = jdecode(jparams, jnp.asarray(toks[i]), jcache, jnp.asarray(pos, jnp.int32),
                               jnp.asarray(start))
        got, cache = model.decode(lm, torch.from_numpy(toks[i]), cache, pos,
                                  start=torch.from_numpy(start))
        _close(got, want, f"decode step {i}")
    for name in ("k", "v"):
        _close(cache["sub_0"][name], jcache["sub_0"][name], f"decoded cache {name}")


def test_decode_after_the_prefix_tracks_the_forward(pair):
    """A prefill of the prefix and 4 tokens, then the gold tokens one by
    one at ``num_patches + j``: each step's logits are the forward's."""
    cfg, _, _, model, lm, _, _ = pair
    tokens, patches = (torch.from_numpy(a) for a in _inputs(cfg, 1, 10, seed=6))
    with torch.no_grad():
        full = model.forward(lm, {"tokens": tokens, "patch_embeds": patches})
    cache = model.init_cache(1, cfg.num_patches + 10, device="cpu")
    got, cache = model.prefill(lm, {"tokens": tokens[:, :4], "patch_embeds": patches}, cache)
    _close(got, full[:, 3], "prefill logits")
    for j in range(4, 10):
        got, cache = model.decode(lm, tokens[:, j], cache, cfg.num_patches + j)
        _close(got, full[:, j], f"text position {j}")


def test_a_vlm_call_without_patch_embeds_raises_as_the_reference():
    """``forward_lm`` and ``prefill_lm`` raise the reference's
    ``ValueError``; ``Model`` reads ``batch["patch_embeds"]`` as the
    reference's does (``KeyError``)."""
    cfg = smoke_config(ARCH)
    jparams, _ = RefModel(ref_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="requires patch_embeds") as want:
        jtr.forward_lm(jparams, ref_smoke_config(ARCH), jnp.asarray(tokens))
    with torch.no_grad(), pytest.raises(ValueError) as got:
        tr.forward_lm(lm, torch.from_numpy(tokens))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="requires patch_embeds"):
        tr.prefill_lm(lm, torch.from_numpy(tokens), Model(cfg).init_cache(1, 16, device="cpu"))
    for model in (RefModel(ref_smoke_config(ARCH)), Model(cfg)):
        with pytest.raises(KeyError, match="patch_embeds"):
            model.forward(jparams if isinstance(model, RefModel) else lm, {"tokens": tokens})
