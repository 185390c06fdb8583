"""The encoder-decoder family (whisper-large-v3), port against the JAX
package on the CPU: ``encode``, the teacher-forced ``forward_encdec``,
``prefill_encdec``'s cross cache and ``decode_encdec``'s steps and self
cache, on the same inputs (numpy, seeded) and the same weights (drawn by
``repro``, carried over by ``convert.lm_from_jax``), in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.models import encdec as jed
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import Model
from repro_torch.models import encdec as ed

# whole models in float32, as tests/test_torch_lm.py holds them
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-4
ARCH = "whisper-large-v3"


def _cut(name, smoke, full):
    cfg = smoke(ARCH) if name == "smoke" else full(ARCH)
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    if name == "smoke":  # 2 + 2 layers, 4 heads of 16, cross_len 32
        return cfg
    # whisper's 20 heads of 64 (d_model 1,280) at 2 + 2 layers, with d_ff,
    # the vocabulary and the cross length narrowed
    return dataclasses.replace(cfg, num_layers=2, decoder_layers=2, d_ff=512, vocab_size=512,
                               cross_len=48, remat="none")


CONFIGS = ["smoke", "whisper_d64"]


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    ref_cfg = _cut(request.param, ref_smoke_config, ref_get_config)
    cfg = _cut(request.param, smoke_config, get_config)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    jmodel = RefModel(ref_cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    m = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), m


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL, err_msg=what)


def _frames(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)


def test_encode_matches_reference(pair):
    cfg, _, jparams, _, m = pair
    frames = _frames(cfg, 2, 40, seed=1)
    want = jed.encode(jparams, cfg, jnp.asarray(frames))
    with torch.no_grad():
        got = ed.encode(m, torch.from_numpy(frames))
    assert got.shape == (2, 40, cfg.d_model) and got.dtype == torch.float32
    _close(got, want, "encoder states")


def test_forward_matches_reference(pair):
    """Teacher-forced logits: the encoder over 40 frames, the decoder's
    causal self-attention and cross-attention over 12 tokens."""
    cfg, jmodel, jparams, model, m = pair
    rng = np.random.default_rng(2)
    frames = _frames(cfg, 2, 40, seed=3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, want_aux = jmodel.forward(jparams, {"frames": jnp.asarray(frames),
                                              "tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = model.forward(m, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(tokens)}, return_aux=True)
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, "forward logits")
    assert set(aux) == set(want_aux) and all(float(v) == 0.0 for v in aux.values())


@pytest.mark.parametrize("frames_of_cross", [-10, 0, 13], ids=["shorter", "equal", "longer"])
def test_prefill_and_decode_match_reference(pair, frames_of_cross):
    """Frames shorter than, as long as and longer than ``cross_len``: the
    prefill's BOS logits and its cross cache (truncated or zero-padded),
    then 8 decode steps at positions 1-8 and the self cache after them."""
    cfg, jmodel, jparams, model, m = pair
    n_frames = cfg.cross_len + frames_of_cross
    rng = np.random.default_rng(n_frames)
    frames = _frames(cfg, 2, n_frames, seed=n_frames + 1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)  # not read
    max_len = 12
    jcache = jmodel.init_cache(2, max_len)
    want, jcache = jax.jit(jmodel.prefill)(
        jparams, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}, jcache)
    cache = model.init_cache(2, max_len, device="cpu")
    assert {k: tuple(t.shape) for k, t in cache.items()} == {
        k: tuple(a.shape) for k, a in jcache.items()}
    got, cache = model.prefill(m, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.from_numpy(tokens)}, cache)
    _close(got, want, "prefill logits")
    for name in ("cross_k", "cross_v", "self_k", "self_v"):
        _close(cache[name], jcache[name], f"prefill cache {name}")
    if n_frames < cfg.cross_len:  # the padding's states are zeros, so are their K and V
        assert not cache["cross_k"][:, :, n_frames:].any()
    jdecode = jax.jit(jmodel.decode)
    toks = rng.integers(0, cfg.vocab_size, (8, 2)).astype(np.int32)
    for i in range(8):
        want, jcache = jdecode(jparams, jnp.asarray(toks[i]), jcache, jnp.asarray(1 + i, jnp.int32))
        got, cache = model.decode(m, torch.from_numpy(toks[i]), cache, 1 + i)
        _close(got, want, f"decode step {i}")
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        _close(cache[name], jcache[name], f"decoded cache {name}")


def test_decode_tracks_the_teacher_forced_forward(pair):
    """BOS at position 0 (the prefill), then the gold tokens one by one:
    each step's logits are the forward's at that position."""
    cfg, _, _, model, m = pair
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(_frames(cfg, 1, cfg.cross_len, seed=8))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 6)))
    tokens[:, 0] = 0  # BOS
    with torch.no_grad():
        full = model.forward(m, {"frames": frames, "tokens": tokens})
    cache = model.init_cache(1, 6, device="cpu")
    got, cache = model.prefill(m, {"frames": frames, "tokens": tokens}, cache)
    _close(got, full[:, 0], "BOS logits")
    for pos in range(1, 6):
        got, cache = model.decode(m, tokens[:, pos], cache, pos)
        _close(got, full[:, pos], f"position {pos}")


def _one_layer_smoke(seed):
    cfg = dataclasses.replace(_cut("smoke", ref_smoke_config, ref_get_config), num_layers=1)
    jparams, _ = RefModel(cfg).init(jax.random.PRNGKey(seed))
    return cfg, jparams, convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def test_encode_past_4096_frames_matches_the_reference_chunked_branch():
    """Past 4,096 frames the reference's encoder attention is
    ``chunked_attention`` (an online softmax over 1,024-key chunks); the
    port's is the same kernel as below it.  5,120 frames: whole chunks."""
    cfg, jparams, m = _one_layer_smoke(1)
    frames = _frames(cfg, 1, 5120, seed=9)
    want = jed.encode(jparams, cfg, jnp.asarray(frames))
    with torch.no_grad():
        got = ed.encode(m, torch.from_numpy(frames))
    _close(got, want, "encoder states past 4,096 frames")


def test_reference_chunked_branch_attends_its_key_padding(monkeypatch):
    """ROADMAP.md queue C #21: at 4,100 frames the reference's
    ``chunked_attention`` pads the keys to 5,120 with zeros and, without a
    causal mask, attends to them; the port computes the attention over
    the 4,100 frames, which is the reference's encoder with that branch
    replaced by its own full attention."""
    from repro.models import layers as jlayers

    cfg, jparams, m = _one_layer_smoke(2)
    frames = _frames(cfg, 1, 4100, seed=11)
    chunked = np.asarray(jed.encode(jparams, cfg, jnp.asarray(frames)))
    monkeypatch.setattr(jed, "chunked_attention", jlayers.attention)
    full = np.asarray(jed.encode(jparams, cfg, jnp.asarray(frames)))
    with torch.no_grad():
        got = ed.encode(m, torch.from_numpy(frames))
    _close(got, full, "encoder states at 4,100 frames")
    assert np.abs(chunked - full).max() > 100 * MODEL_ATOL


def test_decode_past_the_self_cache_raises_where_the_reference_clamps():
    """ROADMAP.md queue C #20: at a position past the self cache the
    reference's ``dynamic_update_slice`` writes the last slot instead and
    goes on; the port raises."""
    cfg = _cut("smoke", ref_smoke_config, ref_get_config)
    jmodel = RefModel(cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    model = Model(cfg)
    m = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    frames = _frames(cfg, 1, cfg.cross_len, seed=10)
    jcache = jmodel.init_cache(1, 4)
    _, jcache = jmodel.prefill(jparams, {"frames": jnp.asarray(frames)}, jcache)
    token = np.array([5], np.int32)
    logits, clamped = jmodel.decode(jparams, jnp.asarray(token), jcache, jnp.asarray(4, jnp.int32))
    assert np.isfinite(np.asarray(logits)).all()
    assert np.asarray(clamped["self_k"])[:, :, 3].any()  # slot 3 took position 4's key
    cache = model.init_cache(1, 4, device="cpu")
    model.prefill(m, {"frames": torch.from_numpy(frames)}, cache)
    for pos in (4, -1):
        with pytest.raises(ValueError, match="outside the self cache"):
            model.decode(m, torch.from_numpy(token), cache, pos)
    assert not cache["self_k"][:, :, 1:].any()  # nothing written past the BOS


def test_init_draws_the_reference_scales():
    """N(0, 0.02) for the tied embedding, 1/sqrt(fan-in) for wq and w_in,
    1/sqrt(heads x head_dim) for wo, the norms at one and zero, in the
    reference's types; the same draw from the same seed."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=1, decoder_layers=1)
    m = ed.init_encdec(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    d, hq, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    dec = m.dec_blocks[0]
    assert m.embed.dtype == torch.bfloat16 and dec.norm_x.bias.dtype == torch.float32
    assert bool((dec.norm_x.scale == 1).all()) and not dec.norm_x.bias.any()
    for w, std in ((m.embed, 0.02), (m.enc_blocks[0].attn.wq, d ** -0.5),
                   (dec.cross_attn.wo, (hq * hd) ** -0.5), (dec.mlp.w_in, d ** -0.5)):
        assert abs(w.float().std().item() / std - 1) < 0.02
    again = ed.init_encdec(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))


def test_lm_from_jax_refuses_a_wrong_encdec_tree():
    cfg = smoke_config(ARCH)
    jparams, _ = RefModel(ref_smoke_config(ARCH)).init(jax.random.PRNGKey(0))
    good = jax.tree.map(np.asarray, jparams)
    m = convert.lm_from_jax(good, cfg, device="cpu")
    assert isinstance(m, ed.EncDec) and m.embed.dtype == torch.bfloat16
    assert m.dec_blocks[1].norm_x.scale.dtype == torch.float32
    assert torch.equal(m.dec_blocks[1].cross_attn.wk.float(), torch.from_numpy(
        np.asarray(good["dec_blocks"]["cross_attn"]["wk"][1], np.float32)))

    def broken(edit):
        tree = jax.tree.map(lambda a: a, good)
        edit(tree)
        return tree

    bad = [
        broken(lambda t: t.pop("enc_final_norm")),
        broken(lambda t: t["dec_blocks"].pop("norm_x")),
        broken(lambda t: t["dec_blocks"]["cross_attn"].pop("wv")),
        broken(lambda t: t["enc_blocks"]["mlp"].update(w_gate=t["enc_blocks"]["mlp"]["w_in"])),
        broken(lambda t: t["dec_blocks"]["self_attn"].update(
            wq=t["dec_blocks"]["self_attn"]["wq"][:1])),
        broken(lambda t: t.update(lm_head=np.zeros((cfg.d_model, cfg.vocab_size), np.float32))),
        broken(lambda t: t.update(blocks=t.pop("dec_blocks"))),
    ]
    for tree in bad:
        with pytest.raises(ValueError):
            convert.lm_from_jax(tree, cfg, device="cpu")
