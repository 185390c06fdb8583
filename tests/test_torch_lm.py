"""The LM of the serving slice, port against the JAX package on the CPU:
attention (the kernel's plain version against the Pallas kernel in
interpret mode and its oracle), the layers, and the model's forward,
prefill and decode, on the same inputs (numpy, seeded) and the same
weights (drawn by ``repro`` and carried over by ``convert.lm_from_jax``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.models import Model as RefModel
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import Model, layers
from repro_torch.models import transformer as tr

# float32 on both sides: XLA and PyTorch sum products and reductions in
# another order on the CPU (tests/test_kernels.py holds the Pallas kernel to
# its oracle at the same 3e-5)
ATTN_TOL = 3e-5
# bf16 inputs: the two frameworks round P to bf16 at the same place, but the
# P.V sums round in another order: the bf16 outputs (under 4 in magnitude)
# differ by up to one bf16 ulp there (2**-6)
BF16_ATOL = 3e-2
# whole models in float32: a few hundred float32 sums per logit in another
# order, through up to 2 layers of norms and a 49,152-way vocabulary
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-4

SWEEP = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 128, 128, 32), (1, 8, 1, 96, 160, 64),
         (2, 2, 1, 64, 128, 32)]
MASKS = [(True, None), (True, 48), (False, None)]


def _qkv(rng, B, H, Hkv, S, T, D):
    return (rng.normal(0, 1, (B, H, S, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, T, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, T, D)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("B,H,Hkv,S,T,D", SWEEP)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_matches_pallas_and_oracle(B, H, Hkv, S, T, D, causal, window):
    q, k, v = _qkv(np.random.default_rng(B * 100 + S + T), B, H, Hkv, S, T, D)
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = pallas_flash_attention(jq, jk, jv, causal=causal, window=window,
                                    block_q=32, block_k=64, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_flash_attention_bf16_matches_pallas_and_oracle():
    q, k, v = _qkv(np.random.default_rng(1), 1, 2, 2, 64, 64, 32)
    got = ops.flash_attention(*_t(q, k, v, dtype=torch.bfloat16)).float().numpy()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pallas = pallas_flash_attention(jq, jk, jv, block_q=32, block_k=32, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), atol=BF16_ATOL)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=BF16_ATOL)


def test_flash_attention_q_offset_decode_tile():
    """8 queries at absolute positions 200..207 over a 256-key cache."""
    q, k, v = _qkv(np.random.default_rng(2), 1, 2, 2, 8, 256, 32)
    got = ops.flash_attention(*_t(q, k, v), causal=True, q_offset=200).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = pallas_flash_attention(jq, jk, jv, causal=True, q_offset=200,
                                    block_q=8, block_k=64, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=True, q_offset=200)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATTN_TOL)


def test_layers_attention_takes_bshd_and_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (2, 24, 6, 20)).astype(np.float32)
    k = rng.normal(0, 1, (2, 24, 2, 20)).astype(np.float32)
    v = rng.normal(0, 1, (2, 24, 2, 20)).astype(np.float32)
    for window in (None, 8):
        got = layers.attention(*_t(q, k, v), causal=True, window=window)
        want = jlayers.attention(*map(jnp.asarray, (q, k, v)), causal=True, window=window)
        assert got.shape == (2, 24, 6, 20)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)


# ------------------------------------------------------------------ layers
def test_rmsnorm_rope_and_mlp_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (2, 7, 40)).astype(np.float32)
    scale = rng.normal(1, 0.1, (40,)).astype(np.float32)
    got = layers.rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)})
    want = jlayers.rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    # rope at large positions: float32 sin/cos of angles up to 1,030 rad
    xr = rng.normal(0, 1, (2, 7, 3, 20)).astype(np.float32)
    pos = np.arange(1024, 1031)
    got = layers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 10000.0)
    want = jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    for act, keys in (("swiglu", ("w_in", "w_gate", "w_out")), ("geglu", ("w_in", "w_gate", "w_out")),
                      ("gelu", ("w_in", "w_out"))):
        shapes = {"w_in": (40, 64), "w_gate": (40, 64), "w_out": (64, 40)}
        p = {k: rng.normal(0, 0.2, shapes[k]).astype(np.float32) for k in keys}
        got = layers.mlp_apply({k: torch.from_numpy(a) for k, a in p.items()},
                               torch.from_numpy(x), act)
        want = jlayers.mlp_apply({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=act)


# ------------------------------------------------------------------ the model
def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


# the other registered ids' smoke configs: the moe family (mixtral: 4
# experts, sliding window 32; phi3.5-moe: 4 experts, d_ff 96), gemma's
# geglu, tied and scaled embeddings, phi3-medium, danube's sliding window
SMOKE_IDS = {"mixtral_smoke": "mixtral-8x7b", "phi35moe_smoke": "phi3.5-moe-42b-a6.6b",
             "gemma_smoke": "gemma-7b", "phi3medium_smoke": "phi3-medium-14b",
             "danube_smoke": "h2o-danube-3-4b"}
# full head width at 2 layers, with d_model, d_ff and the vocabulary
# narrowed: danube's 32 heads of 120 over 8 kv heads (the Hopper kernel's
# zero-padded width on the card) and gemma's 16 heads of 256 (the Hopper
# kernel's widest instantiation, flash_fwd_hopper<256>)
HEAD_CUTS = {"danube_d120": ("h2o-danube-3-4b", dict(d_model=256, d_ff=512, vocab_size=512)),
             "gemma_d256": ("gemma-7b", dict(d_model=256, d_ff=512, vocab_size=512))}


def _cut(name, smoke, full):
    if name == "smoke":  # head_dim 20, GQA 3:1
        return _f32(smoke("smollm-360m"))
    if name == "smollm2":  # smollm-360m's widths at 2 layers: head_dim 64, GQA 15:5
        return dataclasses.replace(_f32(full("smollm-360m")), num_layers=2)
    if name in SMOKE_IDS:
        return _f32(smoke(SMOKE_IDS[name]))
    if name in HEAD_CUTS:
        arch, narrow = HEAD_CUTS[name]
        return dataclasses.replace(_f32(full(arch)), num_layers=2, remat="none", **narrow)
    # the smoke config with a sliding window: the ring cache and the window mask
    return dataclasses.replace(_f32(smoke("smollm-360m")), sliding_window=12)


CONFIGS = ["smoke", "smollm2", "smoke_window", *SMOKE_IDS, *HEAD_CUTS]


def _pair(name):
    ref_cfg = _cut(name, ref_smoke_config, ref_get_config)
    cfg = _cut(name, smoke_config, get_config)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    jmodel = RefModel(ref_cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, jparams)
    # jitted once per config: the same function, compiled instead of dispatched op by op
    jprefill = jax.jit(jmodel.prefill, static_argnums=(3,))
    jdecode = jax.jit(lambda p, tok, c, pos, start: jmodel.decode(p, tok, c, pos, start=start))
    return (cfg, jmodel, jparams, Model(cfg), convert.lm_from_jax(params_np, cfg, device="cpu"),
            jprefill, jdecode)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return _pair(request.param)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL, err_msg=what)


def test_forward_matches_reference(pair):
    cfg, jmodel, jparams, model, lm, _, _ = pair
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():  # the parameters are trainable: no graph for a comparison
        got = model.forward(lm, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 24, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, "forward logits")


@pytest.mark.parametrize("S,max_len,offset", [(16, 32, 0), (16, 32, 9), (16, 16, 5), (20, 12, 7)])
def test_prefill_and_decode_match_reference(pair, S, max_len, offset):
    """Prompts shorter than, as long as, and longer than the cache, at
    offset 0 and past it; then 8 decode steps from the prefilled cache."""
    cfg, jmodel, jparams, model, lm, jprefill, jdecode = pair
    rng = np.random.default_rng(S * 31 + max_len + offset)
    tokens = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jcache = jmodel.init_cache(2, max_len)
    want, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache, offset)
    cache = model.init_cache(2, max_len, device="cpu")
    got, cache = model.prefill(lm, {"tokens": torch.from_numpy(tokens)}, cache, pos_offset=offset)
    _close(got, want, "prefill logits")
    for name in ("k", "v"):
        _close(cache["sub_0"][name], jcache["sub_0"][name], f"prefill cache {name}")
    start = np.array([offset, offset + 3], np.int32)  # slot 1 ignores its first 3 positions
    toks = rng.integers(0, cfg.vocab_size, (8, 2)).astype(np.int32)
    for i in range(8):
        pos = offset + S + i  # past max_len the slots wrap as a ring, on both sides
        want, jcache = jdecode(jparams, jnp.asarray(toks[i]), jcache,
                               jnp.asarray(pos, jnp.int32), jnp.asarray(start))
        got, cache = model.decode(lm, torch.from_numpy(toks[i]), cache, pos,
                                  start=torch.from_numpy(start))
        _close(got, want, f"decode step {i}")
    for name in ("k", "v"):
        _close(cache["sub_0"][name], jcache["sub_0"][name], f"decoded cache {name}")


def test_init_draws_the_reference_scales():
    cfg = get_config("smollm-360m")
    lm = tr.init_lm(dataclasses.replace(cfg, num_layers=1), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    d, hq, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    blk = lm.blocks[0]
    assert lm.embed.dtype == torch.bfloat16 and lm.lm_head is None
    assert blk.norm1.scale.dtype == torch.float32 and bool((blk.norm1.scale == 1).all())
    for w, std in ((lm.embed, 0.02), (blk.attn.wq, d ** -0.5), (blk.attn.wo, (hq * hd) ** -0.5),
                   (blk.mlp.w_out, cfg.d_ff ** -0.5)):
        assert abs(w.float().std().item() / std - 1) < 0.02
    again = tr.init_lm(dataclasses.replace(cfg, num_layers=1), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(lm.parameters(), again.parameters()))


def test_other_families_and_archs_are_refused():
    """Named when jamba (the hybrid family) waited for queue A #13; now its
    configs resolve to the reference's and the LM takes its smoke config,
    and what is still refused is the encdec family, which is
    models/encdec.py's, not the decoder-only LM's, and an unknown
    family."""
    arch = "jamba-1.5-large-398b"
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(ref_smoke_config(arch))
    lm = tr.init_lm(ref_smoke_config(arch), device="cpu")
    kinds = [(hasattr(b, "attn"), hasattr(b, "moe")) for b in lm.blocks]
    assert kinds == ref_smoke_config(arch).layer_kinds()
    with pytest.raises(ValueError, match="unknown family"):
        tr.init_lm(dataclasses.replace(smoke_config(arch), family="hybird"), device="cpu")
    for make in (lambda c: tr.init_lm(c, device="cpu"),
                 lambda c: tr.init_cache(c, 1, 8, device="cpu")):
        with pytest.raises(ValueError, match="encdec"):
            make(smoke_config("whisper-large-v3"))


def test_forward_returns_the_reference_aux_losses():
    """``return_aux``: the router's aux losses summed over the MoE layers,
    as the reference's forward returns them; zeros for a dense model."""
    for name in ("mixtral_smoke", "smoke"):
        cfg, jmodel, jparams, model, lm, _, _ = _pair(name)
        tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        want_logits, want = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
        with torch.no_grad():
            logits, aux = model.forward(lm, {"tokens": torch.from_numpy(tokens)}, return_aux=True)
        _close(logits, want_logits, "forward logits")
        for key in ("lb_loss", "z_loss"):
            assert aux[key].dtype == torch.float32 and aux[key].shape == ()
            np.testing.assert_allclose(float(aux[key]), float(want[key]), rtol=1e-6, atol=1e-6)
        if name == "smoke":
            assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0


def test_moe_forward_under_a_gradient_raises():
    """Named when the moe family's forward refused a gradient (its aux
    losses were not weighted in the step yet).  Now it records one: the
    logits and the aux losses carry a graph, the aux losses' gradient
    reaches every layer's router, and the values agree with the forward's
    without a gradient (which takes the plain attention without lse: float32
    sums in another order)."""
    cfg = _f32(smoke_config("mixtral-8x7b"))
    lm = tr.init_lm(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 8)))
    logits, aux = tr.forward_lm(lm, tokens, return_aux=True)
    assert logits.shape == (2, 8, cfg.vocab_size) and logits.requires_grad
    assert aux.keys() == {"lb_loss", "z_loss"} and all(v.requires_grad for v in aux.values())
    routers = [blk.moe.router for blk in lm.blocks]
    grads = torch.autograd.grad(aux["lb_loss"] + aux["z_loss"], routers)
    assert all(bool(g.abs().sum() > 0) for g in grads)
    with torch.no_grad():
        plain_logits, plain_aux = tr.forward_lm(lm, tokens, return_aux=True)
    torch.testing.assert_close(plain_logits, logits.detach(), atol=1e-5, rtol=1e-5)
    for k in aux:
        torch.testing.assert_close(plain_aux[k], aux[k].detach(), atol=1e-6, rtol=1e-5)


def test_lm_from_jax_refuses_a_wrong_tree():
    cfg = smoke_config("smollm-360m")
    jparams, _ = RefModel(ref_smoke_config("smollm-360m")).init(jax.random.PRNGKey(0))
    good = jax.tree.map(np.asarray, jparams)
    lm = convert.lm_from_jax(good, cfg, device="cpu")
    assert lm.embed.dtype == torch.bfloat16  # JAX's bf16 leaves arrive as bf16
    assert torch.equal(lm.blocks[1].attn.wq.float(),
                       torch.from_numpy(np.asarray(good["blocks"]["sub_0"]["attn"]["wq"][1], np.float32)))

    def broken(edit):
        tree = jax.tree.map(lambda a: a, good)
        edit(tree)
        return tree

    bad = [
        broken(lambda t: t.pop("final_norm")),
        broken(lambda t: t["blocks"]["sub_0"]["attn"].pop("wk")),
        broken(lambda t: t["blocks"]["sub_0"]["mlp"].update(w_in=t["blocks"]["sub_0"]["mlp"]["w_in"][:, :, :5])),
        broken(lambda t: t["blocks"]["sub_0"]["attn"].update(wq=t["blocks"]["sub_0"]["attn"]["wq"][:1])),
        broken(lambda t: t.update(lm_head=np.zeros((cfg.d_model, cfg.vocab_size), np.float32))),
    ]
    for tree in bad:
        with pytest.raises(ValueError):
            convert.lm_from_jax(tree, cfg, device="cpu")
