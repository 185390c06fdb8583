"""The port's Hopper kernels against their plain PyTorch versions on a card,
and the serving paths' prefill and decode (smollm-360m's and falcon-mamba's
widths) on the card against the same on the CPU.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false.  Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import csr_to_dense, flash_attention, ops, ref

# (rows, K, n_cols): the JAX package's ELL sweep, a batch at Tahoe's width
# and a row narrower than one 16-byte store
CASES = [(16, 8, 64), (33, 5, 100), (8, 16, 512), (1, 1, 8), (64, 1800, 62_710), (3, 7, 5)]
ATOL = 1e-6  # random columns repeat, and atomics add duplicates in any order


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,K,G", CASES)
def test_ell_to_dense_kernel_matches_plain_version(R, K, G):
    dev = _card()
    rng = np.random.default_rng(R * 7 + K)
    vals = torch.tensor(rng.normal(0, 1, (R, K)).astype(np.float32), device=dev)
    cols = torch.tensor(rng.integers(-1, G, (R, K)).astype(np.int32), device=dev)
    before = csr_to_dense.ell_to_dense.launches
    got = ops.ell_to_dense(vals, cols, n_cols=G)
    torch.cuda.synchronize()
    assert csr_to_dense.ell_to_dense.launches == before + 1
    torch.testing.assert_close(got, ref.ell_to_dense_ref(vals, cols, G), atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_ell_to_dense_kernel_bitwise_without_duplicates():
    dev = _card()
    rng = np.random.default_rng(0)
    R, K, G = 64, 1800, 62_710
    cols = np.stack([np.sort(rng.choice(G, K, replace=False)) for _ in range(R)]).astype(np.int32)
    cols[:, -100:] = -1  # ragged rows
    vals = rng.integers(1, 50, (R, K)).astype(np.float32)
    v, c = torch.tensor(vals, device=dev), torch.tensor(cols, device=dev)
    assert torch.equal(ops.ell_to_dense(v, c, n_cols=G), ref.ell_to_dense_ref(v, c, G))


# ------------------------------------------------------------ flash attention
# the JAX package's sweep (tests/test_kernels.py), D = 20 (the smoke
# config) and the serving path's heads (GQA 15:5, D = 64)
FA_SHAPES = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 128, 128, 32), (1, 8, 1, 96, 160, 64),
             (2, 2, 1, 64, 128, 32), (2, 3, 1, 37, 37, 20), (1, 15, 5, 200, 200, 64),
             (1, 4, 2, 70, 70, 128)]
FA_MASKS = [(True, None), (True, 48), (False, None)]
# float32: the kernel sums in another order than cuBLAS (TF32 off on both)
FA_F32_ATOL = 3e-5
# bf16: P is rounded to bf16 at the same place; the P.V sums round in
# another order, and the bf16 outputs (under 4 in magnitude: means of
# N(0, 1) values) differ by up to one bf16 ulp there (2**-6)
FA_BF16_ATOL = 3e-2


def _fa_inputs(B, H, Hkv, S, T, D, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, S, D), generator=g).to(dev, dtype)
    k = torch.randn((B, Hkv, T, D), generator=g).to(dev, dtype)
    v = torch.randn((B, Hkv, T, D), generator=g).to(dev, dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window", FA_MASKS)
@pytest.mark.parametrize("B,H,Hkv,S,T,D", FA_SHAPES)
def test_flash_attention_kernel_matches_plain_version(B, H, Hkv, S, T, D, causal, window, dtype):
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _fa_inputs(B, H, Hkv, S, T, D, dtype, dev)
    before = flash_attention.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    atol = FA_F32_ATOL if dtype == torch.float32 else FA_BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_q_offset_decode_tile():
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _fa_inputs(1, 2, 2, 8, 256, 32, torch.float32, dev, seed=1)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=200)
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=200)
    torch.testing.assert_close(got, want, atol=FA_F32_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel_takes_strided_bshd_views(dtype):
    """The model's (B, S, H, D) projections, viewed as (B, H, S, D): no copy
    in, and the output keeps q's memory layout."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(2)
    q = torch.randn((2, 100, 15, 64), generator=g).to(dev, dtype)
    kv = torch.randn((2, 100, 10, 64), generator=g).to(dev, dtype)
    k, v = kv[:, :, :5], kv[:, :, 5:]  # strided in the head axis too
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert got.stride() == qt.stride()
    want = ref.flash_attention_ref(qt.contiguous(), kt.contiguous(), vt.contiguous())
    atol = FA_F32_ATOL if dtype == torch.float32 else FA_BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_rows_without_keys_are_zero():
    """Rows at negative absolute positions see no key under the causal
    mask: the kernel gives zeros there (its oracle the mean of V)."""
    dev = _card()
    q, k, v = _fa_inputs(1, 2, 1, 80, 64, 32, torch.float32, dev, seed=3)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=-10)
    assert not got[:, :, :10].any()
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=-10)
    torch.testing.assert_close(got[:, :, 10:], want[:, :, 10:], atol=FA_F32_ATOL, rtol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q, k, v = _fa_inputs(1, 2, 2, 16, 16, 32, torch.float32, dev)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        ops.flash_attention(*_fa_inputs(1, 2, 2, 16, 16, 160, torch.float32, dev))
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), v)


@pytest.mark.cuda
def test_prefill_and_decode_on_the_card_match_the_cpu():
    """smollm-360m's widths at 2 layers in float32: the same weights on the
    card and on the CPU, a prefill and 4 decode steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    lm_cpu = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    lm_gpu = model.init(generator=torch.Generator().manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    caches = [model.init_cache(2, 48, device=d) for d in ("cpu", dev)]
    before = flash_attention.flash_attention.launches
    want, _ = model.prefill(lm_cpu, {"tokens": tokens}, caches[0])
    got, _ = model.prefill(lm_gpu, {"tokens": tokens.to(dev)}, caches[1])
    assert flash_attention.flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    tok = want.argmax(-1)
    for i in range(4):
        want, _ = model.decode(lm_cpu, tok, caches[0], 40 + i)
        got, _ = model.decode(lm_gpu, tok.to(dev), caches[1], 40 + i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        tok = want.argmax(-1)


# ------------------------------------------------- flash attention, training
# the JAX package's backward sweep (tests/test_kernels_bwd.py: GQA, MQA and
# uneven tiles), D = 20 (the smoke config), the training path's heads (GQA
# 15:5, D = 64), a key axis longer than the query axis, and D = 128
BWD_SHAPES = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 64, 64, 32), (1, 2, 1, 96, 96, 16),
              (2, 3, 1, 37, 37, 20), (1, 15, 5, 200, 200, 64), (2, 2, 1, 64, 128, 32),
              (1, 4, 2, 70, 70, 128)]
BWD_MASKS = [(True, None), (True, 32), (False, None)]
# float32: the JAX package's own tolerance for its backward kernel against
# autodiff of the oracle (tests/test_kernels_bwd.py); sums in another order
BWD_F32_TOL = 2e-4
LSE_F32_ATOL = 1e-5  # a logsumexp of at most a few hundred float32 terms
# bf16: |got - want| <= atol + rtol * |want|.  The kernels round P and dS to
# bf16 as the operands of their second products, and both sides round their
# float32 results to bf16 at the end, where one ulp is 2**-7 of the value
BWD_BF16_ATOL, BWD_BF16_RTOL = 3e-2, 2e-2
LSE_BF16_ATOL = 1e-4  # bf16 products are exact in float32; only the order of sums differs


def _close_bf16(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=BWD_BF16_ATOL, rtol=BWD_BF16_RTOL)


def _train_inputs(B, H, Hkv, S, T, D, dtype, dev, seed=0):
    q, k, v = _fa_inputs(B, H, Hkv, S, T, D, dtype, dev, seed)
    dout = torch.randn((B, H, S, D), generator=torch.Generator().manual_seed(seed + 1)).to(dev, dtype)
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window", BWD_MASKS)
@pytest.mark.parametrize("B,H,Hkv,S,T,D", BWD_SHAPES)
def test_training_kernels_match_plain_versions(B, H, Hkv, S, T, D, causal, window, dtype):
    """The forward with lse, dq and dk/dv, each once, against the plain
    versions on the same inputs."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _train_inputs(B, H, Hkv, S, T, D, dtype, dev)
    n = (flash_attention.flash_attention_fwd_lse.launches, fab.flash_attention_bwd_dq.launches,
         fab.flash_attention_bwd_dkv.launches)
    out, lse = flash_attention.flash_attention_fwd_lse(q, k, v, causal=causal, window=window)
    want_out, want_lse = ref.flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq = fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal, window=window)
    dk, dv = fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.flash_attention_fwd_lse.launches, fab.flash_attention_bwd_dq.launches,
            fab.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in n)
    # the backward from the kernel's own residuals, so each kernel is held alone
    wq, wk, wv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, atol=FA_F32_ATOL, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=LSE_F32_ATOL, rtol=0)
        for got, want in ((dq, wq), (dk, wk), (dv, wv)):
            torch.testing.assert_close(got, want, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)
    else:
        torch.testing.assert_close(out.float(), want_out.float(), atol=FA_BF16_ATOL, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=LSE_BF16_ATOL, rtol=0)
        for got, want in ((dq, wq), (dk, wk), (dv, wv)):
            _close_bf16(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_training_kernels_take_strided_bshd_views_and_are_deterministic(dtype):
    """The model's (B, S, H, D) projections viewed as (B, H, S, D), a
    cotangent in either layout; two backward passes agree bitwise."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(4)
    q = torch.randn((2, 130, 15, 64), generator=g).to(dev, dtype).transpose(1, 2)
    kv = torch.randn((2, 130, 10, 64), generator=g).to(dev, dtype)
    k, v = kv[:, :, :5].transpose(1, 2), kv[:, :, 5:].transpose(1, 2)
    for dout in (torch.randn((2, 15, 130, 64), generator=g).to(dev, dtype),
                 torch.randn((2, 130, 15, 64), generator=g).to(dev, dtype).transpose(1, 2)):
        out, lse = flash_attention.flash_attention_fwd_lse(q, k, v, causal=True)
        assert out.stride() == q.stride()
        delta = (dout.float() * out.float()).sum(-1).contiguous()
        grads = [fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta),
                 *fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta)]
        again = [fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta),
                 *fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta)]
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        wants = ref.flash_attention_bwd_ref(*(t.contiguous() for t in (q, k, v, out)), lse,
                                            dout.contiguous())
        for got, want in zip(grads, wants):
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)
            else:
                _close_bf16(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", BWD_MASKS)
def test_gradients_through_ops_match_autograd_of_the_plain_version(causal, window):
    """``ops.flash_attention`` on tensors that need a gradient goes through
    the three kernels; its gradients equal autograd of ``flash_attention_ref``
    with the JAX package's cotangent sum(o * cos(o))."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (t.requires_grad_() for t in _fa_inputs(2, 4, 2, 96, 96, 32, torch.float32, dev))
    n = (flash_attention.flash_attention_fwd_lse.launches, fab.flash_attention_bwd_dq.launches,
         fab.flash_attention_bwd_dkv.launches, flash_attention.flash_attention.launches)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad((o * torch.cos(o)).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (flash_attention.flash_attention_fwd_lse.launches, fab.flash_attention_bwd_dq.launches,
            fab.flash_attention_bwd_dkv.launches, flash_attention.flash_attention.launches) == (
        n[0] + 1, n[1] + 1, n[2] + 1, n[3])
    o_ref = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad((o_ref * torch.cos(o_ref)).sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_training_kernels_rows_without_keys(dtype):
    """Rows past T + window - 1 of a short key axis see no key: output 0,
    lse -inf, no gradient, as the plain versions give."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _train_inputs(1, 2, 1, 100, 8, 32, dtype, dev, seed=5)
    out, lse = flash_attention.flash_attention_fwd_lse(q, k, v, causal=False, window=4)
    assert not out[:, :, 11:].any() and bool(torch.isneginf(lse[:, :, 11:]).all())
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq = fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False, window=4)
    dk, dv = fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False, window=4)
    assert not dq[:, :, 11:].any()
    wq, wk, wv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False, window=4)
    for got, want in ((dq, wq), (dk, wk), (dv, wv)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=BWD_F32_TOL, rtol=BWD_F32_TOL)
        else:
            _close_bf16(got, want)


@pytest.mark.cuda
def test_training_kernels_refuse_what_they_do_not_take():
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    q, k, v, dout = _train_inputs(1, 2, 2, 16, 16, 32, torch.float32, dev)
    out, lse = flash_attention.flash_attention_fwd_lse(q, k, v)
    delta = (dout * out).sum(-1).contiguous()
    with pytest.raises(TypeError):
        flash_attention.flash_attention_fwd_lse(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd_lse(*_fa_inputs(1, 2, 2, 16, 16, 160, torch.float32, dev))
    with pytest.raises(ValueError):
        fab.flash_attention_bwd_dq(q, k, v, torch.randn((1, 2, 16, 64), device=dev)[..., ::2],
                                   lse, delta)
    with pytest.raises(ValueError):
        fab.flash_attention_bwd_dq(q, k, v, dout, lse[:, :, :8], delta)
    with pytest.raises(ValueError):
        fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta.double())
    with pytest.raises(ValueError):
        fab.flash_attention_bwd_dkv(q, k.cpu(), v, dout, lse, delta)
    with pytest.raises(ValueError):  # the training kernels have no q_offset
        ops.flash_attention(q.requires_grad_(), k, v, q_offset=3)


# ------------------------------------------ flash attention, the Hopper route
# bf16 with head_dim 64 or 128 and strides TMA takes goes to the TMA +
# wgmma kernel: S and T off its 128-row tiles (200, 1,000), T > S with
# q_offset, window 48, non-causal, GQA 15:5 and MQA, each at head_dim 64
# and 128; the last case's rows past T + 47 see no key.  (B, H, Hkv, S,
# T, causal, window, q_offset)
HOPPER_CASES = [
    (1, 15, 5, 200, 200, True, None, 0),
    (1, 6, 2, 1000, 1000, True, None, 0),
    (2, 6, 1, 200, 1000, True, None, 800),
    (1, 4, 4, 200, 1000, True, 48, 800),
    (1, 15, 5, 1000, 1000, False, None, 0),
    (2, 6, 1, 200, 200, True, 48, 0),
    (1, 4, 2, 1000, 200, False, 48, 0),
]


# The Hopper cases' outputs are also held to |got - want| <= a rms(want) +
# r |want|, chip_smoke.py's rule for the path shapes: at T = 1,000 an
# output's rms is about 0.05, so FA_BF16_ATOL alone would let a kernel drop
# a key tile.  r is two bf16 ulps of the value (both sides round to bf16);
# a takes the rounding of P to bf16 as an operand.
HOPPER_RMS_RULE = (0.1, 2**-6)


def _assert_hopper_close(got, want):
    """``got`` within FA_BF16_ATOL of ``want`` and within HOPPER_RMS_RULE."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=FA_BF16_ATOL, rtol=0)
    a, r = HOPPER_RMS_RULE
    torch.testing.assert_close(got, want, atol=a * want.square().mean().sqrt().item(), rtol=r)


def _rows_with_keys(S, T, causal, window, q_offset, device):
    """(S,) bool: the query rows that see at least one key."""
    qpos = q_offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask.any(1)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,H,Hkv,S,T,causal,window,q_offset", HOPPER_CASES)
def test_hopper_kernel_matches_plain_version(B, H, Hkv, S, T, causal, window, q_offset, D):
    """Both entry points (the training one where q_offset is 0) through the
    Hopper kernel, one launch each, against the plain versions; a row that
    sees no key gives zeros (the serving oracle: the mean of V)."""
    dev = _card()
    q, k, v = _fa_inputs(B, H, Hkv, S, T, D, torch.bfloat16, dev, seed=S + T + D)
    assert flash_attention.route(q, k, v) == "hopper"
    n = flash_attention.hopper_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.hopper_launches == n + 1
    seen = _rows_with_keys(S, T, causal, window, q_offset, dev)
    assert not got[:, :, ~seen].any()
    _assert_hopper_close(got[:, :, seen], want[:, :, seen])
    if q_offset == 0:
        out, lse = flash_attention.flash_attention_fwd_lse(q, k, v, causal=causal, window=window)
        want_out, want_lse = ref.flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_attention.hopper_launches == n + 2
        _assert_hopper_close(out, want_out)
        torch.testing.assert_close(lse, want_lse, atol=LSE_BF16_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_hopper_kernel_takes_strided_bshd_views(D):
    """The model's (B, S, H, D) projections, k and v sliced from one tensor
    (strided in the head axis too), through the Hopper kernel; the outputs
    keep q's memory layout."""
    dev = _card()
    g = torch.Generator().manual_seed(6)
    q = torch.randn((2, 100, 15, D), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    kv = torch.randn((2, 100, 10, D), generator=g).to(dev, torch.bfloat16)
    k, v = kv[:, :, :5].transpose(1, 2), kv[:, :, 5:].transpose(1, 2)
    assert flash_attention.route(q, k, v) == "hopper"
    n = flash_attention.hopper_launches
    got = ops.flash_attention(q, k, v, causal=True)
    out, lse = flash_attention.flash_attention_fwd_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.hopper_launches == n + 2
    assert got.stride() == q.stride() and out.stride() == q.stride()
    want_out, want_lse = ref.flash_attention_fwd_lse_ref(*(t.contiguous() for t in (q, k, v)))
    _assert_hopper_close(got, want_out)
    _assert_hopper_close(out, want_out)
    torch.testing.assert_close(lse, want_lse, atol=LSE_BF16_ATOL, rtol=0)


@pytest.mark.cuda
def test_other_bf16_inputs_keep_the_mma_sync_kernel():
    """head_dim 20 (the smoke config) and a 136-byte row stride launch the
    earlier kernel: the entry point counts them, the Hopper counter does
    not."""
    dev = _card()
    q, k, v = _fa_inputs(2, 3, 1, 37, 37, 20, torch.bfloat16, dev)
    x = torch.randn((1, 3, 40, 68), device=dev).to(torch.bfloat16)[..., :64]
    for args in ((q, k, v), (x, x[:, :1], x[:, :1])):
        assert flash_attention.route(*args) == "bf16"
        n = (flash_attention.hopper_launches, flash_attention.flash_attention.launches)
        got = ops.flash_attention(*args, causal=True)
        torch.cuda.synchronize()
        assert (flash_attention.hopper_launches, flash_attention.flash_attention.launches) == (
            n[0], n[1] + 1)
        want = ref.flash_attention_ref(*(t.contiguous() for t in args), causal=True)
        torch.testing.assert_close(got.float(), want.float(), atol=FA_BF16_ATOL, rtol=0)


@pytest.mark.cuda
def test_hopper_kernel_is_bitwise_repeatable_at_the_training_shape():
    """q (4, 15, 2048, 64) and k, v (4, 5, 2048, 64) as the model's views:
    two calls give the same bits (recomputation under remat and bitwise
    resume rely on it)."""
    dev = _card()
    g = torch.Generator().manual_seed(7)
    q = torch.randn((4, 2048, 15, 64), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((4, 2048, 5, 64), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    assert flash_attention.route(q, k, v) == "hopper"
    first = flash_attention.flash_attention_fwd_lse(q, k, v, causal=True)
    second = flash_attention.flash_attention_fwd_lse(q, k, v, causal=True)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# --------------------------------- flash attention backward, the Hopper route
# bf16 with head_dim 64 or 128 and q, k, v and dout at strides TMA takes goes
# to the TMA + wgmma dq and dk/dv kernels: GQA 15:5 and MQA, S = T of 130 and
# 300 (off the 128-row work items and the 64-row query tiles), S != T without
# the causal mask, causal, window 32 and non-causal, each at head_dim 64 and
# 128.  (B, H, Hkv, S, T, causal, window)
HOPPER_BWD_CASES = [
    (1, 15, 5, 130, 130, True, None),
    (2, 6, 1, 300, 300, True, None),
    (1, 15, 5, 300, 300, True, 32),
    (2, 6, 1, 130, 130, True, 32),
    (1, 15, 5, 300, 300, False, None),
    (1, 4, 4, 130, 300, False, None),
    (2, 6, 1, 300, 130, False, 32),
]


def _assert_hopper_bwd_close(got, want):
    """``got`` within the bf16 backward tolerance of ``want`` and within
    HOPPER_RMS_RULE (at S = 300 a gradient's rms is well under the
    tolerance's atol, which alone would let a kernel drop a tile)."""
    _close_bf16(got, want)
    a, r = HOPPER_RMS_RULE
    want = want.float()
    torch.testing.assert_close(got.float(), want, atol=a * want.square().mean().sqrt().item(),
                               rtol=r)


def _backward(fab, q, k, v, dout, causal, window):
    """The forward with lse on the card, then dq and dk/dv: (out, lse, dq, dk, dv)."""
    out, lse = flash_attention.flash_attention_fwd_lse(q, k, v, causal=causal, window=window)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq = fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal, window=window)
    dk, dv = fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal, window=window)
    torch.cuda.synchronize()
    return out, lse, dq, dk, dv


def _bwd_counts(fab):
    """The backward's counts: the module's Hopper launches, each entry
    point's launches, then each entry point's Hopper launches."""
    dq, dkv = fab.flash_attention_bwd_dq, fab.flash_attention_bwd_dkv
    return fab.hopper_launches, dq.launches, dkv.launches, dq.hopper_launches, dkv.hopper_launches


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,H,Hkv,S,T,causal,window", HOPPER_BWD_CASES)
def test_hopper_backward_matches_plain_version(B, H, Hkv, S, T, causal, window, D):
    """dq and dk/dv through the Hopper kernels, one launch each, against the
    plain version from the same residuals."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    q, k, v, dout = _train_inputs(B, H, Hkv, S, T, D, torch.bfloat16, dev, seed=S + T + D)
    assert fab.route(q, k, v, dout, window) == "hopper"
    n = _bwd_counts(fab)
    out, lse, dq, dk, dv = _backward(fab, q, k, v, dout, causal, window)
    assert _bwd_counts(fab) == (n[0] + 2, n[1] + 1, n[2] + 1, n[3] + 1, n[4] + 1)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    for got, want in zip((dq, dk, dv), wants):
        assert got.dtype == torch.bfloat16
        _assert_hopper_bwd_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_hopper_backward_takes_strided_bshd_views(D):
    """The model's (B, S, H, D) projections, k and v sliced from one tensor
    (strided in the head axis too), a cotangent in q's layout; the outputs
    keep q's and k's memory order ((B, S, heads, D), dk and dv packed)."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    g = torch.Generator().manual_seed(8)
    q = torch.randn((2, 300, 15, D), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    kv = torch.randn((2, 300, 10, D), generator=g).to(dev, torch.bfloat16)
    k, v = kv[:, :, :5].transpose(1, 2), kv[:, :, 5:].transpose(1, 2)
    dout = torch.randn((2, 300, 15, D), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    assert fab.route(q, k, v, dout) == "hopper"
    n = fab.hopper_launches
    out, lse, dq, dk, dv = _backward(fab, q, k, v, dout, True, None)
    assert fab.hopper_launches == n + 2
    assert dq.stride() == q.stride()
    assert dk.transpose(1, 2).is_contiguous() and dv.transpose(1, 2).is_contiguous()
    wants = ref.flash_attention_bwd_ref(*(t.contiguous() for t in (q, k, v, out)), lse,
                                        dout.contiguous())
    for got, want in zip((dq, dk, dv), wants):
        _assert_hopper_bwd_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_hopper_backward_rows_and_keys_without_pairs_are_zero(D):
    """Rows past T + window - 1 of a short key axis see no key (lse -inf):
    their dq is zero; keys past S under the causal mask are seen by no
    query: their dk and dv are zero."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    q, k, v, dout = _train_inputs(1, 2, 1, 300, 8, D, torch.bfloat16, dev, seed=5)
    assert fab.route(q, k, v, dout, 4) == "hopper"
    out, lse, dq, dk, dv = _backward(fab, q, k, v, dout, False, 4)
    assert bool(torch.isneginf(lse[:, :, 11:]).all()) and not dq[:, :, 11:].any()
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False, window=4)
    for got, want in zip((dq, dk, dv), wants):
        _assert_hopper_bwd_close(got, want)
    q, k, v, dout = _train_inputs(1, 4, 2, 130, 300, D, torch.bfloat16, dev, seed=6)
    out, lse, dq, dk, dv = _backward(fab, q, k, v, dout, True, None)
    assert not dk[:, :, 130:].any() and not dv[:, :, 130:].any()
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    for got, want in zip((dq, dk, dv), wants):
        _assert_hopper_bwd_close(got, want)


@pytest.mark.cuda
def test_hopper_backward_is_bitwise_repeatable_at_the_training_shape():
    """q (4, 15, 2048, 64) and k, v (4, 5, 2048, 64) as the model's views:
    two backward passes give the same bits (bitwise resume relies on it)."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    g = torch.Generator().manual_seed(9)
    q = torch.randn((4, 2048, 15, 64), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((4, 2048, 5, 64), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    dout = torch.randn((4, 15, 2048, 64), generator=g).to(dev, torch.bfloat16)
    assert fab.route(q, k, v, dout) == "hopper"
    first = _backward(fab, q, k, v, dout, True, None)
    second = _backward(fab, q, k, v, dout, True, None)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_other_bf16_inputs_keep_the_mma_sync_backward():
    """head_dim 20 (the smoke config) and a 136-byte row stride launch the
    earlier backward kernels: their entry points count them, the Hopper
    counter does not."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    q, k, v, dout = _train_inputs(2, 3, 1, 37, 37, 20, torch.bfloat16, dev)
    x = torch.randn((1, 3, 40, 68), device=dev).to(torch.bfloat16)[..., :64]
    for args in ((q, k, v, dout), (x, x[:, :1], x[:, :1], torch.randn_like(x))):
        assert fab.route(*args) == "bf16"
        n = _bwd_counts(fab)
        out, lse, dq, dk, dv = _backward(fab, *args, True, None)
        assert _bwd_counts(fab) == (n[0], n[1] + 1, n[2] + 1, n[3], n[4])
        wants = ref.flash_attention_bwd_ref(*(t.contiguous() for t in (*args[:3], out)), lse,
                                            args[3].contiguous(), causal=True)
        for got, want in zip((dq, dk, dv), wants):
            _close_bf16(got, want)


# ------------------------------------------------------------ selective scan
# (B, S, D, N): S = 1, S under one 16-step chunk, S past several; N = 4
# (the smoke config) and 16 (falcon-mamba-7b), the kernel's only state
# sizes; D not a multiple of the 128-channel block; the last case at the
# serving path's width
SSM_SHAPES = [(2, 1, 64, 4), (2, 37, 200, 4), (1, 300, 160, 16), (2, 37, 96, 16),
              (1, 1, 128, 16), (2, 300, 256, 4), (1, 64, 8192, 16)]
# |got - want| <= a rms(want) + r |want|.  float32 (y and h_final, and
# h_final in bf16): a recurrence of up to 1,024 steps that rounds the state
# once per step (2**-24) and takes its exponentials on the special-function
# unit (ex2.approx, about 2**-22); the errors add along the decay's memory,
# up to about 1,000 steps: about 2**-14 of the scale, and 4x that.  bf16 y:
# one rounding of the float32 y on each side; where float32 noise moves a
# value across a rounding boundary they differ by one bf16 ulp, at most
# 2**-7 of the value, half of r; a covers values near zero.
SSM_RULE = {"float32": (2**-12, 2**-12), "bfloat16": (2**-8, 2**-6)}


def _ssm_inputs(B, S, Dm, N, dtype, dev, seed=0):
    """The model's distributions and layouts: x one half of a wider
    projection, B and C column slices of x_proj's float32 output."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn((B, S, 2 * Dm), generator=g).to(dev, dtype)
    x = xz[..., :Dm]
    dt = torch.exp(torch.empty((B, S, Dm)).uniform_(-6.9078, -2.3026, generator=g)).to(dev)
    A = -torch.exp(torch.log(torch.arange(1, N + 1).float())[None]
                   + 0.1 * torch.randn((Dm, N), generator=g)).to(dev)
    xdb = torch.randn((B, S, 3 + 2 * N), generator=g).to(dev)
    Bc, Cc = xdb[..., 3:3 + N], xdb[..., 3 + N:]
    D = (1 + 0.1 * torch.randn((Dm,), generator=g)).to(dev)
    h0 = (0.3 * torch.randn((B, Dm, N), generator=g)).to(dev)
    return x, dt, A, Bc, Cc, D, h0


def _within_rule(got, want, a, r):
    want = want.float()
    rms = want.square().mean().sqrt()
    assert bool(((got.float() - want).abs() <= a * rms + r * want.abs()).all()), (
        (got.float() - want).abs().max().item(), rms.item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("B,S,Dm,N", SSM_SHAPES)
def test_ssm_scan_kernel_matches_plain_version(B, S, Dm, N, with_h0, dtype):
    from repro_torch.kernels import ssm_scan

    dev = _card()
    x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(B, S, Dm, N, dtype, dev, seed=S + Dm)
    h0 = h0 if with_h0 else None
    before = ssm_scan.ssm_scan.launches
    y, h = ops.ssm_scan(x, dt, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    assert ssm_scan.ssm_scan.launches == before + 1
    assert (y.dtype, y.shape, h.dtype, h.shape) == (dtype, (B, S, Dm), torch.float32, (B, Dm, N))
    want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D, h0)
    _within_rule(y, want_y, *SSM_RULE[str(dtype).removeprefix("torch.")])
    _within_rule(h, want_h, *SSM_RULE["float32"])


@pytest.mark.cuda
def test_ssm_scan_kernel_takes_any_strides_and_an_empty_sequence():
    """Views with a non-unit last stride give what contiguous copies give,
    bitwise; S = 0 gives an empty y and h_final = h0."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(2, 40, 96, 16, torch.float32, dev, seed=7)
    xs = torch.stack([x, x], dim=-1)[..., 0]  # last stride 2
    got = ssm_scan.ssm_scan(xs, dt.transpose(0, 1).contiguous().transpose(0, 1), A, Bc, Cc, D, h0)
    want = ssm_scan.ssm_scan(*(t.contiguous() for t in (x, dt, A, Bc, Cc, D, h0)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    y, h = ssm_scan.ssm_scan(x[:, :0], dt[:, :0], A, Bc[:, :0], Cc[:, :0], D, h0)
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 96) and torch.equal(h, h0)


@pytest.mark.cuda
def test_ssm_scan_kernel_refuses_what_it_does_not_take():
    from repro_torch.kernels import ssm_scan

    dev = _card()
    x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(1, 8, 32, 4, torch.float32, dev)
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan(x.half(), dt, A, Bc, Cc, D)
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan(x, dt.double(), A, Bc, Cc, D)
    for n in (1, 5, 17):  # state sizes the kernel is not compiled for
        with pytest.raises(ValueError):
            ssm_scan.ssm_scan(*_ssm_inputs(1, 8, 32, n, torch.float32, dev)[:6])
    with pytest.raises(ValueError):
        ssm_scan.ssm_scan(x, dt, A.t().contiguous().t(), Bc, Cc, D)
    with pytest.raises(ValueError):
        ssm_scan.ssm_scan(x, dt, A, Bc, Cc, D.cpu())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.ssm_scan(x.clone().requires_grad_(), dt, A, Bc, Cc, D)


@pytest.mark.cuda
def test_mamba_prefill_and_decode_on_the_card_match_the_cpu(monkeypatch):
    """falcon-mamba-7b's mixer width at 2 layers with a small vocabulary in
    float32: the same weights on the card and on the CPU, a 300-token
    prefill (not a multiple of the reference's 256-step chunk) and 4
    decode steps, logits and states."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan
    from repro_torch.models import Model

    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), num_layers=2, vocab_size=1024,
                              param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    lm_gpu = model.init(generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    lm_cpu = model.init(generator=torch.Generator(device=dev).manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), generator=torch.Generator().manual_seed(1))
    caches = [model.init_cache(2, 304, device=d) for d in ("cpu", dev)]
    before = ssm_scan.ssm_scan.launches
    want, _ = model.prefill(lm_cpu, {"tokens": tokens}, caches[0])
    got, _ = model.prefill(lm_gpu, {"tokens": tokens.to(dev)}, caches[1])
    assert ssm_scan.ssm_scan.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
    tok = want.argmax(-1)
    for i in range(4):
        want, _ = model.decode(lm_cpu, tok, caches[0], 300 + i)
        got, _ = model.decode(lm_gpu, tok.to(dev), caches[1], 300 + i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
        tok = want.argmax(-1)
    assert ssm_scan.ssm_scan.launches == before + cfg.num_layers  # decode launches none
    for k in ("conv", "h"):
        torch.testing.assert_close(caches[1]["sub_0"][k].cpu(), caches[0]["sub_0"][k],
                                   atol=1e-4, rtol=1e-3)
