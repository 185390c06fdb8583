"""The port's Hopper kernels against their plain PyTorch versions on a card,
and the serving paths' prefill and decode (smollm-360m's, falcon-mamba's
and the other registered configs' widths, the encdec and vlm families'
among them) on the card against the same on the CPU.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false.  Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import csr_to_dense, flash_attention, ops, ref

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo's card script: the replaced ELL kernel's launcher)

ELL_TILE = 8192  # csrc/ell_to_dense.cu's kTile: columns a block owns
# (rows, K, n_cols): the JAX package's ELL sweep, a batch at Tahoe's width,
# a row narrower than one 16-byte store, widths around one tile, K = 0,
# R = 0, more rows than a grid's y axis takes (65,535), and the Fig. 5
# batch (64 cells of at most 64 counts, the store's longest row, over 2,048
# genes: one partly used tile per row)
CASES = [(16, 8, 64), (33, 5, 100), (8, 16, 512), (1, 1, 8), (64, 1800, 62_710), (3, 7, 5),
         (5, 9, 1), (5, 9, 3), (4, 50, ELL_TILE - 1), (4, 50, ELL_TILE), (4, 50, ELL_TILE + 1),
         (3, 40, 62_710), (6, 0, 100), (0, 5, 100), (70_000, 4, 6), (64, 64, 2_048)]
ATOL = 1e-6  # random columns repeat, and atomics add duplicates in any order


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _want(vals, cols, G, log1p):
    want = ref.ell_to_dense_ref(vals, cols, G)
    return want.log1p_() if log1p else want


@pytest.mark.cuda
@pytest.mark.parametrize("log1p", [False, True])
@pytest.mark.parametrize("R,K,G", CASES)
def test_ell_to_dense_kernel_matches_plain_version(R, K, G, log1p):
    """With log1p the values are non-negative (counts): log1p's domain."""
    dev = _card()
    rng = np.random.default_rng(R * 7 + K)
    vals = rng.normal(0, 1, (R, K)).astype(np.float32)
    vals = torch.tensor(np.abs(vals) if log1p else vals, device=dev)
    cols = torch.tensor(rng.integers(-1, G, (R, K)).astype(np.int32), device=dev)
    before = csr_to_dense.ell_to_dense.launches
    got = ops.ell_to_dense(vals, cols, n_cols=G, log1p=log1p)
    torch.cuda.synchronize()
    assert csr_to_dense.ell_to_dense.launches == before + (R > 0)
    torch.testing.assert_close(got, _want(vals, cols, G, log1p), atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("log1p", [False, True])
def test_ell_to_dense_kernel_columns_out_of_range_add_nothing(log1p):
    dev = _card()
    R, K, G = 9, 30, 3 * ELL_TILE + 5
    rng = np.random.default_rng(3)
    cols = rng.choice([-7, -2, G, G + 1, 2**31 - 1, -(2**31)], (R, K)).astype(np.int32)
    vals = torch.tensor(rng.integers(1, 9, (R, K)).astype(np.float32), device=dev)
    got = ops.ell_to_dense(vals, torch.tensor(cols, device=dev), n_cols=G, log1p=log1p)
    assert torch.equal(got, torch.zeros((R, G), device=dev))


def _canonical(R=64, K=1800, G=62_710, seed=0):
    """A batch of the path's shape without duplicate columns, counts as
    values, the rows' tails padded."""
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(G, K, replace=False)) for _ in range(R)]).astype(np.int32)
    cols[:, -100:] = -1  # ragged rows
    vals = rng.integers(1, 50, (R, K)).astype(np.float32)
    return torch.tensor(vals, device="cuda"), torch.tensor(cols, device="cuda"), G


@pytest.mark.cuda
def test_ell_to_dense_kernel_bitwise_without_duplicates():
    _card()
    v, c, G = _canonical()
    got = ops.ell_to_dense(v, c, n_cols=G)
    assert torch.equal(got, ref.ell_to_dense_ref(v, c, G))
    fused = ops.ell_to_dense(v, c, n_cols=G, log1p=True)
    assert torch.equal(fused, got.log1p_())  # the fused epilogue is log1p_'s bits


@pytest.mark.cuda
def test_ell_to_dense_kernel_bitwise_the_replaced_kernel_and_repeatable():
    _card()
    v, c, G = _canonical(seed=1)
    got = ops.ell_to_dense(v, c, n_cols=G)
    fused = ops.ell_to_dense(v, c, n_cols=G, log1p=True)
    previous = chip_smoke.previous_ell_to_dense(v, c, G)
    assert torch.equal(got, previous)
    assert torch.equal(fused, previous.log1p_())
    assert torch.equal(ops.ell_to_dense(v, c, n_cols=G), got)
    assert torch.equal(ops.ell_to_dense(v, c, n_cols=G, log1p=True), fused)


@pytest.mark.cuda
def test_ell_to_dense_kernel_past_2_to_the_31_elements():
    """One launch whose output passes 2**31 elements (8.6 GB): offsets into
    it are int64.  The last rows hold the entries; checked against the
    plain version on those rows."""
    dev = _card()
    R, K, G = 34_300, 3, 62_710
    assert R * G >= 2**31
    rng = np.random.default_rng(4)
    cols = np.full((R, K), -1, np.int32)
    cols[-3:] = rng.integers(0, G, (3, K))
    cols[-1, -1] = G - 1  # the very last element
    vals = torch.tensor(rng.integers(1, 9, (R, K)).astype(np.float32), device=dev)
    cols = torch.tensor(cols, device=dev)
    got = ops.ell_to_dense(vals, cols, n_cols=G, log1p=True)
    torch.cuda.synchronize()
    assert torch.equal(got[-3:], _want(vals[-3:], cols[-3:], G, True))
    assert not bool(got[:-3].any())
    del got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_sharded_h5ad_batch_densifies_as_the_csr_batch(tmp_path):
    """A ``sharded-h5ad://`` batch (the plates exported by the shim's
    writer, read through the shim) densified on the card with the fused
    ``log1p`` is bitwise the CSR store's batch densified the same way."""
    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.data import open_collection
    from repro_torch.data.synth import generate_sharded_h5ad_like

    dev = _card()
    G = 2_048
    root = generate_sharded_h5ad_like(str(tmp_path / "plates"), n_cells=3_000, n_genes=G,
                                      n_plates=3, seed=2, total_counts=512, chunk=256)
    got = []
    for uri in (f"sharded-h5ad://{root}?driver=shim", f"sharded-csr://{root}.csr"):
        col = open_collection(uri, block_rows=16)
        ds = ScIterableDataset(col, BlockShuffling(16), batch_size=64, fetch_factor=4, seed=0)
        t = ds.fetch(0, 1)[2].to_tensors()
        before = csr_to_dense.ell_to_dense.launches
        got.append(ops.ell_to_dense(t["vals"].to(dev), t["cols"].to(dev), n_cols=G, log1p=True))
        torch.cuda.synchronize()
        assert csr_to_dense.ell_to_dense.launches == before + 1
        col.release()
    assert got[0].shape == (64, G) and bool(got[0].any())
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
def test_a_fault_and_diversity_epoch_on_the_card_is_the_cpus(tmp_path):
    """One epoch of ``train_probe`` on the card from ``fault://`` with
    retries and the diversity monitor, at 2,048 genes: its batches and
    diversity counters bitwise a clean epoch's on the host, one launch of
    the feature kernel a step, and a batch densified on the card bitwise
    the plain version on the CPU."""
    from repro_torch.data import generate_tahoe_like
    from repro_torch.pipeline import Pipeline
    from repro_torch.train import probe

    dev = _card()
    G = 2_048
    root = str(tmp_path / "cells")
    generate_tahoe_like(root, n_cells=4_096, n_genes=G, seed=1, total_counts=512)

    def pipe(uri, **res):
        p = (Pipeline.from_uri(uri, cache_bytes=1 << 22, block_rows=16).strategy("block", block_size=16)
             .batch(64, fetch_factor=8).seed(0).diversity(obs="plate"))
        return (p.resilience(**res) if res else p).build()

    clean = pipe(f"sharded-csr://{root}")
    want = list(clean)
    faulty = pipe(f"fault://sharded-csr://{root}?error_rate=0.1&seed=3", retries=6,
                  backoff_s=1e-4, max_backoff_s=1e-3)
    got = []

    def kept(batches):
        for b in batches:
            got.append(b)
            yield b

    heads = probe.init_heads(G, device=dev, generator=torch.Generator().manual_seed(0))
    opt = probe.init_adam(heads)
    torch.cuda.synchronize()
    before = csr_to_dense.ell_to_dense.launches
    run = probe.train_probe(kept(faulty), heads, opt, device=dev)
    launches = csr_to_dense.ell_to_dense.launches - before
    assert run["steps"] == len(want) == len(got) > 0 and launches == run["steps"]
    assert all(np.isfinite(run["losses"]))
    for a, b in zip(want, got):
        for f in ("data", "indices", "indptr"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    div = ("div_batches", "div_entropy_sum", "div_entropy_min")
    snap, clean_snap = faulty.collection.iostats.snapshot(), clean.collection.iostats.snapshot()
    assert {k: snap[k] for k in div} == {k: clean_snap[k] for k in div}
    assert snap["div_batches"] == len(got) and snap["retries"] > 0
    t = got[0].to_tensors()
    card = ops.ell_to_dense(t["vals"].to(dev), t["cols"].to(dev), n_cols=G)
    assert torch.equal(card.cpu(), ref.ell_to_dense_ref(t["vals"], t["cols"], G))
    clean.close()
    faulty.close()


def _card_densify_equals_plain(dev, batch, G):
    """A delivered batch through the feature kernel on the card: bitwise
    the plain version on the CPU, and with ``log1p`` fused bitwise the
    plain version followed by ``log1p_`` on the card (the CPU's ``log1p``
    has other bits, ROADMAP.md C #5)."""
    t = batch.to_tensors()
    vals, cols = t["vals"].to(dev), t["cols"].to(dev)
    before = csr_to_dense.ell_to_dense.launches
    dense = ops.ell_to_dense(vals, cols, n_cols=G)
    card = ops.ell_to_dense(vals, cols, n_cols=G, log1p=True)
    torch.cuda.synchronize()
    assert csr_to_dense.ell_to_dense.launches == before + 2
    assert bool(card.any())
    assert torch.equal(dense.cpu(), ref.ell_to_dense_ref(t["vals"], t["cols"], G))
    assert torch.equal(card, ref.ell_to_dense_ref(vals, cols, G).log1p_())


@pytest.mark.cuda
def test_a_served_batch_densifies_on_the_card_as_the_plain_version(tmp_path):
    """A batch streamed from the batch server, bitwise the local pipeline's,
    densified on the card as the plain version does on the CPU."""
    from repro_torch.data import generate_tahoe_like
    from repro_torch.pipeline import Pipeline
    from repro_torch.serve.data import BatchServer, DataClient, ServeConfig

    dev = _card()
    G = 2_048
    root = str(tmp_path / "cells")
    generate_tahoe_like(root, n_cells=4_096, n_genes=G, seed=1, total_counts=512)
    spec = (Pipeline.from_uri(f"cloud://sharded-csr://{root}?latency_scale=0")
            .strategy("block", block_size=16).batch(64, fetch_factor=4).seed(0).spec)
    local = Pipeline.from_spec(spec).build()
    want = next(iter(local))
    local.close()
    with BatchServer(ServeConfig(max_tenants=1)) as srv, DataClient(srv.address, spec,
                                                                   timeout_s=60) as cli:
        got = next(iter(cli))
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(want, f), getattr(got, f))
    _card_densify_equals_plain(dev, got, G)


@pytest.mark.cuda
def test_a_fabric_batch_densifies_on_the_card_as_the_plain_version(tmp_path):
    """A batch a re-homed rank delivers after a kill and a resize, densified
    on the card as the plain version does on the CPU."""
    from repro_torch.core import BlockShuffling, ScIterableDataset
    from repro_torch.data import generate_tahoe_like, open_collection
    from repro_torch.distributed.elastic import ElasticFabric, tagged_batches

    dev = _card()
    G = 2_048
    root = str(tmp_path / "cells")
    generate_tahoe_like(root, n_cells=4_096, n_genes=G, seed=1, total_counts=512)
    kw = dict(batch_size=64, fetch_factor=4, seed=0)
    fab = ElasticFabric(open_collection(f"sharded-csr://{root}", io_workers=2), world_size=3,
                        strategy=BlockShuffling(16), **kw)
    for r in list(fab.loaders):
        list(tagged_batches(fab.loaders[r], limit=3))
    fab.kill(1)
    fab.resize(2)
    gid, j, got = next(tagged_batches(fab.loaders[1]))
    want = ScIterableDataset(open_collection(f"sharded-csr://{root}"), BlockShuffling(16),
                             **kw).fetch(0, gid)[j]
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(want, f), getattr(got, f))
    _card_densify_equals_plain(dev, got, G)


# ------------------------------------------------------------ flash attention
# the JAX package's sweep (tests/test_kernels.py), D = 20 (the smoke
# config) and the serving path's heads (GQA 15:5, D = 64)
FA_SHAPES = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 128, 128, 32), (1, 8, 1, 96, 160, 64),
             (2, 2, 1, 64, 128, 32), (2, 3, 1, 37, 37, 20), (1, 15, 5, 200, 200, 64),
             (1, 4, 2, 70, 70, 128), (1, 8, 2, 70, 70, 120), (2, 3, 1, 37, 37, 160),
             (1, 4, 4, 70, 100, 256)]
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
    with pytest.raises(ValueError):  # one past the widest kernel, head_dim 256
        ops.flash_attention(*_fa_inputs(1, 2, 2, 16, 16, 257, torch.float32, dev))
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "gemma-7b",
                                  "h2o-danube-3-4b"])
def test_new_configs_prefill_and_decode_on_the_card_match_the_cpu(arch):
    """The moe family and the head widths 256 and 120, at their full head
    width and expert count with d_model, d_ff and the vocabulary narrowed,
    2 layers, float32, a window of 24 where the config has one: the same
    weights on the card and on the CPU, a 40-token prefill (the window
    cuts) and 4 decode steps, every prefill layer through the kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=2, d_model=256, d_ff=512, vocab_size=1024,
                              param_dtype="float32", compute_dtype="float32",
                              sliding_window=24 if full.sliding_window else None)
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
        flash_attention.flash_attention_fwd_lse(*_fa_inputs(1, 2, 2, 16, 16, 257, torch.float32, dev))
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
# bf16 with head_dim 64, 120, 128 or 256 and strides TMA takes goes to the
# TMA + wgmma kernel: S and T off its 128-row tiles and its 64- and 128-key
# tiles (200, 300, 1,000), T > S with q_offset, window 48, non-causal, GQA
# 15:5, 8:2 and MQA, each at every Hopper head_dim; the last case's rows
# past T + 47 see no key.  (B, H, Hkv, S, T, causal, window, q_offset)
HOPPER_CASES = [
    (1, 15, 5, 200, 200, True, None, 0),
    (1, 6, 2, 1000, 1000, True, None, 0),
    (2, 6, 1, 200, 1000, True, None, 800),
    (1, 4, 4, 200, 1000, True, 48, 800),
    (1, 15, 5, 1000, 1000, False, None, 0),
    (2, 6, 1, 200, 200, True, 48, 0),
    (1, 8, 2, 300, 300, True, None, 0),
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
@pytest.mark.parametrize("D", [64, 120, 128, 256])
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
@pytest.mark.parametrize("D", [64, 120, 128, 256])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(chip_smoke.WIDE_SHAPES))
def test_the_new_head_widths_serving_shapes_match_plain_version(shape, dtype):
    """gemma-7b's prefill attention (head_dim 256) and h2o-danube-3-4b's
    (head_dim 120, window 4,096), both through the Hopper kernel in bf16,
    at batch 4 of 4,608 tokens as the model's (B, S, H, D) views, against
    the plain version within chip_smoke.py's WIDE_RULE."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Hkv, S, D, window = chip_smoke.WIDE_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = chip_smoke._wide_inputs(B, H, Hkv, S, D, dtype, dev, gen)
    want_route = "f32" if dtype == torch.float32 else "hopper"
    assert flash_attention.route(q, k, v, window) == want_route
    n = (flash_attention.hopper_launches, flash_attention.wide_launches)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.hopper_launches - n[0], flash_attention.wide_launches - n[1]) == (
        int(want_route == "hopper"), int(D > 128))
    assert got.stride() == q.stride()
    err = chip_smoke._wide_err(got, want, str(dtype).removeprefix("torch."))
    assert err["of_rule"] <= 1.0, err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(chip_smoke.FAMILY_SHAPES))
def test_the_new_families_prefill_shapes_match_plain_version(shape):
    """whisper-large-v3's encoder attention (20 heads of 64 over 1,500
    frames, non-causal) and internvl2-26b's prefill attention (48 heads of
    128 over 8, 4,608 positions, causal) at batch 1, as the model's (B, S,
    H, D) views in bf16, through the Hopper kernel (one launch each),
    against the plain version within HOPPER_RMS_RULE."""
    dev = _card()
    _, H, Hkv, S, D, causal = chip_smoke.FAMILY_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = chip_smoke._wide_inputs(1, H, Hkv, S, D, torch.bfloat16, dev, gen)
    assert flash_attention.route(q, k, v) == "hopper"
    n = flash_attention.hopper_launches
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.hopper_launches == n + 1
    assert got.stride() == q.stride()
    _assert_hopper_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-26b"])
def test_new_families_prefill_and_decode_on_the_card_match_the_cpu(arch):
    """The encdec and vlm families at their full head widths (20 of 64;
    48 of 128 over 8) with d_model, d_ff, the vocabulary, whisper's cross
    length and internvl2's patches narrowed, 2 layers (2 + 2), float32:
    the same weights on the card and on the CPU, a prefill (whisper: its
    frames, then BOS; internvl2: 16 patch embeddings and 24 tokens) and 4
    decode steps at the model's positions, every prefill attention layer
    through the kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import decode_span
    from repro_torch.models import Model

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2, decoder_layers=2, d_model=256,
                              d_ff=512, vocab_size=1024, cross_len=40, num_patches=16,
                              param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    m_cpu = model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    m_gpu = model.init(generator=torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.cross_len, cfg.d_model), generator=g)
    else:
        batch["patch_embeds"] = torch.randn((2, cfg.num_patches, cfg.d_model), generator=g)
    max_len, start = decode_span(cfg, 24, 5)
    caches = [model.init_cache(2, max_len, device=d) for d in ("cpu", dev)]
    before = flash_attention.flash_attention.launches
    want, _ = model.prefill(m_cpu, batch, caches[0])
    got, _ = model.prefill(m_gpu, {k: t.to(dev) for k, t in batch.items()}, caches[1])
    assert flash_attention.flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    tok = want.argmax(-1)
    for i in range(4):
        want, _ = model.decode(m_cpu, tok, caches[0], start + i)
        got, _ = model.decode(m_gpu, tok.to(dev), caches[1], start + i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        tok = want.argmax(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["row_stride_520B", "base_8B"])
def test_mma_sync_kernel_keeps_head_dim_256_where_tma_refuses(shape):
    """gemma-7b's head_dim at strides TMA refuses (rows of 260 values) or
    at a base 8 bytes off 16 launches flash_fwd_bf16<256>: the wide count
    moves, the Hopper count does not; within WIDE_RULE of the plain
    version, causal with GQA 8:2 and S, T off the tiles."""
    dev = _card()
    B, H, Hkv, S = 1, 8, 2, 300
    g = torch.Generator(device=dev).manual_seed(11)
    if shape == "row_stride_520B":
        x = torch.randn((B, H + 2 * Hkv, S, 260), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = x[:, :H, :, :256], x[:, H:H + Hkv, :, :256], x[:, H + Hkv:, :, :256]
    else:
        n = B * (H + 2 * Hkv) * S * 256
        x = torch.randn((n + 4,), generator=g, device=dev).to(torch.bfloat16)[4:]
        x = x.view(B, H + 2 * Hkv, S, 256)
        q, k, v = x[:, :H], x[:, H:H + Hkv], x[:, H + Hkv:]
    assert flash_attention.route(q, k, v) == "bf16"
    n = (flash_attention.hopper_launches, flash_attention.wide_launches)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(*(t.contiguous() for t in (q, k, v)), causal=True)
    torch.cuda.synchronize()
    assert (flash_attention.hopper_launches, flash_attention.wide_launches) == (n[0], n[1] + 1)
    err = chip_smoke._wide_err(got, want, "bfloat16")
    assert err["of_rule"] <= 1.0, err


@pytest.mark.cuda
def test_training_at_head_dim_256_raises_naming_its_item():
    """Named when the backward refused head_dim 256.  Now a gradient at
    256 (gemma-7b's) runs the forward with lse and the dq and dk/dv
    kernels, each once and through the Hopper kernels, and the gradients
    equal the plain backward's from the same residuals."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    q, k, v, dout = _train_inputs(1, 8, 2, 130, 130, 256, torch.bfloat16, dev, seed=12)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n = (flash_attention.flash_attention_fwd_lse.launches, flash_attention.hopper_launches)
    out = ops.flash_attention(q, k, v, causal=True)
    assert (flash_attention.flash_attention_fwd_lse.launches,
            flash_attention.hopper_launches) == (n[0] + 1, n[1] + 1)
    counts = _bwd_counts(fab)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert _bwd_counts(fab) == (counts[0] + 2, *(c + 1 for c in counts[1:]))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    _, lse = flash_attention.flash_attention_fwd_lse(qd, kd, vd, causal=True)  # the residual, again
    wants = ref.flash_attention_bwd_ref(qd, kd, vd, out.detach(), lse, dout, causal=True)
    for g, want in zip(got, wants):
        _assert_hopper_bwd_close(g, want)


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
    (1, 8, 2, 300, 300, True, None),
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
@pytest.mark.parametrize("D", [64, 128, 256])
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
@pytest.mark.parametrize("D", [64, 128, 256])
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
@pytest.mark.parametrize("D", [64, 128, 256])
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
@pytest.mark.parametrize("causal,window", BWD_MASKS)
def test_head_dim_256_keeps_the_mma_sync_backward_where_tma_refuses(causal, window):
    """gemma-7b's head_dim in rows of 260 values (a 520-byte head stride
    TMA refuses), GQA 8:2, S off the tiles: dq_bf16<256> and the dk/dv
    kernel that splits its 256 output columns over two blocks; their
    entry points count them, the Hopper counter does not."""
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = _card()
    B, H, Hkv, S = 1, 8, 2, 150
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((B, H + 2 * Hkv, S, 260), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = x[:, :H, :, :256], x[:, H:H + Hkv, :, :256], x[:, H + Hkv:, :, :256]
    dout = torch.randn((B, H, S, 256), generator=g, device=dev).to(torch.bfloat16)
    assert fab.route(q, k, v, dout, window) == "bf16"
    n = _bwd_counts(fab)
    out, lse, dq, dk, dv = _backward(fab, q, k, v, dout, causal, window)
    assert _bwd_counts(fab) == (n[0], n[1] + 1, n[2] + 1, n[3], n[4])
    wants = ref.flash_attention_bwd_ref(*(t.contiguous() for t in (q, k, v, out)), lse, dout,
                                        causal=causal, window=window)
    for got, want in zip((dq, dk, dv), wants):
        _assert_hopper_bwd_close(got, want)


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


def _ssm_inputs(B, S, Dm, N, dtype, dev, seed=0, dt_rank=3):
    """The model's distributions and layouts: x one half of a wider
    projection, B and C column slices of x_proj's float32 output after
    ``dt_rank`` columns (3: 12 bytes into each row, where TMA cannot start,
    so these take the simt kernel; 256, falcon-mamba-7b's, the Hopper one)."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn((B, S, 2 * Dm), generator=g).to(dev, dtype)
    x = xz[..., :Dm]
    dt = torch.exp(torch.empty((B, S, Dm)).uniform_(-6.9078, -2.3026, generator=g)).to(dev)
    A = -torch.exp(torch.log(torch.arange(1, N + 1).float())[None]
                   + 0.1 * torch.randn((Dm, N), generator=g)).to(dev)
    xdb = torch.randn((B, S, dt_rank + 2 * N), generator=g).to(dev)
    Bc, Cc = xdb[..., dt_rank:dt_rank + N], xdb[..., dt_rank + N:]
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
    # under a gradient (training) the forward is the same kernel, with the
    # same refusals
    with pytest.raises(ValueError):
        ops.ssm_scan(x.clone().requires_grad_(), dt, A, Bc, Cc, D.cpu())
    with pytest.raises(TypeError):
        ops.ssm_scan(x.half().requires_grad_(), dt, A, Bc, Cc, D)


# ------------------------------------------------------- the scan's backward
# S = 0, one step, around the backward's 8-step segments (15, 16, 17) and
# 1,023; D 96 (three of its 32-channel blocks) and 200 (no whole number of
# blocks, of 32 or of the forward's 128)
SSM_BWD_S = [0, 1, 15, 16, 17, 1023]
SSM_BWD_D = [96, 200]
SSM_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def _bwd_inputs(B, S, Dm, N, dtype, dev, seed, seeded: bool):
    """The model's layouts (x half of a projection, B and C column views
    after falcon-mamba's 256 columns), dy a half of a wider tensor (not
    contiguous); h0 and dh_final where ``seeded``, else None."""
    inputs = list(_ssm_inputs(B, S, Dm, N, dtype, dev, seed=seed, dt_rank=256))
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn((B, S, 2 * Dm), generator=g).to(dev, dtype)[..., Dm:]
    dh_final = torch.randn((B, Dm, N), generator=g).to(dev) if seeded else None
    if not seeded:
        inputs[6] = None
    return inputs, dy, dh_final


def _grads_within_rule(got, want, dtype):
    for name, g, w in zip(SSM_GRADS, got, want):
        kind = str(dtype).removeprefix("torch.") if name == "dx" else "float32"
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.numel():
            _within_rule(g, w, *SSM_RULE[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seeded", [False, True], ids=["zeros", "h0_dh_final"])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("Dm", SSM_BWD_D)
@pytest.mark.parametrize("S", SSM_BWD_S)
def test_ssm_scan_bwd_kernel_matches_plain_version(S, Dm, N, seeded, dtype):
    """Every gradient of the backward kernel within the forward's rule
    (dx by x's type, the rest as float32) of ``ssm_scan_bwd_ref``, one
    launch counted and no copy."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    inputs, dy, dh_final = _bwd_inputs(2, S, Dm, N, dtype, dev, S + Dm + N, seeded)
    assert ssm_scan.bwd_route(*inputs[:2], *inputs[3:5], dy) == "ssm_scan_bwd"
    before = (ssm_scan.ssm_scan_bwd.launches, ssm_scan.ssm_scan_bwd.copies)
    got = ssm_scan.ssm_scan_bwd(*inputs, dy, dh_final)
    torch.cuda.synchronize()
    assert (ssm_scan.ssm_scan_bwd.launches, ssm_scan.ssm_scan_bwd.copies) == (before[0] + 1,
                                                                              before[1])
    _grads_within_rule(got, ref.ssm_scan_bwd_ref(*inputs, dy, dh_final), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1023, 200, 16), (4, 2048, 8192, 16)],
                         ids=["sweep", "falcon_mamba_training"])
def test_ssm_scan_bwd_kernel_is_bitwise_repeatable(shape):
    """No atomics: two calls on the same inputs give the same bits, at the
    sweep's longest case and at falcon-mamba-7b's training shape (bf16)."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    inputs, dy, dh_final = _bwd_inputs(*shape, torch.bfloat16, dev, 3, True)
    first = ssm_scan.ssm_scan_bwd(*inputs, dy, dh_final)
    second = ssm_scan.ssm_scan_bwd(*inputs, dy, dh_final)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(bool(torch.isfinite(g.float()).all()) for g in first)


@pytest.mark.cuda
def test_ssm_scan_bwd_kernel_takes_any_strides_and_copies_only_dh_final():
    """x with a last stride of 2 and dt transposed in memory give what
    contiguous copies give, bitwise, with no copy; a non-contiguous
    dh_final is copied once, counted."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    (x, dt, A, Bc, Cc, D, h0), dy, dh_final = _bwd_inputs(2, 40, 96, 16, torch.float32, dev, 7, True)
    xs = torch.stack([x, x], dim=-1)[..., 0]
    dts = dt.transpose(0, 1).contiguous().transpose(0, 1)
    copies = ssm_scan.ssm_scan_bwd.copies
    got = ssm_scan.ssm_scan_bwd(xs, dts, A, Bc, Cc, D, h0, dy, dh_final)
    assert ssm_scan.ssm_scan_bwd.copies == copies
    want = ssm_scan.ssm_scan_bwd(*(t.contiguous() for t in (x, dt, A, Bc, Cc, D, h0, dy, dh_final)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    strided = dh_final.transpose(1, 2).contiguous().transpose(1, 2)
    again = ssm_scan.ssm_scan_bwd(x, dt, A, Bc, Cc, D, h0, dy, strided)
    torch.cuda.synchronize()
    assert ssm_scan.ssm_scan_bwd.copies == copies + 1
    assert all(torch.equal(g, w) for g, w in zip(again, want))


@pytest.mark.cuda
def test_ssm_scan_bwd_kernel_launches_nothing_for_no_channel_or_no_row():
    """D = 0 or B = 0: no launch counted; the sums over the channels
    (dB, dC) and over the batch (dA, dD) are zeros, as the plain version's."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    (x, dt, A, Bc, Cc, D, h0), dy, dh_final = _bwd_inputs(2, 9, 32, 4, torch.float32, dev, 4, True)
    before = ssm_scan.ssm_scan_bwd.launches
    cases = [(x[..., :0], dt[..., :0], A[:0], Bc, Cc, D[:0], h0[:, :0], dy[..., :0], dh_final[:, :0]),
             (x[:0], dt[:0], A, Bc[:0], Cc[:0], D, h0[:0], dy[:0], dh_final[:0])]
    for inputs in cases:
        inputs = [t.contiguous() for t in inputs]
        got = ssm_scan.ssm_scan_bwd(*inputs)
        want = ref.ssm_scan_bwd_ref(*inputs)
        assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
    assert ssm_scan.ssm_scan_bwd.launches == before


@pytest.mark.cuda
def test_ssm_scan_bwd_kernel_refuses_what_it_does_not_take():
    """N 5, float16 x, a D on the CPU, a dy not of x's type: raised before
    any launch, none counted."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    (x, dt, A, Bc, Cc, D, h0), dy, dh_final = _bwd_inputs(1, 8, 32, 4, torch.float32, dev, 2, True)
    before = ssm_scan.ssm_scan_bwd.launches
    (x5, dt5, A5, B5, C5, D5, h5), dy5, dh5 = _bwd_inputs(1, 8, 32, 5, torch.float32, dev, 2, True)
    with pytest.raises(ValueError):
        ssm_scan.ssm_scan_bwd(x5, dt5, A5, B5, C5, D5, h5, dy5, dh5)
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan_bwd(x.half(), dt, A, Bc, Cc, D, h0, dy.half(), dh_final)
    with pytest.raises(ValueError):
        ssm_scan.ssm_scan_bwd(x, dt, A, Bc, Cc, D.cpu(), h0, dy, dh_final)
    with pytest.raises(ValueError):
        ssm_scan.ssm_scan_bwd(x, dt, A, Bc, Cc, D, h0, dy.bfloat16(), dh_final)
    assert ssm_scan.ssm_scan_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssm_scan_under_autograd_runs_both_kernels(dtype):
    """``ops.ssm_scan`` under a gradient on the card: the forward through
    ``ssm_scan_hopper`` (the model's layouts) and, in the backward, one
    launch of the backward kernel, whose gradients autograd hands back
    bitwise; no plain scan runs."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    (x, dt, A, Bc, Cc, D, h0), dy, _ = _bwd_inputs(2, 300, 200, 16, dtype, dev, 5, True)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bc, Cc, D, h0)]
    plain = (ref.ssm_scan_ref, ref.ssm_scan_bwd_ref)
    ref.ssm_scan_ref = ref.ssm_scan_bwd_ref = None  # a plain scan on this path would raise
    try:
        before = (ssm_scan.hopper_launches, ssm_scan.ssm_scan_bwd.launches)
        y, h = ops.ssm_scan(*leaves)
        grads = torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
    finally:
        ref.ssm_scan_ref, ref.ssm_scan_bwd_ref = plain
    assert (ssm_scan.hopper_launches, ssm_scan.ssm_scan_bwd.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    want = ssm_scan.ssm_scan_bwd(*(t.detach() for t in leaves), dy, None)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


# ------------------------------------------------ the staged (TMA) Hopper scan
# S = 0, one step, under one 16-step chunk, past several, and 1,023 (none a
# multiple of the chunk but 0); D not a multiple of the block's 128 channels
SSM_STAGED_S = [0, 1, 37, 300, 1023]
SSM_STAGED_D = [96, 160, 200]


class _SimtOnly:
    """A library whose Hopper entry point is the simt kernel's: through
    ``ssm_scan.launch`` it runs the simt kernel on inputs routed to the
    Hopper one (the same checks, outputs and arguments)."""

    def __init__(self, lib):
        self.ssm_scan_fwd = self.ssm_scan_fwd_hopper = lib.ssm_scan_fwd
        self.cuda_error_string = lib.cuda_error_string


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("Dm", SSM_STAGED_D)
@pytest.mark.parametrize("S", SSM_STAGED_S)
def test_ssm_staged_kernel_matches_plain_version(S, Dm, N, with_h0, dtype):
    from repro_torch.kernels import ssm_scan

    dev = _card()
    x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(2, S, Dm, N, dtype, dev, seed=S + Dm + N, dt_rank=256)
    h0 = h0 if with_h0 else None
    assert ssm_scan.route(x, dt, Bc, Cc) == "hopper"
    before = (ssm_scan.ssm_scan.launches, ssm_scan.hopper_launches)
    y, h = ops.ssm_scan(x, dt, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    assert (ssm_scan.ssm_scan.launches, ssm_scan.hopper_launches) == (before[0] + 1, before[1] + 1)
    assert (y.dtype, y.shape, h.dtype, h.shape) == (dtype, (2, S, Dm), torch.float32, (2, Dm, N))
    want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D, h0)
    _within_rule(y, want_y, *SSM_RULE[str(dtype).removeprefix("torch.")])
    _within_rule(h, want_h, *SSM_RULE["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssm_staged_kernel_computes_what_the_simt_kernel_does_bitwise(dtype):
    """Both kernels run the same float32 operations in the same order, so
    staging the inputs changes no bit."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    inputs = _ssm_inputs(3, 300, 200, 16, dtype, dev, seed=11, dt_rank=256)
    staged_y, staged_h, kernel = ssm_scan.launch(None, *inputs)
    simt_y, simt_h, _ = ssm_scan.launch(_SimtOnly(ssm_scan._library()), *inputs)
    torch.cuda.synchronize()
    assert kernel == "hopper"
    assert torch.equal(staged_y, simt_y) and torch.equal(staged_h, simt_h)


@pytest.mark.cuda
def test_ssm_staged_kernel_is_bitwise_repeatable_at_the_path_shape():
    """falcon-mamba-7b's prefill scan: x (8, 1024, 8192) bf16, N 16, h0."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    inputs = _ssm_inputs(8, 1024, 8192, 16, torch.bfloat16, dev, seed=5, dt_rank=256)
    assert ssm_scan.route(*inputs[:2], *inputs[3:5]) == "hopper"
    y1, h1 = ssm_scan.ssm_scan(*inputs)
    y2, h2 = ssm_scan.ssm_scan(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert bool(torch.isfinite(y1.float()).all()) and bool(torch.isfinite(h1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["b_c_after_dt_rank_3", "x_transposed", "x_last_stride_2"])
def test_other_strides_keep_the_simt_kernel(layout):
    from repro_torch.kernels import ssm_scan

    dev = _card()
    dt_rank = 3 if layout == "b_c_after_dt_rank_3" else 256
    x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(2, 300, 160, 16, torch.float32, dev, seed=9,
                                          dt_rank=dt_rank)
    if layout == "x_transposed":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "x_last_stride_2":
        x = torch.stack([x, x], dim=-1)[..., 0]
    assert ssm_scan.route(x, dt, Bc, Cc) == "simt"
    before = (ssm_scan.ssm_scan.launches, ssm_scan.hopper_launches)
    y, h = ssm_scan.ssm_scan(x, dt, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    assert (ssm_scan.ssm_scan.launches, ssm_scan.hopper_launches) == (before[0] + 1, before[1])
    want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D, h0)
    _within_rule(y, want_y, *SSM_RULE["float32"])
    _within_rule(h, want_h, *SSM_RULE["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Dm", [(torch.bfloat16, 100), (torch.float32, 99)],
                         ids=["bf16-200B", "f32-396B"])
def test_ssm_staged_kernel_takes_one_step_of_one_row_at_any_width(dtype, Dm):
    """B = S = 1 routes to the staged kernel whatever the row's bytes, so
    its tensor maps must take a length-1 axis over a row that is not a
    multiple of 16 bytes."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(1, 1, Dm, 16, dtype, dev, seed=Dm, dt_rank=256)
    assert ssm_scan.route(x, dt, Bc, Cc) == "hopper"
    before = ssm_scan.hopper_launches
    y, h = ssm_scan.ssm_scan(x, dt, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    assert ssm_scan.hopper_launches == before + 1
    want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D, h0)
    _within_rule(y, want_y, *SSM_RULE[str(dtype).removeprefix("torch.")])
    _within_rule(h, want_h, *SSM_RULE["float32"])


@pytest.mark.cuda
def test_hopper_launches_counts_exactly_the_staged_launches():
    from repro_torch.kernels import ssm_scan

    dev = _card()
    staged = _ssm_inputs(2, 40, 96, 4, torch.bfloat16, dev, seed=1, dt_rank=256)
    simt = _ssm_inputs(2, 40, 96, 4, torch.bfloat16, dev, seed=1)
    x, dt, A, Bc, Cc, D, h0 = staged
    calls = [staged, simt, staged,
             (x[:, :0], dt[:, :0], A, Bc[:, :0], Cc[:, :0], D, h0),  # S = 0: h_final = h0
             (x[:0], dt[:0], A, Bc[:0], Cc[:0], D, None)]  # no batch row: nothing launches
    before = (ssm_scan.ssm_scan.launches, ssm_scan.hopper_launches)
    for inputs in calls:
        ssm_scan.ssm_scan(*inputs)
    torch.cuda.synchronize()
    assert (ssm_scan.ssm_scan.launches, ssm_scan.hopper_launches) == (before[0] + 4, before[1] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssm_staged_kernel_at_jambas_width(dtype):
    """jamba-1.5-large's Mamba layers: d_inner 16,384 (twice falcon-mamba's),
    N 16, B and C after its dt_rank of 512 columns, through the Hopper
    kernel, within the rule of its plain version."""
    from repro_torch.kernels import ssm_scan

    dev = _card()
    x, dt, A, Bc, Cc, D, h0 = _ssm_inputs(2, 300, 16384, 16, dtype, dev, seed=13, dt_rank=512)
    assert ssm_scan.route(x, dt, Bc, Cc) == "hopper"
    before = ssm_scan.hopper_launches
    y, h = ops.ssm_scan(x, dt, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    assert ssm_scan.hopper_launches == before + 1
    want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bc, Cc, D, h0)
    _within_rule(y, want_y, *SSM_RULE[str(dtype).removeprefix("torch.")])
    _within_rule(h, want_h, *SSM_RULE["float32"])


def _mamba_card_against_cpu(dev):
    """falcon-mamba-7b's mixer width at 2 layers with a small vocabulary in
    float32: the same weights on the card and on the CPU, a 300-token
    prefill (not a multiple of the reference's 256-step chunk) and 4
    decode steps, logits and states within phase 16's tolerances."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), num_layers=2, vocab_size=1024,
                              param_dtype="float32", compute_dtype="float32")
    model = Model(cfg)
    lm_gpu = model.init(generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    lm_cpu = model.init(generator=torch.Generator(device=dev).manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), generator=torch.Generator().manual_seed(1))
    caches = [model.init_cache(2, 304, device=d) for d in ("cpu", dev)]
    before = ssm_scan.ssm_scan.launches
    hopper_before = ssm_scan.hopper_launches
    want, _ = model.prefill(lm_cpu, {"tokens": tokens}, caches[0])
    got, _ = model.prefill(lm_gpu, {"tokens": tokens.to(dev)}, caches[1])
    assert ssm_scan.ssm_scan.launches == before + cfg.num_layers
    assert ssm_scan.hopper_launches == hopper_before + cfg.num_layers  # the model's layouts
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


@pytest.mark.cuda
def test_mamba_prefill_and_decode_on_the_card_match_the_cpu(monkeypatch):
    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _mamba_card_against_cpu(dev)


@pytest.mark.cuda
def test_mamba_with_tf32_on_still_matches_the_cpu(monkeypatch):
    """A caller with TF32 on: the model's float32 products are full float32
    all the same, and the caller's setting is as it was after."""
    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _mamba_card_against_cpu(dev)
    assert torch.backends.cuda.matmul.allow_tf32 is True


@pytest.mark.cuda
@pytest.mark.parametrize("caller", [True, False])
def test_probe_step_on_the_card_matches_the_cpu_whatever_the_tf32_setting(monkeypatch, caller):
    """One Adam step of the four heads at 2,048 genes, batch 64, from the
    same heads and batch on the card and on the CPU: the loss within rtol
    1e-5 and Adam's first moments (0.1 of the gradients) within 1e-5 of
    their largest, which TF32's 10-bit products would miss."""
    from repro_torch.train import probe

    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller)
    rng = np.random.default_rng(5)
    x = torch.tensor(np.log1p(rng.poisson(0.5, (64, 2048))).astype(np.float32))
    ys = {t: torch.tensor(rng.integers(0, c, 64).astype(np.int32)) for t, c in probe.TASKS.items()}
    runs = []
    for d in ("cpu", dev):
        heads = probe.init_heads(2048, device=d, generator=torch.Generator().manual_seed(2))
        opt = probe.init_adam(heads)
        loss = probe.train_step(heads, opt, x.to(d), {t: y.to(d) for t, y in ys.items()})
        runs.append((loss.item(), {n: m.cpu() for n, m in opt.m.items()}))
    assert torch.backends.cuda.matmul.allow_tf32 is caller
    (want_loss, want_m), (got_loss, got_m) = runs
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    for n, m in want_m.items():
        torch.testing.assert_close(got_m[n], m, atol=1e-5 * float(m.abs().max()), rtol=0, msg=n)


# ------------------------------------------------------- remat="dots" on the card
@pytest.mark.cuda
def test_remat_dots_gives_the_gradients_of_full_on_the_card():
    """A small model (gemma's smoke config widened to head_dim 256, bf16,
    so the attention runs the Hopper forward with lse and backward) under
    ``"dots"`` and ``"full"``: what dots keeps is the forward's own
    tensors, and full recomputes them with the same kernels on the same
    inputs, so the gradients agree bitwise."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import Model

    dev = _card()
    cfg = dataclasses.replace(smoke_config("gemma-7b"), head_dim=256)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(2))
    grads = {}
    for remat in ("full", "dots"):
        model = Model(dataclasses.replace(cfg, remat=remat))
        lm = model.init(generator=torch.Generator().manual_seed(0), device=dev)
        before = flash_attention.hopper_launches
        logits = model.forward(lm, {"tokens": tokens.to(dev)})
        grads[remat] = torch.autograd.grad(logits.float().square().mean(), list(lm.parameters()))
        torch.cuda.synchronize()
        # the forward and its recomputation in the backward, a layer each
        assert flash_attention.hopper_launches == before + 2 * cfg.num_layers, remat
    assert all(torch.equal(a, b) for a, b in zip(grads["full"], grads["dots"]))
