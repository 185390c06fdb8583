"""The cell-training slice as a whole, port against JAX package on the CPU:
the same batches, the same starting heads and Adam state (converted from
numpy), 20 steps; losses, heads and moments agree in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_fig5_classification as fig5
from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import ScDataset
from repro.data import synth as ref_synth
from repro_torch import convert
from repro_torch.core import BlockShuffling, ScIterableDataset
from repro_torch.data import synth
from repro_torch.kernels import ref
from repro_torch.train import probe

N_GENES = 256
GEN = dict(n_cells=3000, n_genes=N_GENES, total_counts=256, seed=0, chunk=512)
LOADER = dict(batch_size=64, fetch_factor=8, seed=0)
STEPS = 20
# float32 on both sides; matmul and reduction order differ between XLA and
# PyTorch on the CPU
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("probe")
    ref_synth.generate_tahoe_like(str(base / "repro"), **GEN)
    synth.generate_tahoe_like(str(base / "port"), **GEN)
    return ref_synth.load_tahoe_like(str(base / "repro")), synth.load_tahoe_like(str(base / "port"))


def _start(count: int, seed: int = 1):
    """Random heads (and, past step 0, random moments) made with numpy."""
    rng = np.random.default_rng(seed)

    def tree(scale, positive=False):
        out = {}
        for t, c in probe.TASKS.items():
            w = rng.normal(0, scale, (N_GENES, c)).astype(np.float32)
            b = rng.normal(0, scale, (c,)).astype(np.float32)
            out[t] = {"w": np.abs(w) if positive else w, "b": np.abs(b) if positive else b}
        return out

    heads = tree(0.05)
    if count == 0:
        zeros = {t: {k: np.zeros_like(a) for k, a in h.items()} for t, h in heads.items()}
        return heads, {"m": zeros, "v": zeros, "count": 0}
    return heads, {"m": tree(1e-3), "v": tree(1e-6, positive=True), "count": count}


@pytest.mark.parametrize("count", [0, 3])
def test_train_probe_matches_jax_reference(stores, count):
    heads_np, opt_np = _start(count)
    heads = convert.heads_from_jax(heads_np, device="cpu")
    opt = convert.adam_from_jax(opt_np, device="cpu")
    port_ds = ScIterableDataset(stores[1], BlockShuffling(16), **LOADER)
    run = probe.train_probe(port_ds, heads, opt, device="cpu", max_steps=STEPS)
    assert run["steps"] == STEPS and opt.count == count + STEPS

    jheads = jax.tree.map(jnp.asarray, heads_np)
    jopt = {"m": jax.tree.map(jnp.asarray, opt_np["m"]),
            "v": jax.tree.map(jnp.asarray, opt_np["v"]),
            "count": jnp.asarray(count, jnp.int32)}
    want = []
    for _, batch in zip(range(STEPS), ScDataset(stores[0], RefBlockShuffling(16), **LOADER)):
        ys = {t: jnp.asarray(batch.obs[t].astype(np.int32)) for t in probe.TASKS}
        jheads, jopt, loss = fig5._train_step(jheads, jopt, fig5._features(batch), ys)
        want.append(float(loss))

    np.testing.assert_allclose(run["losses"], want, rtol=RTOL, atol=ATOL)
    assert np.mean(run["losses"][-5:]) < np.mean(run["losses"][:5])
    for t in probe.TASKS:
        for p in ("w", "b"):
            name = f"heads.{t}.{p}"
            got = dict(heads.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, np.asarray(jheads[t][p]), rtol=RTOL, atol=ATOL, err_msg=name)
            np.testing.assert_allclose(opt.m[name].numpy(), np.asarray(jopt["m"][t][p]),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
            np.testing.assert_allclose(opt.v[name].numpy(), np.asarray(jopt["v"][t][p]),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_features_bitwise_equal_to_host_densify(stores):
    """The densified batch is bitwise the reference's ``to_dense()``.  Its
    ``log1p`` is held to 1 ULP of numpy's: no two float32 log1p agree
    bitwise (with numpy 2.0 and PyTorch 2.13 on an x86 CPU, on the counts
    0..4999 numpy's differs from the correctly rounded value at 151,
    PyTorch's vectorized one at 7, and XLA's, which the reference loop
    uses, differs from numpy's at 146)."""
    port_ds = ScIterableDataset(stores[1], BlockShuffling(16), **LOADER)
    ref_ds = ScDataset(stores[0], RefBlockShuffling(16), **LOADER)
    for _, a, b in zip(range(8), ref_ds, port_ds):
        t = b.to_tensors()
        dense = ref.ell_to_dense_ref(t["vals"], t["cols"], N_GENES)
        assert np.array_equal(dense.numpy(), a.to_dense())
        x = probe.features(t["vals"], t["cols"], n_genes=N_GENES)
        assert x.dtype == torch.float32
        assert torch.equal(x, torch.log1p(dense))
        np.testing.assert_array_max_ulp(x.numpy(), np.log1p(a.to_dense()), maxulp=1)


def test_macro_f1_matches_reference():
    rng = np.random.default_rng(4)
    for n_classes in (4, 27):
        pred, gold = rng.integers(0, n_classes, 300), rng.integers(0, n_classes, 300)
        assert probe.macro_f1(pred, gold, n_classes) == fig5._macro_f1(pred, gold, n_classes)


def test_converters_check_the_tree():
    heads_np, opt_np = _start(3)
    heads = convert.heads_from_jax(heads_np, device="cpu")
    assert heads.n_genes == N_GENES
    assert [n for n, _ in heads.named_parameters()] == list(convert.adam_from_jax(opt_np, device="cpu").m)
    bad = {t: dict(h) for t, h in heads_np.items()}
    bad["drug"] = {"w": heads_np["drug"]["w"][:, :5], "b": heads_np["drug"]["b"][:5]}
    with pytest.raises(ValueError):
        convert.heads_from_jax(bad, device="cpu")
    with pytest.raises(ValueError):
        convert.heads_from_jax({t: heads_np[t] for t in ("drug",)}, device="cpu")


def test_seeded_heads_are_reproducible():
    a = probe.init_heads(32, device="cpu", generator=torch.Generator().manual_seed(0))
    b = probe.init_heads(32, device="cpu", generator=torch.Generator().manual_seed(0))
    z = probe.init_heads(32, device="cpu")
    for (n, p), (_, q), (_, r) in zip(a.named_parameters(), b.named_parameters(), z.named_parameters()):
        assert torch.equal(p, q), n
        assert not r.any(), n
