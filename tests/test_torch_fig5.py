"""The paper's Fig. 5 experiment, port against the JAX package's benchmark
on the CPU: ``repro_torch.train.fig5`` against the functions of
``benchmarks/bench_fig5_classification.py`` itself (its strategies, zero
heads, jitted Adam step, features and macro-F1), for all four strategies
and both seeds.

The store is 17,500 cells x 64 genes: the smallest Tahoe-like store whose
training plates (16,683 cells) hold one fetch of the block strategies
(64 x 256 = 16,384 cells); below it those strategies train no step.  Each
epoch is 256-260 steps; each of the benchmark's epochs runs once for the
file (``jax_epoch``), and the whole file takes about 40 s on one test
worker.  Every input is made from fixed seeds, so every run computes the
same.
"""
import importlib.util
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ScDataset
from repro.data import synth as ref_synth
from repro_torch.data import synth
from repro_torch.kernels import ref
from repro_torch.train import fig5, probe
from test_torch_kernels import XLA_LOG1P_ULP

_BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "bench_fig5_classification.py")
_spec = importlib.util.spec_from_file_location("bench_fig5_classification", _BENCH)
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

GEN = dict(n_cells=17_500, n_genes=64, seed=0)
# Heads after an epoch: Adam moves a weight by at most about LR a step, and
# the two sides' float32 sums (XLA's and PyTorch's, in another order) make
# their steps differ by less than 2**-20 of that, about 2.5e-6 after 260
# steps (measured: at most 6e-7 over the eight epochs, a few float32 ulps of
# weights near 2).  The mutants below (one Adam step left out, the bias
# corrections one count ahead) miss by 1e-3 and more.
STEP_REL = 2**-20


def heads_tol(steps: int) -> float:
    return steps * probe.LR * STEP_REL


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the products are 64 x 64 x 380 at most, and the
    file shares the machine with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    base = tmp_path_factory.mktemp("fig5")
    ref_synth.generate_tahoe_like(str(base / "repro"), **GEN)
    synth.generate_tahoe_like(str(base / "port"), **GEN)
    return (ref_synth.load_tahoe_like(str(base / "repro")),
            synth.load_tahoe_like(str(base / "port")), str(base / "port"))


class _RefTrainView:
    """The benchmark's ``TrainView`` (defined inside its ``run``)."""

    def __init__(self, store, n):
        self.store, self.n = store, n

    def __len__(self):
        return self.n

    def __getitem__(self, rows):
        return self.store[rows]


@pytest.fixture(scope="module")
def held_out(stores):
    """Plate 13 as the benchmark builds it and as the port does."""
    ref_store, port_store, _ = stores
    plate = ref_store.shards[13]
    batch = plate[np.arange(len(plate))]
    x, y = fig5.held_out_set(port_store, "cpu")
    return np.log1p(batch.to_dense()), {t: np.asarray(batch.obs[t]) for t in bench.TASKS}, x, y


def test_strategies_are_the_benchmarks():
    ours, theirs = fig5.strategies(), bench._strategies()
    assert list(ours) == list(theirs)
    for name in ours:
        (a, fa), (b, fb) = ours[name], theirs[name]
        assert fa == fb and type(a).__name__ == type(b).__name__ and vars(a) == vars(b), name
    assert fig5.M == bench.M and fig5.SEEDS == bench.SEEDS and probe.LR == bench.LR
    assert dict(probe.TASKS) == dict(bench.TASKS)


def test_held_out_plate_matches_the_benchmarks(held_out):
    x_ref, y_ref, x, y = held_out
    assert x.dtype == torch.float32 and x.shape == x_ref.shape
    np.testing.assert_array_max_ulp(x.numpy(), x_ref, maxulp=1)  # torch's and numpy's log1p
    for t in bench.TASKS:
        assert np.array_equal(y[t], y_ref[t]), t


def test_train_view_pickles_with_its_store(stores):
    _, port_store, _ = stores
    ds = fig5.train_dataset(port_store, *fig5.strategies()["block_shuffling"], seed=0)
    back = pickle.loads(pickle.dumps(ds))
    assert len(back.collection) == len(ds.collection) == int(port_store.offsets[13])
    a, b = next(iter(ds)), next(iter(back))
    assert np.array_equal(a.data, b.data) and np.array_equal(a.indptr, b.indptr)


def _jax_epoch(ref_store, port_store, name, seed):
    """The benchmark's epoch over its own loader, checking each batch
    against the port's loader on the way; returns the heads and steps."""
    strat, f = bench._strategies()[name]
    n_train = sum(len(s) for s in ref_store.shards[:13])
    ref_ds = ScDataset(_RefTrainView(ref_store, n_train), strat, batch_size=bench.M,
                       fetch_factor=f, seed=seed)
    port_ds = fig5.train_dataset(port_store, *fig5.strategies()[name], seed=seed)
    heads = bench._init_heads(jax.random.PRNGKey(seed), ref_store.n_var)
    opt = {"m": jax.tree.map(jnp.zeros_like, heads), "v": jax.tree.map(jnp.zeros_like, heads),
           "count": jnp.zeros((), jnp.int32)}
    steps = 0
    for a, b in zip(ref_ds, port_ds, strict=True):
        # the same cells in the same order, with the same obs
        assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.data, b.data)
        assert a.obs.keys() == b.obs.keys()
        assert all(np.array_equal(a.obs[k], b.obs[k]) for k in a.obs)
        # no row repeats a column, so overwriting and adding densify alike
        cell = np.repeat(np.arange(len(b), dtype=np.int64), np.diff(b.indptr))
        assert len(np.unique(cell * b.n_var + b.indices)) == len(cell)
        t = b.to_tensors()
        assert np.array_equal(ref.ell_to_dense_ref(t["vals"], t["cols"], b.n_var).numpy(),
                              a.to_dense())
        x = bench._features(a)
        np.testing.assert_array_max_ulp(
            probe.features(t["vals"], t["cols"], n_genes=b.n_var).numpy(), np.asarray(x),
            maxulp=XLA_LOG1P_ULP)
        ys = {k: jnp.asarray(a.obs[k].astype(np.int32)) for k in bench.TASKS}
        heads, opt, _ = bench._train_step(heads, opt, x, ys)
        steps += 1
    return heads, steps


@pytest.fixture(scope="module")
def jax_epoch(stores):
    """``_jax_epoch`` by (strategy, seed), each computed once for the file."""
    ref_store, port_store, _ = stores
    done = {}

    def epoch(name, seed):
        if (name, seed) not in done:
            done[name, seed] = _jax_epoch(ref_store, port_store, name, seed)
        return done[name, seed]

    return epoch


def _heads_err(port_heads, jax_heads) -> float:
    params = dict(port_heads.named_parameters())
    return max(float(np.abs(params[f"heads.{t}.{p}"].detach().numpy()
                            - np.asarray(jax_heads[t][p])).max())
               for t in bench.TASKS for p in ("w", "b"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(fig5.strategies()))
def test_epoch_and_scores_match_the_benchmark(stores, jax_epoch, held_out, name, seed):
    _, port_store, _ = stores
    jax_heads, steps = jax_epoch(name, seed)
    heads, record = fig5.train_one(port_store, *fig5.strategies()[name], seed, "cpu")
    assert record["steps"] == steps >= 256
    assert record["ell_to_dense_launches"] == 0  # the CPU takes the plain version
    tol = heads_tol(steps)
    err = _heads_err(heads, jax_heads)
    assert err <= tol, (err, tol)

    x_ref, y_ref, x, y = held_out
    got = fig5.evaluate(heads, x, y)
    w = {t: np.asarray(jax_heads[t]["w"]) for t in bench.TASKS}
    dx = np.abs(x.numpy() - x_ref)
    with torch.no_grad():
        port_logits = heads(x)
    for t, c in bench.TASKS.items():
        logits = np.asarray(jnp.asarray(x_ref) @ jax_heads[t]["w"] + jax_heads[t]["b"])
        want_pred = logits.argmax(-1)
        pred = port_logits[t].argmax(-1).numpy()
        # a logit may move by the heads' tolerance times the row's L1 norm
        # (and 1), plus the features' ulps times the weights
        bound = (np.abs(x_ref).sum(1) + 1) * tol + (dx @ np.abs(w[t])).max(1)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= 2 * bound
        differ = pred != want_pred
        assert not (differ & ~tie).any(), (t, np.flatnonzero(differ & ~tie))
        # the port's score is the benchmark's macro-F1 of its predictions,
        # and so the benchmark's own score unless a tie flipped one
        assert got[t] == bench._macro_f1(pred, y_ref[t], c)
        if not differ.any():
            assert got[t] == bench._macro_f1(want_pred, y_ref[t], c)


def _mutant_err(stores, jax_epoch, steps_less: int, count_ahead: int) -> float:
    """The port's block-shuffling epoch at seed 0 with ``steps_less`` Adam
    steps left out at its end and Adam's count (which its bias corrections
    ``1 - beta ** count`` read) ``count_ahead`` ahead; the heads' distance
    from the benchmark's."""
    _, port_store, _ = stores
    strategy, f = fig5.strategies()["block_shuffling"]
    jax_heads, steps = jax_epoch("block_shuffling", 0)
    heads = probe.init_heads(port_store.n_var, device="cpu")
    opt = probe.init_adam(heads)
    opt.count = count_ahead
    run = probe.train_probe(fig5.train_dataset(port_store, strategy, f, 0), heads, opt,
                            device="cpu", max_steps=steps - steps_less)
    assert run["steps"] == steps - steps_less
    return _heads_err(heads, jax_heads) / heads_tol(steps)


def test_heads_tolerance_catches_a_skipped_adam_step(stores, jax_epoch):
    """The mutant: the same epoch with its last Adam step left out."""
    assert _mutant_err(stores, jax_epoch, steps_less=1, count_ahead=0) > 10


def test_heads_tolerance_catches_an_off_by_one_bias_correction(stores, jax_epoch):
    """The mutant: the same epoch with Adam's bias corrections one count
    ahead, ``1 - beta ** (count + 1)``."""
    assert _mutant_err(stores, jax_epoch, steps_less=0, count_ahead=1) > 10


def test_main_runs_on_the_cpu(tmp_path, capsys):
    """At 3,000 cells the block strategies' one fetch (16,384 cells) does
    not fit the training plates: their epochs take no step, and the heads
    stay zero."""
    cells, genes = 3_000, 64
    assert fig5.main(["--device", "cpu", "--cells", str(cells), "--genes", str(genes),
                      "--data-dir", str(tmp_path / "store")]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])["fig5"]
    assert (out["device"], out["cells"], out["genes"]) == ("cpu", cells, genes)
    store = synth.load_tahoe_like(str(tmp_path / "store"))
    assert [(e["strategy"], e["seed"], e["steps"]) for e in out["epochs"]] == [
        (s, seed, len(fig5.train_dataset(store, strategy, f, seed)))
        for s, (strategy, f) in fig5.strategies().items() for seed in fig5.SEEDS]
    assert [e["steps"] for e in out["epochs"]] == [44, 44, 44, 44, 0, 0, 0, 0]
    assert all(e["ell_to_dense_launches"] == 0 for e in out["epochs"])
    for by in out["macro_f1"].values():
        assert all(len(v) == 2 and all(0.0 <= x <= 1.0 for x in v) for v in by.values())
    assert lines[-2].startswith("fig5_ordering streaming=")
    assert sum(line.startswith("fig5_") for line in lines) == 4 * 4 + 1


def test_main_without_a_card_needs_device_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit) as e:
        fig5.main(["--cells", "100"])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
