"""The JAX package's end-to-end system tests (``test_system.py``) run
against the port on the CPU:

1. block sampling cuts random I/O runs by about b (counted by
   ``IOCounters``, and equal to the JAX package's ``IOStats`` runs);
2. batched fetching recovers minibatch diversity: the entropy of delivered
   batches lies inside ``entropy_bounds``;
3. the loader trains a model end to end: the probe's loss falls through
   ``probe.train_step`` (the JAX test trains its LM; the port's LM training
   has its own tests);
4. DDP ranks through the host-to-device feed of ``distributed/dataio.py``:
   disjoint cells, aligned obs.

The store is the JAX test's own, 20,000 cells x 256 genes from seed 0, and
every loader seed is fixed, so every run sees the same batches; the file
takes about 5 s on one CPU core.
"""
import numpy as np
import pytest
import torch

from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import ScDataset
from repro.data import synth as ref_synth
from repro_torch.core import BlockShuffling, ScIterableDataset, Streaming
from repro_torch.core.theory import entropy_bounds, mean_batch_entropy
from repro_torch.data import synth
from repro_torch.distributed.dataio import device_prefetch
from repro_torch.kernels import ref
from repro_torch.train import probe

GEN = dict(n_cells=20_000, n_genes=256, seed=0)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tahoe"))
    synth.generate_tahoe_like(root, **GEN)
    return synth.load_tahoe_like(root)


def _runs(store, strategy_cls, b: int) -> int:
    """Random runs read by the first 4 batches (fetch factor 8)."""
    ds = ScDataset if strategy_cls is RefBlockShuffling else ScIterableDataset
    before = store.iostats.runs
    it = iter(ds(store, strategy_cls(b), batch_size=64, fetch_factor=8))
    for _ in range(4):
        next(it)
    return store.iostats.runs - before


def test_block_sampling_reduces_io_runs(store, tmp_path):
    r1, r16, r64 = (_runs(store, BlockShuffling, b) for b in (1, 16, 64))
    assert r16 < r1 / 8  # ~16x fewer random extents
    assert r64 <= r16
    ref_synth.generate_tahoe_like(str(tmp_path), **GEN)
    ref_store = ref_synth.load_tahoe_like(str(tmp_path))
    assert [r1, r16, r64] == [_runs(ref_store, RefBlockShuffling, b) for b in (1, 16, 64)]


def _plate_entropy(store, strategy, f: int, n_batches: int) -> tuple[float, float]:
    ds = ScIterableDataset(store, strategy, batch_size=64, fetch_factor=f,
                           batch_transform=lambda bb: bb.obs["plate"])
    return mean_batch_entropy([pl for _, pl in zip(range(n_batches), ds)])


@pytest.mark.parametrize("b,f", [(16, 1), (16, 16), (64, 16)])
def test_entropy_within_bounds(store, b, f):
    sizes = np.array([len(s) for s in store.shards], np.float64)
    mean, std = _plate_entropy(store, BlockShuffling(b), f, 61)
    lo, hi = entropy_bounds(sizes / sizes.sum(), 64, b)
    assert lo - 3 * std - 0.1 <= mean <= hi + 3 * std + 0.1, (b, f, mean)


def test_streaming_entropy_is_low(store):
    mean, _ = _plate_entropy(store, Streaming(), 4, 30)
    assert mean < 0.5  # contiguous plates -> near-zero diversity


def test_end_to_end_training_loss_decreases(store):
    """Zero heads, Adam at the probe's LR, 60 steps of BlockShuffling(16)."""
    heads = probe.init_heads(store.n_var, device="cpu")
    opt = probe.init_adam(heads)
    ds = ScIterableDataset(store, BlockShuffling(16), batch_size=64, fetch_factor=8, seed=3)
    run = probe.train_probe(ds, heads, opt, device="cpu", max_steps=60)
    losses = run["losses"]
    assert run["steps"] == 60 and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.1, losses


class _Recording:
    """The store, recording the rows each fetch reads."""

    def __init__(self, store):
        self.store, self.rows = store, []

    def __len__(self):
        return len(self.store)

    def __getitem__(self, rows):
        self.rows.append(np.asarray(rows))
        return self.store[rows]


def test_ddp_ranks_compose_with_training(store):
    """Two ranks read disjoint cells; collated on the way to the device,
    obs stay aligned with the rows, and the densified batch is whole."""
    seen, plates = [], []
    for rank in range(2):
        view = _Recording(store)
        ds = ScIterableDataset(view, BlockShuffling(16), batch_size=64, fetch_factor=4,
                               seed=11, rank=rank, world_size=2)
        rows = []
        for b in device_prefetch(ds, "cpu"):
            x = ref.ell_to_dense_ref(b["vals"], b["cols"], store.n_var)
            assert x.shape == (64, store.n_var) and not torch.isnan(x).any()
            assert all(v.shape == (64,) for v in b["obs"].values())
            rows.append(b["obs"]["plate"].numpy())
        assert len(rows) == len(ds) > 0
        plates.append(np.concatenate(rows))
        seen.append(np.concatenate(view.rows))
    assert not np.intersect1d(seen[0], seen[1]).size
    assert all(len(np.unique(s)) == len(s) for s in seen)
    allp = np.concatenate(plates)
    assert allp.min() >= 0 and allp.max() < 14
    # each delivered plate is the plate of a row its rank read
    offsets = store.offsets
    for s, p in zip(seen, plates):
        assert set(np.unique(p)) <= set(np.searchsorted(offsets, s, side="right") - 1)
