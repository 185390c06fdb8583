"""Counterpart of ``tests/test_weighted_ddp.py`` (paper Appendix B):
weighted and class-balanced sampling compose with the per-rank
round-robin, the stream that the rule-sharded train step's ranks each
consume.  Both cases with the reference's assertions, run on the port's
``ScIterableDataset``, and each rank's stream bitwise the reference
``ScDataset``'s at the same rank, world size and seed."""
import numpy as np

from repro.core import BlockWeightedSampling as RefWeighted
from repro.core import ClassBalancedSampling as RefBalanced
from repro.core import ScDataset
from repro_torch.core import BlockWeightedSampling, ClassBalancedSampling, ScIterableDataset


def _stream(ds) -> list:
    return [np.asarray(b) for b in ds]


def _equal_streams(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        for a, b in zip(got, want))


def test_weighted_sampling_composes_with_ranks():
    n = 8192
    X = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    w = np.where(np.arange(n) < n // 2, 4.0, 1.0)
    strat = BlockWeightedSampling(block_size=8, weights=w)

    world = 4
    all_rows = []
    for r in range(world):
        ds = ScIterableDataset(X, strat, batch_size=64, fetch_factor=2,
                               seed=7, rank=r, world_size=world)
        batches = _stream(ds)
        ref = ScDataset(X, RefWeighted(block_size=8, weights=w), batch_size=64, fetch_factor=2,
                        seed=7, rank=r, world_size=world)
        assert _equal_streams(batches, _stream(ref)), r
        rows = np.concatenate([(b[:, 0] / 2).astype(int) for b in batches])
        all_rows.append(rows)
        # every rank individually sees the weighting
        frac = np.mean(rows < n // 2)
        assert 0.70 <= frac <= 0.90, (r, frac)

    # ranks partition the SAME weighted global sequence (no coordination)
    ds_ref = ScIterableDataset(X, strat, batch_size=64, fetch_factor=2, seed=7)
    union = np.concatenate(all_rows)
    fetches = ds_ref._global_fetch_count()
    order = strat.epoch_indices(n, 7, 0)[: fetches * 128]
    assert sorted(union.tolist()) == sorted(order.tolist())


def test_class_balanced_with_ranks_rebalances_each_rank():
    n = 9000
    labels = np.repeat([0, 1, 2], [8000, 900, 100])
    X = np.stack([np.arange(n), labels], axis=1).astype(np.float32)
    strat = ClassBalancedSampling(block_size=1, labels=labels)
    for r in range(2):
        ds = ScIterableDataset(X, strat, batch_size=64, fetch_factor=2,
                               seed=3, rank=r, world_size=2)
        batches = _stream(ds)
        ref = ScDataset(X, RefBalanced(block_size=1, labels=labels), batch_size=64,
                        fetch_factor=2, seed=3, rank=r, world_size=2)
        assert _equal_streams(batches, _stream(ref)), r
        ys = np.concatenate([b[:, 1].astype(int) for b in batches])
        frac = np.bincount(ys, minlength=3) / len(ys)
        assert frac.min() > 0.2, (r, frac)  # each rank near-balanced
