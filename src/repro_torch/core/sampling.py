"""Sampling strategies — the index-generation half of scDataset (paper §3.1, §3.3).

The port's copy of ``repro.core.sampling``.  A strategy maps (dataset size,
epoch seed) to the global index sequence of one epoch; everything downstream
(batched fetching, rank and worker round-robin, in-memory reshuffle)
consumes that sequence.  The orders stay numpy: they must be bitwise equal
to the JAX package's, so that a checkpoint or a stream from either package
continues in the other, and numpy's ``SeedSequence`` is what defines them.
No tensor is involved until a batch is collated for the device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "SamplingStrategy",
    "Streaming",
    "BlockShuffling",
    "BlockWeightedSampling",
    "ClassBalancedSampling",
    "class_balanced_weights",
    "epoch_rng",
]


def epoch_rng(seed: int, epoch: int, *extra: int) -> np.random.Generator:
    """A reproducible RNG namespaced by (seed, epoch, *extra).

    Independent streams for different tuples, identical streams for
    identical tuples on every rank, worker and restart.
    """
    return np.random.default_rng(np.random.SeedSequence((seed, epoch, *extra)))


def _block_starts(n: int, block_size: int) -> np.ndarray:
    """Start offsets of the contiguous blocks partitioning ``range(n)``."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    return np.arange(0, n, block_size, dtype=np.int64)


def _blocks_to_indices(starts: np.ndarray, block_size: int, n: int) -> np.ndarray:
    """Expand block start offsets to the concatenated per-sample indices
    (Algorithm 1 line 4).  The final block may be ragged."""
    lengths = np.minimum(starts + block_size, n) - starts
    if (lengths == block_size).all():
        offs = np.arange(block_size, dtype=np.int64)
        return (starts[:, None] + offs[None, :]).reshape(-1)
    out = np.empty(int(lengths.sum()), dtype=np.int64)
    pos = 0
    # at most one ragged block per epoch order: a loop is fine
    for s, ln in zip(starts.tolist(), lengths.tolist()):
        out[pos : pos + ln] = np.arange(s, s + ln, dtype=np.int64)
        pos += ln
    return out


class SamplingStrategy:
    """Base class.  Subclasses implement :meth:`epoch_indices`."""

    def epoch_indices(self, n: int, seed: int, epoch: int) -> np.ndarray:
        raise NotImplementedError

    def epoch_len(self, n: int) -> int:
        """Samples per epoch (the nominal length fetch ids derive from)."""
        return n


@dataclasses.dataclass(frozen=True)
class Streaming(SamplingStrategy):
    """Sequential order, optionally decorrelated by a shuffle buffer.

    ``shuffle_buffer <= 1`` is pure sequential streaming.  A larger buffer
    emulates a sliding shuffle buffer on indices: each step emits a uniform
    pick from the buffer and refills the slot from the stream.
    """

    shuffle_buffer: int = 0

    def epoch_indices(self, n: int, seed: int, epoch: int) -> np.ndarray:
        idx = np.arange(n, dtype=np.int64)
        S = int(self.shuffle_buffer)
        if S <= 1:
            return idx
        rng = epoch_rng(seed, epoch, 0xB0FF)
        out = np.empty(n, dtype=np.int64)
        buf = idx[: min(S, n)].copy()
        fill = len(buf)
        nxt = fill
        pos = 0
        # fill phase: `fill` is constant, so picks are pre-drawn in chunks
        while nxt < n:
            chunk = min(n - nxt, 65536)
            picks = rng.integers(0, fill, size=chunk)
            for p in picks:
                out[pos] = buf[p]
                pos += 1
                buf[p] = idx[nxt]
                nxt += 1
        # drain phase: random picks without replacement = a shuffle
        rng.shuffle(buf[:fill])
        out[pos : pos + fill] = buf[:fill]
        return out


@dataclasses.dataclass(frozen=True)
class BlockShuffling(SamplingStrategy):
    """Algorithm 1, lines 1–4: shuffle contiguous blocks, keep within-block order.

    ``block_size=1`` is true random sampling.
    """

    block_size: int = 16

    def epoch_indices(self, n: int, seed: int, epoch: int) -> np.ndarray:
        starts = _block_starts(n, self.block_size)
        rng = epoch_rng(seed, epoch, 0xB10C)
        rng.shuffle(starts)
        return _blocks_to_indices(starts, self.block_size, n)


@dataclasses.dataclass(frozen=True)
class BlockWeightedSampling(SamplingStrategy):
    """Weighted sampling with block-level I/O efficiency.

    Per-sample weights are summed per block, and ``ceil(n / block_size)``
    blocks are drawn with replacement in proportion to their sums, so a
    ragged tail block carries exactly its members' mass and
    ``block_size=1`` is a weighted random sampler.
    """

    block_size: int
    weights: np.ndarray = dataclasses.field(repr=False, default=None)

    def __post_init__(self):
        if self.weights is None:
            raise ValueError("BlockWeightedSampling requires per-sample weights")
        w = np.asarray(self.weights, dtype=np.float64)
        if (w < 0).any() or not np.isfinite(w).all() or w.sum() <= 0:
            raise ValueError("weights must be finite, non-negative, not all zero")
        object.__setattr__(self, "weights", w)

    def _block_weights(self, n: int) -> np.ndarray:
        """Normalized per-block draw probabilities: the SUM of member weights
        (zero padding of the ragged tail adds no mass)."""
        if len(self.weights) != n:
            raise ValueError(f"weights length {len(self.weights)} != dataset size {n}")
        b = self.block_size
        k = (n + b - 1) // b
        w = np.pad(self.weights, (0, k * b - n))
        bw = w.reshape(k, b).sum(axis=1)
        return bw / bw.sum()

    def epoch_indices(self, n: int, seed: int, epoch: int) -> np.ndarray:
        starts = _block_starts(n, self.block_size)
        p = self._block_weights(n)
        rng = epoch_rng(seed, epoch, 0x3E16)
        drawn = rng.choice(len(starts), size=len(starts), replace=True, p=p)
        return _blocks_to_indices(starts[drawn], self.block_size, n)


def class_balanced_weights(labels: Sequence) -> np.ndarray:
    """Inverse-frequency weights: every class contributes equal expected mass."""
    _, inv, counts = np.unique(np.asarray(labels), return_inverse=True, return_counts=True)
    return (1.0 / counts)[inv]


@dataclasses.dataclass(frozen=True)
class ClassBalancedSampling(SamplingStrategy):
    """Automatic class balancing = BlockWeightedSampling with 1/freq weights."""

    block_size: int
    labels: np.ndarray = dataclasses.field(repr=False, default=None)

    def __post_init__(self):
        if self.labels is None:
            raise ValueError("ClassBalancedSampling requires per-sample labels")

    def epoch_indices(self, n: int, seed: int, epoch: int) -> np.ndarray:
        if len(self.labels) != n:
            raise ValueError(f"labels length {len(self.labels)} != dataset size {n}")
        inner = BlockWeightedSampling(
            block_size=self.block_size, weights=class_balanced_weights(self.labels)
        )
        return inner.epoch_indices(n, seed, epoch)
