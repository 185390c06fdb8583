"""Token-corpus backend — the paper's technique applied to LM pretraining data.

The port's copy of ``repro.data.tokens``: the same store and generator
(corpus files byte-identical for the same arguments); reads are counted in
the port's :class:`~repro_torch.data.iostats.IOCounters`.

A pretraining corpus is a flat on-disk token stream; a training example is a
contiguous window of ``seq_len + 1`` tokens.  The *identical* trade-off the
paper solves for cells applies: shuffled window sampling is one random read
per sequence, sequential streaming biases batches toward one document/source
(web crawl shards, books, code dumps are stored contiguously — the "plates"
of an LM corpus).

:class:`TokenStore` exposes the corpus as an indexable collection of
sequences so it drops straight into
:class:`~repro_torch.core.dataset.ScIterableDataset`: block
sampling shuffles *blocks of adjacent sequences*, batched fetching coalesces
the reads, and the entropy bounds of §3.4 apply verbatim to source labels.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from .iostats import IOCounters

__all__ = ["TokenStore", "generate_token_corpus"]


class TokenStore:
    """Memory-mapped token file viewed as (num_sequences, seq_len + 1).

    ``store[rows]`` returns a dict with ``tokens`` (inputs) and ``labels``
    (inputs shifted by one) plus the per-sequence ``source`` label used for
    diversity measurement — a MultiIndexable-compatible mapping is not needed
    because ScDataset's default callbacks handle any indexable; we return a
    CSR-free dense batch directly.
    """

    def __init__(self, root: str, seq_len: int, iostats: Optional[IOCounters] = None):
        with open(os.path.join(root, "meta.json")) as f:
            self.meta = json.load(f)
        self.seq_len = int(seq_len)
        self._tokens = np.load(os.path.join(root, "tokens.npy"), mmap_mode="r")
        self._sources = np.load(os.path.join(root, "sources.npy"), mmap_mode="r")
        self.n_tokens = int(self._tokens.shape[0])
        self.vocab_size = int(self.meta["vocab_size"])
        self.n_seqs = (self.n_tokens - 1) // self.seq_len
        self.iostats = iostats if iostats is not None else IOCounters()

    def __len__(self) -> int:
        return self.n_seqs

    @property
    def avg_row_bytes(self) -> float:
        return float((self.seq_len + 1) * self._tokens.dtype.itemsize)

    def read_range(self, start: int, stop: int) -> dict:
        """Raw contiguous read of sequences ``[start, stop)``; not counted.

        One memmap slice covers the whole extent (adjacent sequences overlap
        by one label token), then windows are materialized from it — this is
        the sequential-read advantage the planner's run merging buys.
        """
        L = self.seq_len
        a, b = int(start), int(stop)
        flat = np.asarray(self._tokens[a * L : b * L + 1])
        offs = np.arange(b - a, dtype=np.int64)[:, None] * L + np.arange(L + 1)[None, :]
        chunk = flat[offs]
        src = np.asarray(self._sources[np.arange(a, b, dtype=np.int64) * L])
        return {
            "tokens": chunk[:, :-1].astype(np.int32),
            "labels": chunk[:, 1:].astype(np.int32),
            "source": src.astype(np.int32),
        }

    def __getitem__(self, rows) -> dict:
        t0 = time.perf_counter()
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim == 0:
            rows = rows[None]
        L = self.seq_len
        # coalesce: adjacent sequence ids share pages; count distinct runs
        srows = np.sort(rows)
        runs = 1 + int(np.count_nonzero(np.diff(srows) != 1)) if len(srows) else 0
        # gather windows (one fancy-index into the memmap; OS coalesces runs)
        offs = rows[:, None] * L + np.arange(L + 1)[None, :]
        chunk = np.asarray(self._tokens[offs.reshape(-1)]).reshape(len(rows), L + 1)
        src = np.asarray(self._sources[rows * L])
        self.iostats.record(
            runs=runs,
            rows=len(rows),
            bytes_read=int(chunk.nbytes),
            wall_s=time.perf_counter() - t0,
        )
        return {
            "tokens": chunk[:, :-1].astype(np.int32),
            "labels": chunk[:, 1:].astype(np.int32),
            "source": src.astype(np.int32),
        }


def generate_token_corpus(
    root: str,
    *,
    n_tokens: int = 4_000_000,
    vocab_size: int = 32000,
    n_sources: int = 14,
    seed: int = 0,
    force: bool = False,
) -> str:
    """Synthetic corpus with contiguous source segments ("plates" of text).

    Each source has a distinct unigram distribution (Zipf re-ranked by a
    source-specific permutation) so batch-source-entropy measures diversity
    exactly like plate entropy does for cells.
    """
    os.makedirs(root, exist_ok=True)
    meta_path = os.path.join(root, "meta.json")
    params = dict(n_tokens=n_tokens, vocab_size=vocab_size, n_sources=n_sources, seed=seed)
    if not force and os.path.exists(meta_path):
        with open(meta_path) as f:
            if json.load(f).get("params") == params:
                return root
    rng = np.random.default_rng(seed)
    # source segment sizes ~ non-uniform (same shape as Tahoe plates)
    fracs = rng.dirichlet(np.full(n_sources, 8.0))
    sizes = np.floor(fracs * n_tokens).astype(np.int64)
    sizes[-1] += n_tokens - sizes.sum()
    base_ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    zipf = 1.0 / base_ranks
    tokens = np.empty(n_tokens, dtype=np.int32)
    sources = np.empty(n_tokens, dtype=np.int16)
    pos = 0
    for s in range(n_sources):
        perm = rng.permutation(vocab_size)
        p = zipf[np.argsort(perm)]  # source-specific rank assignment
        p = p / p.sum()
        n_s = int(sizes[s])
        tokens[pos : pos + n_s] = rng.choice(vocab_size, size=n_s, p=p)
        sources[pos : pos + n_s] = s
        pos += n_s
    np.save(os.path.join(root, "tokens.npy"), tokens)
    np.save(os.path.join(root, "sources.npy"), sources)
    with open(meta_path, "w") as f:
        json.dump({"params": params, "vocab_size": vocab_size, "n_sources": n_sources}, f)
    return root
