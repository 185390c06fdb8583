"""The planned storage layer: one collection protocol over every format.

The port of ``repro.data.backend``:

- :class:`StorageReader` — the contract a storage format implements
  (contiguous ``read_range``, ``take``/``concat`` on its batch type, shard
  ``boundaries``, byte estimates, obs/schema access); the counterpart of
  ``StorageAdapter``.  :class:`CSRReader`, :class:`CompositeCSRReader`,
  :class:`ShardedCSRReader`, :class:`ChunkedReader` and
  :class:`TokenReader` are the counterparts of ``CSRAdapter``,
  ``CSRCompositeAdapter``, ``ShardedCSRAdapter``, ``ChunkedAdapter`` and
  ``TokenAdapter``.
- a registry of URI schemes — ``csr``, ``sharded-csr``, ``chunked`` and
  ``tokens`` here, ``h5ad`` and ``sharded-h5ad`` in
  :mod:`repro_torch.data.h5ad`, and the wrapping ``cloud`` and ``fault``
  in :mod:`repro_torch.data.cloud` and :mod:`repro_torch.data.faults` —
  behind :func:`open_collection`.
- :class:`PlannedRows` — the counterpart of ``PlannedCollection``: fetches
  go through the shared read planner and the byte-budgeted block cache of
  :mod:`repro_torch.data.readplan`, with miss extents read on a thread pool
  (``io_workers``), upcoming fetches staged in the background
  (``readahead``, fixed or ``"auto"``) and cache admission by policy; one
  :class:`~repro_torch.data.iostats.IOCounters` counts runs, bytes and
  cache outcomes once, uniformly, for every format; its reads run under
  the resilience knobs: retries, hedged reads and per-shard breakers.

Batches, read plans and counters of the synchronous path equal the
reference's bit for bit, under injected faults too; the asynchronous paths
deliver the synchronous path's batches.  :meth:`PlannedRows.tagged`
attributes a thread's reads to a tag (a rank of the elastic fabric): blocks
read under a tag are owned by it, and a tagged fetch that obtains a block
another tag read counts one ``shared_rank_hits``.

Locks: one rendezvous lock (``_fl``) guards the in-flight table, the
prefetch marks, the block cache, the stream detector, the sketch and the
readahead controller, none of which locks itself; ``_exec_lock`` guards the
executor.  :class:`IOCounters`' lock, and the lock of the shard circuit
(:class:`~repro_torch.data.faults.ShardCircuit`), are taken only with
neither held, and never one inside the other.
A planned collection holds locks and, once asynchronous, a thread pool, so
it does not pickle.  Threads share it (``FetchPool``); ``DataLoader``
workers forked from a process that holds it share it only while no
executor thread exists and no lock is held: ``io_workers=1`` and
``readahead=0``, no fetch in flight at the fork.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import urllib.parse
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Iterator, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from .chunked_store import ChunkedDenseStore
from .csr_store import CSRBatch, CSRStore, ShardedCSRStore, _concat_batches
from .iostats import IOCounters
from .readplan import (
    BlockFrequencySketch,
    ForwardStreamDetector,
    ReadaheadDepth,
    RowBlockCache,
    SegmentedRowBlockCache,
    blocks_to_row_spans,
    normalize_readahead,
    split_at_boundaries,
    split_max_extent,
)
from .tokens import TokenStore

__all__ = [
    "CollectionProtocol",
    "StorageReader",
    "CSRReader",
    "CompositeCSRReader",
    "ShardedCSRReader",
    "ChunkedReader",
    "TokenReader",
    "PlannedRows",
    "register_backend",
    "registered_schemes",
    "open_adapter",
    "open_collection",
    "piece_nbytes",
]

DEFAULT_CACHE_BYTES = 64 << 20
DEFAULT_BLOCK_ROWS = 256
DEFAULT_MAX_EXTENT_ROWS = 32768


@runtime_checkable
class CollectionProtocol(Protocol):
    """What :class:`~repro_torch.core.dataset.ScIterableDataset` requires of
    a planned collection (the counterpart of ``Collection``)."""

    def __len__(self) -> int: ...

    def fetch(self, rows) -> Any:
        """Batched read of ``rows`` (any order, duplicates allowed)."""
        ...

    def nbytes_of(self, rows) -> int:
        """Estimated on-disk bytes of ``rows``."""
        ...

    @property
    def schema(self) -> dict:
        """Shape/kind description of what ``fetch`` returns."""
        ...


def piece_nbytes(piece: Any) -> int:
    """In-memory bytes of a backend batch (CSRBatch / ndarray / dict)."""
    if hasattr(piece, "nbytes"):
        return int(piece.nbytes)
    if isinstance(piece, dict):
        return int(sum(int(v.nbytes) for v in piece.values()))
    raise TypeError(f"cannot size {type(piece).__name__}")


class StorageReader:
    """The contract a storage format implements to join the planned layer.

    Subclasses supply contiguous physical reads and batch algebra on their
    batch type; :class:`PlannedRows` never looks into batches beyond these
    methods.
    """

    def __len__(self) -> int:
        raise NotImplementedError

    def boundaries(self) -> Optional[np.ndarray]:
        """Ascending physical-extent offsets ``[0, ..., n]`` (shards/chunks);
        None means one uninterrupted extent."""
        return None

    def read_range(self, start: int, stop: int) -> Any:
        """ONE contiguous read of rows ``[start, stop)``, never across an
        interior boundary.  Records nothing."""
        raise NotImplementedError

    def take(self, piece: Any, rows: np.ndarray) -> Any:
        """Row-index a batch (relative indices; duplicates/order kept)."""
        raise NotImplementedError

    def concat(self, pieces: Sequence[Any]) -> Any:
        """Concatenate batches in order."""
        raise NotImplementedError

    def nbytes_of(self, rows: np.ndarray) -> int:
        """Estimated payload bytes of ``rows`` without reading them."""
        raise NotImplementedError

    @property
    def avg_row_bytes(self) -> float:
        raise NotImplementedError

    @property
    def schema(self) -> dict:
        raise NotImplementedError

    def obs_keys(self) -> list[str]:
        return []

    def obs_column(self, key: str) -> np.ndarray:
        raise KeyError(key)

    def bind_iostats(self, iostats: IOCounters) -> None:
        """Called once by :class:`PlannedRows` with the shared counters;
        adapters with dimensions the planner cannot see record through it."""

    def close(self) -> None:
        """Release OS resources (mmap-backed stores release on GC)."""


# --------------------------------------------------------------------- CSR
class CSRReader(StorageReader):
    """One CSR shard."""

    def __init__(self, store: CSRStore):
        self.store = store

    def __len__(self) -> int:
        return len(self.store)

    def read_range(self, start: int, stop: int) -> CSRBatch:
        return self.store.read_range(start, stop)

    def take(self, piece: CSRBatch, rows: np.ndarray) -> CSRBatch:
        return piece[rows]

    def concat(self, pieces: Sequence[CSRBatch]) -> CSRBatch:
        return _concat_batches(list(pieces), self.store.n_var)

    def nbytes_of(self, rows: np.ndarray) -> int:
        rows = np.asarray(rows, dtype=np.int64)
        nnz = (self.store._indptr[rows + 1] - self.store._indptr[rows]).sum()
        per = self.store._data.dtype.itemsize + self.store._indices.dtype.itemsize
        return int(nnz) * per

    @property
    def avg_row_bytes(self) -> float:
        return self.store.avg_row_bytes

    @property
    def schema(self) -> dict:
        return {"kind": "csr", "n_obs": self.store.n_obs, "n_var": self.store.n_var,
                "obs_keys": list(self.store.obs.keys())}

    def obs_keys(self) -> list[str]:
        return list(self.store.obs.keys())

    def obs_column(self, key: str) -> np.ndarray:
        return self.store.obs[key]


class CompositeCSRReader(StorageReader):
    """Many CSR-shaped stores behind one row space: shard edges are the
    planner's ``boundaries``, so :meth:`read_range` reads one store."""

    def __init__(self, stores: Sequence[Any], n_var: int):
        if not stores:
            raise ValueError("need at least one shard")
        self.stores = list(stores)
        self.n_var = int(n_var)
        sizes = np.array([len(s) for s in self.stores], dtype=np.int64)
        self.offsets = np.concatenate(([0], np.cumsum(sizes)))
        self.n_obs = int(self.offsets[-1])

    def __len__(self) -> int:
        return self.n_obs

    def boundaries(self) -> np.ndarray:
        return self.offsets

    def read_range(self, start: int, stop: int) -> CSRBatch:
        sid = int(np.searchsorted(self.offsets, start, side="right") - 1)
        off = int(self.offsets[sid])
        return self.stores[sid].read_range(start - off, stop - off)

    def take(self, piece: CSRBatch, rows: np.ndarray) -> CSRBatch:
        return piece[rows]

    def concat(self, pieces: Sequence[CSRBatch]) -> CSRBatch:
        return _concat_batches(list(pieces), self.n_var)

    def nbytes_of(self, rows: np.ndarray) -> int:
        rows = np.asarray(rows, dtype=np.int64)
        sids = np.searchsorted(self.offsets, rows, side="right") - 1
        total = 0
        for sid in np.unique(sids):
            shard = self.stores[int(sid)]
            local = rows[sids == sid] - int(self.offsets[sid])
            nnz = (shard._indptr[local + 1] - shard._indptr[local]).sum()
            per = shard._data.dtype.itemsize + shard._indices.dtype.itemsize
            total += int(nnz) * per
        return total

    @property
    def avg_row_bytes(self) -> float:
        return float(np.mean([s.avg_row_bytes for s in self.stores]))


class ShardedCSRReader(CompositeCSRReader):
    """Sharded CSR (the Tahoe plate files)."""

    def __init__(self, store: ShardedCSRStore):
        super().__init__(store.shards, store.n_var)
        self.store = store

    @property
    def schema(self) -> dict:
        return {"kind": "csr", "n_obs": self.store.n_obs, "n_var": self.store.n_var,
                "n_shards": len(self.store.shards), "obs_keys": self.store.obs_keys}

    def obs_keys(self) -> list[str]:
        return self.store.obs_keys

    def obs_column(self, key: str) -> np.ndarray:
        return self.store.obs_column(key)


# ----------------------------------------------------------------- chunked
class ChunkedReader(StorageReader):
    """Chunked dense store: boundaries at chunk edges, so the planner's run
    count equals the objects touched."""

    def __init__(self, store: ChunkedDenseStore):
        self.store = store

    def __len__(self) -> int:
        return len(self.store)

    def boundaries(self) -> np.ndarray:
        edges = np.arange(self.store.n_chunks + 1, dtype=np.int64) * self.store.chunk_rows
        edges[-1] = self.store.n
        return edges

    def read_range(self, start: int, stop: int) -> np.ndarray:
        return self.store.read_range(start, stop)

    def take(self, piece: np.ndarray, rows: np.ndarray) -> np.ndarray:
        return piece[rows]

    def concat(self, pieces: Sequence[np.ndarray]) -> np.ndarray:
        return np.concatenate(list(pieces))

    def nbytes_of(self, rows: np.ndarray) -> int:
        return int(len(np.asarray(rows)) * self.store.d * 4)

    @property
    def avg_row_bytes(self) -> float:
        return self.store.avg_row_bytes

    @property
    def schema(self) -> dict:
        return {"kind": "dense", "n_obs": self.store.n, "n_var": self.store.d,
                "chunk_rows": self.store.chunk_rows, "obs_keys": list(self.store.obs.keys())}

    def obs_keys(self) -> list[str]:
        return list(self.store.obs.keys())

    def obs_column(self, key: str) -> np.ndarray:
        return self.store.obs[key]


# ------------------------------------------------------------------ tokens
class TokenReader(StorageReader):
    """A flat token stream viewed as sequences."""

    def __init__(self, store: TokenStore):
        self.store = store

    def __len__(self) -> int:
        return len(self.store)

    def read_range(self, start: int, stop: int) -> dict:
        return self.store.read_range(start, stop)

    def take(self, piece: dict, rows: np.ndarray) -> dict:
        return {k: v[rows] for k, v in piece.items()}

    def concat(self, pieces: Sequence[dict]) -> dict:
        return {k: np.concatenate([p[k] for p in pieces]) for k in pieces[0]}

    def nbytes_of(self, rows: np.ndarray) -> int:
        return int(len(np.asarray(rows)) * self.store.avg_row_bytes)

    @property
    def avg_row_bytes(self) -> float:
        return self.store.avg_row_bytes

    @property
    def schema(self) -> dict:
        return {"kind": "tokens", "n_seqs": self.store.n_seqs, "seq_len": self.store.seq_len,
                "vocab_size": self.store.vocab_size}


# --------------------------------------------------------- planned wrapper
class PlannedRows:
    """A collection whose fetches run through the shared planner.

    ``fetch(rows)`` maps rows to ``block_rows``-row cache blocks, serves
    resident blocks from the byte-budgeted cache and reads the rest as
    maximal contiguous runs, split at physical boundaries and at
    ``max_extent_rows``.  One :class:`IOCounters` record per fetch counts
    the physical reads issued (``runs``), ``bytes_read``, ``rows`` and the
    block outcomes (``cache_hits``, ``cache_misses``, ``prefetched``,
    ``adm_bypassed``, ``adm_rejected``).

    Asynchronous execution, off by default:

    - ``io_workers > 1`` — a fetch's miss extents are read concurrently on
      a bounded thread pool; pieces are gathered in plan order, so batches
      are the synchronous path's, bit for bit.
    - ``readahead > 0`` — :meth:`prefetch` issues a future fetch's read
      plan in the background; in-flight blocks sit in a rendezvous table,
      and a fetch that needs one waits on its future instead of reading it
      again.  ``"auto"`` hands the depth to :class:`ReadaheadDepth`.  Staged
      blocks hand over through the cache, so readahead needs one.

    ``admission`` — ``"always"`` (LRU), ``"never"`` or ``"auto"`` (a
    :class:`ForwardStreamDetector` bypasses insertion of streaming fetches
    but their last block, and a :class:`BlockFrequencySketch` guards
    insertion by the TinyLFU duel once the working set exceeds the budget).
    ``cache_policy`` — ``"lru"`` or ``"wtinylfu"``
    (:class:`SegmentedRowBlockCache`).  ``cache_bytes=0`` disables the
    cache.

    Resilience, off by default:

    - ``retries > 0`` — each physical read runs under a
      :class:`~repro_torch.data.faults.RetryPolicy`: a transient failure
      (``OSError``, ``TimeoutError``) is read again after a decorrelated-
      jitter backoff, within the attempt budget and ``retry_deadline_s``;
      then :class:`~repro_torch.data.faults.RetryBudgetExhausted` ends it.
    - ``hedge_factor > 0`` (with ``io_workers > 1``) — a miss read still
      running ``max(hedge_min_s, hedge_factor * wait_EWMA)`` after the
      fetch issued it races a duplicate; the first success wins
      (``hedges_issued``, ``hedges_won``; the duplicate's work is not in
      ``runs``/``bytes_read``).
    - ``breaker_threshold > 0`` — that many consecutive failures of a shard
      open its :class:`~repro_torch.data.faults.ShardCircuit`: background
      prefetch skips it, and a demand read of it gets a budget of one retry
      until a half-open probe, after ``breaker_cooldown_s``, closes it.

    A read that fails deregisters its blocks before their futures are
    failed.  Under a retry policy a fetch waiting on such a block makes one
    recovery read of it (:meth:`_reissue_block`) and raises if that fails
    too; with no retry policy the producer's failure is the waiter's, as in
    the reference.
    """

    def __init__(
        self,
        adapter: StorageReader,
        *,
        iostats: Optional[IOCounters] = None,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        max_extent_rows: Optional[int] = DEFAULT_MAX_EXTENT_ROWS,
        io_workers: int = 1,
        readahead=0,
        admission: str = "always",
        cache_policy: str = "lru",
        retries: int = 0,
        retry_backoff_s: float = 0.005,
        retry_max_backoff_s: float = 0.25,
        retry_deadline_s: float = 0.0,
        hedge_factor: float = 0.0,
        hedge_min_s: float = 0.05,
        breaker_threshold: int = 0,
        breaker_cooldown_s: float = 1.0,
    ):
        from .faults import RetryPolicy, ShardCircuit  # faults imports this module

        if block_rows <= 0:
            raise ValueError("block_rows must be positive")
        if io_workers < 1:
            raise ValueError("io_workers must be >= 1")
        if retries < 0 or hedge_factor < 0 or breaker_threshold < 0:
            raise ValueError("resilience knobs must be non-negative")
        if hedge_min_s <= 0:
            raise ValueError("hedge_min_s must be positive")
        readahead = normalize_readahead(readahead)
        ra_auto = readahead == "auto"
        if admission not in ("always", "auto", "never"):
            raise ValueError(f"admission must be always|auto|never, got {admission!r}")
        if cache_policy not in ("lru", "wtinylfu"):
            raise ValueError(f"cache_policy must be lru|wtinylfu, got {cache_policy!r}")
        if (ra_auto or readahead > 0) and cache_bytes <= 0:
            # staged blocks hand over through the cache
            raise ValueError("readahead > 0 requires cache_bytes > 0")
        self.adapter = adapter
        self.iostats = iostats if iostats is not None else IOCounters()
        adapter.bind_iostats(self.iostats)
        # every call on the cache, the detector, the sketch and the
        # controller is made under _fl; none of them locks itself
        cache_cls = SegmentedRowBlockCache if cache_policy == "wtinylfu" else RowBlockCache
        self.cache = cache_cls(cache_bytes)  # guarded-by: external — used under _fl
        self.cache_policy = cache_policy
        self.block_rows = int(block_rows)
        self.max_extent_rows = max_extent_rows
        self.io_workers = int(io_workers)
        self._ra_fixed = 0 if ra_auto else int(readahead)
        self._ra_controller = (
            ReadaheadDepth(self.cache) if ra_auto else None
        )  # guarded-by: external — observe() under _fl; depth reads stale-ok
        self.admission = admission
        # the TinyLFU sketch of admission="auto", sized to the block universe
        self._sketch: Optional[BlockFrequencySketch] = None  # guarded-by: external — under _fl
        if admission == "auto" and cache_bytes > 0:
            n_blocks = max(1, (len(adapter) + block_rows - 1) // block_rows)
            width = 1 << min(16, max(10, int(np.ceil(np.log2(2 * n_blocks)))))
            self._sketch = BlockFrequencySketch(width=width)
        self._boundaries = adapter.boundaries()
        self._stream = ForwardStreamDetector()  # guarded-by: _fl
        self._avg_row_bytes = float(adapter.avg_row_bytes)
        self._executor: Optional[ThreadPoolExecutor] = None  # guarded-by: _exec_lock
        self._closed = False  # guarded-by: _exec_lock
        self._exec_lock = threading.Lock()
        # rendezvous table: block id -> Future of the block's value while a
        # read of it is in flight
        self._inflight: dict[int, Future] = {}  # guarded-by: _fl
        # blocks staged by prefetch and not yet consumed: their first
        # consumption counts as `prefetched`, not as a cache hit
        self._pf_marks: set[int] = set()  # guarded-by: _fl
        self._fl = threading.Lock()
        # cross-rank attribution: block id -> the tag whose read produced
        # the block's value.  A tag claims a block when it claims its read;
        # an untagged claim clears the owner.  The tag itself is per thread
        self._tag = threading.local()
        self._block_owner: dict[int, Any] = {}  # guarded-by: _fl
        self._retry = None  # guarded-by: external — a frozen RetryPolicy, set once
        if retries > 0:
            self._retry = RetryPolicy(retries=int(retries), backoff_s=float(retry_backoff_s),
                                      max_backoff_s=float(retry_max_backoff_s),
                                      deadline_s=float(retry_deadline_s))
        self._breaker = None  # guarded-by: external — set once; the circuit locks itself
        if breaker_threshold > 0:
            self._breaker = ShardCircuit(int(breaker_threshold), float(breaker_cooldown_s))
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_s = float(hedge_min_s)
        # smoothed seconds per physical read (the hedge deadline and the
        # controller's storage-tier signal); a single float store, a racing
        # update only blurs it
        self._wait_ewma = 0.0  # guarded-by: external — benign-race EWMA

    @property
    def readahead(self) -> int:
        """Current readahead depth (the controller's live one under
        ``"auto"``); the dataset reads it per fetch."""
        if self._ra_controller is not None:
            return self._ra_controller.depth
        return self._ra_fixed

    @property
    def readahead_auto(self) -> bool:
        return self._ra_controller is not None

    @property
    def async_enabled(self) -> bool:
        return self.io_workers > 1 or self.readahead > 0 or self.readahead_auto

    def epoch_boundary(self) -> None:
        """An epoch ended: the stream detector restarts cold and the
        controller opens a fresh pressure window; the cache and the sketch
        persist."""
        with self._fl:
            self._stream.reset()
            if self._ra_controller is not None:
                self._ra_controller.epoch_boundary()

    @contextlib.contextmanager
    def tagged(self, tag: Any) -> Iterator[None]:
        """Attribute this thread's fetches and prefetches to ``tag`` (a rank
        id in the elastic fabric) for the duration.  Blocks read under a tag
        are owned by it; a later tagged fetch that obtains a block owned by
        another tag, from the cache, a staged prefetch or a read in flight,
        counts one ``shared_rank_hits``: the read the shared cache saved it.
        Untagged traffic neither claims nor counts.  Nesting restores the
        outer tag."""
        prev = getattr(self._tag, "value", None)
        self._tag.value = tag
        try:
            yield
        finally:
            self._tag.value = prev

    def _own(self, block: int, tag: Any) -> None:
        """Record ``tag`` as the owner of a block whose read it claimed
        (caller holds ``_fl``); an untagged read leaves it unowned."""
        if tag is not None:
            self._block_owner[block] = tag  # unlocked-ok: the caller holds _fl
        else:
            self._block_owner.pop(block, None)  # unlocked-ok: the caller holds _fl

    def _pool(self) -> Optional[ThreadPoolExecutor]:
        if not self.async_enabled:
            return None
        ex = self._executor  # unlocked-ok: double-checked fast path
        if ex is not None:
            return ex
        with self._exec_lock:
            if self._closed:
                return None
            if self._executor is None:
                self._executor = ThreadPoolExecutor(max_workers=self.io_workers,
                                                    thread_name_prefix="planned-io")
            return self._executor

    def close(self) -> None:
        """Shut the I/O pool down and drop unconsumed staged blocks.  Later
        fetches read synchronously; the adapter stays open (:meth:`release`
        closes it)."""
        with self._exec_lock:
            self._closed = True
            ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=True)
        with self._fl:
            marks, self._pf_marks = self._pf_marks, set()
            for b in marks:
                self.cache.discard(b)

    def release(self) -> None:
        """:meth:`close`, then release the adapter's OS resources."""
        self.close()
        self.adapter.close()

    def __len__(self) -> int:
        return len(self.adapter)

    @property
    def schema(self) -> dict:
        return self.adapter.schema

    @property
    def avg_row_bytes(self) -> float:
        return self.adapter.avg_row_bytes

    def obs_keys(self) -> list[str]:
        return self.adapter.obs_keys()

    def obs_column(self, key: str) -> np.ndarray:
        return self.adapter.obs_column(key)

    def nbytes_of(self, rows) -> int:
        return self.adapter.nbytes_of(np.asarray(rows, dtype=np.int64))

    def _spans_for_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """Cache-block ids -> the physical read plan, ``(n, 2)`` spans."""
        spans = blocks_to_row_spans(blocks, self.block_rows, len(self.adapter))
        spans = split_at_boundaries(spans, self._boundaries)
        return split_max_extent(spans, self.max_extent_rows)

    def plan(self, rows) -> np.ndarray:
        """The physical reads a cold-cache fetch of ``rows`` would issue."""
        rows = np.asarray(rows, dtype=np.int64)
        return self._spans_for_blocks(np.unique(rows // self.block_rows))

    def __getitem__(self, rows) -> Any:
        return self.fetch(rows)

    # ---------------------------------------------------- read primitives
    def _shard_of(self, row: int) -> int:
        """The boundary interval holding ``row``: the unit of circuit
        breaking (one shard 0 without interior boundaries)."""
        edges = self._boundaries
        if edges is None or len(edges) <= 2:
            return 0
        return int(np.searchsorted(edges, row, side="right") - 1)

    def _read_one(self, lo: int, hi: int) -> tuple[Any, int]:
        """ONE logical read (retried under the policy) and its simulated
        latency, slept in the reading thread so that concurrent reads
        overlap it; backoff sleeps count into the wait EWMA, which widens
        the hedge deadline while storage misbehaves."""
        t0 = time.perf_counter()
        piece = self._resilient_read(lo, hi)
        nb = piece_nbytes(piece)
        self.iostats.sleep_for(runs=1, bytes_read=nb)
        dt = time.perf_counter() - t0
        prev = self._wait_ewma
        self._wait_ewma = dt if prev == 0.0 else 0.8 * prev + 0.2 * dt
        return piece, nb

    def _resilient_read(self, lo: int, hi: int) -> Any:
        """One contiguous read under the retry policy and the shard circuit;
        with neither configured, the bare ``read_range``.  A transition of
        the circuit is recorded here, after its lock was released."""
        retry, breaker = self._retry, self._breaker
        if retry is None and breaker is None:
            return self.adapter.read_range(lo, hi)
        from .faults import RetryBudgetExhausted, is_transient

        shard = self._shard_of(lo)
        budget = retry.retries if retry is not None else 0
        if breaker is not None and breaker.admit(shard) == "open":
            # an open shard is still read on demand, with one retry at most
            budget = min(budget, 1)
        deadline = (time.monotonic() + retry.deadline_s
                    if retry is not None and retry.deadline_s > 0 else None)
        attempt, prev_delay = 0, 0.0
        while True:
            try:
                piece = self.adapter.read_range(lo, hi)
            except BaseException as e:
                if breaker is not None and breaker.record_failure(shard):
                    self.iostats.record_resilience(breaker_opens=1)
                if retry is None or not is_transient(e):
                    raise
                if attempt >= budget:
                    raise RetryBudgetExhausted(
                        f"read [{lo}, {hi}) failed after {attempt + 1} attempts (budget {budget})"
                    ) from e
                delay = retry.backoff(lo, hi, attempt, prev_delay)
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0.0:
                        raise RetryBudgetExhausted(
                            f"read [{lo}, {hi}) deadline ({retry.deadline_s:.3f}s) exhausted "
                            f"after {attempt + 1} attempts"
                        ) from e
                    delay = min(delay, left)
                time.sleep(delay)
                self.iostats.record_resilience(retries=1, retry_wait_s=delay)
                prev_delay = delay
                attempt += 1
                continue
            if breaker is not None and breaker.record_success(shard):
                self.iostats.record_resilience(breaker_closes=1)
            return piece

    def _read_one_for(self, lo: int, hi: int, pend) -> tuple[Any, int]:
        """Pool-thread read on behalf of a (possibly deferred) consumer."""
        with self.iostats.borrowed_pending(pend):
            return self._read_one(lo, hi)

    def _gather_hedged(self, read_futs: list, spans, pool: ThreadPoolExecutor, pend) -> list:
        """A fetch's concurrent miss reads, in plan order, each raced by a
        duplicate once it overruns ``max(hedge_min_s, hedge_factor *
        wait_EWMA)`` from the fetch's issue; both read the same span, so
        the winner changes ``hedges_won`` only, never the bytes."""
        t_issue = time.perf_counter()
        out = []
        for fut, (lo, hi) in zip(read_futs, spans):
            tail = max(self.hedge_min_s, self.hedge_factor * self._wait_ewma)
            left = t_issue + tail - time.perf_counter()
            try:
                out.append(fut.result(timeout=max(0.0, left)))
                continue
            except FuturesTimeout:
                pass
            hedge = pool.submit(self._read_one_for, lo, hi, pend)
            self.iostats.record_resilience(hedges_issued=1)
            val, hedge_won = self._first_success(fut, hedge)
            if hedge_won:
                self.iostats.record_resilience(hedges_won=1)
            out.append(val)
        return out

    @staticmethod
    def _first_success(primary: Future, hedge: Future) -> tuple[Any, bool]:
        """Race a late primary against its hedge: the first success wins
        (the primary on a tie); both failing raise the last failure.
        Returns ``(result, hedge_won)``."""
        waiting = {primary, hedge}
        last_exc: Optional[BaseException] = None
        while waiting:
            done, waiting = futures_wait(waiting, return_when=FIRST_COMPLETED)
            if primary in done:
                exc = primary.exception()
                if exc is None:
                    return primary.result(), False
                last_exc = exc
            if hedge in done:
                exc = hedge.exception()
                if exc is None:
                    return hedge.result(), True
                last_exc = exc
        raise last_exc

    def _blocks_of(self, spans, pieces, blocks) -> dict:
        """Cut span pieces at block edges; each block's value, in span
        order whatever the order in which the reads completed."""
        B = self.block_rows
        pending: dict[int, list] = {b: [] for b in blocks}
        for (lo, hi), piece in zip(spans, pieces):
            for bb in range(lo // B, (hi - 1) // B + 1):
                if bb not in pending:
                    continue
                blo, bhi = max(lo, bb * B), min(hi, (bb + 1) * B)
                if blo == lo and bhi == hi:
                    pending[bb].append(piece)
                else:
                    pending[bb].append(self.adapter.take(piece, np.arange(blo - lo, bhi - lo)))
        return {b: p[0] if len(p) == 1 else self.adapter.concat(p) for b, p in pending.items()}

    def _cache_put(self, block: int, val: Any, *, last_block: int, streaming: bool) -> str:
        """Insertion under the admission policy (caller holds ``_fl``);
        returns ``"stored"``, ``"bypassed"`` or ``"rejected"``.  A streaming
        fetch keeps only its last block (the next fetch may straddle it)."""
        if self.admission == "never" or (streaming and block != last_block):
            self.cache.bypass()
            return "bypassed"
        nb = piece_nbytes(val)
        if self._sketch is not None and not streaming and nb <= self.cache.max_bytes:
            stored = self.cache.put_admit(block, val, nb, self._sketch.estimate)
            return "stored" if stored else "rejected"
        self.cache.put(block, val, nb)
        return "stored"

    def _resolve(self, vals: dict, futs: dict) -> None:
        """Resolve, then deregister, the futures of blocks just put in the
        cache (caller holds ``_fl``): a fetch that finds no in-flight entry
        finds the cache."""
        for b, f in futs.items():
            f.set_result(vals[b])
            if self._inflight.get(b) is f:  # unlocked-ok: the caller holds _fl
                del self._inflight[b]  # unlocked-ok: the caller holds _fl

    def _fail(self, futs: dict, exc: BaseException) -> None:
        """Deregister, then fail, the futures of a read that raised: a
        fetch arriving later reads the block itself instead of waiting on
        a failed future."""
        with self._fl:
            for b, f in futs.items():
                if self._inflight.get(b) is f:
                    del self._inflight[b]
        for f in futs.values():
            if not f.done():
                f.set_exception(exc)

    def _reissue_block(self, b: int) -> tuple[Any, int, int, str]:
        """One recovery read of a block whose in-flight read failed: take it
        from the cache, join a newer in-flight read, or claim and read it.
        Returns ``(value, runs, bytes_read, outcome)``; outcome ``"served"``
        means no read was issued here.  A second failure raises."""
        f: Future = Future()
        with self._fl:
            val = self.cache.peek(b)
            if val is not None:
                return val, 0, 0, "served"
            other = self._inflight.get(b)
            if other is None:
                self._inflight[b] = f
                self._own(b, getattr(self._tag, "value", None))
        if other is not None:
            return other.result(), 0, 0, "served"
        try:
            spans = self._spans_for_blocks(np.asarray([b]))
            results = [self._read_one(lo, hi) for lo, hi in spans]
            val = self._blocks_of(spans, [p for p, _ in results], [b])[b]
        except BaseException as e:
            self._fail({b: f}, e)
            raise
        with self._fl:
            outcome = self._cache_put(b, val, last_block=b, streaming=self._stream.streaming)
            self._resolve({b: val}, {b: f})
        return val, len(spans), sum(nb for _, nb in results), outcome

    def fetch(self, rows) -> Any:
        t0 = time.perf_counter()
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim == 0:
            rows = rows[None]
        if len(rows) == 0:
            raise ValueError("fetch of zero rows")
        B = self.block_rows
        n = len(self.adapter)
        lo_row, hi_row = int(rows.min()), int(rows.max())
        if lo_row < 0 or hi_row >= n:
            raise IndexError(f"rows out of range [0, {n}): min={lo_row}, max={hi_row}")
        blocks = np.unique(rows // B)
        last_block = int(blocks[-1])
        async_mode = self.async_enabled

        # ---- one critical section: admission state, cache lookup, and (in
        # async mode) the rendezvous: per missing block, wait on its
        # in-flight read or claim the read for this fetch
        local: dict[int, Any] = {}
        missing: list[int] = []
        waits: dict[int, Future] = {}
        claimed: dict[int, Future] = {}
        pf_blocks: list[int] = []
        streaming = False
        my_tag = getattr(self._tag, "value", None)
        with self._fl:
            if self.admission == "auto":
                streaming = self._stream.observe(blocks)
            if self._ra_controller is not None:
                self._ra_controller.observe(len(blocks) * B * self._avg_row_bytes, len(blocks),
                                            len(self._inflight), wait_s=self._wait_ewma)
            if self._sketch is not None:
                self._sketch.touch_many(blocks)
            for b in blocks.tolist():
                piece = self.cache.get(b)
                if piece is None:
                    missing.append(b)
                    continue
                local[b] = piece
                if b in self._pf_marks:  # staged by prefetch: not a hit
                    self._pf_marks.discard(b)
                    pf_blocks.append(b)
            if async_mode:
                for b in missing:
                    fut = self._inflight.get(b)
                    if fut is not None:
                        waits[b] = fut
                    else:
                        claimed[b] = self._inflight[b] = Future()
                        self._pf_marks.discard(b)  # stale staging: we re-read
                        # owned from the claim on: a waiter may take the
                        # block before this fetch reaches its accounting
                        self._own(b, my_tag)
                missing = list(claimed)
        served = list(local)  # from the cache, staged blocks included
        hits = len(local) - len(pf_blocks)

        # ---- plan + issue the physical reads
        spans = np.empty((0, 2), dtype=np.int64)
        read_futs = pool = pend = None
        if missing:
            spans = self._spans_for_blocks(np.asarray(missing))
            pool = self._pool()
            # a lone span reads inline, unless a hedge needs a future to race
            if pool is not None and self.io_workers > 1 and (
                    len(spans) > 1 or self.hedge_factor > 0.0):
                pend = self.iostats.current_pending()
                read_futs = [pool.submit(self._read_one_for, lo, hi, pend) for lo, hi in spans]

        # ---- assembly prep overlaps the reads in flight
        order = np.argsort(rows, kind="stable")
        srows = rows[order]
        sblocks = srows // B
        edges = np.flatnonzero(np.diff(sblocks) != 0) + 1
        groups = list(zip(np.concatenate(([0], edges)).tolist(),
                          np.concatenate((edges, [len(srows)])).tolist()))
        parts: list = [None] * len(groups)
        for gi, (a, z) in enumerate(groups):
            bb = int(sblocks[a])
            if bb in local:
                parts[gi] = self.adapter.take(local[bb], srows[a:z] - bb * B)

        # ---- gather this fetch's reads (plan order), publish its blocks
        bytes_read = 0
        adm = {"bypassed": 0, "rejected": 0, "stored": 0}
        if missing:
            try:
                if read_futs is not None and self.hedge_factor > 0.0:
                    results = self._gather_hedged(read_futs, spans, pool, pend)
                elif read_futs is not None:
                    results = [f.result() for f in read_futs]
                else:
                    results = [self._read_one(lo, hi) for lo, hi in spans]
                bytes_read = sum(nb for _, nb in results)
                vals = self._blocks_of(spans, [p for p, _ in results], missing)
            except BaseException as e:
                self._fail(claimed, e)
                raise
            with self._fl:
                for b, v in vals.items():
                    adm[self._cache_put(b, v, last_block=last_block, streaming=streaming)] += 1
                self._resolve(vals, claimed)
            local.update(vals)

        # ---- blocks read by other threads: wait on their futures
        reissue_runs = 0
        for b, fut in waits.items():
            try:
                local[b] = fut.result()  # raises the producer's failure
                pf_blocks.append(b)
            except BaseException:
                if self._retry is None:
                    raise  # no retry policy: the producer's failure is this fetch's
                val, runs2, nb2, outcome = self._reissue_block(b)
                local[b] = val
                if outcome == "served":
                    hits += 1
                else:
                    missing.append(b)
                    reissue_runs += runs2
                    bytes_read += nb2
                    adm[outcome] += 1
        if waits or pf_blocks:
            with self._fl:
                for b in waits:
                    self._pf_marks.discard(b)
                # consume-once staging under a bypassing policy: drop the
                # staged blocks now that this fetch has them (a stream keeps
                # its straddled last block, as _cache_put does)
                if self.admission == "never" or streaming:
                    for b in pf_blocks:
                        if self.admission == "never" or b != last_block:
                            self.cache.discard(b)

        # ---- fill the remaining parts, restore the caller's order
        for gi, (a, z) in enumerate(groups):
            if parts[gi] is None:
                bb = int(sblocks[a])
                parts[gi] = self.adapter.take(local[bb], srows[a:z] - bb * B)
        merged = parts[0] if len(parts) == 1 else self.adapter.concat(parts)
        inv = np.empty(len(rows), dtype=np.int64)
        inv[order] = np.arange(len(rows))
        if not np.array_equal(inv, np.arange(len(rows))):
            merged = self.adapter.take(merged, inv)

        # ---- cross-rank attribution: blocks this fetch obtained without
        # reading them (cache, staged, another thread's read) that another
        # tag read.  The synchronous path claims no read ahead, so its own
        # reads take their owner here
        shared = 0
        if my_tag is not None or self._block_owner:  # unlocked-ok: emptiness fast path; untagged traffic skips the lock, a stale non-empty read costs one locked no-op pass
            obtained = set(served) | set(pf_blocks)
            with self._fl:
                if not async_mode:
                    for b in missing:
                        self._own(b, my_tag)
                if my_tag is not None:
                    for b in obtained:
                        owner = self._block_owner.get(b)
                        if owner is not None and owner != my_tag:
                            shared += 1

        self.iostats.record(
            runs=len(spans) + reissue_runs,
            rows=len(rows),
            bytes_read=bytes_read,
            wall_s=time.perf_counter() - t0,
            cache_hits=hits,
            cache_misses=len(missing),
            prefetched=len(pf_blocks),
            adm_bypassed=adm["bypassed"],
            adm_rejected=adm["rejected"],
            shared_rank_hits=shared,
            slept=True,
        )
        return merged

    # ------------------------------------------------------- double buffer
    def prefetch(self, rows) -> int:
        """Issue a future fetch's read plan in the background; returns the
        blocks scheduled.  Blocks cached or in flight are skipped; the rest
        are claimed in the rendezvous table and read by the pool, one task
        per contiguous block group, split as a fetch would split them.
        No-op unless ``readahead > 0`` or ``io_workers > 1``."""
        pool = self._pool()
        if pool is None:
            return 0
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return 0
        block_list = np.unique(rows // self.block_rows).tolist()
        if self._breaker is not None:
            # background staging skips shards whose circuit is open (a block
            # follows the shard of its first row); demand fetches still read them
            block_list = [b for b in block_list
                          if not self._breaker.is_open(self._shard_of(b * self.block_rows))]
        futs: dict[int, Future] = {}
        my_tag = getattr(self._tag, "value", None)
        with self._fl:
            for b in block_list:
                if b in self._inflight or self.cache.peek(b) is not None:
                    continue
                futs[b] = self._inflight[b] = Future()
                self._own(b, my_tag)
        if not futs:
            return 0
        arr = np.asarray(list(futs))
        groups = np.split(arr, np.flatnonzero(np.diff(arr) != 1) + 1)
        for gi, grp in enumerate(groups):
            gfuts = {int(b): futs[int(b)] for b in grp.tolist()}
            try:
                pool.submit(self._prefetch_group, self._spans_for_blocks(grp), gfuts)
            except BaseException as e:
                # the pool shut down mid-issue (close() racing): fail every
                # future not handed to a task, or a fetch would wait forever
                self._fail({int(b): futs[int(b)] for g in groups[gi:] for b in g.tolist()}, e)
                return sum(len(g) for g in groups[:gi])
        return len(futs)

    def _prefetch_group(self, spans: np.ndarray, futs: dict[int, Future]) -> None:
        """Pool task: read one contiguous block group and stage its blocks
        through the cache, marked, so that the consuming fetch counts them
        as ``prefetched``.  Under admission="auto" outside a stream they
        fight the same TinyLFU duel as fetched blocks; a rejected block
        still hands over through its future."""
        try:
            results = [self._read_one(lo, hi) for lo, hi in spans]
            vals = self._blocks_of(spans, [p for p, _ in results], list(futs))
        except BaseException as e:
            self._fail(futs, e)
            return
        rejected = 0
        with self._fl:
            self._pf_marks.update(vals)
            duel = self._sketch is not None and not self._stream.streaming
            for b, v in vals.items():
                nb = piece_nbytes(v)
                if duel and nb <= self.cache.max_bytes:
                    rejected += not self.cache.put_admit(b, v, nb, self._sketch.estimate)
                else:
                    self.cache.put(b, v, nb)
            self._resolve(vals, futs)
        # background work: runs and bytes counted once, not a consumer call
        self.iostats.record(runs=len(spans), rows=0, bytes_read=sum(nb for _, nb in results),
                            wall_s=0.0, cache_misses=len(futs), adm_rejected=rejected,
                            calls=0, slept=True)

    def stats(self) -> dict:
        """The counters, the cache and, where they act, the readahead
        controller, the admission sketch, the diversity counters' mean and
        minimum, the resilience settings and the injected faults: the
        reference's sections, key for key."""
        io = self.iostats.snapshot()
        with self._fl:
            out = {"io": io, "cache": self.cache.snapshot()}
            if io["div_batches"] > 0:
                out["diversity"] = {"batches": io["div_batches"],
                                    "entropy_mean": io["div_entropy_sum"] / io["div_batches"],
                                    "entropy_min": io["div_entropy_min"]}
            if self._ra_controller is not None:
                out["readahead"] = self._ra_controller.snapshot()
            if self._sketch is not None:
                out["admission"] = {"doorkeeper": len(self._sketch.door),
                                    "ops": self._sketch.ops, "ages": self._sketch.ages}
        if self._retry is not None or self._breaker is not None or self.hedge_factor > 0.0:
            res: dict = {"wait_ewma_s": self._wait_ewma, "hedge_factor": self.hedge_factor,
                         "hedge_min_s": self.hedge_min_s}
            if self._retry is not None:
                res["retry"] = {"retries": self._retry.retries,
                                "backoff_s": self._retry.backoff_s,
                                "max_backoff_s": self._retry.max_backoff_s,
                                "deadline_s": self._retry.deadline_s}
            if self._breaker is not None:
                res["breaker"] = self._breaker.snapshot()
            out["resilience"] = res
        faults = getattr(self.adapter, "fault_snapshot", None)
        if faults is not None:
            out["faults"] = faults()
        return out


# ---------------------------------------------------------------- registry
_REGISTRY: dict[str, Callable[..., StorageReader]] = {}


def register_backend(scheme: str):
    """Register a reader opener under a URI scheme (``scheme://path``)."""

    def deco(fn: Callable[..., StorageReader]):
        _REGISTRY[scheme] = fn
        return fn

    return deco


def registered_schemes() -> list[str]:
    return sorted(_REGISTRY)


@register_backend("csr")
def _open_csr(path: str) -> CSRReader:
    return CSRReader(CSRStore(path))


@register_backend("sharded-csr")
def _open_sharded_csr(path: str) -> ShardedCSRReader:
    if "," in path:
        shard_paths = path.split(",")
    else:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        shard_paths = [os.path.join(path, s) for s in manifest["shards"]]
    return ShardedCSRReader(ShardedCSRStore(shard_paths))


@register_backend("chunked")
def _open_chunked(path: str) -> ChunkedReader:
    return ChunkedReader(ChunkedDenseStore(path))


@register_backend("tokens")
def _open_tokens(path: str, *, seq_len=None) -> TokenReader:
    if seq_len is None:
        raise ValueError("tokens:// requires seq_len (e.g. tokens:///corpus?seq_len=128)")
    return TokenReader(TokenStore(path, seq_len=int(seq_len)))


def _sniff_scheme(path: str) -> str:
    """The backend of a bare path, from its on-disk layout: ``.h5ad`` files
    and HDF5 signatures are ``h5ad``, a manifest of ``.h5ad`` shards is
    ``sharded-h5ad``."""
    if os.path.isfile(path):
        if path.endswith(".h5ad"):
            return "h5ad"
        with open(path, "rb") as f:
            if f.read(8) == b"\x89HDF\r\n\x1a\n":
                return "h5ad"
        raise ValueError(f"cannot detect a storage backend for file {path!r}")
    manifest_path = os.path.join(path, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            shards = json.load(f).get("shards", [])
        if shards and all(str(s).endswith(".h5ad") for s in shards):
            return "sharded-h5ad"
        return "sharded-csr"
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if "chunk_rows" in meta:
            return "chunked"
        if "n_obs" in meta:
            return "csr"
        if os.path.exists(os.path.join(path, "tokens.npy")):
            return "tokens"
    raise ValueError(f"cannot detect a storage backend at {path!r}")


_UNSET = object()  # distinguishes "not passed" from a meaningful None/0


def _parse_uri(uri: str, opts: dict) -> tuple[str, str, dict]:
    """``scheme://path[?k=v...]`` (or a bare, sniffed path) -> (scheme,
    path, merged opts); explicit ``opts`` win over the query string."""
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
    else:
        scheme, rest = _sniff_scheme(uri), uri
    if "?" in rest:
        rest, query = rest.split("?", 1)
        opts = {**dict(urllib.parse.parse_qsl(query)), **opts}
    if scheme not in _REGISTRY:
        raise ValueError(f"unknown backend scheme {scheme!r}; known: {registered_schemes()}")
    return scheme, rest, opts


def open_adapter(uri: str, **opts) -> StorageReader:
    """A URI's raw reader: no planner, no cache, no counters."""
    scheme, rest, opts = _parse_uri(uri, opts)
    return _REGISTRY[scheme](rest, **opts)


def open_collection(
    uri: str,
    *,
    iostats: Optional[IOCounters] = None,
    cache_bytes=_UNSET,
    block_rows=_UNSET,
    max_extent_rows=_UNSET,
    io_workers=_UNSET,
    readahead=_UNSET,
    admission=_UNSET,
    cache_policy=_UNSET,
    retries=_UNSET,
    retry_backoff_s=_UNSET,
    retry_max_backoff_s=_UNSET,
    retry_deadline_s=_UNSET,
    hedge_factor=_UNSET,
    hedge_min_s=_UNSET,
    breaker_threshold=_UNSET,
    breaker_cooldown_s=_UNSET,
    **opts,
) -> PlannedRows:
    """Open any registered format behind the planned layer.

    ``uri`` is ``scheme://path[?key=value...]`` or a bare directory, whose
    layout is sniffed.  The planner knobs (``cache_bytes``, ``block_rows``,
    ``max_extent_rows``, ``io_workers``, ``readahead``, ``admission``,
    ``cache_policy``) and the resilience knobs may ride in the query
    string; an explicit keyword wins over the query.  Other query keys go
    to the opener, which rejects what it does not know.  The resilience
    knobs are ``retries`` with ``retry_backoff_s``, ``retry_max_backoff_s``
    and ``retry_deadline_s``; ``hedge_factor`` with ``hedge_min_s``;
    ``breaker_threshold`` with ``breaker_cooldown_s`` (:class:`PlannedRows`).
    """
    scheme, rest, opts = _parse_uri(uri, opts)

    def knob(kwarg, key: str, default, allow_none: bool = False, cast=int):
        if kwarg is not _UNSET:
            opts.pop(key, None)
            return kwarg
        raw = opts.pop(key, _UNSET)
        if raw is _UNSET:
            return default
        if allow_none and isinstance(raw, str) and raw.lower() == "none":
            return None
        return cast(raw)

    planner = dict(
        cache_bytes=int(knob(cache_bytes, "cache_bytes", DEFAULT_CACHE_BYTES)),
        block_rows=int(knob(block_rows, "block_rows", DEFAULT_BLOCK_ROWS)),
        max_extent_rows=knob(max_extent_rows, "max_extent_rows", DEFAULT_MAX_EXTENT_ROWS,
                             allow_none=True),
        io_workers=int(knob(io_workers, "io_workers", 1)),
        readahead=knob(readahead, "readahead", 0, cast=normalize_readahead),
        admission=str(knob(admission, "admission", "always", cast=str)),
        cache_policy=str(knob(cache_policy, "cache_policy", "lru", cast=str)),
        retries=int(knob(retries, "retries", 0)),
        retry_backoff_s=float(knob(retry_backoff_s, "retry_backoff_s", 0.005, cast=float)),
        retry_max_backoff_s=float(knob(retry_max_backoff_s, "retry_max_backoff_s", 0.25,
                                       cast=float)),
        retry_deadline_s=float(knob(retry_deadline_s, "retry_deadline_s", 0.0, cast=float)),
        hedge_factor=float(knob(hedge_factor, "hedge_factor", 0.0, cast=float)),
        hedge_min_s=float(knob(hedge_min_s, "hedge_min_s", 0.05, cast=float)),
        breaker_threshold=int(knob(breaker_threshold, "breaker_threshold", 0)),
        breaker_cooldown_s=float(knob(breaker_cooldown_s, "breaker_cooldown_s", 1.0, cast=float)),
    )
    if planner["io_workers"] < 1:
        raise ValueError("io_workers must be >= 1")
    adapter = _REGISTRY[scheme](rest, **opts)
    return PlannedRows(adapter, iostats=iostats, **planner)
