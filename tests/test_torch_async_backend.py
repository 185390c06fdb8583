"""The port planner's asynchronous paths on the CPU, the counterpart of
``tests/test_async_backend.py``: with ``io_workers`` 4 and ``readahead`` 0,
2 or ``"auto"`` the batches are bitwise the synchronous path's; concurrent
fetches of one block make one physical read; a read that raises leaves no
in-flight entry, and what waited on it raises (with no retry policy, as in
the reference) or, under a retry policy, raises or recovers through one
recovery read.  Every test runs under the runtime lock-order witness
(``tests/conftest.py``).

Nothing here asserts a timing.  Where a test needs a fetch to be waiting on
another's read, a gate holds the read until the waiter has passed its
lookup (its cache misses are counted inside the same critical section), and
every wait has a timeout of its own."""
import threading
import time

import numpy as np
import pytest

from repro.data import open_collection as ref_open
from repro.data import write_chunked_store, write_csr_shard
from repro_torch.core import BlockShuffling, ScIterableDataset, Streaming
from repro_torch.data import IOCounters, open_adapter, open_collection
from repro_torch.data.backend import PlannedRows, StorageReader
from repro_torch.data.faults import RetryBudgetExhausted

TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _witness(lock_order_witness):
    yield


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(2048, 12)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("async") / "ck")
    write_chunked_store(path, X, {"y": np.arange(len(X)) % 7}, chunk_rows=300)
    return f"chunked://{path}", X


@pytest.fixture(scope="module")
def csr_shards(tmp_path_factory):
    rng = np.random.default_rng(8)
    root = tmp_path_factory.mktemp("async_csr")
    paths = []
    for s in range(3):
        n, g = 400, 24
        lens = rng.integers(0, 5, n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=indptr[1:])
        indices = np.concatenate([np.sort(rng.choice(g, int(k), replace=False)) for k in lens])
        p = str(root / f"s{s}")
        write_csr_shard(p, rng.normal(size=int(indptr[-1])).astype(np.float32),
                        indices.astype(np.int32), indptr, g, {"row": np.arange(n, dtype=np.int32)})
        paths.append(p)
    return "sharded-csr://" + ",".join(paths)


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        return
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for k in a.obs:
        assert np.array_equal(a.obs[k], b.obs[k]), k


def _epochs(col, strategy, epochs=2, cross_epoch=False):
    ds = ScIterableDataset(col, strategy, batch_size=16, fetch_factor=8, seed=1,
                           cross_epoch_prefetch=cross_epoch)
    return [b for _ in range(epochs) for b in ds]


@pytest.mark.parametrize("readahead", [0, 2, "auto"])
@pytest.mark.parametrize("which", ["chunked", "csr"])
def test_async_epochs_are_bitwise_the_sync_path(chunked, csr_shards, which, readahead):
    uri = chunked[0] if which == "chunked" else csr_shards
    kw = dict(block_rows=32, cache_bytes=2 << 20)
    strat = BlockShuffling(4) if which == "csr" else Streaming()
    want = _epochs(open_collection(uri, **kw), strat)
    col = open_collection(uri, io_workers=4, readahead=readahead, **kw)
    got = _epochs(col, strat, cross_epoch=readahead == 2)
    col.close()
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        _same(a, b)
    snap = col.iostats.snapshot()
    assert snap["calls"] == len(want) // 8  # one record per fetch of 8 batches
    if readahead == 2:
        assert snap["prefetched"] > 0  # the next fetches were staged
    if readahead == "auto":
        ctl = col.stats()["readahead"]
        assert 0 <= ctl["depth"] <= ctl["max_depth"]


def test_one_fetch_split_across_the_pool_equals_the_reference(csr_shards):
    """Many spans (shard boundaries, a small extent cap) read on 4 workers:
    the batch, the plan and the runs are the reference's synchronous ones."""
    rows = np.random.default_rng(2).integers(0, 1200, 300)
    kw = dict(block_rows=16, max_extent_rows=20)
    a, b = ref_open(csr_shards, **kw), open_collection(csr_shards, io_workers=4, **kw)
    assert np.array_equal(a.plan(rows), b.plan(rows)) and len(b.plan(rows)) > 4
    _same(a.fetch(rows), b.fetch(rows))
    for k in ("runs", "bytes_read", "cache_misses", "rows"):
        assert a.iostats.snapshot()[k] == b.iostats.snapshot()[k], k
    b.close()


class GatedReader(StorageReader):
    """Wraps a reader: counts physical reads, signals ``entered`` when one
    starts, holds it until ``gate`` is set, and fails the first ``fail``
    reads (``fail=-1``: every read) with ``OSError``."""

    def __init__(self, inner, fail=0):
        self.inner, self.fail = inner, fail
        self.reads = 0
        self.entered, self.gate = threading.Event(), threading.Event()
        self._count = threading.Lock()

    def __len__(self):
        return len(self.inner)

    def boundaries(self):
        return self.inner.boundaries()

    def read_range(self, start, stop):
        with self._count:
            self.reads += 1
            failing = self.fail != 0
            if self.fail > 0:
                self.fail -= 1
        self.entered.set()
        assert self.gate.wait(TIMEOUT), "the test never opened the gate"
        if failing:
            raise OSError(f"injected failure of [{start}, {stop})")
        return self.inner.read_range(start, stop)

    def take(self, piece, rows):
        return self.inner.take(piece, rows)

    def concat(self, pieces):
        return self.inner.concat(pieces)

    def nbytes_of(self, rows):
        return self.inner.nbytes_of(rows)

    @property
    def avg_row_bytes(self):
        return self.inner.avg_row_bytes

    @property
    def schema(self):
        return self.inner.schema


def _wait_until(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


def _run(fn):
    """Start ``fn`` on a thread; returns (thread, outcome dict)."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # the test inspects it
            out["error"] = e

    t = threading.Thread(target=body)
    t.start()
    return t, out


def _join(t):
    t.join(TIMEOUT)
    assert not t.is_alive(), "a fetch hung"


def test_concurrent_fetches_of_one_block_make_one_read(chunked):
    uri, X = chunked
    reader = GatedReader(open_adapter(uri))
    col = PlannedRows(reader, block_rows=64, io_workers=2, readahead=1)
    rows = np.arange(0, 40)  # one block, one span
    ta, a = _run(lambda: col.fetch(rows))
    assert reader.entered.wait(TIMEOUT)  # A claimed the block and is reading it
    tb, b = _run(lambda: col.fetch(rows))
    _wait_until(lambda: col.cache.misses == 2, "B's lookup")  # B found A's read in flight
    reader.gate.set()
    _join(ta)
    _join(tb)
    col.close()
    assert reader.reads == 1
    np.testing.assert_array_equal(a["value"], X[rows])
    np.testing.assert_array_equal(b["value"], X[rows])
    snap = col.iostats.snapshot()
    assert (snap["runs"], snap["cache_misses"], snap["prefetched"]) == (1, 1, 1)
    assert col._inflight == {}


@pytest.mark.parametrize("fail", [-1, 1])
def test_a_failed_read_leaves_no_inflight_entry(chunked, fail):
    """A staged read fails.  With no retry policy the fetch that waited on
    it raises the producer's failure, as the reference does.  Under a retry
    policy the producer spends its budget and the waiting fetch makes one
    recovery read: with a lasting fault that read fails too and the fetch
    raises; with a fault of the producer's attempts only, the fetch
    recovers the block."""
    uri, X = chunked
    rows = np.arange(130, 180)  # one block, one span
    for retries in (0, 1):
        reader = GatedReader(open_adapter(uri), fail=fail if fail < 0 else fail + retries)
        col = PlannedRows(reader, block_rows=64, io_workers=2, readahead=1, retries=retries,
                          retry_backoff_s=1e-4, retry_max_backoff_s=1e-3)
        assert col.prefetch(rows) == 1
        tb, b = _run(lambda: col.fetch(rows))
        _wait_until(lambda: col.cache.misses == 1, "the fetch's lookup")
        reader.gate.set()
        _join(tb)
        assert col._inflight == {}
        if retries == 0:
            assert isinstance(b.get("error"), OSError) and reader.reads == 1
        elif fail < 0:
            assert isinstance(b.get("error"), RetryBudgetExhausted) and reader.reads == 4
        else:
            np.testing.assert_array_equal(b["value"], X[rows])
            assert reader.reads == 3
            snap = col.iostats.snapshot()
            assert (snap["runs"], snap["cache_misses"], snap["prefetched"], snap["retries"]) == (
                1, 1, 0, 1)
        # a failing fetch of its own claims deregisters them too
        reader.fail = -1
        with pytest.raises((OSError, RetryBudgetExhausted)):
            col.fetch(np.arange(600, 700))
        assert col._inflight == {}
        col.close()
        assert col.prefetch(rows) == 0  # closed: no pool


def test_close_drops_staging_and_reads_synchronously(chunked):
    uri, X = chunked
    col = open_collection(uri, block_rows=32, io_workers=2, readahead=1)
    assert col.prefetch(np.arange(0, 96)) == 3
    col.fetch(np.arange(500, 510))
    deadline = time.monotonic() + TIMEOUT
    while col._inflight:  # unlocked read: the test only polls for drain
        assert time.monotonic() < deadline
        time.sleep(0.001)
    col.close()
    assert col.cache.snapshot()["entries"] == 1  # the staged blocks were dropped
    np.testing.assert_array_equal(col.fetch(np.arange(0, 96)), X[:96])


def test_deferred_fetch_on_the_pool_commits_speculatively(chunked):
    """A deferred fetch whose miss extents run on pool threads: nothing
    reaches the totals until the commit, which sends it to ``spec_*``."""
    uri, X = chunked
    stats = IOCounters()
    col = open_collection(uri, iostats=stats, block_rows=16, max_extent_rows=16, io_workers=4)
    rows = np.arange(0, 160, 2)
    with stats.deferred() as pend:
        np.testing.assert_array_equal(col.fetch(rows), X[rows])
    assert stats.snapshot()["runs"] == 0
    stats.commit(pend, speculative=True)
    snap = stats.snapshot()
    assert snap["runs"] == 0 and snap["spec_runs"] == len(col.plan(rows)) > 1
    col.close()
