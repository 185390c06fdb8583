"""The port's fetch pool (``repro_torch.core.prefetch.FetchPool``) against the
JAX package's ``PrefetchPool`` on the CPU, the counterpart of
``tests/test_prefetch.py``: the same batches in the same order at 1, 2 and
4 workers, work shared between workers, resumption from a cursor, errors
raised to the consumer, and a straggler's duplicate dropped with the
reference's ``spec_*`` counters.  Every test runs under the runtime
lock-order witness (``tests/conftest.py``).

Nothing here asserts a timing.  The straggler test blocks one fetch on a
``threading.Event`` until its re-issue has been delivered, and every wait
has a timeout of its own."""
import threading
import time

import numpy as np
import pytest

from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import PrefetchPool, ScDataset
from repro.data import open_collection as ref_open
from repro.data import write_csr_shard
from repro_torch.core import BlockShuffling, FetchPool, ScIterableDataset, prefetch_iterator
from repro_torch.data import open_collection as port_open

TIMEOUT = 30.0
SPEC = ("calls", "runs", "rows", "bytes_read", "cache_hits", "cache_misses", "prefetched")


@pytest.fixture(autouse=True)
def _witness(lock_order_witness):
    yield


def _X(n=4096):
    return np.arange(n * 3, dtype=np.float32).reshape(n, 3)


def _pair(collections=None, **kw):
    """The reference's dataset and the port's over the same rows."""
    kw = {"batch_size": 32, "fetch_factor": 4, "seed": 3, **kw}
    ref_col, port_col = collections if collections is not None else (_X(), _X())
    return (ScDataset(ref_col, RefBlockShuffling(8), **kw),
            ScIterableDataset(port_col, BlockShuffling(8), **kw))


@pytest.fixture(scope="module")
def csr_uri(tmp_path_factory):
    rng = np.random.default_rng(4)
    root = tmp_path_factory.mktemp("pool_csr")
    paths = []
    for s, n in enumerate((700, 530)):
        lens = rng.integers(0, 6, n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=indptr[1:])
        indices = np.concatenate([np.sort(rng.choice(30, int(k), replace=False)) for k in lens])
        paths.append(str(root / f"s{s}"))
        write_csr_shard(paths[-1], rng.normal(size=int(indptr[-1])).astype(np.float32),
                        indices.astype(np.int32), indptr, 30, {"row": np.arange(n, dtype=np.int32)})
    return "sharded-csr://" + ",".join(paths)


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        return
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert sorted(a.obs) == sorted(b.obs)
    for k in a.obs:
        assert np.array_equal(a.obs[k], b.obs[k]), k


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_pool_matches_the_reference_and_sync_iteration(workers):
    ref, port = _pair()
    want = list(PrefetchPool(ref, num_workers=workers))
    got = list(FetchPool(port, num_workers=workers))
    sync = list(_pair()[1])
    assert len(want) == len(got) == len(sync) > 0
    for a, b, c in zip(want, got, sync):
        _same(a, b)
        _same(b, c)
    assert port.state().to_dict() == ref.state().to_dict()
    assert port.state().epoch == 1


@pytest.mark.parametrize("workers", [2, 4])
def test_pool_over_a_planned_collection_equals_the_reference(csr_uri, workers):
    kw = dict(cache_bytes=1 << 18, block_rows=16, io_workers=2, readahead=1)
    a, b = ref_open(csr_uri, **kw), port_open(csr_uri, **kw)
    ref, port = _pair((a, b), fetch_factor=2)
    # no speculation: a re-issue would move the counters compared below
    want = list(PrefetchPool(ref, num_workers=workers, max_outstanding=3, enable_speculation=False))
    got = list(FetchPool(port, num_workers=workers, max_outstanding=3, enable_speculation=False))
    assert len(want) == len(got) > 0
    for x, y in zip(want, got):
        _same(x, y)
    a.release()
    b.release()
    assert b.iostats.calls == a.iostats.calls == len(got) // 2


def test_workers_share_the_fetches():
    pool = FetchPool(_pair(fetch_factor=2)[1], num_workers=2, max_outstanding=8,
                     enable_speculation=False)
    list(pool)
    wf = pool.stats["worker_fetches"]
    assert sum(wf.values()) == pool.stats["fetches"] == 64
    assert set(wf) <= {0, 1}


def test_pool_resumes_from_a_cursor():
    ref, port = _pair()
    ref_it, port_it = iter(PrefetchPool(ref, num_workers=2)), iter(FetchPool(port, num_workers=2))
    for _ in range(port.fetch_factor * 2 + 1):  # two whole fetches and one batch
        _same(next(ref_it), next(port_it))
    state = port.state()
    assert state.to_dict() == ref.state().to_dict()
    assert (state.fetch_cursor, state.batch_cursor) == (2, 1)
    ref_it.close()
    port_it.close()
    resumed = _pair()[1]
    resumed.load_state(state)
    rest = list(FetchPool(resumed, num_workers=2))
    tail = list(_pair()[1])[port.fetch_factor * 2 + 1:]
    assert len(rest) == len(tail) > 0
    for a, b in zip(tail, rest):
        _same(a, b)


class _Broken:
    def __len__(self):
        return 4096

    def __getitem__(self, rows):
        raise IOError("disk on fire")


def test_worker_errors_reach_the_consumer():
    with pytest.raises(IOError, match="disk on fire"):
        list(PrefetchPool(_pair((_Broken(), _Broken()))[0], num_workers=2))
    with pytest.raises(IOError, match="disk on fire"):
        list(FetchPool(_pair((_Broken(), _Broken()))[1], num_workers=2))


def test_prefetch_iterator_without_workers_is_the_dataset():
    ref, port = _pair()
    got = list(prefetch_iterator(port, 0))
    want = list(prefetch_iterator(_pair()[1], 3))
    assert len(got) == len(want) == len(list(ref))
    for a, b in zip(got, want):
        _same(a, b)
    with pytest.raises(ValueError):
        FetchPool(port, num_workers=0)


class _Straggler:
    """A collection whose first fetch of ``target`` rows waits for
    ``release``; the re-issue of that fetch switches speculation off, so it
    is the only one."""

    def __init__(self, inner, target):
        self.inner = inner
        self.target = target
        self.iostats = inner.iostats
        self.pool = None
        self.release = threading.Event()
        self._seen = 0
        self._seen_lock = threading.Lock()

    def __len__(self):
        return len(self.inner)

    def nbytes_of(self, rows):
        return self.inner.nbytes_of(rows)

    @property
    def schema(self):
        return self.inner.schema

    def fetch(self, rows):
        if np.array_equal(rows, self.target):
            with self._seen_lock:
                self._seen += 1
                first = self._seen == 1
            if first:
                assert self.release.wait(TIMEOUT), "the straggler was never released"
            else:
                self.pool.enable_speculation = False
        return self.inner.fetch(rows)


def _wait_for(cond):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, "the pool never reached the awaited state"
        time.sleep(0.001)


def _straggler_epoch(open_fn, uri, dataset_cls, strategy, pool_cls):
    """One epoch in which fetch 1 straggles.  The consumer holds the last
    batch of fetch 0 (so the pool stays within fetches 0-3) until fetch 1's
    re-issue has completed, then releases the straggler and waits until its
    completion has been dropped as a duplicate: the re-issue wins, whatever
    the threads' timing."""
    inner = open_fn(uri, cache_bytes=0, block_rows=16)
    probe = dataset_cls(inner, strategy, batch_size=32, fetch_factor=2, seed=3)
    order = probe._epoch_order(0)
    target = np.sort(order[probe.fetch_size:2 * probe.fetch_size])  # fetch 1
    col = _Straggler(inner, target)
    ds = dataset_cls(col, strategy, batch_size=32, fetch_factor=2, seed=3)
    pool = pool_cls(ds, num_workers=2, max_outstanding=4, straggler_factor=1.0,
                    straggler_min_latency=0.0)
    col.pool = pool
    out = []
    for b in pool:
        out.append(b)
        if len(out) == ds.fetch_factor:
            _wait_for(lambda: pool.stats["fetches"] == 4)  # 0, 2, 3 and the re-issued 1
            assert pool.stats["speculative_reissues"] == 1
            col.release.set()
            _wait_for(lambda: pool.stats["duplicate_completions"] == 1)
    inner.release()
    return out, pool.stats, inner.iostats.snapshot()


def test_straggler_duplicate_is_dropped_as_the_reference_drops_it(csr_uri):
    want, ref_stats, ref_io = _straggler_epoch(ref_open, csr_uri, ScDataset, RefBlockShuffling(8),
                                               PrefetchPool)
    got, stats, io = _straggler_epoch(port_open, csr_uri, ScIterableDataset, BlockShuffling(8),
                                      FetchPool)
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        _same(a, b)
    for k in ("fetches", "speculative_reissues", "duplicate_completions", "heartbeat_reissues"):
        assert stats[k] == ref_stats[k], k
    assert stats["fetches"] == len(got) // 2 and stats["duplicate_completions"] == 1
    assert {k: io[k] for k in SPEC} == {k: ref_io[k] for k in SPEC}
    assert {k: io["spec_" + k] for k in SPEC} == {k: ref_io["spec_" + k] for k in SPEC}
    assert io["calls"] == len(got) // 2 and io["spec_calls"] == 1 and io["spec_runs"] > 0
