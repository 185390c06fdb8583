"""The port's ``cloud://`` against the JAX package's on the CPU, the
counterpart of ``tests/test_cloud_backend.py``: one counted request per
physical read (a simulated GET), cache hits and the rendezvous table's
shared reads issuing none, the ``max_inflight`` bound, the profiles and
their overrides from the query string, the inner opener's options, batches
bitwise the inner reader's and the reference's, a deferred fetch's requests
in the ``spec_*`` mirrors, ``release`` reaching the inner h5ad file, the
request-aware autotune, the deterministic tail, and both compositions:
``fault://cloud://...`` and ``cloud://sharded-h5ad://...?driver=shim``.

Sleeps are scaled to at most 0.01 of the profiles' (``latency_scale``);
request counts are compared with the reference's where the reads are
synchronous.  Nothing here asserts a timing."""
import threading

import numpy as np
import pytest

from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import ScDataset
from repro.core import autotune as ref_autotune
from repro.data import CLOUD_PROFILES as REF_PROFILES
from repro.data import CloudProfile as RefCloudProfile
from repro.data import IOStats
from repro.data import open_collection as ref_open
from repro.data import write_chunked_store
from repro.data.synth import generate_sharded_h5ad_like, write_csr_shard
from repro_torch.core import BlockShuffling, ScIterableDataset
from repro_torch.core import autotune
from repro_torch.data import CLOUD_PROFILES, CloudProfile, CloudReader, IOCounters
from repro_torch.data import open_adapter, open_collection
from repro_torch.data.backend import PlannedRows

TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _witness(lock_order_witness):
    yield


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    rng = np.random.default_rng(17)
    X = rng.normal(size=(4096, 12)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("cloud") / "ck")
    write_chunked_store(path, X, {"y": np.arange(len(X))}, chunk_rows=300)
    return path, X


@pytest.fixture(scope="module")
def h5ad_plates(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cloud_h5ad"))
    generate_sharded_h5ad_like(root, n_cells=1200, n_genes=40, n_plates=3, seed=2)
    return root


def _cloud_uri(path, **kw):
    opts = "&".join(f"{k}={v}" for k, v in kw.items())
    return f"cloud://chunked://{path}?latency_scale=0&{opts}".rstrip("&?")


def _counts(stats):
    snap = stats.snapshot()
    return {k: snap[k] for k in ("calls", "runs", "rows", "bytes_read", "requests", "cache_hits",
                                 "cache_misses")}


# ------------------------------------------------------ request accounting
def test_requests_equal_physical_runs_cold(chunked):
    path, X = chunked
    got = []
    for open_fn, cls in ((ref_open, IOStats), (open_collection, IOCounters)):
        stats = cls()
        col = open_fn(_cloud_uri(path), iostats=stats, cache_bytes=0, block_rows=64)
        rng = np.random.default_rng(0)
        for _ in range(5):
            col.fetch(rng.integers(0, len(X), 128))
        assert stats.requests == stats.runs > 0 and stats.request_wait_s > 0.0
        got.append(_counts(stats))
    assert got[1] == got[0]


def test_cache_hits_issue_no_requests(chunked):
    path, X = chunked
    got = []
    for open_fn, cls in ((ref_open, IOStats), (open_collection, IOCounters)):
        stats = cls()
        col = open_fn(_cloud_uri(path), iostats=stats, cache_bytes=64 << 20, block_rows=64)
        col.fetch(np.arange(256))
        cold = stats.requests
        col.fetch(np.arange(256))
        assert stats.requests == cold and stats.cache_hits > 0
        got.append(_counts(stats))
    assert got[1] == got[0]


def test_rendezvous_shares_one_request_per_block(chunked):
    """Two threads fetch the same cold blocks: the rendezvous table shares
    each read, so there are at most as many requests as blocks."""
    path, X = chunked
    stats = IOCounters()
    col = open_collection(_cloud_uri(path), iostats=stats, cache_bytes=64 << 20, block_rows=64,
                          io_workers=2, readahead=1)
    rows = np.arange(0, 512)  # 8 cold blocks
    barrier = threading.Barrier(2)
    outs = [None, None]

    def work(tid):
        barrier.wait(TIMEOUT)
        outs[tid] = col.fetch(rows)

    ts = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
    col.close()
    np.testing.assert_array_equal(outs[0], X[rows])
    np.testing.assert_array_equal(outs[1], X[rows])
    assert stats.requests == stats.runs <= 8


def test_readahead_requests_counted_once_end_to_end(chunked):
    path, X = chunked

    def run(open_fn, cls, strat, stats, **kw):
        col = open_fn(_cloud_uri(path), iostats=stats, cache_bytes=64 << 20, block_rows=64, **kw)
        out = [b.copy() for b in cls(col, strat, batch_size=32, fetch_factor=4, seed=11)]
        col.close()
        return out

    ref_stats, sync_stats, async_stats = IOStats(), IOCounters(), IOCounters()
    ref = run(ref_open, ScDataset, RefBlockShuffling(8), ref_stats)
    sync = run(open_collection, ScIterableDataset, BlockShuffling(8), sync_stats)
    got = run(open_collection, ScIterableDataset, BlockShuffling(8), async_stats, io_workers=2,
              readahead=2)
    for a, b, c in zip(ref, sync, got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert _counts(sync_stats) == _counts(ref_stats)
    assert async_stats.requests == async_stats.runs <= sync_stats.requests
    assert async_stats.prefetched > 0


def test_max_inflight_bounds_concurrency(chunked):
    path, X = chunked

    class InnerCounter:
        """Counts the reads in progress inside the cloud reader's slot."""

        def __init__(self, inner):
            self.inner, self.now, self.peak = inner, 0, 0
            self._l = threading.Lock()

        def __getattr__(self, k):
            return getattr(self.inner, k)

        def __len__(self):
            return len(self.inner)

        def read_range(self, start, stop):
            with self._l:
                self.now += 1
                self.peak = max(self.peak, self.now)
            try:
                return self.inner.read_range(start, stop)
            finally:
                with self._l:
                    self.now -= 1

    inner = InnerCounter(open_adapter(f"chunked://{path}"))
    prof = CloudProfile("t", first_byte_s=0.002, bw_Bps=1e12, max_inflight=2)
    col = PlannedRows(CloudReader(inner, prof), cache_bytes=0, block_rows=32, max_extent_rows=32,
                      io_workers=8)
    np.testing.assert_array_equal(col.fetch(np.arange(0, 2048, 32)), X[np.arange(0, 2048, 32)])
    col.close()
    assert 1 <= inner.peak <= 2
    assert col.iostats.requests == col.iostats.runs >= 64  # chunk edges split some blocks
    with pytest.raises(ValueError, match="max_inflight"):
        CloudReader(inner, prof.replace(max_inflight=0))


# ------------------------------------------------------------ URI parsing
def test_profile_and_overrides_via_query(chunked):
    path, X = chunked
    uri = (f"cloud://chunked://{path}?profile=cross-region&first_byte_ms=1&bw_mbps=5000"
           "&max_inflight=3&latency_scale=0.5&tail_p=0.1&tail_mult=3&tail_seed=4")
    ref_col, col = ref_open(uri), open_collection(uri)
    assert col.adapter.profile.__dict__ == ref_col.adapter.profile.__dict__
    assert col.adapter.profile.first_byte_s == pytest.approx(0.001)
    assert col.schema == ref_col.schema and col.schema["cloud_profile"] == "cross-region"
    assert {k: p.__dict__ for k, p in CLOUD_PROFILES.items()} == \
        {k: p.__dict__ for k, p in REF_PROFILES.items()}


def test_unknown_profile_rejected_with_the_same_message(chunked):
    path, X = chunked
    msgs = []
    for open_fn in (ref_open, open_collection):
        with pytest.raises(ValueError, match="unknown cloud profile") as e:
            open_fn(f"cloud://chunked://{path}?profile=mars")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_inner_opts_forwarded(tmp_path):
    from repro_torch.data import generate_token_corpus

    root = str(tmp_path / "corpus")
    generate_token_corpus(root, n_tokens=4096, vocab_size=50, seed=0)
    col = open_collection(f"cloud://tokens://{root}?seq_len=64&profile=local-ssd&latency_scale=0")
    assert col.schema["kind"] == "tokens" and col.schema["seq_len"] == 64
    assert col.fetch(np.arange(4))["tokens"].shape == (4, 64)


def test_delivery_is_the_inner_readers_and_the_references(chunked):
    path, X = chunked
    plain = open_collection(f"chunked://{path}", cache_bytes=0)
    cloud = open_collection(_cloud_uri(path), cache_bytes=0)
    ref = ref_open(_cloud_uri(path), cache_bytes=0)
    rows = np.random.default_rng(2).integers(0, len(X), 200)
    np.testing.assert_array_equal(plain.fetch(rows), cloud.fetch(rows))
    np.testing.assert_array_equal(cloud.fetch(rows), ref.fetch(rows))
    np.testing.assert_array_equal(cloud.fetch(rows), X[rows])


# ------------------------------------------------- speculative separation
def test_speculative_requests_routed_to_spec_counters():
    got = []
    for stats in (IOStats(), IOCounters()):
        stats.record_request(1, wait_s=0.5)
        with stats.deferred() as pend:
            stats.record_request(3, wait_s=1.5)
        stats.commit(pend, speculative=True)
        snap = stats.snapshot()
        got.append({k: snap[k] for k in ("requests", "request_wait_s", "spec_requests",
                                         "spec_request_wait_s")})
    assert got[1] == got[0] == {"requests": 1, "request_wait_s": 0.5, "spec_requests": 3,
                                "spec_request_wait_s": 1.5}


def test_speculative_requests_captured_across_pool_threads(chunked):
    """A deferred fetch's GETs on pool threads land in its capture buffer."""
    path, X = chunked
    stats = IOCounters()
    col = open_collection(_cloud_uri(path), iostats=stats, cache_bytes=0, block_rows=32,
                          max_extent_rows=32, io_workers=4)
    with stats.deferred() as pend:
        col.fetch(np.arange(0, 1024, 32))
    assert pend.requests == pend.runs >= 32  # chunk edges split some blocks
    assert stats.requests == 0
    stats.commit(pend, speculative=True)
    assert stats.spec_requests == pend.requests and stats.requests == 0
    col.close()


def test_release_closes_the_inner_h5ad_file(h5ad_plates):
    uri = f"cloud://sharded-h5ad://{h5ad_plates}?driver=shim&latency_scale=0"
    col = open_collection(uri, cache_bytes=0)
    col.fetch(np.arange(64))
    col.release()
    assert all(s._f._fd is None for s in col.adapter.inner.stores)
    with pytest.raises(ValueError, match="closed"):
        col.fetch(np.arange(64))


# --------------------------------------------------- request-aware autotune
def test_probe_collection_measures_requests_per_sample(chunked):
    path, X = chunked
    got = []
    for mod, open_fn in ((ref_autotune, ref_open), (autotune, open_collection)):
        m = mod.probe_collection(open_fn(_cloud_uri(path), cache_bytes=0, block_rows=64),
                                 probes=2, probe_rows=256)
        plain = mod.probe_collection(open_fn(f"chunked://{path}", cache_bytes=0, block_rows=64),
                                     probes=2, probe_rows=256)
        got.append((m.requests_per_sample, m.runs_per_sample, m.n_rows, plain.requests_per_sample))
    assert got[1] == got[0]
    assert got[1][0] > 0 and got[1][2] == float(len(X)) and got[1][3] == 0.0


def test_recommended_fetch_factor_grows_with_request_cost():
    for mod in (ref_autotune, autotune):
        fs = []
        for c_seek in (1e-4, 2e-3, 1e-2, 5e-2):
            m = mod.IOCostModel(c0=1e-3, c_seek=c_seek, c_byte=1 / 400e6, row_bytes=50_000,
                                runs_per_sample=0.05, n_rows=150_000.0)
            fs.append(mod.recommend(m, batch_size=64, num_classes=14, mem_budget_bytes=2e9,
                                    entropy_slack_bits=0.1, throughput_slack=0.1).fetch_factor)
        assert all(a <= b for a, b in zip(fs, fs[1:])) and fs[-1] > fs[0], fs
        if mod is ref_autotune:
            want = fs
    assert fs == want


def test_throughput_slack_zero_is_pure_argmax():
    m = autotune.IOCostModel(c0=1e-3, c_seek=1e-2, c_byte=1 / 400e6, row_bytes=50_000,
                             runs_per_sample=0.05, n_rows=150_000.0)
    kw = dict(batch_size=64, num_classes=14, mem_budget_bytes=2e9, entropy_slack_bits=0.1)
    r0, rbest = autotune.recommend(m, **kw), autotune.recommend(m, throughput_slack=0.0, **kw)
    assert (r0.block_size, r0.fetch_factor) == (rbest.block_size, rbest.fetch_factor)
    rlean = autotune.recommend(m, throughput_slack=0.1, **kw)
    assert rlean.buffer_bytes <= r0.buffer_bytes
    assert rlean.modeled_samples_per_sec >= 0.9 * r0.modeled_samples_per_sec


def test_request_seconds_and_the_tail_equal_the_reference():
    for name, p in CLOUD_PROFILES.items():
        q = REF_PROFILES[name]
        for nb in (0, 4096, 10**9):
            assert p.request_seconds(nb) == q.request_seconds(nb)
    p, q = (cls("x", 0.01, 1e9, tail_p=0.2, tail_mult=5.0, tail_seed=3)
            for cls in (CloudProfile, RefCloudProfile))
    got = [p.request_seconds(100, seq) for seq in range(500)]
    assert got == [q.request_seconds(100, seq) for seq in range(500)]
    assert 0.1 < np.mean(np.asarray(got) > 0.011) < 0.3  # about tail_p of GETs in the tail
    assert CloudProfile("x", 0.01, 1e9).replace(first_byte_s=0.5).first_byte_s == 0.5


# ------------------------------------------------------------- composition
def test_fault_over_cloud_over_sharded_h5ad(h5ad_plates):
    """fault://cloud://sharded-h5ad://...?driver=shim under retries, read
    synchronously: the batches, requests and retries of the reference."""
    uri = (f"fault://cloud://sharded-h5ad://{h5ad_plates}?driver=shim&profile=same-region"
           "&latency_scale=0.01&error_rate=0.1&seed=3")
    clean = f"sharded-h5ad://{h5ad_plates}?driver=shim"
    kw = dict(cache_bytes=1 << 20, block_rows=16, retries=6, retry_backoff_s=1e-4,
              retry_max_backoff_s=1e-3)

    def epoch(open_fn, cls, strat, uri, **kw):
        col = open_fn(uri, **kw)
        out = [b.to_dense() for b in cls(col, strat, batch_size=16, fetch_factor=4, seed=1)]
        snap = col.iostats.snapshot()
        col.release()
        return out, snap

    want, ref_snap = epoch(ref_open, ScDataset, RefBlockShuffling(16), uri, **kw)
    got, snap = epoch(open_collection, ScIterableDataset, BlockShuffling(16), uri, **kw)
    base, _ = epoch(open_collection, ScIterableDataset, BlockShuffling(16), clean, cache_bytes=0)
    assert len(got) == len(want) == len(base) > 0
    for a, b, c in zip(want, got, base):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    keys = ("runs", "rows", "bytes_read", "requests", "retries", "retry_wait_s", "cache_hits",
            "cache_misses")
    assert {k: snap[k] for k in keys} == {k: ref_snap[k] for k in keys}
    assert snap["retries"] > 0 and snap["requests"] == snap["runs"]


def test_cloud_over_sharded_h5ad_under_io_workers(h5ad_plates):
    uri = f"cloud://sharded-h5ad://{h5ad_plates}?driver=shim&latency_scale=0.01"
    ref = ref_open(f"sharded-h5ad://{h5ad_plates}?driver=shim", cache_bytes=0)
    col = open_collection(uri, cache_bytes=1 << 20, block_rows=16, io_workers=4, readahead=1)
    a = [b.to_dense() for b in ScDataset(ref, RefBlockShuffling(8), batch_size=16, fetch_factor=4,
                                         seed=2)]
    b = [x.to_dense() for x in ScIterableDataset(col, BlockShuffling(8), batch_size=16,
                                                 fetch_factor=4, seed=2)]
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert col.iostats.requests == col.iostats.runs > 0
    assert col.schema["cloud_profile"] == "same-region"
    col.release()
