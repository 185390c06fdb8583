"""The elastic data fabric against the JAX package's: kill and resize
mid-epoch with the merged stream bitwise the never-resized one (under fault
injection too), cross-rank read dedup with its counters equal to the
reference fabric's for the same schedule, the supervisor's ledger and
re-issue, ``merge_states`` / ``partition``, the shared collections, and the
loader's ``repartition``.

Each test of ``tests/test_elastic_fabric.py`` has a counterpart here of the
same name (``test_pipeline_shared_pool_is_content_free_and_shared`` is in
``tests/test_torch_pipeline.py``), and so has
``tests/test_elastic.py::test_loader_repartitions_after_world_resize``.
``test_elastic.py::test_elastic_remesh_subprocess`` re-shards JAX arrays onto
another device mesh; its counterpart waits for the port's parallelism
(ROADMAP.md queue A #13).  Every test runs under the runtime lock-order
witness, and every thread join has a timeout.
"""
import json
import threading
import time

import numpy as np
import pytest

from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import ScDataset
from repro.data import IOStats
from repro.data import open_collection as ref_open
from repro.data.chunked_store import write_chunked_store
from repro.data.csr_store import write_csr_shard
from repro.distributed import elastic as ref_elastic
from repro_torch.core import BlockShuffling, ScIterableDataset
from repro_torch.core.dataset import LoaderState
from repro_torch.data import IOCounters, open_collection
from repro_torch.distributed.elastic import (
    ElasticFabric,
    RankSupervisor,
    SharedCollections,
    merge_states,
    partition,
    pool_key,
    tagged_batches,
)
from repro_torch.distributed.fault import LivenessMonitor


@pytest.fixture(autouse=True)
def _witness(lock_order_witness):
    yield


N, G = 512, 8
FETCH_KW = dict(batch_size=8, fetch_factor=2, seed=3)
FAULT_Q = "seed=5&error_rate=0.15"
RETRY_KW = dict(retries=10, retry_backoff_s=0.0005, retry_max_backoff_s=0.005)
JOIN_S = 30.0


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    rng = np.random.default_rng(11)
    X = (rng.random((N, G)) * 10).astype(np.float32)
    d = str(tmp_path_factory.mktemp("elastic") / "chunks")
    write_chunked_store(d, X, chunk_rows=32)
    return d, X


@pytest.fixture(scope="module")
def csr_shards(tmp_path_factory):
    rng = np.random.default_rng(23)
    root = tmp_path_factory.mktemp("elastic_csr")
    counts = rng.integers(1, G, N)
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, G, nnz).astype(np.int32)
    data = rng.random(nnz).astype(np.float32)
    half = int(indptr[N // 2])
    s0, s1 = str(root / "s0"), str(root / "s1")
    write_csr_shard(s0, data[:half], indices[:half], indptr[: N // 2 + 1], G, {})
    write_csr_shard(s1, data[half:], indices[half:], indptr[N // 2:] - half, G, {})
    return f"{s0},{s1}"


def _dense(b):
    """A batch's content as one array: a CSR batch's raw values, columns and
    row pointers (its ``to_dense`` differs between the packages on repeated
    columns, which the port adds up), an array as it is."""
    if hasattr(b, "indptr"):
        return np.concatenate([np.ascontiguousarray(a).view(np.uint8)
                               for a in (b.data, b.indices, b.indptr)])
    return np.asarray(b).copy()


def _open(d, opener=open_collection, **kw):
    return opener(f"chunked://{d}", block_rows=32, cache_bytes=4 << 20, **kw)


def _fabric(col, world, package=None, **overrides):
    kw = dict(FETCH_KW)
    kw.update(overrides)
    if package == "reference":
        return ref_elastic.ElasticFabric(col, world_size=world, strategy=RefBlockShuffling(8), **kw)
    return ElasticFabric(col, world_size=world, strategy=BlockShuffling(8), **kw)


def _drain_into(out, ds, limit=None, tagger=tagged_batches):
    """Collect ``(gid, batch_index) -> dense batch``, refusing duplicates."""
    n = 0
    for gid, j, b in tagger(ds, limit=limit):
        assert (gid, j) not in out, f"duplicate delivery of {(gid, j)}"
        out[(gid, j)] = _dense(b)
        n += 1
    return n


def _reference_stream(d):
    """The never-resized epoch, from the JAX package's world-1 loader."""
    ds = ScDataset(_open(d, ref_open), RefBlockShuffling(8), rank=0, world_size=1, **FETCH_KW)
    ref = {}
    _drain_into(ref, ds, tagger=ref_elastic.tagged_batches)
    return ref


def _assert_streams_equal(ref, got):
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


# --------------------------------------------------- bitwise kill / resize
def test_bitwise_kill_resize_n_m_n(store):
    d, _ = store
    ref = _reference_stream(d)
    col = _open(d)
    fab = _fabric(col, 3)
    got = {}
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r], limit=3)
    fab.kill(1)
    fab.resize(2)
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r], limit=2)
    fab.resize(3)
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r])
    _assert_streams_equal(ref, got)
    assert col.stats()["io"]["shared_rank_hits"] > 0


@pytest.mark.parametrize("world,resizes", [(2, [4]), (3, [1]), (1, [3, 2]), (4, [2, 3, 4])])
def test_bitwise_resize_sequences(store, world, resizes):
    d, _ = store
    ref = _reference_stream(d)
    fab = _fabric(_open(d), world)
    got = {}
    for new_world in resizes:
        for r in list(fab.loaders):
            _drain_into(got, fab.loaders[r], limit=2)
        fab.resize(new_world)
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r])
    _assert_streams_equal(ref, got)


def test_bitwise_kill_without_resize_then_merge(store):
    d, _ = store
    ref = _reference_stream(d)
    fab = _fabric(_open(d), 3)
    got = {}
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r], limit=1)
    state = fab.kill(2)
    assert state.remaining, "killed mid-epoch: the orphan still owes fetches"
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r], limit=2)
    assert len(fab.remaining()) > len(state.remaining)
    fab.resize(2)
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r])
    _assert_streams_equal(ref, got)


def _schedule(fab, got, tagger):
    """The kill/resize schedule of the fault-injection test."""
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r], limit=3, tagger=tagger)
    fab.kill(0)
    fab.resize(3)
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r], limit=2, tagger=tagger)
    fab.resize(2)
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r], tagger=tagger)


def test_bitwise_resize_under_fault_injection(store):
    """fault:// transient errors and retries under kill/resize: the stream
    stays bitwise, and the retries and counters are the reference's."""
    d, _ = store
    ref = _reference_stream(d)
    uri = f"fault://chunked://{d}?{FAULT_Q}"
    col = open_collection(uri, block_rows=32, cache_bytes=4 << 20, **RETRY_KW)
    got = {}
    _schedule(_fabric(col, 2), got, tagged_batches)
    _assert_streams_equal(ref, got)
    rcol = ref_open(uri, block_rows=32, cache_bytes=4 << 20, **RETRY_KW)
    rgot = {}
    _schedule(_fabric(rcol, 2, "reference"), rgot, ref_elastic.tagged_batches)
    ours, theirs = col.stats()["io"], rcol.stats()["io"]
    assert ours["retries"] > 0, "faults must actually fire"
    for key in ("retries", "runs", "bytes_read", "cache_hits", "cache_misses",
                "shared_rank_hits"):
        assert ours[key] == theirs[key], key


def test_resize_mid_fetch_respects_batch_cursor(store):
    d, _ = store
    ref = _reference_stream(d)
    fab = _fabric(_open(d), 2)
    got = {}
    _drain_into(got, fab.loaders[0], limit=1)
    st = fab.kill(0)
    assert st.remaining[0][1] > 0, "the first remaining entry carries the skip"
    fab.resize(2)
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r])
    _assert_streams_equal(ref, got)


def test_next_epoch_reverts_to_round_robin(store):
    d, _ = store
    fab = _fabric(_open(d), 3)
    got = {}
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r], limit=2)
    fab.resize(2)
    for r in list(fab.loaders):
        _drain_into(got, fab.loaders[r])
    for ds in fab.loaders.values():
        assert ds._fetch_plan is None, "the plan clears at the epoch boundary"
        assert ds._state.epoch == 1
    fresh = {r: ScDataset(_open(d, ref_open), RefBlockShuffling(8), rank=r, world_size=2,
                          **FETCH_KW) for r in range(2)}
    for ds in fresh.values():
        ds.set_epoch(1)
    for r, ds in fab.loaders.items():
        want, have = [_dense(b) for b in fresh[r]], [_dense(b) for b in ds]
        assert len(have) == len(want) > 0
        for w, h in zip(want, have):
            np.testing.assert_array_equal(w, h)


# -------------------------------------------------- loader state v2 surface
def test_state_v2_json_roundtrip_resumes_bitwise(store):
    d, _ = store
    ds = ScIterableDataset(_open(d), BlockShuffling(8), rank=0, world_size=2, **FETCH_KW)
    rds = ScDataset(_open(d, ref_open), RefBlockShuffling(8), rank=0, world_size=2, **FETCH_KW)
    it, rit = iter(ds), iter(rds)
    for _ in range(3):
        np.testing.assert_array_equal(_dense(next(it)), _dense(next(rit)))
    st = ds.state()
    assert st.world_size == 2 and st.remaining is not None
    assert st.global_cursor == st.remaining[0][0]
    assert json.dumps(st.to_dict()) == json.dumps(rds.state().to_dict())
    back = LoaderState.from_dict(json.loads(json.dumps(st.to_dict())))
    assert back == st
    rest = [_dense(b) for b in it]
    ds2 = ScIterableDataset(_open(d), BlockShuffling(8), rank=0, world_size=2, **FETCH_KW)
    ds2.load_state(back)
    rest2 = [_dense(b) for b in ds2]
    assert len(rest2) == len(rest) > 0
    for a, b in zip(rest, rest2):
        np.testing.assert_array_equal(a, b)


def test_repartition_method_validates(store):
    d, _ = store
    ds = ScIterableDataset(_open(d), BlockShuffling(8), **FETCH_KW)
    rds = ScDataset(_open(d, ref_open), RefBlockShuffling(8), **FETCH_KW)
    g = len(ds._epoch_order(0)) // ds.fetch_size
    for loader in (ds, rds):
        with pytest.raises(ValueError):
            loader.repartition(5, 3)
        with pytest.raises(ValueError):
            loader.repartition(0, 2, plan=[(g + 7, 0)])
        loader.repartition(0, 2, plan=[(0, 1), (3, 0)])
        assert loader._fetch_entries() == [(0, 1), (3, 0)]
    assert [_dense(b).tobytes() for b in ds] == [_dense(b).tobytes() for b in rds]
    for loader in (ds, rds):
        loader.repartition(1, 2, plan=None)
    assert ds._fetch_entries() == rds._fetch_entries() and len(ds._fetch_entries()) > 2
    assert ds.state() == LoaderState(**rds.state().to_dict())


def test_loader_repartitions_after_world_resize():
    """The same seed and epoch: worlds of 2 and 4 ranks split the same
    global order, and each rank's rows are the reference's."""
    X = np.arange(8192 * 2, dtype=np.float32).reshape(8192, 2)

    def rows(cls, strat, world, rank):
        ds = cls(X, strat(16), batch_size=32, fetch_factor=4, seed=5, rank=rank,
                 world_size=world)
        return np.concatenate([(np.asarray(b)[:, 0] / 2).astype(int) for b in ds])

    two = np.concatenate([rows(ScIterableDataset, BlockShuffling, 2, r) for r in range(2)])
    four = np.concatenate([rows(ScIterableDataset, BlockShuffling, 4, r) for r in range(4)])
    assert np.array_equal(np.sort(two), np.sort(four))
    for world in (2, 4):
        for r in range(world):
            np.testing.assert_array_equal(rows(ScIterableDataset, BlockShuffling, world, r),
                                          rows(ScDataset, RefBlockShuffling, world, r))


# --------------------------------------------------------- merge_states
def _mk_state(**kw):
    base = dict(seed=3, epoch=0, fetch_cursor=0, batch_cursor=0, fingerprint=None,
                world_size=2, global_cursor=0, remaining=((0, 0),))
    base.update(kw)
    return LoaderState(**base)


def test_merge_states_rejects_drift_and_duplicates():
    with pytest.raises(ValueError, match="no states"):
        merge_states([])
    with pytest.raises(ValueError, match="seed/epoch"):
        merge_states([_mk_state(), _mk_state(seed=4, remaining=((1, 0),))])
    with pytest.raises(ValueError, match="seed/epoch"):
        merge_states([_mk_state(), _mk_state(epoch=1, remaining=((1, 0),))])
    with pytest.raises(ValueError, match="fingerprints"):
        merge_states([_mk_state(fingerprint="a"), _mk_state(fingerprint="b", remaining=((1, 0),))])
    with pytest.raises(ValueError, match="no global cursor"):
        merge_states([_mk_state(), _mk_state(remaining=None)])
    with pytest.raises(ValueError, match="owed by two ranks"):
        merge_states([_mk_state(), _mk_state(remaining=((0, 1),))])
    states = [_mk_state(remaining=((4, 0), (2, 1))), _mk_state(remaining=((1, 0),))]
    assert merge_states(states) == (3, 0, None, ((1, 0), (2, 1), (4, 0)))
    assert merge_states(states) == ref_elastic.merge_states(states)


def test_partition_round_robin_and_empty_shares():
    with pytest.raises(ValueError):
        partition([(0, 0)], 0)
    assert partition([(5, 0), (1, 2), (3, 0)], 2) == [[(1, 2), (5, 0)], [(3, 0)]]
    assert partition([(1, 0)], 3) == [[(1, 0)], [], []]
    rem = [(int(g), int(s)) for g, s in np.random.default_rng(0).integers(0, 50, (20, 2))]
    for world in (1, 2, 3, 7):
        assert partition(rem, world) == ref_elastic.partition(rem, world)


# ------------------------------------------------- cross-rank read dedup
def _interleaved(fab, tagger):
    """Every rank's epoch, consumed batch by batch in turns."""
    got = {}
    its = {r: tagger(ds) for r, ds in sorted(fab.loaders.items())}
    while its:
        for r in list(its):
            try:
                gid, j, b = next(its[r])
            except StopIteration:
                del its[r]
                continue
            assert (gid, j) not in got
            got[(gid, j)] = _dense(b)
    return got


@pytest.mark.parametrize("io_workers", [1, 2])
def test_shared_collection_fewer_cloud_requests(csr_shards, io_workers):
    """Ranks on one collection against the same ranks on collections of
    their own: strictly fewer requests and bytes, the dividend in
    ``shared_rank_hits``, the stream the same; and the shared arm's counters
    equal the reference fabric's."""
    uri = f"cloud://sharded-csr://{csr_shards}?profile=same-region&latency_scale=0"
    kw = dict(block_rows=32, io_workers=io_workers)
    shared_stats = IOCounters()
    fab = _fabric(open_collection(uri, iostats=shared_stats, cache_bytes=8 << 20, **kw), 3)
    shared_got = _interleaved(fab, tagged_batches)
    snap = shared_stats.snapshot()
    assert snap["shared_rank_hits"] > 0

    ref_stats = IOStats()
    rfab = _fabric(ref_open(uri, iostats=ref_stats, cache_bytes=8 << 20, **kw), 3, "reference")
    _assert_streams_equal(_interleaved(rfab, ref_elastic.tagged_batches), shared_got)
    for key in ("requests", "bytes_read", "cache_hits", "cache_misses", "shared_rank_hits",
                "runs", "rows"):
        assert snap[key] == ref_stats.snapshot()[key], key

    iso_stats = [IOCounters() for _ in range(3)]
    iso_got = {}
    for r in range(3):
        c = open_collection(uri, iostats=iso_stats[r], cache_bytes=(8 << 20) // 3, **kw)
        _drain_into(iso_got, ScIterableDataset(c, BlockShuffling(8), rank=r, world_size=3,
                                               **FETCH_KW))
    _assert_streams_equal(iso_got, shared_got)
    assert snap["requests"] < sum(s.requests for s in iso_stats)
    assert snap["bytes_read"] < sum(s.bytes_read for s in iso_stats)
    assert sum(s.shared_rank_hits for s in iso_stats) == 0


def test_fabric_counters_equal_the_reference_across_kill_resize(csr_shards):
    """The kill/resize schedule of the bitwise test over a cloud collection:
    requests, bytes, hits and cross-rank hits are the reference fabric's."""
    uri = f"cloud://sharded-csr://{csr_shards}?profile=same-region&latency_scale=0"
    out = {}
    for package, opener, tagger in (("port", open_collection, tagged_batches),
                                    ("reference", ref_open, ref_elastic.tagged_batches)):
        col = opener(uri, block_rows=32, cache_bytes=1 << 20)
        fab = _fabric(col, 3, package)
        got = {}
        for r in list(fab.loaders):
            _drain_into(got, fab.loaders[r], limit=3, tagger=tagger)
        fab.kill(1)
        fab.resize(2)
        for r in list(fab.loaders):
            _drain_into(got, fab.loaders[r], limit=2, tagger=tagger)
        fab.resize(3)
        for r in list(fab.loaders):
            _drain_into(got, fab.loaders[r], tagger=tagger)
        out[package] = (got, col.stats()["io"])
    _assert_streams_equal(out["reference"][0], out["port"][0])
    ours, theirs = out["port"][1], out["reference"][1]
    assert ours["shared_rank_hits"] > 0
    for key in ("requests", "bytes_read", "cache_hits", "cache_misses", "shared_rank_hits",
                "runs", "rows", "calls"):
        assert ours[key] == theirs[key], key


def test_untagged_traffic_neither_claims_nor_counts(store):
    d, _ = store
    col = _open(d)
    rows = np.arange(64)
    col.fetch(rows)  # untagged: no owner
    with col.tagged(1):
        col.fetch(rows)  # cached, unowned: no shared hit
        with col.tagged(2):
            col.fetch(np.arange(64, 96))  # rank 2 reads block 2
        col.fetch(np.arange(64, 96))  # rank 1 takes rank 2's block: one hit
    col.fetch(np.arange(64, 96))  # untagged again: counts nothing
    assert col.stats()["io"]["shared_rank_hits"] == 1


# ------------------------------------------------------ rank supervisor
def test_supervisor_ack_dedup_and_outstanding(store):
    d, _ = store
    ds = ScIterableDataset(_open(d), BlockShuffling(8), **FETCH_KW)
    sup = RankSupervisor(ds, timeout_s=60.0)
    sup.issue(0, 0, 4)
    sup.issue(1, 0, 5)
    assert sup.outstanding() == [(0, 4), (0, 5)]
    assert sup.outstanding(1) == [(0, 5)]
    assert sup.ack(0, 0, 4) is True
    assert sup.ack(0, 0, 4) is False, "a duplicate delivery acks False"
    assert sup.outstanding() == [(0, 5)]


def test_supervisor_reassigned_late_delivery_drops(store):
    d, _ = store
    sup = RankSupervisor(ScIterableDataset(_open(d), BlockShuffling(8), **FETCH_KW),
                         timeout_s=60.0)
    sup.issue(1, 0, 7)
    sup.issue(0, 0, 7)
    assert sup.ack(0, 0, 7) is True
    assert sup.ack(1, 0, 7) is False


class _Clock:
    """A stand-in ``time.monotonic`` for both packages' liveness monitors."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture()
def clock(monkeypatch):
    import repro.distributed.fault as ref_fault
    import repro_torch.distributed.fault as port_fault

    c = _Clock()
    for mod in (ref_fault, port_fault):
        monkeypatch.setattr(mod, "time", c)
    return c


def _recover_cached(d, clock, package):
    if package == "port":
        col = _open(d, io_workers=2)
        ds = ScIterableDataset(col, BlockShuffling(8), **FETCH_KW)
        sup = RankSupervisor(ds, heartbeat=LivenessMonitor(timeout_s=0.05))
    else:
        from repro.distributed.fault import HeartbeatMonitor

        col = _open(d, ref_open, io_workers=2)
        ds = ScDataset(col, RefBlockShuffling(8), **FETCH_KW)
        sup = ref_elastic.ElasticSupervisor(ds, heartbeat=HeartbeatMonitor(timeout_s=0.05))
    sup.beat(0)
    sup.beat(1)
    sup.issue(0, 0, 0)
    sup.issue(1, 0, 1)
    sup.issue(1, 0, 2)
    sup.ack(1, 0, 2)  # delivered before the stall: not issued again
    ds.fetch(0, 1)  # the suspect's fetch is cached
    before = col.stats()["io"]["bytes_read"]
    clock.now += 0.08
    sup.beat(0)  # rank 0 lives on; rank 1 is a suspect now
    assert sup.suspects() == ["1"]
    out = sup.recover()
    io = col.stats()["io"]
    again = sup.recover()
    sup.beat(1)
    sup.issue(1, 0, 3)
    return out, io["bytes_read"] - before, io["reissued_fetches"], again, sup.recover()


def test_supervisor_recover_is_idempotent_and_free_when_cached(store, clock):
    """recover() issues only the suspects' unacknowledged fetches, once,
    through the rendezvous table (no read for cached blocks), and records
    ``reissued_fetches``: as the reference supervisor does."""
    d, _ = store
    ours = _recover_cached(d, clock, "port")
    assert ours == ({"1": [1]}, 0, 1, {}, {})
    assert ours == _recover_cached(d, clock, "reference")


def test_supervisor_recover_prefetches_cold_fetch(store, clock):
    """A suspect's fetch nobody started is staged by recover(): the adopting
    rank's fetch then costs what the fetch alone costs cold."""
    d, _ = store
    col = _open(d, io_workers=2)
    ds = ScIterableDataset(col, BlockShuffling(8), **FETCH_KW)
    sup = RankSupervisor(ds, heartbeat=LivenessMonitor(timeout_s=0.02))
    sup.beat(2)
    sup.issue(2, 0, 6)
    clock.now += 0.05
    assert sup.recover() == {"2": [6]}
    ds.fetch(0, 6)  # joins the staged reads
    spent = col.stats()["io"]
    assert spent["bytes_read"] > 0 and spent["prefetched"] > 0
    cold_col = _open(d, io_workers=2)
    ScIterableDataset(cold_col, BlockShuffling(8), **FETCH_KW).fetch(0, 6)
    assert spent["bytes_read"] == cold_col.stats()["io"]["bytes_read"]


def test_supervisor_recover_holds_no_lock_while_it_reads(store, clock):
    """The port's recover() issues the re-reads after releasing its ledger
    lock (the reference holds it across them): an ack can run while a
    re-issue is under way, and the fetch is still re-issued only once."""
    d, _ = store
    col = _open(d, io_workers=2)
    ds = ScIterableDataset(col, BlockShuffling(8), **FETCH_KW)
    sup = RankSupervisor(ds, heartbeat=LivenessMonitor(timeout_s=0.02))
    sup.beat(1)
    sup.issue(1, 0, 4)
    clock.now += 0.05
    entered, release, acked = threading.Event(), threading.Event(), []
    inner = col.prefetch

    def held_prefetch(rows):
        entered.set()
        assert release.wait(JOIN_S)
        return inner(rows)

    col.prefetch = held_prefetch
    th = threading.Thread(target=lambda: acked.append(sup.recover()), name="recover")
    th.start()
    assert entered.wait(JOIN_S)
    assert sup.ack(0, 0, 4) is True  # the ledger is free during the re-read
    release.set()
    th.join(timeout=JOIN_S)
    assert not th.is_alive()
    assert acked == [{"1": [4]}] and sup.recover() == {}
    assert col.stats()["io"]["reissued_fetches"] == 1


# -------------------------------------------------------- shared collections
class _FakeCol:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_collection_pool_refcounts_and_close_all():
    pool = SharedCollections()
    key = pool_key("chunked:///tmp/x", {"block_rows": 32})
    assert key != pool_key("chunked:///tmp/x", {"block_rows": 64})
    assert key == ref_elastic.pool_key("chunked:///tmp/x", {"block_rows": 32})
    made = []

    def opener():
        made.append(_FakeCol())
        return made[-1]

    a, b = pool.acquire(key, opener), pool.acquire(key, opener)
    assert a is b and len(made) == 1 and pool.refs(key) == 2
    assert pool.entries() == [(key, a, 2)]
    pool.release(key)
    assert pool.refs(key) == 1
    pool.release(key)
    assert pool.refs(key) == 0 and not made[0].closed
    pool.close_all()
    assert made[0].closed and pool.entries() == []


def test_collection_pool_open_race_single_winner():
    pool = SharedCollections()
    barrier = threading.Barrier(2)
    made, got = [], [None, None]

    def opener():
        c = _FakeCol()
        made.append(c)
        barrier.wait(JOIN_S)  # both opens are under way outside the lock
        return c

    def contend(i):
        got[i] = pool.acquire("race", opener)

    ts = [threading.Thread(target=contend, args=(i,), name=f"contend-{i}") for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert got[0] is got[1] and pool.refs("race") == 2
    survivors = [c for c in made if not c.closed]
    assert len(made) == 2 and len(survivors) == 1 and survivors[0] is got[0]
    pool.close_all()


def test_rank_view_tags_prefetch(store):
    """A rank's staged blocks are owned by the rank: another rank's fetch of
    them counts shared hits, the same rank's does not."""
    from repro_torch.distributed.elastic import RankView

    d, _ = store
    col = _open(d, io_workers=2)
    r0, r1 = RankView(col, 0), RankView(col, 1)
    assert len(r0) == N and r0.block_rows == 32
    assert r0.prefetch(np.arange(64)) == 2
    assert _wait_for_staged(col, 2)
    r0.fetch(np.arange(32))
    r1[np.arange(32, 64)]
    assert col.stats()["io"]["shared_rank_hits"] == 1


def _wait_for_staged(col, n, timeout_s=JOIN_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if len(col.cache) >= n:
            return True
        time.sleep(0.005)
    return False
