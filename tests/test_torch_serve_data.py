"""The batch server against the JAX package's: wire codec bytes, batches
bitwise over the wire, resume refusal, shared-cache dedup, admission,
quota, stats; and wire compatibility both ways (a port client
against the reference's server, the reference's client against the port's
server), bitwise over two epochs and across a mid-epoch resume.

Each test of ``tests/test_serve_data.py`` has a counterpart here of the same
name; the IOStats merge/scope tests and the segmented-cache tests run on the
port's ``IOCounters`` and ``SegmentedRowBlockCache`` beside the reference's
classes.  Counters are held equal to the reference server's where its reads
are synchronous with the consumer (tenants one after another).  Every test
runs under the runtime lock-order witness, and every socket wait and thread
join has a timeout.
"""
import json
import socket
import threading
import time

import numpy as np
import pytest

from repro.data import BlockCache, IOStats, SegmentedBlockCache
from repro.data.csr_store import CSRBatch as RefCSRBatch
from repro.data.iostats import PendingIO
from repro.data.synth import generate_tahoe_like
from repro.pipeline import DataSpec as RefDataSpec
from repro.serve.data import DataClient as RefDataClient
from repro.serve.data import DataServeServer
from repro.serve.data import ServeConfig as RefServeConfig
from repro.serve.data import decode_batch as ref_decode
from repro.serve.data import encode_batch as ref_encode
from repro_torch.core.dataset import LoaderState
from repro_torch.data import IOCounters, PendingCounters
from repro_torch.data.csr_store import CSRBatch
from repro_torch.data.readplan import RowBlockCache, SegmentedRowBlockCache
from repro_torch.pipeline import Pipeline, PipelineSpec
from repro_torch.serve.data import (
    BatchServer,
    DataClient,
    ProtocolError,
    ServeConfig,
    ServeError,
    decode_batch,
    encode_batch,
)

JOIN_S = 30.0


@pytest.fixture(autouse=True)
def _witness(lock_order_witness):
    yield


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_fixture"))
    generate_tahoe_like(d, n_cells=2000, n_genes=64, n_plates=3, seed=0)
    return d


def _spec(data_dir, *, seed=7, scheme="sharded-csr", **kw) -> PipelineSpec:
    spec = (Pipeline.from_uri(f"{scheme}://{data_dir}").strategy("block", block_size=16)
            .batch(32, fetch_factor=4).seed(seed).spec)
    return spec.replace(**kw) if kw else spec


@pytest.fixture()
def server():
    srv = BatchServer(ServeConfig(max_tenants=3)).start()
    yield srv
    srv.stop()


def _batches_equal(a, b) -> bool:
    if hasattr(a, "indptr"):
        return (
            hasattr(b, "indptr")
            and np.array_equal(a.data, b.data) and a.data.dtype == b.data.dtype
            and np.array_equal(a.indices, b.indices) and a.indices.dtype == b.indices.dtype
            and np.array_equal(a.indptr, b.indptr)
            and a.n_var == b.n_var
            and list(a.obs) == list(b.obs)
            and all(np.array_equal(a.obs[k], b.obs[k]) for k in a.obs)
        )
    return np.array_equal(a, b)


def _csr_pair(seed=0):
    rng = np.random.default_rng(seed)
    kw = dict(data=rng.normal(size=300).astype(np.float32),
              indices=rng.integers(0, 64, 300).astype(np.int32),
              indptr=np.sort(rng.integers(0, 300, 31)).astype(np.int64), n_var=64,
              obs={"plate": np.array(["p1", "p2"] * 15), "y": np.arange(30),
                   "name": np.array(["a", "bc"] * 15, dtype=object)})
    return CSRBatch(**kw), RefCSRBatch(**kw)


def _wait_for(pred, timeout_s=JOIN_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _join(*threads):
    for th in threads:
        th.join(timeout=JOIN_S)
        assert not th.is_alive(), f"{th.name} did not finish"


# ===================================================================== codec
def test_codec_csr_roundtrip_bitwise():
    batch, _ = _csr_pair()
    state = {"seed": 7, "epoch": 0, "fetch_cursor": 3, "batch_cursor": 1, "fingerprint": "abc"}
    out, st = decode_batch(encode_batch(batch, state))
    assert st == state and isinstance(out, CSRBatch)
    batch.obs["name"] = batch.obs["name"].astype(str)  # object columns ship as unicode
    assert _batches_equal(batch, out)


def test_codec_dense_and_map_roundtrip():
    x = np.random.default_rng(1).normal(size=(8, 5)).astype(np.float32)
    out, _ = decode_batch(encode_batch(x, {}))
    assert np.array_equal(x, out) and out.dtype == x.dtype and out.flags.writeable
    m = {"tokens": np.arange(12, dtype=np.int32), "w": x}
    out2, _ = decode_batch(encode_batch(m, {}))
    assert list(out2) == ["tokens", "w"]
    assert all(np.array_equal(m[k], out2[k]) for k in m)


def test_codec_qint8_bounded_error_ints_exact():
    rng = np.random.default_rng(2)
    m = {"f": rng.normal(0, 3, 1000).astype(np.float32),
         "i": rng.integers(0, 9, 500).astype(np.int64)}
    payload = encode_batch(m, {}, compression="qint8")
    out, _ = decode_batch(payload)
    assert np.array_equal(m["i"], out["i"])
    step = np.abs(m["f"]).max() / 127.0
    assert np.abs(out["f"] - m["f"]).max() <= step
    assert len(encode_batch(m, {})) - len(payload) > 2500


def test_codec_rejects_unknown_batch_type():
    with pytest.raises(ProtocolError):
        encode_batch(object(), {})
    with pytest.raises(ProtocolError):
        encode_batch(np.zeros(3), {}, compression="zstd")
    with pytest.raises(ProtocolError):
        decode_batch(b"\x00\x00")


@pytest.mark.parametrize("compression", ["none", "qint8"])
@pytest.mark.parametrize("kind", ["csr", "dense", "map"])
def test_encode_batch_bytes_equal_the_reference(kind, compression):
    """The same batch and state give the reference's frame bytes, and each
    side decodes the other's frame to the same arrays."""
    rng = np.random.default_rng(5)
    state = LoaderState(7, 1, 2, 3, "f" * 16, 2, 4, ((4, 3), (6, 0))).to_dict()
    if kind == "csr":
        port_b, ref_b = _csr_pair(3)
    elif kind == "dense":
        port_b = ref_b = rng.normal(size=(33, 7)).astype(np.float32)
    else:
        port_b = ref_b = {"x": rng.normal(size=(5, 300)).astype(np.float64),
                          "h": rng.normal(size=(9,)).astype(np.float16),
                          "y": rng.integers(0, 9, 5).astype(np.int32)}
    ours, theirs = encode_batch(port_b, state, compression), ref_encode(ref_b, state, compression)
    assert ours == theirs
    (a, sa), (b, sb) = decode_batch(theirs), ref_decode(ours)
    assert sa == sb == json.loads(json.dumps(state))
    if kind == "csr":
        assert isinstance(a, CSRBatch) and isinstance(b, RefCSRBatch) and _batches_equal(a, b)
    elif kind == "dense":
        assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
    else:
        assert list(a) == list(b) and all(a[k].tobytes() == b[k].tobytes() for k in a)


# ==================================================================== config
def test_serve_config_validation_and_roundtrip():
    cfg = ServeConfig(max_tenants=2, quota_bytes=123, cache_policy="wtinylfu")
    assert ServeConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == RefServeConfig(max_tenants=2, quota_bytes=123,
                                           cache_policy="wtinylfu").to_dict()
    for bad in ({"max_tenants": 0}, {"queue_depth": 0}, {"quota_bytes": -1},
                {"compression": "zstd"}, {"cache_policy": "clock"}, {"admission": "x"},
                {"io_workers": 0}, {"admit_timeout_s": 0}):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
        with pytest.raises(ValueError):
            RefServeConfig(**bad)
    with pytest.raises(ValueError):
        ServeConfig.from_dict({"max_tenant": 3})


# ==================================================== wire parity and resume
def test_wire_parity_bitwise_two_epochs(data_dir, server):
    spec = _spec(data_dir)
    local = Pipeline.from_spec(spec).build()
    with DataClient(server.address, spec) as cli:
        assert cli.fingerprint == spec.fingerprint()
        assert len(cli) == len(local)
        for _epoch in range(2):
            lit, rit = iter(local), iter(cli)
            for lb in lit:
                rb = next(rit)
                assert _batches_equal(lb, rb)
                assert cli.state() == local.state()
            with pytest.raises(StopIteration):
                next(rit)
            assert cli.state() == local.state()
    local.close()


def test_mid_epoch_resume_over_wire(data_dir, server):
    spec = _spec(data_dir)
    with DataClient(server.address, spec) as cli:
        it = iter(cli)
        for _ in range(5):
            next(it)
        ckpt = cli.state()
        assert ckpt.fingerprint == spec.fingerprint()
    local = Pipeline.from_spec(spec).build()
    local.load_state(ckpt)
    want = list(iter(local))
    local.close()
    with DataClient(server.address, spec) as cli2:
        cli2.load_state(ckpt)
        got = list(iter(cli2))
    assert len(got) == len(want) > 0
    assert all(_batches_equal(a, b) for a, b in zip(want, got))


def test_fingerprint_refusal_is_server_side(data_dir, server):
    spec = _spec(data_dir)
    with DataClient(server.address, spec) as cli:
        bad = cli.state().to_dict()
        bad["fingerprint"] = "deadbeefdeadbeef"
        cli.load_state(bad)  # the client records it unchecked
        with pytest.raises(ValueError, match="fingerprint"):
            next(iter(cli))
        cli.set_epoch(0)  # the connection survives the refusal
        local = Pipeline.from_spec(spec).build()
        assert _batches_equal(next(iter(cli)), next(iter(local)))
        local.close()


def test_abandoned_epoch_resyncs(data_dir, server):
    spec = _spec(data_dir)
    local = Pipeline.from_spec(spec).build()
    with DataClient(server.address, spec) as cli:
        for i, _b in enumerate(iter(cli)):
            if i == 2:
                break  # frames of this epoch are still in flight
        local.load_state(cli.state())
        want = list(iter(local))
        got = list(iter(cli))  # reconnects instead of reading stale frames
    local.close()
    assert len(got) == len(want)
    assert all(_batches_equal(a, b) for a, b in zip(want, got))


def test_qint8_end_to_end_approximate(data_dir, server):
    spec = _spec(data_dir)
    local = Pipeline.from_spec(spec).build()
    with DataClient(server.address, spec, compression="qint8") as cli:
        assert cli.compression == "qint8"
        lb, rb = next(iter(local)), next(iter(cli))
    local.close()
    assert np.array_equal(lb.indices, rb.indices) and np.array_equal(lb.indptr, rb.indptr)
    assert all(np.array_equal(lb.obs[k], rb.obs[k]) for k in lb.obs)
    assert lb.data.shape == rb.data.shape
    step = np.abs(lb.data).max() / 127.0
    assert np.abs(lb.data - rb.data).max() <= step + 1e-6


def test_bad_spec_refused(server):
    with pytest.raises(ServeError) as ei:
        DataClient(server.address, PipelineSpec(uri=None))
    assert ei.value.code == "bad_spec"
    with pytest.raises(ServeError) as ei:
        DataClient(server.address, PipelineSpec(uri="sharded-csr:///nope"))
    assert ei.value.code == "bad_spec"
    with pytest.raises(ServeError) as ei:
        DataClient(server.address, PipelineSpec(uri="sharded-csr:///nope"), compression="zip")
    assert ei.value.code == "bad_spec"


# ======================================================= shared-cache dedup
def _two_tenants(server_cls, config_cls, client_cls, spec_dict):
    srv = server_cls(config_cls(max_tenants=2)).start()
    try:
        with client_cls(srv.address, spec_dict) as c1:
            n1 = sum(1 for _ in iter(c1))
        after_one = srv.stats().aggregate
        with client_cls(srv.address, spec_dict) as c2:
            n2 = sum(1 for _ in iter(c2))
        after_two = srv.stats()
    finally:
        srv.stop()
    return n1, n2, after_one, after_two


def test_two_tenants_share_one_cache(data_dir):
    """Tenant 2's reads are tenant 1's cache hits, and the counters are the
    reference server's for the same two tenants."""
    spec = _spec(data_dir).replace(uri=f"cloud://sharded-csr://{data_dir}?latency_scale=0")
    n1, n2, after_one, after_two = _two_tenants(BatchServer, ServeConfig, DataClient,
                                                spec.to_dict())
    assert n1 == n2 > 0
    agg = after_two.aggregate
    assert after_one["requests"] > 0
    assert agg["requests"] < 1.5 * after_one["requests"]
    assert agg["bytes_read"] < 1.5 * after_one["bytes_read"]
    assert agg["cache_hits"] > after_one["cache_hits"]
    assert len(after_two.collections) == 1
    assert agg["rows"] == (n1 + n2) * 32
    r1, r2, ref_one, ref_two = _two_tenants(DataServeServer, RefServeConfig, RefDataClient,
                                            spec.to_dict())
    assert (r1, r2) == (n1, n2)
    for key in ("calls", "runs", "rows", "bytes_read", "requests", "cache_hits",
                "cache_misses", "prefetched", "shared_rank_hits", "reissued_fetches"):
        assert (after_one[key], agg[key]) == (ref_one[key], ref_two.aggregate[key]), key
    assert after_two.collections[0]["cache"] == ref_two.collections[0]["cache"]


def test_per_tenant_attribution_scoped(data_dir):
    srv = BatchServer(ServeConfig(max_tenants=2)).start()
    try:
        with DataClient(srv.address, _spec(data_dir)) as cli:
            n = sum(1 for _ in iter(cli))
            st = cli.stats()
        (t,) = st["tenants"]
        assert n > 0
        assert t["iostats"]["rows"] == n * 32
        assert t["batches_sent"] == n and t["bytes_sent"] > 0
        assert st["shared"]["rows"] == 0
        assert st["aggregate"]["rows"] == n * 32
        assert set(st) == {"tenants", "aggregate", "shared", "admission", "collections",
                           "config"}
    finally:
        srv.stop()


# ================================================ admission, quota, slots
def _queued_pair(srv, spec, order, olock):
    """Tenants B then C, C started only once B waits for a slot."""

    def tenant(name):
        with DataClient(srv.address, spec) as c:
            with olock:
                order.append(name)
            next(iter(c))

    tb = threading.Thread(target=tenant, args=("B",), name="tenant-B")
    tc = threading.Thread(target=tenant, args=("C",), name="tenant-C")
    tb.start()
    assert _wait_for(lambda: srv.stats().admission["waiting"] == 1)
    tc.start()
    assert _wait_for(lambda: srv.stats().admission["waiting"] == 2)
    return tb, tc


def test_admission_fifo_under_slot_exhaustion(data_dir):
    srv = BatchServer(ServeConfig(max_tenants=1, admit_timeout_s=30.0)).start()
    spec = _spec(data_dir)
    order: list = []
    try:
        a = DataClient(srv.address, spec)  # holds the only slot
        next(iter(a))
        tb, tc = _queued_pair(srv, spec, order, threading.Lock())
        adm = srv.stats().admission
        assert adm["active"] == 1 and adm["waiting"] == 2
        a.close()  # the slot goes to the head of the queue
        _join(tb, tc)
    finally:
        srv.stop()
    assert order == ["B", "C"]


def test_admission_timeout_errors(data_dir):
    srv = BatchServer(ServeConfig(max_tenants=1, admit_timeout_s=0.3)).start()
    spec = _spec(data_dir)
    try:
        a = DataClient(srv.address, spec)
        next(iter(a))
        with pytest.raises(ServeError) as ei:
            DataClient(srv.address, spec)
        assert ei.value.code == "admission_timeout"
        a.close()
        assert srv.stats().admission["admit_timeouts"] == 1
    finally:
        srv.stop()


def _crash(cli: DataClient) -> None:
    """Kill the client's socket mid-stream: no F_CLOSE."""
    sock = cli._sock
    cli._sock = None
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    sock.close()


def test_tenant_crash_releases_slot_to_queue_head(data_dir):
    srv = BatchServer(ServeConfig(max_tenants=1, admit_timeout_s=30.0)).start()
    spec = _spec(data_dir)
    order: list = []
    try:
        a = DataClient(srv.address, spec)
        next(iter(a))
        tb, tc = _queued_pair(srv, spec, order, threading.Lock())
        _crash(a)
        _join(tb, tc)
    finally:
        srv.stop()
    assert order == ["B", "C"]


def test_tenant_crash_50_cycles_no_leaks(data_dir):
    """50 crash/reconnect cycles over one slot: no slot, tenant or
    collection reference leaks, and every departed tenant's counters fold
    into the aggregate."""
    srv = BatchServer(ServeConfig(max_tenants=1, admit_timeout_s=10.0)).start()
    spec = _spec(data_dir)
    cycles, per_cycle = 50, 2
    try:
        for _ in range(cycles):
            c = DataClient(srv.address, spec)
            it = iter(c)
            for _ in range(per_cycle):
                next(it)
            _crash(c)

        def settled():
            st = srv.stats()
            return st.admission["active"] == 0 and not st.tenants

        assert _wait_for(settled, 10.0)
        st = srv.stats()
        assert st.admission["waiting"] == 0
        assert st.admission["admitted_total"] == cycles
        assert len(st.collections) == 1 and st.collections[0]["refs"] == 0
        assert st.aggregate["rows"] >= cycles * per_cycle * spec.batch_size
        assert st.shared["rows"] == 0
    finally:
        srv.stop()


def test_quota_exhausted(data_dir):
    srv = BatchServer(ServeConfig(quota_bytes=20_000)).start()
    try:
        with DataClient(srv.address, _spec(data_dir)) as cli:
            with pytest.raises(ServeError) as ei:
                for _ in iter(cli):
                    pass
        assert ei.value.code == "quota_exhausted"
    finally:
        srv.stop()


def _http_get(address, path: bytes) -> bytes:
    s = socket.create_connection(address, timeout=JOIN_S)
    try:
        s.sendall(b"GET " + path + b" HTTP/1.0\r\n\r\n")
        resp = b""
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                return resp
            resp += chunk
    finally:
        s.close()


def test_http_stats_endpoint(data_dir, server):
    with DataClient(server.address, _spec(data_dir)) as cli:
        next(iter(cli))
    head, body = _http_get(server.address, b"/stats").split(b"\r\n\r\n", 1)
    assert b"200 OK" in head
    st = json.loads(body)
    assert set(st) >= {"tenants", "aggregate", "shared", "admission", "collections", "config"}
    assert st["admission"]["admitted_total"] >= 1
    assert b"404" in _http_get(server.address, b"/nope").split(b"\r\n", 1)[0]


def test_stop_wakes_the_accept_loop(data_dir):
    """``stop()`` shuts the listener down before closing it, so the accept
    thread ends at once (the reference only closes it, and its ``stop``
    waits out the accept thread's 5-second join)."""
    srv = BatchServer(ServeConfig()).start()
    with DataClient(srv.address, _spec(data_dir)) as cli:
        next(iter(cli))
    t0 = time.monotonic()
    srv.stop()
    assert not srv._accept_thread.is_alive()
    assert time.monotonic() - t0 < 4.0


# ========================================= wire compatibility, both ways
def _parity_with_resume(address, client_cls, spec):
    """Two epochs bitwise a local port pipeline's, then a mid-epoch resume
    over a new connection."""
    local = Pipeline.from_spec(spec).build()
    with client_cls(address, spec.to_dict()) as cli:
        assert cli.fingerprint == spec.fingerprint() and len(cli) == len(local)
        for _epoch in range(2):
            want, got = list(iter(local)), list(iter(cli))
            assert len(got) == len(want) > 0
            assert all(_batches_equal(a, b) for a, b in zip(want, got))
            assert cli.state().to_dict() == local.state().to_dict()
        it = iter(cli)
        for _ in range(3):
            next(it)
        ckpt = cli.state().to_dict()
    local.load_state(LoaderState.from_dict(ckpt))
    want = list(iter(local))
    local.close()
    with client_cls(address, spec.to_dict()) as cli2:
        cli2.load_state(ckpt)
        got = list(iter(cli2))
    assert len(got) == len(want) > 0
    assert all(_batches_equal(a, b) for a, b in zip(want, got))


def test_port_client_against_reference_server(data_dir):
    srv = DataServeServer(RefServeConfig(max_tenants=2)).start()
    try:
        _parity_with_resume(srv.address, DataClient, _spec(data_dir))
    finally:
        srv.stop()


def test_reference_client_against_port_server(data_dir, server):
    _parity_with_resume(server.address, RefDataClient, _spec(data_dir))
    # a refusal crosses the wire the same way: a drifted fingerprint
    with RefDataClient(server.address, RefDataSpec.from_dict(_spec(data_dir).to_dict())) as cli:
        bad = cli.state().to_dict()
        bad["fingerprint"] = "0" * 16
        cli.load_state(bad)
        with pytest.raises(ValueError, match="fingerprint"):
            next(iter(cli))


# ===================================================== IOStats merge/scoping
PAIR = ((IOStats, PendingIO), (IOCounters, PendingCounters))


@pytest.mark.parametrize("stats_cls,_pend", PAIR, ids=["reference", "port"])
def test_iostats_merge_adds_counters(stats_cls, _pend):
    a, b = stats_cls(), stats_cls()
    a.record(runs=1, rows=10, bytes_read=100, wall_s=0.5)
    b.record(runs=2, rows=20, bytes_read=200, wall_s=0.1, cache_hits=3)
    a.merge(b)
    assert a.runs == 3 and a.rows == 30 and a.bytes_read == 300
    assert a.cache_hits == 3 and b.runs == 2


@pytest.mark.parametrize("stats_cls,_pend", PAIR, ids=["reference", "port"])
def test_iostats_merge_min_semantics_for_entropy_floor(stats_cls, _pend):
    a, b, c = stats_cls(), stats_cls(), stats_cls()
    a.record_diversity(3.0)
    b.record_diversity(1.5)
    a.merge(b)
    assert a.div_entropy_min == 1.5 and a.div_batches == 2
    a.merge(c)
    assert a.div_entropy_min == 1.5


@pytest.mark.parametrize("stats_cls,_pend", PAIR, ids=["reference", "port"])
def test_iostats_scoped_redirects_and_restores(stats_cls, _pend):
    base = stats_cls()
    child = base.child()
    with base.scoped(child):
        base.record(runs=1, rows=5, bytes_read=50, wall_s=0.0)
        inner = base.child()
        with base.scoped(inner):
            base.record(runs=1, rows=1, bytes_read=1, wall_s=0.0)
            base.record_elastic(reissued_fetches=2, shared_rank_hits=1)
    base.record(runs=1, rows=2, bytes_read=2, wall_s=0.0)
    assert (child.rows, inner.rows, base.rows) == (5, 1, 2)
    assert (inner.reissued_fetches, inner.shared_rank_hits, base.reissued_fetches) == (2, 1, 0)
    agg = base.child()
    for s in (base, child, inner):
        agg.merge(s)
    assert (agg.runs, agg.rows, agg.bytes_read) == (3, 8, 53)


@pytest.mark.parametrize("stats_cls,pend_cls", PAIR, ids=["reference", "port"])
def test_iostats_commit_follows_scope(stats_cls, pend_cls):
    base = stats_cls()
    child = base.child()
    with base.scoped(child):
        base.commit(pend_cls(runs=2, rows=7, bytes_read=70))
    assert child.rows == 7 and base.rows == 0
    base.commit(pend_cls(runs=1, rows=3, bytes_read=30))
    assert base.rows == 3
    with base.deferred() as pend:  # the elastic counters are captured too
        base.record_elastic(reissued_fetches=1, shared_rank_hits=4)
    base.commit(pend, speculative=True)
    assert (base.reissued_fetches, base.spec_reissued_fetches, base.spec_shared_rank_hits) == \
        (0, 1, 4)


@pytest.mark.parametrize("stats_cls,_pend", PAIR, ids=["reference", "port"])
def test_iostats_scoped_none_is_noop(stats_cls, _pend):
    base = stats_cls()
    with base.scoped(None):
        base.record(runs=1, rows=4, bytes_read=4, wall_s=0.0)
    assert base.rows == 4


# ============================================= segmented cache (W-TinyLFU)
def _mixed_tenant_workload(cache):
    """Tenant A's hot redraw set against tenant B's one-touch scan; returns
    A's surviving hot blocks."""
    for k in range(10):
        cache.put(("A", k), b"x", 90)
    for _ in range(5):
        for k in range(8):
            cache.get(("A", k))
    est = lambda key: 2 if key[0] == "B" else 1  # noqa: E731
    for j in range(20):
        cache.put_admit(("B", j), b"y", 90, est)
    return [k for k in range(8) if cache.peek(("A", k)) is not None]


def test_segmented_cache_protects_hot_set_from_scan():
    for plain, seg in ((BlockCache(1000), SegmentedBlockCache(1000)),
                       (RowBlockCache(1000), SegmentedRowBlockCache(1000))):
        assert _mixed_tenant_workload(plain) == []
        assert _mixed_tenant_workload(seg) == list(range(8))
        snap = seg.snapshot()
        assert snap["rejections"] > 0 and snap["protected_entries"] == 8
        assert set(snap) >= {"window_entries", "probation_entries", "protected_bytes",
                             "window_bytes"}
    assert SegmentedRowBlockCache(1000).snapshot().keys() == SegmentedBlockCache(1000).snapshot().keys()


def test_segmented_cache_basic_lru_contract():
    seg = SegmentedRowBlockCache(1000)
    seg.put("a", 1, 400)
    seg.put("b", 2, 400)
    assert seg.get("a") == 1 and seg.get("b") == 2
    assert seg.get("missing") is None
    assert seg.hits == 2 and seg.misses == 1
    seg.discard("a")
    assert seg.peek("a") is None and len(seg) == 1
    seg.clear()
    assert len(seg) == 0 and seg.cur_bytes == 0


def test_wtinylfu_policy_through_pipeline_is_bit_identical(data_dir):
    batches, fps = {}, {}
    for policy in ("lru", "wtinylfu"):
        pipe = (Pipeline.from_uri(f"sharded-csr://{data_dir}", cache_bytes=1 << 20,
                                  cache_policy=policy)
                .strategy("block", block_size=16).batch(32, fetch_factor=4).seed(1).build())
        batches[policy] = [b.to_dense() for b in iter(pipe)]
        fps[policy] = pipe.spec.fingerprint()
        pipe.close()
    assert fps["lru"] == fps["wtinylfu"]
    assert len(batches["lru"]) == len(batches["wtinylfu"]) > 0
    for x, y in zip(batches["lru"], batches["wtinylfu"]):
        assert np.array_equal(x, y)
