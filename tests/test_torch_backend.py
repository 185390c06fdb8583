"""The port's planned storage layer (``repro_torch.data.backend``) against
the JAX package's ``open_collection`` on the CPU: for the csr, sharded-csr,
chunked and tokens schemes, under every ``admission`` x ``cache_policy``,
the same seeded fetch sequences (random, streaming, repeated rows) give
bitwise equal batches, equal ``plan()`` spans, equal counters and equal
cache snapshots after every fetch.  Also the registry, URI parsing and
refusals, the chunked store's files, the collection branch of the fetch
callback and an epoch of ``ScIterableDataset`` over a planned collection.
Synchronous paths only: no threads."""
import itertools
import json
import os
import zipfile

import numpy as np
import pytest

from repro.core import BlockShuffling, ScDataset, Streaming
from repro.data import backend as ref_backend
from repro.data import chunked_store as ref_chunked
from repro.data import open_collection as ref_open
from repro.data import write_csr_shard as ref_write_csr
from repro.data.tokens import generate_token_corpus as ref_generate_tokens
from repro_torch.core import ScIterableDataset, callbacks
from repro_torch.core import sampling as port_sampling
from repro_torch.data import backend, chunked_store
from repro_torch.data import open_collection as port_open
from repro_torch.data.csr_store import CSRBatch

COUNTERS = ("calls", "runs", "rows", "bytes_read", "cache_hits", "cache_misses",
            "adm_bypassed", "adm_rejected", "prefetched")


def _csr_shard(rng, path, n, g):
    lens = rng.integers(0, 7, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    total = int(indptr[-1])
    indices = np.concatenate([np.sort(rng.choice(g, int(k), replace=False)) for k in lens]
                             ).astype(np.int32) if total else np.zeros(0, np.int32)
    obs = {"row": np.arange(n, dtype=np.int32), "plate": rng.integers(0, 4, n).astype(np.int64)}
    ref_write_csr(path, rng.normal(size=total).astype(np.float32), indices, indptr, g, obs)


@pytest.fixture(scope="module")
def uris(tmp_path_factory):
    """One URI per scheme, over files the reference's writers made."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("backend")
    shards = []
    for s, n in enumerate((130, 97, 161)):
        shards.append(str(root / f"s{s}"))
        _csr_shard(rng, shards[-1], n, 48)
    with open(root / "manifest.json", "w") as f:
        json.dump({"shards": [f"s{s}" for s in range(3)]}, f)
    X = rng.normal(size=(700, 9)).astype(np.float32)
    ref_chunked.write_chunked_store(str(root / "ck"), X, {"y": np.arange(700) % 5}, chunk_rows=90)
    ref_generate_tokens(str(root / "tok"), n_tokens=30_000, vocab_size=61)
    return {
        "csr": f"csr://{shards[0]}",
        "sharded-csr": "sharded-csr://" + ",".join(shards),
        "sharded-manifest": f"sharded-csr://{root}",
        "chunked": f"chunked://{root / 'ck'}",
        "tokens": f"tokens://{root / 'tok'}?seq_len=20",
        "root": str(root),
    }


def assert_same_batch(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        return
    assert isinstance(b, CSRBatch) and a.n_var == b.n_var
    for f in ("data", "indices", "indptr"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert sorted(a.obs) == sorted(b.obs)
    for k in a.obs:
        assert a.obs[k].dtype == b.obs[k].dtype and np.array_equal(a.obs[k], b.obs[k]), k


def _fetches(n: int, seed: int, count: int = 24):
    """Random draws, forward streams (which engage the stream detector),
    repeated rows and a re-read of an earlier fetch."""
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    for i in range(count):
        kind = i % 6
        if kind in (0, 1, 2):  # a forward stream of contiguous fetches
            size = int(rng.integers(20, 60))
            out.append(np.arange(pos, pos + size) % n)
            pos = (pos + size) % n
        elif kind == 3:
            out.append(rng.integers(0, n, int(rng.integers(1, 80))))
        elif kind == 4:
            out.append(np.repeat(rng.integers(0, n, 5), 3))
        else:
            out.append(out[int(rng.integers(0, len(out)))][::-1].copy())
    return out


SCHEMES = ("csr", "sharded-csr", "chunked", "tokens")


@pytest.mark.parametrize("admission,policy",
                         list(itertools.product(("always", "auto", "never"), ("lru", "wtinylfu"))))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sync_fetch_equals_the_reference(uris, scheme, admission, policy):
    kw = dict(cache_bytes=6000, block_rows=16, max_extent_rows=24, admission=admission,
              cache_policy=policy)
    a, b = ref_open(uris[scheme], **kw), port_open(uris[scheme], **kw)
    assert len(a) == len(b) and a.schema == b.schema
    for step, rows in enumerate(_fetches(len(a), seed=SCHEMES.index(scheme))):
        assert np.array_equal(a.plan(rows), b.plan(rows)), step
        assert_same_batch(a.fetch(rows), b.fetch(rows))
        sa, sb = a.iostats.snapshot(), b.iostats.snapshot()
        assert {k: sa[k] for k in COUNTERS} == {k: sb[k] for k in COUNTERS}, step
        assert a.cache.snapshot() == b.cache.snapshot(), step
    assert list(sa) == list(sb)
    sa, sb = a.stats(), b.stats()
    assert sa["cache"] == sb["cache"] and sa.get("admission") == sb.get("admission")
    assert sb["io"]["calls"] == 24


def test_admission_outcomes_are_exercised(uris):
    """The sequences above reach the counters they compare."""
    seen = {}
    for admission in ("auto", "never"):
        col = port_open(uris["chunked"], cache_bytes=6000, block_rows=16, admission=admission)
        for rows in _fetches(len(col), seed=2):
            col.fetch(rows)
        seen[admission] = col.iostats.snapshot()
    assert seen["auto"]["adm_bypassed"] > 0 and seen["auto"]["adm_rejected"] > 0
    assert seen["never"]["adm_bypassed"] > 0 and seen["never"]["cache_hits"] == 0


@pytest.mark.parametrize("scheme", SCHEMES)
def test_reader_contract_equals_the_reference(uris, scheme):
    a, b = ref_backend.open_adapter(uris[scheme]), backend.open_adapter(uris[scheme])
    assert len(a) == len(b) and a.schema == b.schema and a.avg_row_bytes == b.avg_row_bytes
    ba, bb = a.boundaries(), b.boundaries()
    assert (ba is None and bb is None) or np.array_equal(ba, bb)
    rows = np.random.default_rng(3).integers(0, len(a), 50)
    assert a.nbytes_of(rows) == b.nbytes_of(rows)
    assert a.obs_keys() == b.obs_keys()
    for k in a.obs_keys():
        assert np.array_equal(a.obs_column(k), b.obs_column(k))
    edges = bb if bb is not None else np.array([0, len(b)])
    lo, hi = int(edges[-2]), min(int(edges[-2]) + 11, int(edges[-1]))
    pa, pb = a.read_range(lo, hi), b.read_range(lo, hi)
    assert_same_batch(pa, pb)
    assert backend.piece_nbytes(pb) == ref_backend.piece_nbytes(pa)
    assert_same_batch(a.concat([pa, a.take(pa, np.array([2, 0, 2]))]),
                      b.concat([pb, b.take(pb, np.array([2, 0, 2]))]))


def test_registry_uris_and_knobs(uris):
    assert backend.registered_schemes() == ["chunked", "cloud", "csr", "fault", "h5ad",
                                            "sharded-csr", "sharded-h5ad", "tokens"]
    assert backend.registered_schemes() == ref_backend.registered_schemes()
    root = uris["root"]
    # bare paths are sniffed as the reference sniffs them
    for path in (root, os.path.join(root, "s0"), os.path.join(root, "ck"),
                 os.path.join(root, "tok")):
        assert backend._sniff_scheme(path) == ref_backend._sniff_scheme(path)
    assert len(port_open(root)) == len(ref_open(root))
    assert len(port_open(uris["sharded-manifest"])) == len(ref_open(uris["sharded-csr"]))
    # knobs in the query string equal knobs as keywords; a keyword wins
    q = port_open(uris["chunked"] + "?cache_bytes=0&block_rows=32&max_extent_rows=none"
                  "&io_workers=2&admission=never&cache_policy=wtinylfu")
    k = port_open(uris["chunked"], cache_bytes=0, block_rows=32, max_extent_rows=None,
                  io_workers=2, admission="never", cache_policy="wtinylfu")
    for c in (q, k):
        assert (c.cache.max_bytes, c.block_rows, c.max_extent_rows, c.io_workers,
                c.admission, c.cache_policy) == (0, 32, None, 2, "never", "wtinylfu")
        c.close()
    assert port_open(uris["chunked"] + "?block_rows=8", block_rows=4).block_rows == 4
    assert port_open(uris["chunked"] + "?readahead=auto").readahead_auto
    assert port_open(uris["tokens"] + "&readahead=2").readahead == 2


def test_refusals(uris, tmp_path):
    with pytest.raises(ValueError, match="unknown backend scheme"):
        port_open("nope:///x")
    with pytest.raises(ValueError, match="seq_len"):
        port_open(uris["tokens"].split("?")[0])
    with pytest.raises(TypeError):
        port_open(uris["chunked"] + "?bogus=1")
    # cloud:// and fault:// open (tests/test_torch_cloud.py and
    # tests/test_torch_resilience.py); over a missing store, a bad profile
    # or a bad fault knob they raise what the reference raises
    for uri in ("cloud://chunked:///x", "fault://chunked:///x", "cloud://h5ad:///x.h5ad",
                "cloud://sharded-h5ad:///x", uris["chunked"].replace("chunked://", "cloud://chunked://")
                + "?profile=mars", "fault://" + uris["chunked"] + "?error_rate=2"):
        with pytest.raises(Exception) as ea:
            ref_open(uri)
        with pytest.raises(Exception) as eb:
            port_open(uri)
        assert type(ea.value) is type(eb.value) and str(ea.value) == str(eb.value), uri
    for bad in ({"block_rows": 0}, {"io_workers": 0}, {"admission": "x"},
                {"cache_policy": "x"}, {"readahead": 1, "cache_bytes": 0}, {"readahead": -1},
                {"retries": -1}, {"hedge_factor": -1.0}, {"breaker_threshold": -1},
                {"hedge_min_s": 0.0}):
        with pytest.raises(ValueError):
            port_open(uris["chunked"], **bad)
        with pytest.raises(ValueError):
            ref_open(uris["chunked"], **bad)
    col = port_open(uris["chunked"])
    with pytest.raises(IndexError):
        col.fetch([0, len(col)])
    with pytest.raises(IndexError):
        col.fetch([-1])
    with pytest.raises(ValueError):
        col.fetch([])
    # tagged() is ported (tests/test_torch_elastic.py holds its counters):
    # a thread-local tag, restored on exit
    with col.tagged(0):
        with col.tagged(1):
            assert col._tag.value == 1
        assert col._tag.value == 0
    assert col._tag.value is None


def test_chunked_store_files_are_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(333, 7)).astype(np.float32)
    obs = {"label": rng.integers(0, 3, 333), "name": np.array(["c"] * 333)}
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_chunked.write_chunked_store(a, X, obs, chunk_rows=50)
    chunked_store.write_chunked_store(b, X, obs, chunk_rows=50)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 7 + 2
    for name in names:
        if name == "obs.npz":  # a zip whose member headers carry the write time
            with zipfile.ZipFile(os.path.join(a, name)) as za, \
                    zipfile.ZipFile(os.path.join(b, name)) as zb:
                assert za.namelist() == zb.namelist()
                assert all(za.read(m) == zb.read(m) for m in za.namelist())
            continue
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    ra, rb = ref_chunked.ChunkedStore(b), chunked_store.ChunkedDenseStore(a)
    rows = rng.integers(0, 333, 40)
    got = rb[rows]
    assert np.array_equal(ra[rows], got) and np.array_equal(got, X[rows])
    assert np.array_equal(ra.read_range(45, 160), rb.read_range(45, 160))
    sa, sb = ra.iostats.snapshot(), rb.iostats.snapshot()
    assert {k: sa[k] for k in COUNTERS} == {k: sb[k] for k in COUNTERS}


def test_fetch_callback_takes_the_collection_branch(uris):
    col = port_open(uris["chunked"])
    rows = np.array([5, 1, 5])
    got = callbacks.default_fetch_callback(col, rows)
    assert col.iostats.snapshot()["calls"] == 1
    assert np.array_equal(got, ref_open(uris["chunked"]).fetch(rows))
    plain = np.arange(12.0)
    assert np.array_equal(callbacks.default_fetch_callback(plain, rows), plain[rows])
    assert callbacks.default_prefetch_callback(plain, rows) == 0
    assert callbacks.default_prefetch_callback(col, rows) == 0  # synchronous: no pool
    assert isinstance(col, backend.CollectionProtocol)


@pytest.mark.parametrize("scheme,strategy", [("sharded-csr", "block"), ("chunked", "stream"),
                                             ("tokens", "block")])
def test_dataset_epochs_over_planned_collections_equal_the_reference(uris, scheme, strategy):
    """Two epochs of ScIterableDataset against ScDataset, batch by batch,
    with plan_epoch and the collections' counters equal."""
    kw = dict(cache_bytes=20_000, block_rows=32, admission="auto")
    a, b = ref_open(uris[scheme], **kw), port_open(uris[scheme], **kw)
    make = {"block": (lambda: BlockShuffling(8), lambda: port_sampling.BlockShuffling(8)),
            "stream": (Streaming, port_sampling.Streaming)}[strategy]
    geo = dict(batch_size=8, fetch_factor=5, seed=3)
    ra, pb = ScDataset(a, make[0](), **geo), ScIterableDataset(b, make[1](), **geo)
    for epoch in range(2):
        assert pb.plan_epoch() == ra.plan_epoch()
        got, want = list(pb), list(ra)
        assert len(got) == len(want) > 0
        for x, y in zip(want, got):
            assert_same_batch(x, y)
    sa, sb = a.iostats.snapshot(), b.iostats.snapshot()
    assert {k: sa[k] for k in COUNTERS} == {k: sb[k] for k in COUNTERS}
    assert pb.state().to_dict() == ra.state().to_dict()
