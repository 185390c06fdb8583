"""The port's token corpus, ``DataSpec`` and ``tokens://`` Pipeline against
the JAX package's, on the CPU: corpus files, spec JSON and fingerprints,
the training driver's batches over 1.5 epochs, ``LoaderState`` JSON and
mid-epoch resumption must all be bitwise equal; a drifted spec and what
the port does not build yet are refused."""
import json
import os

import numpy as np
import pytest

from repro.core import sampling as ref_sampling
from repro.core.dataset import LoaderState as RefLoaderState
from repro.data.tokens import generate_token_corpus as ref_generate_token_corpus
from repro.launch.train import build_loader as ref_build_loader
from repro.pipeline import DataSpec as RefDataSpec
from repro.pipeline import spec as ref_spec
from repro_torch.core import LoaderState, sampling
from repro_torch.data.iostats import IOCounters
from repro_torch.data.tokens import TokenStore, generate_token_corpus
from repro_torch.launch.train import build_loader
from repro_torch.pipeline import DataSpec, Pipeline, spec

CORPUS = dict(n_tokens=40_000, vocab_size=97)  # build_loader's corpus: 14 sources, seed 0
LOADER = dict(seq_len=24, batch=6, block_size=4, fetch_factor=3, n_tokens=40_000, vocab_size=97)
KEYS = ("tokens", "labels", "source")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp("tokens")
    ref_root, port_root = str(base / "repro"), str(base / "port")
    ref_generate_token_corpus(ref_root, **CORPUS)
    generate_token_corpus(port_root, **CORPUS)
    return ref_root, port_root


def test_corpus_files_are_byte_identical(corpora, tmp_path):
    other = dict(n_tokens=10_001, vocab_size=50, n_sources=5, seed=3)
    ref_generate_token_corpus(str(tmp_path / "r"), **other)
    generate_token_corpus(str(tmp_path / "p"), **other)
    for a_root, b_root in (corpora, (str(tmp_path / "r"), str(tmp_path / "p"))):
        for name in ("tokens.npy", "sources.npy", "meta.json"):
            with open(os.path.join(a_root, name), "rb") as a, \
                    open(os.path.join(b_root, name), "rb") as b:
                assert a.read() == b.read(), name


def test_token_store_reads_and_counts(corpora):
    counters = IOCounters()
    store = TokenStore(corpora[1], seq_len=24, iostats=counters)
    assert len(store) == (CORPUS["n_tokens"] - 1) // 24
    rows = np.array([5, 6, 7, 40, 2])
    got = store[rows]
    flat = np.load(os.path.join(corpora[1], "tokens.npy"))
    for i, r in enumerate(rows):
        assert np.array_equal(got["tokens"][i], flat[r * 24:(r + 1) * 24])
        assert np.array_equal(got["labels"][i], flat[r * 24 + 1:(r + 1) * 24 + 1])
    assert counters.calls == 1 and counters.rows == 5 and counters.runs == 3
    assert counters.bytes_read == 5 * 25 * 4
    whole = store.read_range(5, 8)
    assert all(np.array_equal(whole[k], got[k][:3]) for k in KEYS)


# ------------------------------------------------------------------ spec
SPECS = [
    {},
    {"uri": "tokens:///data/c", "open_opts": {"seq_len": 128}},
    {"uri": "tokens:///data/c?seq_len=64", "strategy": "streaming", "strategy_params": {},
     "batch_size": 8, "fetch_factor": 4, "drop_last": False, "seed": 11, "world_size": 4,
     "rank": 3},
    {"uri": "csr:///x", "cache_bytes": 1 << 20, "block_rows": 64, "max_extent_rows": 0,
     "io_workers": 4, "readahead": "auto", "admission": "auto", "cache_policy": "wtinylfu",
     "prefetch_workers": 2, "retries": 3, "hedge_factor": 2.0, "diversity_obs": "plate",
     "entropy_floor": 1.5, "shared_pool": True, "cross_epoch_prefetch": True},
    {"uri": "tokens:///c", "strategy": "block-weighted",
     "strategy_params": {"block_size": 8, "weights": [0.5, 1.0, 2.0]}},
    {"uri": "tokens:///c", "strategy": "class-balanced",
     "strategy_params": {"block_size": 8, "labels_obs": "cell_line"}},
]


@pytest.mark.parametrize("kw", SPECS, ids=range(len(SPECS)))
def test_data_spec_json_and_fingerprint_equal_the_reference(kw):
    ours, theirs = DataSpec(**kw), RefDataSpec(**kw)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.fingerprint() == theirs.fingerprint()
    if kw.get("uri") is not None:
        assert ours.to_json() == theirs.to_json()
        assert DataSpec.from_json(theirs.to_json()) == ours
    assert spec.SPEC_VERSION == ref_spec.SPEC_VERSION
    assert spec.FINGERPRINT_FIELDS == ref_spec.FINGERPRINT_FIELDS
    assert spec.CONTENT_FREE_FIELDS == ref_spec.CONTENT_FREE_FIELDS


def test_content_free_knobs_leave_the_fingerprint_and_content_knobs_move_it():
    base = DataSpec(uri="tokens:///c", open_opts={"seq_len": 16})
    assert base.replace(prefetch_workers=3, retries=2, rank=0).fingerprint() == base.fingerprint()
    for kw in ({"seed": 1}, {"batch_size": 32}, {"open_opts": {"seq_len": 17}}):
        assert base.replace(**kw).fingerprint() != base.fingerprint()
        assert base.replace(**kw).fingerprint() == RefDataSpec(**base.replace(**kw).to_dict()).fingerprint()


def test_spec_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        DataSpec.from_dict({"uri": "tokens:///c", "bogus": 1})
    with pytest.raises(ValueError):
        DataSpec.from_dict({"uri": "tokens:///c", "version": spec.SPEC_VERSION + 1})
    for bad in ({"batch_size": 0}, {"rank": 2, "world_size": 2}, {"admission": "x"},
                {"readahead": -1}, {"strategy": "nope"}, {"retries": -1}, {"hedge_min_s": 0}):
        with pytest.raises(ValueError):
            DataSpec(**bad)
        with pytest.raises(ValueError):
            RefDataSpec(**bad)
    with pytest.raises(ValueError):
        DataSpec().to_json()  # no uri: not serializable


def test_strategy_specs_equal_the_reference():
    pairs = [(sampling.Streaming(), ref_sampling.Streaming()),
             (sampling.BlockShuffling(8), ref_sampling.BlockShuffling(8)),
             (sampling.BlockWeightedSampling(block_size=4, weights=np.arange(1.0, 51.0)),
              ref_sampling.BlockWeightedSampling(block_size=4, weights=np.arange(1.0, 51.0)))]
    for ours, theirs in pairs:
        assert spec.strategy_to_spec(ours) == ref_spec.strategy_to_spec(theirs)
        name, params = spec.strategy_to_spec(ours)
        again = spec.strategy_from_spec(name, params)
        assert type(again) is type(ours)
        assert np.array_equal(again.epoch_indices(50, 1, 0), ours.epoch_indices(50, 1, 0))
    with pytest.raises(ValueError):
        spec.strategy_from_spec("class-balanced", {"block_size": 4, "labels_obs": "plate"})


# ------------------------------------------------------------------ loader
def _pair(corpora, **kw):
    """(repro's, the port's) ``build_loader`` over the two corpora."""
    args = {**LOADER, **kw}
    seq, batch = args.pop("seq_len"), args.pop("batch")
    return (ref_build_loader(corpora[0], seq, batch, **args),
            build_loader(corpora[1], seq, batch, **args))


def _same_batch(a, b):
    for k in KEYS:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_build_loader_batches_and_states_equal_the_reference(corpora):
    """1.5 epochs of the training driver's pipeline, batch by batch, with
    ``state()`` JSON equal after every batch."""
    ref_pipe, pipe = _pair(corpora)
    assert pipe.spec.to_dict() == {**ref_pipe.spec.to_dict(), "uri": pipe.spec.uri}
    assert len(pipe) == len(ref_pipe)
    n = len(pipe) + len(pipe) // 2
    ref_it, it = iter(ref_pipe), iter(pipe)
    for i in range(n):
        try:
            a = next(ref_it)
        except StopIteration:
            ref_it = iter(ref_pipe)
            a = next(ref_it)
        try:
            b = next(it)
        except StopIteration:
            it = iter(pipe)
            b = next(it)
        _same_batch(a, b)
        ours, theirs = pipe.state().to_dict(), ref_pipe.state().to_dict()
        # the fingerprints differ only through the corpus paths in the uris
        assert {**ours, "fingerprint": None} == {**theirs, "fingerprint": None}, i
        assert json.dumps(ours) == json.dumps({**theirs, "fingerprint": ours["fingerprint"]})
    assert pipe.state().epoch == 1


def test_fingerprint_matches_the_reference_on_one_corpus(corpora):
    ref_pipe = ref_build_loader(corpora[1], LOADER["seq_len"], LOADER["batch"],
                                **{k: v for k, v in LOADER.items() if k not in ("seq_len", "batch")})
    _, pipe = _pair(corpora)
    assert pipe.spec.to_json() == ref_pipe.spec.to_json()
    assert pipe.state().fingerprint == ref_pipe.state().fingerprint


def test_mid_epoch_resume_is_bitwise_and_crosses_packages(corpora):
    ref_pipe, pipe = _pair(corpora)
    it = iter(pipe)
    for _ in range(7):  # mid-fetch: fetches hold 3 batches
        next(it)
    st = pipe.state()
    want = [next(it) for _ in range(10)]
    fresh = _pair(corpora)[1]
    fresh.load_state(LoaderState.from_dict(json.loads(json.dumps(st.to_dict()))))
    got_it = iter(fresh)
    for w in want:
        _same_batch(next(got_it), w)
    # a state written by the reference resumes the port's stream
    rit = iter(ref_pipe)
    for _ in range(7):
        next(rit)
    rst = ref_pipe.state().to_dict()
    port = _pair(corpora)[1]
    port.load_state(LoaderState.from_dict({**rst, "fingerprint": None}))
    got_it = iter(port)
    for w in want:
        _same_batch(next(got_it), w)
    assert RefLoaderState.from_dict(st.to_dict()).to_dict() == st.to_dict()


def test_drifted_spec_is_refused(corpora):
    _, pipe = _pair(corpora)
    next(iter(pipe))
    st = pipe.state()
    for kw in ({"block_size": 8}, {"fetch_factor": 2}, {"seed": 1}):
        drifted = _pair(corpora, **kw)[1]
        with pytest.raises(ValueError, match="fingerprint"):
            drifted.load_state(st)
    with pytest.raises(ValueError, match="seed"):
        _pair(corpora, seed=1)[1].load_state(LoaderState(seed=0, epoch=0, fetch_cursor=0))


def test_set_epoch_len_and_rebuild_from_json(corpora):
    ref_pipe, pipe = _pair(corpora)
    pipe.set_epoch(3)
    ref_pipe.set_epoch(3)
    assert len(pipe) == len(ref_pipe)
    _same_batch(next(iter(pipe)), next(iter(ref_pipe)))
    # the spec's JSON rebuilds the stream from its start
    rebuilt = DataSpec.from_json(pipe.spec.to_json()).build()
    _same_batch(next(iter(rebuilt)), next(iter(_pair(corpora)[0])))


def test_what_the_port_does_not_build_yet_is_refused(corpora):
    """Every knob whose module is not ported raises, naming its ROADMAP item;
    the planner's knobs and prefetch workers now build, the latter giving
    the synchronous batches."""
    root = corpora[1]

    def pipe():
        return Pipeline.from_uri(f"tokens://{root}", seq_len=8)

    pooled, sync = pipe().prefetch(workers=2).build(), pipe().build()
    got, want = list(pooled), list(sync)
    assert len(got) == len(want) > 0 and pooled.last_pool.stats["fetches"] > 0
    for a, b in zip(got, want):
        _same_batch(a, b)
    pooled.close()
    sync.close()
    # resilience, diversity, autotune, cloud:// and the shared pool build
    # now (their own tests hold them against the reference); a shared pool
    # needs a URI, as in the reference
    from repro.pipeline import Pipeline as RefPipeline

    for cls in (RefPipeline, Pipeline):
        with pytest.raises(ValueError, match="URI-backed"):
            cls(DataSpec(uri=None, shared_pool=True)).build()
    shared = pipe().shared().build()
    assert shared.spec.shared_pool and shared.pool_key is not None
    shared.close()
    for kw in ({"retries": 1}, {"hedge_factor": 2.0}):
        DataSpec(uri=f"tokens://{root}", open_opts={"seq_len": 8}, **kw).build().close()
    from repro.pipeline import DataSpec as RefDataSpec

    for cls in (RefDataSpec, DataSpec):  # a token corpus has no obs column to monitor
        with pytest.raises(KeyError, match="source"):
            next(iter(cls(uri=f"tokens://{root}", open_opts={"seq_len": 8},
                          diversity_obs="source").build()))
    cloud = Pipeline.from_uri(f"cloud://tokens://{root}?latency_scale=0", seq_len=8).batch(4).build()
    assert next(iter(cloud))["tokens"].shape == (4, 8)
    cloud.close()
    with pytest.raises(ValueError, match="seq_len"):
        Pipeline.from_uri(f"tokens://{root}").build()
    built = Pipeline.from_uri(f"tokens://{root}?seq_len=8&io_workers=2", cache_bytes=0).batch(4).build()
    assert next(iter(built))["tokens"].shape == (4, 8)
    built.close()


def test_train_loop_from_the_reference_state_follows_repro(corpora):
    """The training driver end to end: ``train_loop`` over the same ``tokens://``
    stream from the state ``repro``'s ``make_train_state`` drew, 4 steps of
    the smoke config in float32 beside ``repro``'s ``train_loop``: every
    step's metrics and the final parameters agree (the tolerances of
    tests/test_torch_train.py's three-step check)."""
    import dataclasses

    import jax

    from repro.configs import smoke_config as ref_smoke_config
    from repro.launch.train import train_loop as ref_train_loop
    from repro.models import Model as RefModel
    from repro.train import optimizer as jopt
    from repro.train import step as jstep
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models import Model

    kw = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config("smollm-360m"), **kw)
    cfg = dataclasses.replace(smoke_config("smollm-360m"), **kw)
    ref_pipe, pipe = _pair(corpora, seq_len=16, batch=4)
    want = ref_train_loop(RefModel(ref_cfg), ref_pipe, steps=4, lr=1e-3, log_every=1)
    # repro's train_loop draws its state from PRNGKey(seed) with these moments
    jstate = jstep.make_train_state(RefModel(ref_cfg), jax.random.PRNGKey(0),
                                    jopt.AdamWConfig(moment_dtype="float32"))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    got = train_loop(Model(cfg), pipe, steps=4, lr=1e-3, log_every=1, device="cpu", state=state)
    assert [m["step"] for m in got["metrics"]] == [m["step"] for m in want["metrics"]] == [1, 2, 3, 4]
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"{k} step {g['step']}")
    final = dict(convert.train_state_from_jax(jax.tree.map(np.asarray, want["final_state"]), cfg,
                                              device="cpu")["params"].named_parameters())
    for name, p in got["final_state"]["params"].named_parameters():
        err = (p.detach() - final[name].detach()).abs()
        assert float((err <= 2e-6).float().mean()) >= 0.999, name
        assert float(err.max()) <= 1e-4, (name, float(err.max()))


# --------------------------------------------------------- planned cells
@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """A three-shard CSR store written by the reference, and its URI."""
    from repro.data import write_csr_shard

    rng = np.random.default_rng(4)
    root = tmp_path_factory.mktemp("cells")
    paths = []
    for s, n in enumerate((150, 90, 121)):
        lens = rng.integers(0, 6, n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=indptr[1:])
        idx = np.concatenate([np.sort(rng.choice(30, int(k), replace=False)) for k in lens])
        paths.append(str(root / f"p{s}"))
        write_csr_shard(paths[-1], rng.random(int(indptr[-1])).astype(np.float32),
                        idx.astype(np.int32), indptr, 30,
                        {"cell_line": rng.integers(0, 5, n).astype(np.int32)})
    return "sharded-csr://" + ",".join(paths)


def _same_cells(a, b):
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert all(np.array_equal(a.obs[k], b.obs[k]) for k in a.obs)


def _chain(cls, uri, **knobs):
    return (cls.from_uri(uri, **knobs).strategy("block", block_size=4)
            .batch(8, fetch_factor=4).seed(2)
            .cache(bytes=1 << 16, block_rows=16, admission="auto", policy="wtinylfu")
            .prefetch(readahead="auto", io_workers=3, cross_epoch=True))


def test_planned_pipeline_equals_the_reference(cells):
    """Planner knobs through ``from_uri``, ``cache`` and ``prefetch``: the
    spec JSON, fingerprint, ``plan_epoch``, schema and two epochs of batches
    equal ``repro``'s; the knobs reach the collection."""
    from repro.pipeline import Pipeline as RefPipeline

    ref_pipe = _chain(RefPipeline, cells, max_extent_rows=0).build()
    pipe = _chain(Pipeline, cells, max_extent_rows=0).build()
    assert pipe.spec.to_json() == ref_pipe.spec.to_json()
    assert pipe.spec.fingerprint() == ref_pipe.spec.fingerprint()
    assert pipe.plan_epoch() == ref_pipe.plan_epoch()
    assert pipe.schema == ref_pipe.schema
    col = pipe.collection
    assert (col.cache.max_bytes, col.block_rows, col.max_extent_rows, col.io_workers,
            col.admission, col.cache_policy, col.readahead_auto) == (
        1 << 16, 16, None, 3, "auto", "wtinylfu", True)
    for epoch in range(2):
        got, want = list(pipe), list(ref_pipe)
        assert len(got) == len(want) > 0
        for a, b in zip(want, got):
            _same_cells(a, b)
        assert pipe.state().to_dict() == ref_pipe.state().to_dict()
    # After two epochs "readahead" is each controller's live depth, which
    # steps on measured read waits: two pipelines timed apart may stand at
    # different depths.  Every other key is compared bitwise; the depth is
    # held to its controller's range on each side.
    got, want = pipe.plan_epoch(1), ref_pipe.plan_epoch(1)
    assert {k: v for k, v in got.items() if k != "readahead"} == \
        {k: v for k, v in want.items() if k != "readahead"}
    for p in (pipe, ref_pipe):
        ctl = p.collection._ra_controller
        assert ctl.min_depth <= p.plan_epoch(1)["readahead"] <= ctl.max_depth
    assert sorted(pipe.stats()) == ["admission", "cache", "io", "readahead"]
    pipe.close()
    ref_pipe.close()


def test_query_string_knobs_are_parsed_as_the_reference_parses_them(cells):
    """Knobs in the URI's query reach the collection as in ``repro``: the
    ones the spec leaves unset (``cache_bytes``, ``block_rows``) take the
    query's value, the ones it records (``io_workers``, ``readahead``,
    ``admission``) take the spec's, which a keyword sets."""
    from repro.pipeline import Pipeline as RefPipeline

    base = cells.split(",")[0].replace("sharded-csr://", "csr://")
    uri = base + "?cache_bytes=4096&block_rows=8&io_workers=2&readahead=1&admission=never"

    def knobs(c):
        return (c.cache.max_bytes, c.block_rows, c.io_workers, c.readahead, c.admission)

    q, ref_q = Pipeline.from_uri(uri).batch(8).build(), RefPipeline.from_uri(uri).batch(8).build()
    assert knobs(q.collection) == knobs(ref_q.collection) == (4096, 8, 1, 0, "always")
    k = Pipeline.from_uri(base, cache_bytes=4096, block_rows=8, io_workers=2, readahead=1,
                          admission="never").batch(8).build()
    assert knobs(k.collection) == (4096, 8, 2, 1, "never")
    assert q.spec.fingerprint() == ref_q.spec.fingerprint()
    for a, b, c in zip(ref_q, q, k):
        _same_cells(a, b)
        _same_cells(a, c)
    for p in (q, ref_q, k):
        p.close()


def test_from_collection_wraps_without_owning(cells):
    from repro.data import open_collection as ref_open
    from repro.pipeline import Pipeline as RefPipeline
    from repro_torch.data import open_collection

    col = open_collection(cells, io_workers=2, readahead=1)
    pipe = Pipeline.from_collection(col, batch_size=16, fetch_factor=2, seed=5).build()
    ref_pipe = RefPipeline.from_collection(ref_open(cells), batch_size=16, fetch_factor=2,
                                           seed=5).build()
    assert pipe.spec.uri is None and pipe.state().fingerprint is None
    assert pipe.plan_epoch() == {**ref_pipe.plan_epoch(), "io_workers": 2, "readahead": 1}
    for a, b in zip(ref_pipe, pipe):
        _same_cells(a, b)
    pipe.close()  # the caller's collection: untouched
    assert col._pool() is not None
    col.close()
    with pytest.raises(ValueError, match="pre-opened"):
        Pipeline.from_collection(col, cache_bytes=1).build()


def test_close_releases_owned_and_a_knob_change_reopens(cells):
    builder = Pipeline.from_uri(cells, io_workers=2).batch(8)
    first = builder.build()
    assert builder.build().collection is first.collection  # opened once, reused
    builder.cache(bytes=2048)
    second = builder.build()
    assert second.collection is not first.collection
    assert second.collection.cache.max_bytes == 2048
    with first:
        next(iter(first))
    assert first.collection._pool() is None  # released
    _same_cells(next(iter(second)), next(iter(Pipeline.from_uri(cells).batch(8).build())))
    second.close()


def test_pipeline_shared_pool_is_content_free_and_shared(tmp_path):
    """``shared()`` keeps the fingerprint, builds pipelines of one spec on
    one pooled collection, delivers the private pipeline's batches, and
    closing drops references without closing the collection; as the
    reference's ``shared_pool`` does."""
    from repro.data.chunked_store import write_chunked_store
    from repro.distributed.elastic import GLOBAL_POOL as REF_POOL
    from repro.pipeline import Pipeline as RefPipeline
    from repro_torch.distributed.elastic import GLOBAL_POOL, pool_key

    X = (np.random.default_rng(11).random((512, 8)) * 10).astype(np.float32)
    write_chunked_store(str(tmp_path / "chunks"), X, chunk_rows=32)
    uri = f"chunked://{tmp_path / 'chunks'}"
    refs = {}
    for cls, pool in ((Pipeline, GLOBAL_POOL), (RefPipeline, REF_POOL)):
        spec_priv = cls.from_uri(uri).strategy("block", block_size=8).batch(8, fetch_factor=2) \
            .seed(3).spec
        spec_shared = spec_priv.replace(shared_pool=True)
        assert spec_shared.fingerprint() == spec_priv.fingerprint()
        p1, p2 = cls(spec_shared).build(), cls(spec_shared).build()
        key = pool_key(spec_shared.uri, spec_shared.open_opts)
        try:
            assert p1.collection is p2.collection and pool.refs(key) == 2
            batches = [np.asarray(b) for b in p1]
            private = cls(spec_priv).build()
            ref = [np.asarray(b) for b in private]
            private.close()
            assert len(batches) == len(ref) > 0
            for a, b in zip(batches, ref):
                np.testing.assert_array_equal(a, b)
            refs[cls] = (spec_shared.to_json(), batches)
        finally:
            p1.close()
            p2.close()
        assert pool.refs(key) == 0
        assert p1.collection.fetch(np.arange(4)) is not None  # still open
        # a collection knob changed after a build drops the builder's reference
        builder = cls(spec_shared)
        builder.build()
        assert pool.refs(key) == 1
        builder.cache(bytes=1 << 16)
        assert pool.refs(key) == 0
    (ours, got), (theirs, want) = refs[Pipeline], refs[RefPipeline]
    assert ours == theirs
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
