"""The port's ``(b, f)`` autotune against the JAX package's on the CPU, the
counterpart of ``tests/test_autotune.py``: every pure function of
``core/autotune.py`` equal on equal inputs, ``probe_collection``'s
counter-derived fields equal over the same planned store, the whole
``Pipeline.autotune`` chain equal (spec JSON, fingerprint, recommendation,
``check_drift``, ``retune``), ``apply=True`` changing the loader's geometry
as the reference's does, the cached model probed again only on drift, and
an unreachable entropy floor raising the same message.

A probe times its reads with ``time.perf_counter``.  Where a test compares
fitted costs it installs one deterministic stand-in as the ``time``
attribute of both packages' autotune modules (``Clock``), so both fits see
the same durations; nothing in the JAX package changes, and no test asserts
a wall-clock time."""
import dataclasses
import types

import numpy as np
import pytest

from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import ScDataset
from repro.core import autotune as ref_autotune
from repro.data import IOStats
from repro.data import open_collection as ref_open
from repro.data import write_chunked_store
from repro.data.synth import write_csr_shard
from repro.pipeline import Pipeline as RefPipeline
from repro_torch.core import BlockShuffling, ScIterableDataset
from repro_torch.core import autotune
from repro_torch.data import IOCounters
from repro_torch.data import open_collection as port_open
from repro_torch.pipeline import Pipeline

N, G, K = 3000, 24, 14


class Clock:
    """A deterministic ``perf_counter``: each call moves time on by an
    amount that depends only on how many calls came before."""

    def __init__(self):
        self.calls = 0

    def perf_counter(self) -> float:
        self.calls += 1
        return self.calls * 1e-3 + (self.calls % 7) * 3e-5 + (self.calls % 3) * 1e-6


@pytest.fixture
def clocks(monkeypatch):
    """One stand-in clock per package, installed in its autotune module."""
    ref_clock, port_clock = Clock(), Clock()
    monkeypatch.setattr(ref_autotune, "time", types.SimpleNamespace(perf_counter=ref_clock.perf_counter))
    monkeypatch.setattr(autotune, "time", types.SimpleNamespace(perf_counter=port_clock.perf_counter))
    return ref_clock, port_clock


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8192, 8)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("autotune") / "ck")
    write_chunked_store(path, X, {"y": np.arange(len(X))}, chunk_rows=1024)
    return path


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    """Two CSR shards with a skewed 14-class ``plate`` column."""
    rng = np.random.default_rng(31)
    root = tmp_path_factory.mktemp("autotune_csr")
    lens = rng.integers(1, 5, N)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate([np.sort(rng.choice(G, int(k), replace=False)) for k in lens])
    data = rng.normal(size=int(indptr[-1])).astype(np.float32)
    p = np.arange(1, K + 1, dtype=np.float64)
    plate = rng.choice(K, size=N, p=p / p.sum()).astype(np.int32)
    half, h = N // 2, indptr[N // 2]
    s0, s1 = str(root / "s0"), str(root / "s1")
    write_csr_shard(s0, data[:h], indices[:h].astype(np.int32), indptr[: half + 1], G,
                    {"plate": plate[:half]})
    write_csr_shard(s1, data[h:], indices[h:].astype(np.int32), indptr[half:] - h, G,
                    {"plate": plate[half:]})
    return f"sharded-csr://{s0},{s1}"


def _fields(obj):
    d = dataclasses.asdict(obj)
    d.pop("model", None)
    return d


def _models():
    base = dict(c0=0.005, c_seek=0.048, c_byte=1 / 450e6, row_bytes=50_000)
    return [base, dict(base, hit_rate=0.8, runs_per_sample=1e-4, cache_bytes=400e6),
            dict(c0=0.0, c_seek=0.01, c_byte=0.0, row_bytes=1.0, runs_per_sample=0.25),
            dict(c0=1e-3, c_seek=1e-2, c_byte=1 / 400e6, row_bytes=50_000, runs_per_sample=0.05,
                 n_rows=150_000.0, requests_per_sample=0.3)]


# ------------------------------------------------------- pure functions
@pytest.mark.parametrize("kw", _models())
def test_cost_model_equals_the_reference(kw):
    a, b = ref_autotune.IOCostModel(**kw), autotune.IOCostModel(**kw)
    for m, f, blk in ((64, 1, 16), (64, 16, 1024), (32, 4, 4), (64, 256, 64), (1, 1, 1)):
        assert b.fetch_seconds(m, f, blk) == a.fetch_seconds(m, f, blk)
        assert b.samples_per_sec(m, f, blk) == a.samples_per_sec(m, f, blk)
        assert autotune.recommend_concurrency(b, batch_size=m, fetch_factor=f, block_size=blk) == \
            ref_autotune.recommend_concurrency(a, batch_size=m, fetch_factor=f, block_size=blk)


@pytest.mark.parametrize("kw", _models())
def test_recommend_equals_the_reference(kw):
    for rec_kw in ({}, {"mem_budget_bytes": 500e6}, {"mem_budget_bytes": 900e6},
                   {"throughput_slack": 0.1}, {"num_classes": 5, "entropy_slack_bits": 0.3},
                   {"class_probs": np.arange(1, 15) / 105.0, "entropy_floor": 3.0}):
        try:
            want = ref_autotune.recommend(ref_autotune.IOCostModel(**kw), batch_size=64, **rec_kw)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                autotune.recommend(autotune.IOCostModel(**kw), batch_size=64, **rec_kw)
            assert str(got.value) == str(e)
            continue
        got = autotune.recommend(autotune.IOCostModel(**kw), batch_size=64, **rec_kw)
        assert _fields(got) == _fields(want)


def test_recommend_respects_the_constraints():
    m = autotune.IOCostModel(c0=0.005, c_seek=0.048, c_byte=1 / 450e6, row_bytes=50_000)
    rec = autotune.recommend(m, batch_size=64, num_classes=14, mem_budget_bytes=500e6,
                             entropy_slack_bits=0.1)
    assert rec.buffer_bytes <= 500e6
    assert rec.fetch_factor * 64 // rec.block_size >= 16
    assert rec.modeled_samples_per_sec > 10 * m.samples_per_sec(64, 1, 1)
    for mod in (ref_autotune, autotune):  # nothing fits: the same refusal
        with pytest.raises(ValueError, match="no \\(b, f\\)"):
            mod.recommend(mod.IOCostModel(c0=0.005, c_seek=0.048, c_byte=1e-9, row_bytes=5e4),
                          batch_size=64, mem_budget_bytes=1.0)


def test_model_drift_equals_the_reference():
    got = []
    for mod, cls in ((ref_autotune, IOStats), (autotune, IOCounters)):
        model = mod.IOCostModel(c0=0.01, c_seek=1e-3, c_byte=1e-9, row_bytes=100.0,
                                runs_per_sample=0.5, hit_rate=0.5)
        row = []
        for extra in ({}, {"adm_bypassed": 80}, {"adm_rejected": 60}):
            st = cls()
            st.record(runs=50, rows=100, bytes_read=100, wall_s=0.0, cache_hits=50,
                      cache_misses=50, **extra)
            row.append(mod.model_drift(model, st))
        st = cls()
        st.record(runs=500, rows=1000, bytes_read=100, wall_s=0.0, cache_hits=500,
                  cache_misses=500, adm_bypassed=900)
        base = st.snapshot()
        row.append(mod.model_drift(model, st))
        st.record(runs=50, rows=100, bytes_read=100, wall_s=0.0, cache_hits=50, cache_misses=50)
        row.append(mod.model_drift(model, st, base=base))
        row += [mod.model_drift(model, cls(), ra_shifts=k) for k in (0, 1, 2, 7)]
        got.append(row)
    assert got[1] == got[0]
    assert got[1] == pytest.approx([0.0, 0.8, 0.6, 0.9, 0.0, 0.0, 0.5, 1.0, 1.0])


def test_probe_io_cost_equals_the_reference(tmp_path, clocks):
    """The same reads timed by the same stand-in clock fit the same model."""
    from repro_torch.data import generate_tahoe_like, load_tahoe_like

    generate_tahoe_like(str(tmp_path), n_cells=4000, n_genes=64, seed=0)
    store = load_tahoe_like(str(tmp_path))
    seen = [], []
    models = [mod.probe_io_cost(lambda idx, s=s: (s.append(idx.copy()), store[idx]), len(store),
                                row_bytes=store.avg_row_bytes, probes=2)
              for mod, s in zip((ref_autotune, autotune), seen)]
    assert len(seen[0]) == len(seen[1]) == 8
    for a, b in zip(*seen):
        np.testing.assert_array_equal(a, b)
    assert _fields(models[1]) == _fields(models[0])
    assert min(models[1].c0, models[1].c_seek, models[1].c_byte) >= 0


# -------------------------------------------------- through the planner
@pytest.mark.parametrize("cache_bytes", [32 << 20, 0])
def test_probe_collection_equals_the_reference(chunked, clocks, cache_bytes):
    uri = f"chunked://{chunked}"
    ref_col = ref_open(uri, block_rows=64, cache_bytes=cache_bytes)
    col = port_open(uri, block_rows=64, cache_bytes=cache_bytes)
    want = ref_autotune.probe_collection(ref_col, probes=2, probe_rows=256)
    got = autotune.probe_collection(col, probes=2, probe_rows=256)
    assert _fields(got) == _fields(want)
    assert col.iostats.snapshot() == {k: v for k, v in ref_col.iostats.snapshot().items()
                                      if k not in ("wall_s", "spec_wall_s")} | {
        "wall_s": col.iostats.wall_s, "spec_wall_s": 0.0}
    if cache_bytes:
        assert got.hit_rate > 0.1 and got.cache_bytes == float(cache_bytes)
    else:
        assert got.hit_rate == 0.0 and got.cache_bytes == 0.0
    ref_col.release()
    col.release()


def test_dataset_autotune_probes_again_only_on_drift(chunked, clocks):
    col = port_open(f"chunked://{chunked}", block_rows=64, cache_bytes=32 << 20,
                    readahead="auto")
    ds = ScIterableDataset(col, BlockShuffling(64), batch_size=64, fetch_factor=4, seed=0)
    kw = dict(mem_budget_bytes=60e6, probes=2, probe_rows=256)
    ds.autotune(**kw)
    first = ds._tuned_model
    ds.autotune(**kw)
    assert ds._tuned_model is first  # nothing moved: the cached fit
    col._ra_controller.grows += 2  # two controller moves: drift 1.0
    ds.autotune(**kw)
    assert ds._tuned_model is not first
    assert ds._tuned_ra_mark == col._ra_controller.grows + col._ra_controller.shrinks
    second = ds._tuned_model
    ds.autotune(**kw)
    assert ds._tuned_model is second
    ds.autotune(force=True, **kw)
    assert ds._tuned_model is not second
    col.release()
    with pytest.raises(TypeError, match="planned collection"):
        ScIterableDataset(np.arange(100)).autotune()


def test_apply_changes_the_geometry_as_the_reference_does(plates, clocks):
    loaders = []
    for open_fn, cls, strat in ((ref_open, ScDataset, RefBlockShuffling(8)),
                                (port_open, ScIterableDataset, BlockShuffling(8))):
        col = open_fn(plates, block_rows=16, cache_bytes=1 << 20)
        ds = cls(col, strat, batch_size=32, fetch_factor=2, seed=3, drop_last=False,
                 diversity_obs="plate")
        first = [b.to_dense() for b in ds]  # one epoch at the old geometry
        rec = ds.autotune(mem_budget_bytes=5e6, probes=2, probe_rows=128, apply=True)
        loaders.append((col, ds, rec, first, [b.to_dense() for b in ds]))
    (rcol, rds, rrec, rfirst, rnext), (col, ds, rec, first, nxt) = loaders
    assert _fields(rec) == _fields(rrec)
    assert (ds.fetch_factor, ds.strategy.block_size, ds._tuned_entropy) == (
        rds.fetch_factor, rds.strategy.block_size, rds._tuned_entropy)
    assert ds.fetch_factor == rec.fetch_factor and ds.strategy.block_size == rec.block_size
    for a, b in zip(rfirst + rnext, first + nxt):
        np.testing.assert_array_equal(a, b)
    assert len(nxt) == len(rnext) > 0
    rcol.release()
    col.release()


def _tuned(cls, uri, floor=None):
    builder = (cls.from_uri(uri, cache_bytes=1 << 20, block_rows=16)
               .strategy("block", block_size=8).batch(64, fetch_factor=1).seed(5)
               .diversity(obs="plate"))
    return builder, builder.autotune(budget=5e6, probes=2, probe_rows=128, entropy_floor=floor)


def test_pipeline_autotune_chain_equals_the_reference(plates, clocks):
    from repro_torch.core.theory import distribution_entropy

    p = np.unique(np.asarray(port_open(plates).obs_column("plate")), return_counts=True)[1]
    floor = distribution_entropy(p / p.sum()) - (K - 1) / (2 * 64 * np.log(2)) - 0.05
    (ref_b, _), (b, _) = _tuned(RefPipeline, plates, floor), _tuned(Pipeline, plates, floor)
    assert b.spec.to_json() == ref_b.spec.to_json()
    assert b.spec.fingerprint() == ref_b.spec.fingerprint()
    assert _fields(b.last_recommendation) == _fields(ref_b.last_recommendation)
    assert _fields(b.last_recommendation.model) == _fields(ref_b.last_recommendation.model)
    rec = b.last_recommendation
    assert rec.predicted_entropy >= floor and b.spec.entropy_floor == pytest.approx(floor)
    assert b.spec.fetch_factor == rec.fetch_factor
    assert b.spec.strategy_params["block_size"] == rec.block_size
    assert (b.spec.io_workers, b.spec.readahead) == (rec.io_workers, rec.readahead)
    # the fingerprint ignores the diversity fields
    assert b.spec.replace(diversity_obs=None, entropy_floor=0.0).fingerprint() == b.spec.fingerprint()
    ref_pipe, pipe = ref_b.build(), b.build()
    assert pipe.recommendation is b.last_recommendation
    assert pipe.check_drift() == ref_pipe.check_drift() == 0.0  # nothing read yet
    for x, y in zip(ref_pipe, pipe):
        np.testing.assert_array_equal(x.to_dense(), y.to_dense())
    assert pipe.check_drift() == ref_pipe.check_drift()
    assert _fields(pipe.retune(budget=5e6, probes=2, probe_rows=128)) == \
        _fields(ref_pipe.retune(budget=5e6, probes=2, probe_rows=128))
    assert pipe.spec.to_json() == ref_pipe.spec.to_json()  # retune leaves the spec
    for x in (ref_pipe, pipe):
        x.close()
    unpiped = Pipeline.from_uri(plates).batch(64).build()
    assert unpiped.recommendation is None and unpiped.check_drift() is None
    unpiped.close()


def test_an_unreachable_floor_raises_the_same_message(plates, clocks):
    msgs = []
    for cls in (RefPipeline, Pipeline):
        with pytest.raises(ValueError, match="unreachable") as e:
            _tuned(cls, plates, floor=4.5)  # above log2(14)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
