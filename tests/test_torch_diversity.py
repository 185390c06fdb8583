"""The port's diversity monitor against the JAX package's on the CPU, the
counterpart of ``tests/test_diversity.py``: ``IOCounters.record_diversity``
beside ``IOStats.record_diversity`` (sum, minimum, count, the ``spec_*``
mirrors, the min-merge), :class:`EntropyMonitor` beside
``DiversityMonitor``, live ``div_*`` counters equal to the reference's
bitwise on the same stream and to an offline recomputation, the stream
bitwise the same with and without the monitor and under ``fault://``
retries and hedging, the entropy floor of ``recommend`` and
``model_drift``, the spec's diversity fields, and the refusals.

``div_entropy_sum`` is a float summed in arrival order: it equals the
sequential sum of the per-batch entropies bit for bit, and Python's
``sum``, which compensates its rounding, within an ulp (ROADMAP.md queue C
#3).  Every test runs under the runtime lock-order witness; nothing here
asserts a timing."""
import functools
import math
import operator

import numpy as np
import pytest

from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import DiversityMonitor, ScDataset
from repro.core import autotune as ref_autotune
from repro.core.theory import batch_entropy as ref_batch_entropy
from repro.data import IOStats
from repro.data import open_collection as ref_open
from repro.data.synth import write_csr_shard
from repro.pipeline import Pipeline as RefPipeline
from repro_torch.core import BlockShuffling, ScIterableDataset
from repro_torch.core import autotune
from repro_torch.core.dataset import EntropyMonitor
from repro_torch.core.theory import batch_entropy, distribution_entropy
from repro_torch.data import IOCounters
from repro_torch.data import open_collection as port_open
from repro_torch.pipeline import DataSpec, Pipeline

N, G, K = 2000, 32, 14
FAULT_Q = "seed=5&error_rate=0.15"
RETRY_KW = dict(retries=10, retry_backoff_s=0.0005, retry_max_backoff_s=0.005)
DIV = ("div_batches", "div_entropy_sum", "div_entropy_min",
       "spec_div_batches", "spec_div_entropy_sum", "spec_div_entropy_min")


@pytest.fixture(autouse=True)
def _witness(lock_order_witness):
    yield


def _random_csr(rng, n, g):
    lens = rng.integers(1, 5, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate([np.sort(rng.choice(g, int(k), replace=False)) for k in lens])
    return rng.normal(size=int(indptr[-1])).astype(np.float32), indices.astype(np.int32), indptr


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Two CSR shards with a skewed 14-class ``plate`` column."""
    rng = np.random.default_rng(29)
    root = tmp_path_factory.mktemp("diversity")
    data, indices, indptr = _random_csr(rng, N, G)
    p = np.arange(1, K + 1, dtype=np.float64)
    plate = rng.choice(K, size=N, p=p / p.sum()).astype(np.int32)
    half = indptr[N // 2]
    s0, s1 = str(root / "s0"), str(root / "s1")
    write_csr_shard(s0, data[:half], indices[:half], indptr[: N // 2 + 1], G,
                    {"plate": plate[: N // 2]})
    write_csr_shard(s1, data[half:], indices[half:], indptr[N // 2:] - half, G,
                    {"plate": plate[N // 2:]})
    return {"uri": f"sharded-csr://{s0},{s1}", "plate": plate}


def _both(ops):
    """Apply ``ops(stats)`` to a reference IOStats and a port IOCounters;
    their snapshots' diversity counters."""
    out = []
    for st in (IOStats(), IOCounters()):
        ops(st)
        out.append({k: st.snapshot()[k] for k in DIV})
    return out


# ------------------------------------------------------------ the counters
def test_record_diversity_sum_min_count():
    def ops(st):
        for h in (2.5, 1.25, 3.0):
            st.record_diversity(h)

    want, got = _both(ops)
    assert got == want
    assert (got["div_batches"], got["div_entropy_sum"], got["div_entropy_min"]) == (3, 6.75, 1.25)

    def reset(st):
        ops(st)
        st.reset()

    want, got = _both(reset)
    assert got == want and all(v == 0 for v in got.values())


def test_zero_entropy_is_a_legal_observation():
    def ops(st):
        st.record_diversity(2.0)
        st.record_diversity(0.0)

    want, got = _both(ops)
    assert got == want and (got["div_batches"], got["div_entropy_min"]) == (2, 0.0)


def test_deferred_diversity_routes_to_spec_mirrors():
    def ops(st):
        with st.deferred() as pend:
            st.record_diversity(1.5)
            st.record_diversity(0.5)
        st.commit(pend, speculative=True)
        with st.deferred() as pend:
            st.record_diversity(3.0)
        st.commit(pend)

    want, got = _both(ops)
    assert got == want
    assert (got["div_batches"], got["spec_div_batches"], got["spec_div_entropy_min"]) == (1, 2, 0.5)


def test_min_merge_across_commits():
    """An observation-free buffer never clobbers the running minimum."""
    def ops(st):
        for hs in ((2.0,), (1.0, 4.0), ()):
            with st.deferred() as pend:
                for h in hs:
                    st.record_diversity(h)
            st.commit(pend)

    want, got = _both(ops)
    assert got == want and got["div_entropy_min"] == 1.0 and got["div_batches"] == 3


def test_merge_and_scoped_keep_the_minimum_gate():
    src = IOCounters()
    src.record_diversity(0.75)
    dst = IOCounters()
    dst.record_diversity(2.0)
    dst.merge(src)
    dst.merge(IOCounters())  # no observations: the minimum stays
    assert (dst.div_batches, dst.div_entropy_min, dst.div_entropy_sum) == (2, 0.75, 2.75)
    child = dst.child()
    with dst.scoped(child):
        dst.record_diversity(0.25)
        dst.record_resilience(retries=2, retry_wait_s=0.5)
    assert (child.div_batches, child.div_entropy_min, child.retries) == (1, 0.25, 2)
    assert dst.div_batches == 2 and dst.retries == 0


# ------------------------------------------------------------- the monitor
def test_monitor_refuses_a_collection_without_obs():
    with pytest.raises(ValueError) as ea:
        DiversityMonitor(object(), "plate")
    with pytest.raises(ValueError) as eb:
        EntropyMonitor(object(), "plate")
    assert str(ea.value) == str(eb.value) and "diversity_obs" in str(eb.value)
    with pytest.raises(ValueError, match="diversity_obs"):
        ScIterableDataset(np.arange(10), diversity_obs="plate")


def test_monitor_resolves_classes_and_probs(sharded):
    ref_col, col = ref_open(sharded["uri"], block_rows=32), port_open(sharded["uri"], block_rows=32)
    ref_mon, mon = DiversityMonitor(ref_col, "plate"), EntropyMonitor(col, "plate")
    assert mon.num_classes == ref_mon.num_classes == K
    np.testing.assert_array_equal(mon.class_probs(), ref_mon.class_probs())
    np.testing.assert_array_equal(mon.class_probs(), np.bincount(sharded["plate"], minlength=K) / N)
    rows = np.random.default_rng(0).integers(0, N, 64)
    assert mon.observe(rows) == ref_mon.observe(rows)
    assert col.iostats.snapshot()["div_entropy_sum"] == ref_col.iostats.snapshot()["div_entropy_sum"]
    ref_col.release()
    col.release()


def _chain(cls, uri, stats):
    return (cls.from_uri(uri, iostats=stats).strategy("block", block_size=32)
            .batch(32, fetch_factor=4).seed(11).diversity(obs="plate"))


def test_live_counters_equal_the_reference_and_the_offline_sum(sharded):
    ref_stats, stats = IOStats(), IOCounters()
    take = dict(batch_transform=lambda b: np.asarray(b.obs["plate"]).copy())
    ref_pipe = _chain(RefPipeline, sharded["uri"], ref_stats).build(**take)
    pipe = _chain(Pipeline, sharded["uri"], stats).build(**take)
    want, got = list(ref_pipe), list(pipe)
    assert len(got) == len(want) == len(pipe.dataset) > 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    ents = [batch_entropy(lb, K) for lb in got]
    assert ents == [ref_batch_entropy(lb, K) for lb in want]
    snap, ref_snap = stats.snapshot(), ref_stats.snapshot()
    assert {k: snap[k] for k in DIV} == {k: ref_snap[k] for k in DIV}
    assert snap["div_batches"] == len(got)
    assert snap["div_entropy_sum"] == functools.reduce(operator.add, ents, 0.0)
    assert math.isclose(snap["div_entropy_sum"], math.fsum(ents), rel_tol=1e-12)
    assert snap["div_entropy_min"] == min(ents)
    assert pipe.stats()["diversity"] == ref_pipe.stats()["diversity"]
    ref_pipe.close()
    pipe.close()


def test_the_stream_is_the_same_with_and_without_the_monitor(sharded):
    def epoch(obs):
        col = port_open(sharded["uri"], block_rows=32)
        ds = ScIterableDataset(col, BlockShuffling(32), batch_size=32, fetch_factor=4, seed=7,
                               diversity_obs=obs)
        out = [b.to_dense() for b in ds.epochs(2)]
        snap = col.iostats.snapshot()
        col.release()
        return out, snap

    (plain, s0), (watched, s1) = epoch(None), epoch("plate")
    assert len(plain) == len(watched) > 0
    for a, b in zip(plain, watched):
        np.testing.assert_array_equal(a, b)
    assert s0["div_batches"] == 0 and s1["div_batches"] == len(watched)
    for k in ("runs", "rows", "bytes_read", "cache_hits", "cache_misses"):
        assert s0[k] == s1[k], k


def test_a_dropped_duplicate_fetch_counts_in_the_spec_mirrors(sharded):
    """The fetch pool runs a duplicate inside the counters' deferred capture
    and commits it as speculative: its observations land in ``spec_*``."""
    got = []
    for open_fn, cls, strat in ((ref_open, ScDataset, RefBlockShuffling(32)),
                                (port_open, ScIterableDataset, BlockShuffling(32))):
        col = open_fn(sharded["uri"], block_rows=32)
        ds = cls(col, strat, batch_size=32, fetch_factor=4, seed=7, diversity_obs="plate")
        ds.fetch(0, 0)
        with col.iostats.deferred() as pend:
            ds.fetch(0, 0)
        col.iostats.commit(pend, speculative=True)
        got.append({k: col.iostats.snapshot()[k] for k in DIV})
        col.release()
    assert got[1] == got[0]
    assert got[1]["spec_div_batches"] == got[1]["div_batches"] == 4
    assert got[1]["spec_div_entropy_sum"] == got[1]["div_entropy_sum"]


def test_the_monitor_survives_a_pickle(sharded):
    import pickle

    from repro_torch.data import ShardedCSRStore

    store = ShardedCSRStore(sharded["uri"].split("://", 1)[1].split(","))
    ds = ScIterableDataset(store, diversity_obs="plate")  # as a DataLoader worker gets it
    ds._div.num_classes  # resolve, then travel
    back = pickle.loads(pickle.dumps(ds))
    assert back._div.num_classes == K and back._div._lock is not ds._div._lock
    rows = np.arange(64)
    assert back._div.observe(rows) == ds._div.observe(rows)


# ----------------------------------------------------------- the floor
def _cost(mod):
    return mod.IOCostModel(c0=0.0, c_seek=0.05, c_byte=1e-8, row_bytes=2048, n_rows=1e5)


def _rec_fields(r):
    return (r.block_size, r.fetch_factor, r.modeled_samples_per_sec, r.entropy_lower_bound,
            r.buffer_bytes, r.rationale, r.cache_reserved_bytes, r.io_workers, r.readahead,
            r.predicted_entropy)


def test_recommend_respects_the_entropy_floor():
    p = np.full(K, 1 / K)
    floor = distribution_entropy(p) - (K - 1) / (2 * 64 * np.log(2)) - 0.02
    for kw in ({}, {"entropy_floor": floor}, {"entropy_floor": None}):
        got = autotune.recommend(_cost(autotune), batch_size=64, class_probs=p, **kw)
        want = ref_autotune.recommend(_cost(ref_autotune), batch_size=64, class_probs=p, **kw)
        assert _rec_fields(got) == _rec_fields(want)
    tight = autotune.recommend(_cost(autotune), batch_size=64, class_probs=p, entropy_floor=floor)
    free = autotune.recommend(_cost(autotune), batch_size=64, class_probs=p)
    assert tight.predicted_entropy >= floor and "floor" in tight.rationale
    assert tight.modeled_samples_per_sec <= free.modeled_samples_per_sec


def test_an_unreachable_floor_raises_as_the_reference_does():
    p = np.full(K, 1 / K)
    msgs = []
    for mod in (ref_autotune, autotune):
        with pytest.raises(ValueError, match="unreachable") as e:
            mod.recommend(_cost(mod), batch_size=64, class_probs=p,
                          entropy_floor=distribution_entropy(p) + 1.0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_model_drift_flags_an_entropy_shortfall_only():
    got = []
    for mod, stats in ((ref_autotune, IOStats()), (autotune, IOCounters())):
        stats.record_diversity(2.0)
        stats.record_diversity(2.0)
        cost = _cost(mod)
        row = [mod.model_drift(cost, stats, expected_entropy=2.5),
               mod.model_drift(cost, stats, expected_entropy=1.5)]
        base = stats.snapshot()
        stats.record_diversity(0.5)
        row.append(mod.model_drift(cost, stats, base=base, expected_entropy=2.0))
        got.append(row)
    assert got[1] == got[0] == [0.5, 0.0, 1.5]


# ------------------------------------------------------------- the spec
def test_spec_diversity_fields_are_content_free(sharded):
    from repro.pipeline import DataSpec as RefDataSpec

    plain = DataSpec(uri=sharded["uri"], batch_size=32)
    tuned = DataSpec(uri=sharded["uri"], batch_size=32, diversity_obs="plate", entropy_floor=3.5)
    assert plain.fingerprint() == tuned.fingerprint()
    assert tuned.to_json() == RefDataSpec(uri=sharded["uri"], batch_size=32, diversity_obs="plate",
                                          entropy_floor=3.5).to_json()
    back = DataSpec.from_json(tuned.to_json())
    assert (back.diversity_obs, back.entropy_floor) == ("plate", 3.5)
    with pytest.raises(ValueError, match="entropy_floor"):
        DataSpec(uri=sharded["uri"], entropy_floor=-0.1)


def test_builder_threads_diversity_into_the_dataset(sharded):
    def chain(cls):
        return (cls.from_uri(sharded["uri"]).strategy("block", block_size=32)
                .batch(32, fetch_factor=2).diversity(obs="plate", entropy_floor=3.0).build())

    ref_pipe, pipe = chain(RefPipeline), chain(Pipeline)
    assert (pipe.spec.diversity_obs, pipe.spec.entropy_floor) == ("plate", 3.0)
    assert pipe.dataset.diversity_obs == "plate"
    assert pipe.plan_epoch(0) == ref_pipe.plan_epoch(0)
    assert pipe.spec.to_json() == ref_pipe.spec.to_json()
    assert "diversity" not in pipe.stats()  # nothing observed yet
    ref_pipe.close()
    pipe.close()


# ------------------------------------------------------------ under faults
def test_the_counters_and_batches_hold_under_faults_and_hedging(sharded):
    """fault:// with retries, hedged reads, four I/O workers and readahead
    deliver the clean synchronous run's batches and diversity counters, and
    those equal the reference's clean run."""
    uri = sharded["uri"]

    def run(open_fn, cls, strat, uri, **kw):
        col = open_fn(uri, block_rows=32, **kw)
        ds = cls(col, strat, batch_size=32, fetch_factor=4, seed=7, diversity_obs="plate")
        out = [np.asarray(b.to_dense()).copy() for b in ds.epochs(2)]
        snap = col.iostats.snapshot()
        col.release()
        return out, snap

    ref, ref_clean = run(ref_open, ScDataset, RefBlockShuffling(32), uri, cache_bytes=0)
    clean_out, clean = run(port_open, ScIterableDataset, BlockShuffling(32), uri, cache_bytes=0)
    got, snap = run(port_open, ScIterableDataset, BlockShuffling(32), f"fault://{uri}?{FAULT_Q}",
                    cache_bytes=64 << 10, io_workers=4, readahead=2, hedge_factor=1.0,
                    hedge_min_s=0.001, **RETRY_KW)
    assert snap["retries"] > 0  # faults were injected and retried
    assert len(ref) == len(clean_out) == len(got)
    for a, b, c in zip(ref, clean_out, got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert {k: snap[k] for k in DIV} == {k: clean[k] for k in DIV} == {k: ref_clean[k] for k in DIV}
