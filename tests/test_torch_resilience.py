"""The port's resilient storage against the JAX package's on the CPU, the
counterpart of ``tests/test_resilience.py``: fault decisions over a grid of
``(seed, lo, hi, attempt)`` bit for bit, the retry backoff schedule, the
shard circuit's transitions under an injected clock, synchronous
``fault://`` epochs whose batches, retries, breaker transitions and
injection counts equal the reference's, a fault stream that is fatal
without retries (and, at ``retries=0``, a waiter that raises the
producer's failure, as the reference does), the terminal
``RetryBudgetExhausted``, a hedge race decided by an ``Event``, background
prefetch skipping an open shard, the stream bitwise the clean one under
full concurrency, resumption and the fetch pool, and the resilience spec
fields.

Where counters are compared the reads are synchronous (``io_workers`` 1,
no readahead), so every fault decision meets the same attempt ordinals in
both packages; the shard circuit's cooldown is 0 or out of reach, so its
clock decides nothing.  Nothing here asserts a timing."""
import threading
import time

import numpy as np
import pytest

from repro.core import BlockShuffling as RefBlockShuffling
from repro.core import BlockWeightedSampling as RefBlockWeightedSampling
from repro.core import ScDataset
from repro.data import IOStats
from repro.data import faults as ref_faults
from repro.data import open_adapter as ref_open_adapter
from repro.data import open_collection as ref_open
from repro.data.backend import PlannedCollection
from repro.data.synth import write_csr_shard, write_h5ad
from repro.pipeline import DataSpec as RefDataSpec
from repro.pipeline import Pipeline as RefPipeline
from repro_torch.core import BlockShuffling, BlockWeightedSampling, FetchPool, ScIterableDataset
from repro_torch.data import IOCounters, faults, open_adapter, open_collection
from repro_torch.data.backend import PlannedRows
from repro_torch.pipeline import DataSpec, Pipeline

N, G = 2000, 32
FAULT_Q = "seed=5&error_rate=0.15"
RETRY_KW = dict(retries=10, retry_backoff_s=0.0005, retry_max_backoff_s=0.005)
TIMEOUT = 30.0
RES = ("runs", "rows", "bytes_read", "cache_hits", "cache_misses", "requests", "retries",
       "retry_wait_s", "breaker_opens", "breaker_closes", "hedges_issued", "hedges_won")


@pytest.fixture(autouse=True)
def _witness(lock_order_witness):
    yield


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    """The same cells as csr, two-shard csr, h5ad (shim) and cloud h5ad."""
    rng = np.random.default_rng(17)
    root = tmp_path_factory.mktemp("resilience")
    lens = rng.integers(1, 5, N)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate([np.sort(rng.choice(G, int(k), replace=False)) for k in lens])
    indices = indices.astype(np.int32)
    data = rng.normal(size=int(indptr[-1])).astype(np.float32)
    obs = {"cell_line": rng.integers(0, 5, N).astype(np.int32)}
    half = indptr[N // 2]
    s0, s1 = str(root / "s0"), str(root / "s1")
    write_csr_shard(s0, data[:half], indices[:half], indptr[: N // 2 + 1], G,
                    {k: v[: N // 2] for k, v in obs.items()})
    write_csr_shard(s1, data[half:], indices[half:], indptr[N // 2:] - half, G,
                    {k: v[N // 2:] for k, v in obs.items()})
    h5ad = str(root / "cells.h5ad")
    write_h5ad(h5ad, data, indices, indptr, G, obs)
    return {
        "csr": f"csr://{s0}",
        "sharded-csr": f"sharded-csr://{s0},{s1}",
        "h5ad": f"h5ad://{h5ad}?driver=shim",
        "cloud-h5ad": f"cloud://h5ad://{h5ad}?driver=shim&profile=same-region&latency_scale=0",
    }


def _faulty(uri, q=FAULT_Q):
    return f"fault://{uri}{'&' if '?' in uri else '?'}{q}"


def _dense(b):
    return b.to_dense().copy()


def _epochs(open_fn, cls, strat, uri, n=1, **kw):
    col = open_fn(uri, **kw)
    ds = cls(col, strat, batch_size=32, fetch_factor=4, seed=7)
    out = [_dense(b) for b in ds.epochs(n)]
    snap, stats = col.iostats.snapshot(), col.stats()
    col.release()
    return out, snap, stats


def _same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------- deterministic decisions
def test_fault_decisions_equal_the_reference_bitwise():
    grid = [(seed, lo, lo + w, att) for seed in (0, 3, 2**40 + 7) for lo in (0, 64, 1000, 2**33)
            for w in (1, 64, 4096) for att in range(4)]
    for seed, lo, hi, att in grid:
        assert faults.mix_u01(seed, 1, lo, hi, att) == ref_faults.mix_u01(seed, 1, lo, hi, att)
    kw = dict(error_rate=0.3, spike_rate=0.5, spike_s=0.01, stuck_row=70, stuck_s=0.2, scale=0.5)
    for spike_on_retries in (True, False):
        for seed in (0, 3, 9):
            p = faults.FaultProfile(seed=seed, spike_on_retries=spike_on_retries, **kw)
            q = ref_faults.FaultProfile(seed=seed, spike_on_retries=spike_on_retries, **kw)
            for _, lo, hi, att in grid:
                assert p.transient(lo, hi, att) == q.transient(lo, hi, att)
                assert p.spike(lo, hi, att) == q.spike(lo, hi, att)
                assert p.stuck(lo, hi, att) == q.stuck(lo, hi, att)
    draws = [faults.FaultProfile(seed=3, error_rate=0.3).transient(lo, lo + 64, 0)
             for lo in range(0, 64_000, 64)]
    assert 0.2 < np.mean(draws) < 0.4


def test_fault_profile_refuses_what_the_reference_refuses(backends):
    for kw in ({"error_rate": 2.0}, {"spike_rate": -0.1}, {"scale": -1.0},
               {"blackouts": ((0, 10, 5),)}):
        with pytest.raises(ValueError) as ea:
            ref_faults.FaultProfile(**kw)
        with pytest.raises(ValueError) as eb:
            faults.FaultProfile(**kw)
        assert str(ea.value) == str(eb.value)
    for q in ("error_rate=2.0", "blackout=banana", "spike_on_retries=maybe"):
        with pytest.raises(ValueError) as ea:
            ref_open(_faulty(backends["csr"], q))
        with pytest.raises(ValueError) as eb:
            open_collection(_faulty(backends["csr"], q))
        assert str(ea.value) == str(eb.value), q


def test_retry_backoff_equals_the_reference():
    for seed in (0, 2):
        pol = faults.RetryPolicy(retries=8, backoff_s=0.001, max_backoff_s=0.05, seed=seed)
        ref = ref_faults.RetryPolicy(retries=8, backoff_s=0.001, max_backoff_s=0.05, seed=seed)
        prev = 0.0
        for k in range(8):
            d = pol.backoff(100, 200, k, prev)
            assert d == ref.backoff(100, 200, k, prev)
            assert 0.001 <= d <= min(0.05, max(3.0 * prev, 0.001)) + 1e-12
            prev = d
    assert faults.RetryPolicy().enabled is False and faults.RetryPolicy(retries=1).enabled


def test_circuit_transitions_equal_the_reference_under_an_injected_clock():
    t = [0.0]
    ours = faults.ShardCircuit(threshold=2, cooldown_s=1.0, clock=lambda: t[0])
    theirs = ref_faults.ShardBreaker(threshold=2, cooldown_s=1.0, clock=lambda: t[0])
    script = [("admit", 0), ("fail", 0), ("fail", 0), ("open", 0), ("admit", 0), ("at", 1.5),
              ("admit", 0), ("admit", 0), ("ok", 0), ("open", 0), ("fail", 1), ("fail", 1),
              ("at", 2.6), ("admit", 1), ("fail", 1), ("at", 3.0), ("admit", 1), ("at", 3.7),
              ("admit", 1), ("ok", 1), ("ok", 3), ("fail", 2)]
    got, want = [], []
    for op, arg in script:
        if op == "at":
            t[0] = arg
            continue
        for br, out in ((ours, got), (theirs, want)):
            out.append({"admit": br.admit, "fail": br.record_failure, "ok": br.record_success,
                        "open": br.is_open}[op](arg))
        assert ours.snapshot() == theirs.snapshot()
    assert got == want
    assert ours.snapshot() == {"open_shards": [], "opens": 2, "closes": 2, "threshold": 2,
                               "cooldown_s": 1.0}
    with pytest.raises(ValueError):
        faults.ShardCircuit(threshold=0, cooldown_s=1.0)


# --------------------------------------------- synchronous fault:// epochs
@pytest.mark.parametrize("backend", ["csr", "sharded-csr", "h5ad", "cloud-h5ad"])
def test_a_synchronous_fault_epoch_equals_the_reference(backends, backend):
    """Weighted sampling over a small cache, faults retried, reads in plan
    order: batches, counters and injections are the reference's."""
    uri = backends[backend]
    n = len(open_adapter(uri))
    weights = np.random.default_rng(0).random(n) ** 3 + 1e-3
    kw = dict(block_rows=32, cache_bytes=64 << 10, **RETRY_KW)
    want, ref_snap, ref_stats = _epochs(ref_open, ScDataset,
                                        RefBlockWeightedSampling(block_size=32, weights=weights),
                                        _faulty(uri), n=2, **kw)
    got, snap, stats = _epochs(open_collection, ScIterableDataset,
                               BlockWeightedSampling(block_size=32, weights=weights),
                               _faulty(uri), n=2, **kw)
    clean, _, _ = _epochs(ref_open, ScDataset,
                          RefBlockWeightedSampling(block_size=32, weights=weights), uri, n=2,
                          block_rows=32, cache_bytes=0)
    _same(want, got)
    _same(clean, got)
    assert {k: snap[k] for k in RES} == {k: ref_snap[k] for k in RES}
    assert snap["retries"] > 0
    assert stats["faults"] == ref_stats["faults"]
    assert stats["resilience"]["retry"] == ref_stats["resilience"]["retry"]


@pytest.mark.parametrize("cooldown_s", [0.0, 60.0])
def test_a_shard_blackout_epoch_equals_the_reference(backends, cooldown_s):
    """Shard 1 fails its ops 5 to 10: the circuit opens and closes as the
    reference's does (a cooldown of 0 always admits a probe, one of 60 s
    never does within the epoch), and the epoch is delivered exactly."""
    uri = _faulty(backends["sharded-csr"], "seed=5&blackout=1:5:11")
    kw = dict(block_rows=32, cache_bytes=64 << 10, breaker_threshold=3,
              breaker_cooldown_s=cooldown_s, **RETRY_KW)
    want, ref_snap, ref_stats = _epochs(ref_open, ScDataset, RefBlockShuffling(32), uri, **kw)
    got, snap, stats = _epochs(open_collection, ScIterableDataset, BlockShuffling(32), uri, **kw)
    _same(want, got)
    assert {k: snap[k] for k in RES} == {k: ref_snap[k] for k in RES}
    assert snap["breaker_opens"] >= 1 and snap["breaker_closes"] >= 1
    assert stats["resilience"]["breaker"] == ref_stats["resilience"]["breaker"]
    assert stats["resilience"]["breaker"]["open_shards"] == []


def test_without_retries_the_fault_stream_is_fatal_as_in_the_reference(backends):
    errs = []
    for open_fn, cls, strat in ((ref_open, ScDataset, RefBlockShuffling(32)),
                                (open_collection, ScIterableDataset, BlockShuffling(32))):
        col = open_fn(_faulty(backends["csr"]), cache_bytes=0, block_rows=32)
        with pytest.raises(OSError) as e:
            for _ in cls(col, strat, batch_size=32, fetch_factor=4, seed=7):
                pass
        errs.append((type(e.value).__name__, str(e.value), col.iostats.snapshot()["calls"]))
        col.release()
    assert errs[0] == errs[1]


class GatedAdapter:
    """A duck-typed reader for either package's planner: every read waits
    for ``gate``; the first ``fail`` reads raise ``OSError``."""

    def __init__(self, inner, fail: int):
        self.inner, self.fail, self.reads = inner, fail, 0
        self.gate = threading.Event()
        self._l = threading.Lock()

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, k):
        return getattr(self.inner, k)

    def read_range(self, start, stop):
        with self._l:
            self.reads += 1
            failing = self.fail != 0
            self.fail -= self.fail > 0
        assert self.gate.wait(TIMEOUT)
        if failing:
            raise OSError(f"injected failure of [{start}, {stop})")
        return self.inner.read_range(start, stop)


@pytest.mark.parametrize("retries", [0, 1])
def test_a_waiter_on_a_failed_read_behaves_as_the_reference(backends, retries):
    """A staged read fails while a fetch waits on it.  With no retry policy
    the fetch raises the producer's failure; under one, it makes one
    recovery read.  Both packages, the same outcome and the same reads."""
    rows = np.arange(130, 180)
    out = []
    for planner, opener in ((PlannedCollection, ref_open_adapter), (PlannedRows, open_adapter)):
        reader = GatedAdapter(opener(backends["csr"]), fail=1 + retries)
        col = planner(reader, block_rows=64, io_workers=2, readahead=1, retries=retries,
                      retry_backoff_s=1e-4, retry_max_backoff_s=1e-3)
        assert col.prefetch(rows) == 1
        box = {}

        def fetch():
            try:
                box["value"] = col.fetch(rows)
            except BaseException as e:  # the outcome under test
                box["error"] = e

        t = threading.Thread(target=fetch)
        t.start()
        fut = col._inflight[130 // 64]
        deadline = time.monotonic() + TIMEOUT  # a guard, not a measurement
        while not fut._condition._waiters and time.monotonic() < deadline:
            time.sleep(0.001)  # until the fetch waits on the staged read's future
        reader.gate.set()
        t.join(TIMEOUT)
        err = box.get("error")
        out.append((type(err).__name__ if err else None, reader.reads,
                    None if err else box["value"].to_dense()))
        col.close()
    (ref_err, ref_reads, ref_val), (err, reads, val) = out
    assert (err, reads) == (ref_err, ref_reads)
    if retries == 0:
        assert err == "OSError" and reads == 1
    else:
        assert err is None and reads == 3
        np.testing.assert_array_equal(val, ref_val)


def test_the_retry_budget_runs_out_terminally(backends):
    uri = _faulty(backends["csr"], "seed=1&error_rate=1.0")
    got = []
    for open_fn, mod in ((ref_open, ref_faults), (open_collection, faults)):
        col = open_fn(uri, cache_bytes=0, block_rows=32, retries=2, retry_backoff_s=1e-4,
                      retry_max_backoff_s=1e-3)
        with pytest.raises(mod.RetryBudgetExhausted) as e:
            col.fetch(np.arange(64))
        assert isinstance(e.value.__cause__, mod.TransientStorageError)
        assert not mod.is_transient(e.value) and mod.is_transient(e.value.__cause__)
        got.append((str(e.value), col.iostats.snapshot()["retries"]))
        col.release()
    assert got[0] == got[1] and got[1][1] == 2
    col = open_collection(uri, cache_bytes=0, block_rows=32, retries=10_000,
                          retry_backoff_s=0.02, retry_max_backoff_s=0.02, retry_deadline_s=0.05)
    with pytest.raises(faults.RetryBudgetExhausted, match="deadline"):
        col.fetch(np.arange(64))
    col.release()


# ------------------------------------------------------------ hedged reads
class FirstReadHangs:
    """The first read of each span waits for ``release``; a later read of
    the same span (the hedge) returns at once."""

    def __init__(self, inner):
        self.inner = inner
        self.release = threading.Event()
        self.seen: set = set()
        self._l = threading.Lock()

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, k):
        return getattr(self.inner, k)

    def read_range(self, start, stop):
        with self._l:
            first = (start, stop) not in self.seen
            self.seen.add((start, stop))
        if first:
            assert self.release.wait(TIMEOUT)
        return self.inner.read_range(start, stop)


def test_a_hedge_race_decided_by_an_event(backends):
    """Every primary hangs until released, so every span is hedged and
    every hedge wins; the bytes are the plain read's."""
    reader = FirstReadHangs(open_adapter(backends["sharded-csr"]))
    col = PlannedRows(reader, cache_bytes=0, block_rows=32, io_workers=4, hedge_factor=1.0,
                      hedge_min_s=0.001)
    rows = np.arange(0, N, 7)
    got = col.fetch(rows)
    snap = col.iostats.snapshot()
    spans = len(col.plan(rows))
    reader.release.set()
    col.close()
    np.testing.assert_array_equal(got.to_dense(),
                                  open_collection(backends["sharded-csr"]).fetch(rows).to_dense())
    assert spans == 2  # one span a shard: the hung primaries hold 2 of the 4 workers
    assert snap["hedges_issued"] == snap["hedges_won"] == spans == snap["runs"]


def test_first_success_takes_the_first_to_succeed():
    from concurrent.futures import Future

    def futures(primary, hedge):
        fs = []
        for outcome in (primary, hedge):
            f = Future()
            if isinstance(outcome, BaseException):
                f.set_exception(outcome)
            elif outcome is not None:
                f.set_result(outcome)
            fs.append(f)
        return fs

    race = PlannedRows._first_success
    assert race(*futures("p", "h")) == ("p", False)  # a tie goes to the primary
    assert race(*futures(OSError("p"), "h")) == ("h", True)
    assert race(*futures("p", OSError("h"))) == ("p", False)
    with pytest.raises(OSError, match="h"):
        race(*futures(OSError("p"), OSError("h")))
    primary, hedge = futures(None, None)
    done = threading.Event()
    box = {}
    t = threading.Thread(target=lambda: (box.update(r=race(primary, hedge)), done.set()))
    t.start()
    hedge.set_result("h")  # the primary is still running
    assert done.wait(TIMEOUT) and box["r"] == ("h", True)
    primary.set_result("p")
    t.join(TIMEOUT)


# ----------------------------------------------------------------- circuit
def test_prefetch_skips_open_shards(backends):
    got = []
    for open_fn in (ref_open, open_collection):
        col = open_fn(backends["sharded-csr"], cache_bytes=1 << 20, block_rows=32, io_workers=2,
                      breaker_threshold=1, breaker_cooldown_s=60.0, retries=1)
        col._breaker.record_failure(1)
        assert col._breaker.is_open(1)
        got.append(col.prefetch(np.arange(N)))
        shard0 = sum(1 for b in range(-(-N // 32)) if col._shard_of(b * 32) == 0)
        col.release()
    assert got[0] == got[1] and 0 < got[1] <= shard0


# ------------------------------------------------ the stream under chaos
def test_the_stream_under_full_concurrency_is_the_clean_one(backends):
    uri = backends["sharded-csr"]
    want, _, _ = _epochs(ref_open, ScDataset, RefBlockShuffling(32), uri, n=2, cache_bytes=0,
                         block_rows=32)
    got, snap, _ = _epochs(open_collection, ScIterableDataset, BlockShuffling(32), _faulty(uri),
                           n=2, cache_bytes=64 << 10, block_rows=32, io_workers=4, readahead=2,
                           hedge_factor=1.0, hedge_min_s=0.001, **RETRY_KW)
    _same(want, got)
    assert snap["retries"] > 0


def test_the_fetch_pool_across_epochs_under_faults(backends):
    uri = backends["sharded-csr"]
    want, _, _ = _epochs(ref_open, ScDataset, RefBlockShuffling(32), uri, n=2, cache_bytes=0,
                         block_rows=32)
    col = open_collection(_faulty(uri), cache_bytes=64 << 10, block_rows=32, io_workers=4,
                          readahead=2, **RETRY_KW)
    ds = ScIterableDataset(col, BlockShuffling(32), batch_size=32, fetch_factor=4, seed=7,
                           cross_epoch_prefetch=True)
    got = []
    for _ in range(2):  # a fresh pool each epoch over the same collection
        got.extend(_dense(b) for b in FetchPool(ds, num_workers=2))
    assert col.iostats.snapshot()["retries"] > 0
    col.release()
    _same(want, got)


def test_midepoch_resume_under_faults(backends):
    uri = _faulty(backends["h5ad"])

    def make():
        col = open_collection(uri, cache_bytes=64 << 10, block_rows=32, io_workers=2,
                              readahead=1, **RETRY_KW)
        return col, ScIterableDataset(col, BlockShuffling(32), batch_size=32, fetch_factor=2,
                                      seed=11)

    full = [_dense(b) for b in ScDataset(ref_open(backends["h5ad"], cache_bytes=0, block_rows=32),
                                         RefBlockShuffling(32), batch_size=32, fetch_factor=2,
                                         seed=11)]
    col1, ds1 = make()
    it = iter(ds1)
    consumed = [next(it) for _ in range(5)]  # mid-fetch
    state = ds1.state()
    col1.release()
    col2, ds2 = make()
    ds2.load_state(state)
    rest = [_dense(b) for b in ds2]
    col2.release()
    _same(full[len(consumed):], rest)


# ---------------------------------------------------- counters and the spec
def test_resilience_counters_pair_with_spec_mirrors():
    got = []
    for st in (IOStats(), IOCounters()):
        st.record_resilience(retries=2, retry_wait_s=0.5, hedges_issued=3, hedges_won=1,
                             breaker_opens=1, breaker_closes=1)
        with st.deferred() as pend:
            st.record_resilience(retries=4, retry_wait_s=0.25, hedges_issued=1)
        st.commit(pend, speculative=True)
        got.append(st.snapshot())
        st.reset()
        assert all(v == 0 for k, v in st.snapshot().items() if "retr" in k or "hedge" in k
                   or "breaker" in k)
    keys = [k for k in got[0] if "retr" in k or "hedge" in k or "breaker" in k]
    assert {k: got[1][k] for k in keys} == {k: got[0][k] for k in keys}
    assert (got[1]["retries"], got[1]["spec_retries"], got[1]["spec_retry_wait_s"]) == (2, 4, 0.25)


def test_spec_resilience_fields_are_content_free(backends):
    def chain(cls):
        return (cls.from_uri(backends["csr"], cache_bytes=1 << 20).strategy("block", block_size=32)
                .batch(32).seed(0))

    hard, ref_hard = chain(Pipeline), chain(RefPipeline)
    for b in (hard, ref_hard):
        b.resilience(retries=5, backoff_s=0.01, max_backoff_s=0.1, deadline_s=2.0,
                     hedge_factor=2.0, hedge_min_s=0.01, breaker_threshold=3,
                     breaker_cooldown_s=0.5)
    s = hard.spec
    assert s.to_json() == ref_hard.spec.to_json()
    assert chain(Pipeline).spec.fingerprint() == s.fingerprint()
    assert DataSpec.from_json(s.to_json()) == s
    hard.resilience(retries=7)
    assert (hard.spec.retries, hard.spec.hedge_factor) == (7, 2.0)
    for bad in ({"retries": -1}, {"hedge_min_s": 0.0}):
        with pytest.raises(ValueError):
            DataSpec(uri="csr:///x", **bad)
        with pytest.raises(ValueError):
            RefDataSpec(uri="csr:///x", **bad)


def test_pipeline_resilience_reaches_the_collection(backends):
    def build(cls):
        return (cls.from_uri(_faulty(backends["csr"]), cache_bytes=1 << 20, block_rows=32)
                .strategy("block", block_size=32).batch(32).seed(0)
                .resilience(retries=10, backoff_s=0.0005, max_backoff_s=0.005,
                            breaker_threshold=4, breaker_cooldown_s=0.0).build())

    ref_pipe, pipe = build(RefPipeline), build(Pipeline)
    for a, b in zip(ref_pipe, pipe):
        np.testing.assert_array_equal(a.to_dense(), b.to_dense())
    st, ref_st = pipe.stats(), ref_pipe.stats()
    assert st["resilience"]["retry"] == ref_st["resilience"]["retry"]
    assert st["resilience"]["breaker"] == ref_st["resilience"]["breaker"]
    assert st["faults"] == ref_st["faults"] and st["faults"]["reads"] > 0
    assert {k: st["io"][k] for k in RES} == {k: ref_st["io"][k] for k in RES}
    assert st["io"]["retries"] > 0 and len(pipe) == len(ref_pipe)
    assert sorted(st) == sorted(ref_st)
    ref_pipe.close()
    pipe.close()
