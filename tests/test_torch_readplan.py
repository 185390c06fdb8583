"""The port's read planner (``repro_torch.data.readplan``) against the JAX
package's on the CPU: the span functions are bitwise equal on seeded
inputs, and the caches, the frequency sketch, the stream detector and the
readahead controller, driven through the same operation sequences with no
threads, give equal results and snapshots at every step."""
import types

import numpy as np
import pytest

from repro.data import readplan as ref
from repro_torch.data import readplan as port

SEEDS = range(5)


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_span_functions_are_bitwise_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 3000))
    rows = rng.integers(0, n, int(rng.integers(0, 400)))
    bounds = np.unique(np.concatenate(([0, n], rng.integers(1, n, int(rng.integers(0, 9))))))
    uniq = np.unique(rows)
    _same_array(ref.coalesce_rows(uniq), port.coalesce_rows(uniq))
    runs = ref.coalesce_rows(uniq)
    for b in (None, bounds, np.array([0, n])):
        _same_array(ref.split_at_boundaries(runs, b), port.split_at_boundaries(runs, b))
    for m in (None, 0, 1, 7, 64):
        _same_array(ref.split_max_extent(runs, m), port.split_max_extent(runs, m))
        _same_array(ref.plan_reads(rows, boundaries=bounds, max_extent_rows=m),
                    port.plan_reads(rows, boundaries=bounds, max_extent_rows=m))
    for B in (1, 16, 256):
        blocks = ref.block_ids_of(rows, B)
        _same_array(blocks, port.block_ids_of(rows, B))
        _same_array(ref.blocks_to_row_spans(blocks, B, n), port.blocks_to_row_spans(blocks, B, n))
    # span-shaped inputs of other spellings
    listed = [tuple(s) for s in runs.tolist()]
    _same_array(ref.split_max_extent(listed, 5), port.split_max_extent(listed, 5))


def test_readahead_grammar_equals_the_reference():
    for v in (0, 3, "auto", "7", 2.0):
        assert port.normalize_readahead(v) == ref.normalize_readahead(v)
    for bad in (-1, "x", True, 1.5, "-2"):
        for fn in (port.normalize_readahead, ref.normalize_readahead):
            with pytest.raises(ValueError):
                fn(bad)


CACHES = {"lru": (ref.BlockCache, port.RowBlockCache),
          "wtinylfu": (ref.SegmentedBlockCache, port.SegmentedRowBlockCache)}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("policy", sorted(CACHES))
def test_caches_follow_the_reference_op_by_op(policy, seed):
    """Random get/peek/put/put_admit/discard/bypass/clear sequences over a
    small key space with values of mixed sizes; one shared sketch drives
    both caches' duels."""
    rng = np.random.default_rng(seed)
    budget = int(rng.choice([0, 200, 1000, 4000]))
    a, b = (cls(budget) for cls in CACHES[policy])
    sketch = ref.FrequencySketch(width=64)
    for step in range(400):
        key = int(rng.integers(0, 40))
        op = rng.choice(["get", "peek", "put", "admit", "discard", "bypass", "clear"],
                        p=[0.3, 0.1, 0.2, 0.3, 0.05, 0.04, 0.01])
        nb = int(rng.choice([8, 40, 120, 300, 5000]))
        sketch.touch(key)
        if op == "get":
            assert a.get(key) == b.get(key), step
        elif op == "peek":
            assert a.peek(key) == b.peek(key), step
        elif op == "put":
            a.put(key, ("v", key, step), nb)
            b.put(key, ("v", key, step), nb)
        elif op == "admit":
            assert (a.put_admit(key, ("v", key, step), nb, sketch.estimate)
                    == b.put_admit(key, ("v", key, step), nb, sketch.estimate)), step
        elif op == "discard":
            a.discard(key)
            b.discard(key)
        elif op == "bypass":
            a.bypass(2)
            b.bypass(2)
        else:
            a.clear()
            b.clear()
        assert a.snapshot() == b.snapshot(), step
        assert len(a) == len(b) and a.hit_rate == b.hit_rate
    assert a.snapshot()["insertions"] > 0 or budget == 0


def test_lru_byte_budget_and_disabled_cache():
    """The reference's own LRU cases (tests/test_backend.py) on the port."""
    cache = port.RowBlockCache(max_bytes=100)
    a = np.zeros(10, np.float32)  # 40 bytes
    cache.put(0, a, a.nbytes)
    cache.put(1, a, a.nbytes)
    assert cache.get(0) is a and cache.cur_bytes == 80
    cache.put(2, a, a.nbytes)  # evicts key 1, the least recently used
    assert cache.evictions == 1 and cache.cur_bytes == 80
    assert cache.get(1) is None and cache.get(2) is a
    big = np.zeros(100, np.float32)
    cache.put(3, big, big.nbytes)  # larger than the budget: not cached
    assert cache.get(3) is None
    snap = cache.snapshot()
    assert snap["hits"] == 2 and snap["misses"] == 2 and snap["insertions"] == 3
    off = port.RowBlockCache(max_bytes=0)
    off.put(0, "x", 1)
    assert off.get(0) is None and len(off) == 0
    with pytest.raises(ValueError):
        port.SegmentedRowBlockCache(100, window_frac=1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_frequency_sketch_follows_the_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = ref.FrequencySketch(width=32, reset_interval=97), port.BlockFrequencySketch(
        width=32, reset_interval=97)
    for step in range(300):
        keys = np.unique(rng.integers(0, 60, int(rng.integers(1, 12))))
        if rng.random() < 0.5:
            a.touch_many(keys)
            b.touch_many(keys)
        else:
            for k in keys.tolist():
                a.touch(k)
                b.touch(k)
        assert np.array_equal(a.table, b.table) and a.door == b.door, step
        assert (a.ops, a.ages) == (b.ops, b.ages)
        for k in range(0, 60, 7):
            assert a.estimate(k) == b.estimate(k)
    assert b.ages > 0
    with pytest.raises(ValueError):
        port.BlockFrequencySketch(width=48)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_detector_follows_the_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = ref.StreamDetector(), port.ForwardStreamDetector()
    hi = 0
    for step in range(200):
        r = rng.random()
        if r < 0.6:  # a forward contiguous fetch
            lo = hi + int(rng.integers(0, 2))
            blocks = np.arange(lo, lo + int(rng.integers(1, 6)))
        elif r < 0.95:
            blocks = np.unique(rng.integers(0, 500, int(rng.integers(1, 6))))
        else:
            a.reset()
            b.reset()
            continue
        hi = int(blocks[-1])
        assert a.observe(blocks) == b.observe(blocks), step
        assert (a.streak, a.streaming) == (b.streak, b.streaming)


@pytest.mark.parametrize("seed", SEEDS)
def test_readahead_controller_follows_the_reference(seed):
    """Explicit observations: fetch sizes, in-flight counts, per-read waits
    crossing the 2 ms floor and doubling, and eviction pressure set by hand
    on a shared stand-in cache — no timing anywhere."""
    rng = np.random.default_rng(seed)
    cache = types.SimpleNamespace(evictions=0, rejections=0, max_bytes=int(rng.integers(1, 20)) << 20)
    a = ref.ReadaheadController(cache, max_depth=int(rng.integers(1, 9)), interval=int(rng.integers(1, 5)))
    b = port.ReadaheadDepth(cache, max_depth=a.max_depth, interval=a.interval)
    assert a.snapshot() == b.snapshot()
    for step in range(300):
        if rng.random() < 0.1:
            cache.evictions += int(rng.integers(0, 3))
            cache.rejections += int(rng.integers(0, 2))
        if rng.random() < 0.03:
            a.epoch_boundary()
            b.epoch_boundary()
        wait = float(rng.choice([0.0, 0.0005, 0.001, 0.003, 0.008, 0.02]))
        obs = (float(rng.integers(1, 4) << 20), int(rng.integers(1, 40)),
               int(rng.integers(0, 80)), wait)
        assert a.observe(*obs) == b.observe(*obs), step
        assert a.snapshot() == b.snapshot(), step
        assert b.min_depth <= b.depth <= b.max_depth
    with pytest.raises(ValueError):
        port.ReadaheadDepth(cache, min_depth=3, max_depth=2)
