"""The port's I/O counters (``repro_torch.data.iostats``) against the JAX
package's ``IOStats`` on the CPU: the same sequences of recordings, deferred
captures, commits, merges and resets give equal snapshots at every step,
key for key; the storage models are the reference's.  No sleeping: the
simulated latency runs at scale 0, and the slept path at a 1 ns model."""
import dataclasses
import pickle
import threading

import numpy as np
import pytest

from repro.data import iostats as ref
from repro_torch.data import iostats as port

MODELS = ("SATA_SSD", "NVME_SSD", "CLOUD_OBJECT")


def _pair(**kw):
    """(reference, port) counters with the same storage model."""
    model = kw.pop("model", None)
    return (ref.IOStats(simulate=getattr(ref, model) if model else None, **kw),
            port.IOCounters(simulate=getattr(port, model) if model else None, **kw))


def _same(a, b):
    sa, sb = a.snapshot(), b.snapshot()
    assert list(sa) == list(sb)
    assert sa == sb


def test_snapshot_keys_equal_the_reference():
    assert list(port.IOCounters().snapshot()) == list(ref.IOStats().snapshot())
    assert ([f.name for f in dataclasses.fields(port.PendingCounters)]
            == [f.name for f in dataclasses.fields(ref.PendingIO)])


@pytest.mark.parametrize("name", MODELS)
def test_storage_models_equal_the_reference(name):
    a, b = getattr(ref, name), getattr(port, name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for runs, nbytes in ((0, 0), (1, 4096), (37, 123_456_789)):
        assert a.seconds(runs, nbytes) == b.seconds(runs, nbytes)


def _ops(seed: int, n: int = 40):
    """A seeded sequence of recordings: (kind, kwargs)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(["record", "record", "background", "request", "deferred", "reset"],
                          p=[0.35, 0.15, 0.15, 0.15, 0.15, 0.05])
        kw = dict(runs=int(rng.integers(0, 9)), rows=int(rng.integers(0, 500)),
                  bytes_read=int(rng.integers(0, 1 << 20)), wall_s=float(rng.random()),
                  cache_hits=int(rng.integers(0, 5)), cache_misses=int(rng.integers(0, 5)),
                  prefetched=int(rng.integers(0, 3)), adm_bypassed=int(rng.integers(0, 3)),
                  adm_rejected=int(rng.integers(0, 3)))
        out.append((str(kind), kw, bool(rng.random() < 0.5), int(rng.integers(1, 4)),
                    float(rng.random())))
    return out


def _apply(stats, op):
    kind, kw, speculative, n, wait = op
    if kind == "record":
        stats.record(**kw)
    elif kind == "background":
        stats.record(**{**kw, "rows": 0}, calls=0, slept=True)
    elif kind == "request":
        stats.record_request(n, wait_s=wait)
    elif kind == "deferred":
        with stats.deferred() as pend:
            stats.record(**kw)
            stats.record_request(n, wait_s=wait)
        stats.commit(pend, speculative=speculative)
    else:
        stats.reset()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("model", [None, "NVME_SSD"])
def test_recording_sequences_equal_the_reference(seed, model):
    a, b = _pair(model=model, simulate_scale=0.0)
    for op in _ops(seed):
        _apply(a, op)
        _apply(b, op)
        _same(a, b)
        assert a.cache_hit_rate == b.cache_hit_rate
        assert a.total_seconds() == b.total_seconds()


def test_merge_child_and_scoped_equal_the_reference():
    a, b = _pair(model="CLOUD_OBJECT", simulate_scale=0.0)
    ca, cb = a.child(), b.child()
    assert (ca.simulate, ca.simulate_scale) == (a.simulate, a.simulate_scale)
    for stats, child in ((a, ca), (b, cb)):
        for op in _ops(7, 12):
            with stats.scoped(child):
                _apply(stats, op)
        stats.record(runs=2, rows=3, bytes_read=5, wall_s=0.5)
        stats.merge(child)
    _same(ca, cb)
    _same(a, b)
    assert b.snapshot()["runs"] == cb.snapshot()["runs"] + 2


def test_deferred_nesting_and_speculative_commit():
    for stats in _pair():
        with stats.deferred() as pend:
            with pytest.raises(RuntimeError):
                with stats.deferred():
                    pass
            stats.record(runs=3, rows=4, bytes_read=10, wall_s=0.0)
        assert stats.snapshot()["runs"] == 0  # captured, not yet committed
        stats.commit(pend, speculative=True)
        snap = stats.snapshot()
        assert (snap["runs"], snap["spec_runs"], snap["spec_calls"]) == (0, 3, 1)


def test_borrowed_pending_captures_a_pool_threads_requests():
    """A pool thread reading for a deferred fetch records into the fetch's
    buffer, not into the totals."""
    a, b = _pair()
    for stats in (a, b):
        with stats.deferred() as pend:
            def read():
                with stats.borrowed_pending(pend):
                    stats.record_request(2, wait_s=0.25)
            t = threading.Thread(target=read)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert stats.snapshot()["requests"] == 0
        stats.commit(pend)
        assert stats.current_pending() is None
    _same(a, b)
    assert b.snapshot()["requests"] == 2


def test_slept_latency_and_pickling():
    model = port.StorageModel("tiny", seek_s=1e-9, bw_Bps=1e12)
    stats = port.IOCounters(simulate=model, simulate_scale=0.5)
    stats.sleep_for(runs=3, bytes_read=1000)
    stats.record(runs=2, rows=1, bytes_read=1000, wall_s=0.25)
    modeled = model.seconds(2, 1000)
    assert stats.snapshot()["modeled_s"] == modeled
    assert stats.total_seconds() == 0.25 + modeled * 0.5
    back = pickle.loads(pickle.dumps(stats))
    assert back == stats and back.snapshot() == stats.snapshot()
    back.record(runs=1, rows=1, bytes_read=1, wall_s=0.0)  # its lock was rebuilt
    assert back.snapshot()["runs"] == 3
