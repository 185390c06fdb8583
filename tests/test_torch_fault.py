"""The port's liveness monitor against the JAX package's heartbeat monitor
on the CPU, the counterpart of the heartbeat tests of
``tests/test_fault_tolerance.py``: beats, suspects and alive members at the
timeout's edges, a suspect that beats again, and a ``FetchPool`` worker
wedged in a read whose fetch is issued again because the monitor suspects
it.

Each monitor reads ``time.monotonic`` through its module's ``time``
attribute; the tests install one stand-in clock there, so no test sleeps
for a timeout, and the wedged read waits on an ``Event``."""
import threading
import time
import types

import numpy as np
import pytest

import repro.distributed.fault as ref_fault
from repro.data.synth import write_csr_shard
from repro_torch.core import BlockShuffling, FetchPool, ScIterableDataset
from repro_torch.data import open_collection
from repro_torch.data.backend import PlannedRows
from repro_torch.distributed import fault
from repro_torch.distributed.fault import LivenessMonitor

TIMEOUT = 30.0


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (ref_fault, fault):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=c.monotonic))
    return c


def _pair():
    return ref_fault.HeartbeatMonitor(timeout_s=0.05), LivenessMonitor(timeout_s=0.05)


def _views(hb):
    return sorted(hb.suspects()), sorted(hb.alive())


def test_beats_suspects_and_alive_equal_the_reference(clock):
    monitors = _pair()
    for hb in monitors:
        hb.beat("w0")
        hb.beat("w1")
    assert [_views(hb) for hb in monitors] == [([], ["w0", "w1"])] * 2
    clock.t += 0.05  # exactly the timeout: still alive
    assert [_views(hb) for hb in monitors] == [([], ["w0", "w1"])] * 2
    clock.t += 0.03
    for hb in monitors:
        hb.beat("w1")
    assert [_views(hb) for hb in monitors] == [(["w0"], ["w1"])] * 2


def test_a_suspect_recovers_on_its_beat(clock):
    monitors = _pair()
    for hb in monitors:
        hb.beat("w0")
    clock.t += 0.08
    assert [_views(hb) for hb in monitors] == [(["w0"], [])] * 2
    for hb in monitors:
        hb.beat("w0")  # rejoins
    assert [_views(hb) for hb in monitors] == [([], ["w0"])] * 2
    clock.t += 0.08
    assert [_views(hb) for hb in monitors] == [(["w0"], [])] * 2
    assert LivenessMonitor().timeout_s == ref_fault.HeartbeatMonitor().timeout_s == 5.0


class WedgedReader:
    """Wraps a reader; the first read of the span holding ``row`` signals
    ``wedged`` and waits for ``release``; a later read of it returns."""

    def __init__(self, inner, row: int):
        self.inner, self.row = inner, row
        self.wedged, self.release = threading.Event(), threading.Event()
        self.attempts = 0
        self._l = threading.Lock()

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, k):
        return getattr(self.inner, k)

    def read_range(self, start, stop):
        if start <= self.row < stop:
            with self._l:
                self.attempts += 1
                first = self.attempts == 1
            if first:
                self.wedged.set()
                assert self.release.wait(TIMEOUT), "the wedged read was never released"
        return self.inner.read_range(start, stop)


def test_a_suspected_workers_fetch_is_issued_again(tmp_path, clock):
    """A worker wedged in a read stops beating; once the clock passes the
    monitor's timeout it is a suspect, and its fetch is issued again to the
    other worker, whose read of the span returns.  The latency deadline is
    out of reach, so only the monitor can cause the re-issue."""
    rng = np.random.default_rng(3)
    n, g = 640, 16
    lens = rng.integers(1, 4, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate([np.sort(rng.choice(g, int(k), replace=False)) for k in lens])
    path = str(tmp_path / "s0")
    write_csr_shard(path, rng.normal(size=int(indptr[-1])).astype(np.float32),
                    indices.astype(np.int32), indptr, g, {"row": np.arange(n, dtype=np.int32)})
    uri = f"csr://{path}"

    def dataset(col):
        return ScIterableDataset(col, BlockShuffling(32), batch_size=32, fetch_factor=2, seed=4)

    want = [b.to_dense() for b in dataset(open_collection(uri, cache_bytes=0, block_rows=32))]
    reader = WedgedReader(open_collection(uri).adapter, row=40)
    col = PlannedRows(reader, cache_bytes=0, block_rows=32)
    hb = LivenessMonitor(timeout_s=0.15)
    pool = FetchPool(dataset(col), num_workers=2, heartbeat=hb, straggler_factor=1e6,
                     straggler_min_latency=1e6)

    def watchdog():
        assert reader.wedged.wait(TIMEOUT), "no read of the wedged span"
        clock.t += 1.0  # the wedged worker's last beat is now past the timeout
        deadline = time.monotonic() + TIMEOUT  # the real clock: this is a test guard
        while pool.stats["heartbeat_reissues"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        reader.release.set()

    t = threading.Thread(target=watchdog, daemon=True)
    t.start()
    got = [b.to_dense() for b in pool]
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert pool.stats["heartbeat_reissues"] >= 1 and pool.stats["speculative_reissues"] == 0
    assert reader.attempts >= 2
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
