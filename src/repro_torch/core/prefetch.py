"""A work-stealing fetch pool with straggler re-issue; the port of
``repro.core.prefetch`` (paper Appendix E).

:meth:`ScIterableDataset.fetch` is a pure function of
``(seed, epoch, global_fetch_id)``, so a fetch is idempotent: it can be
issued again on another thread, and the first completion wins.

- :class:`FetchPool` — N threads take fetch positions from one shared
  queue (an idle thread takes the next unclaimed fetch, so a slow fetch
  never holds up the ones behind it).
- Straggler re-issue — a fetch not done ``straggler_factor`` times the
  rolling median fetch latency after it was claimed (and at least
  ``straggler_min_latency`` seconds) is issued again; a duplicate
  completion is dropped.  Where the collection carries
  :class:`~repro_torch.data.iostats.IOCounters`, each execution's counts
  are captured with ``IOCounters.deferred()`` and committed once the winner
  is known: a dropped duplicate's runs and bytes go to the ``spec_*``
  counters, so the main counters describe the delivered data.
- Bounded in-order delivery — results are yielded in fetch order, so
  training sees the synchronous iteration's batches in its order, with at
  most ``max_outstanding`` fetches resident.

Threads, not processes: the reads (``os.pread``, numpy copies, zlib) release
the GIL, and the collection is shared as it is.  ``DataLoader`` workers are
the other way (:class:`~repro_torch.core.dataset.ScIterableDataset` splits
fetches round-robin across them).

The class has another name than its counterpart, ``PrefetchPool``, because
``tools/analyze`` resolves classes by bare name across ``src/``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Iterator, Optional

from .dataset import LoaderState, ScIterableDataset

__all__ = ["FetchPool", "prefetch_iterator"]


class _FetchResult:
    __slots__ = ("batches", "worker", "latency")

    def __init__(self, batches, worker: int, latency: float):
        self.batches = batches
        self.worker = worker
        self.latency = latency


class FetchPool:
    """Run a rank's fetch list through a work-stealing thread pool.

    ``heartbeat`` is duck-typed (``.beat(name)``, ``.suspects()``; e.g. a
    :class:`~repro_torch.distributed.fault.LivenessMonitor`): workers
    beat once per claim and once per completed fetch, and a worker named
    among the suspects has its claimed fetch issued again without waiting
    for the latency deadline.  ``stats`` counts ``fetches``,
    ``speculative_reissues``, ``heartbeat_reissues``,
    ``duplicate_completions`` and ``worker_fetches`` (a Counter by worker).
    """

    def __init__(
        self,
        dataset: ScIterableDataset,
        num_workers: int = 2,
        *,
        max_outstanding: int = 4,
        straggler_factor: float = 3.0,
        straggler_min_latency: float = 0.05,
        enable_speculation: bool = True,
        heartbeat=None,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.dataset = dataset
        self.num_workers = num_workers
        self.max_outstanding = max(1, max_outstanding)
        self.straggler_factor = straggler_factor
        self.straggler_min_latency = straggler_min_latency
        self.enable_speculation = enable_speculation
        self.heartbeat = heartbeat
        # Mutated by workers under __iter__'s per-iteration condition lock
        # (a local the analyzer cannot name); read between iterations only.
        self.stats = {  # guarded-by: external
            "fetches": 0,
            "speculative_reissues": 0,
            "heartbeat_reissues": 0,
            "duplicate_completions": 0,
            "worker_fetches": collections.Counter(),
        }

    def __iter__(self) -> Iterator:
        ds = self.dataset
        epoch = ds._state.epoch
        # (gid, skip) entries: an explicit plan is honoured as the
        # synchronous iteration honours it
        entries = ds._fetch_entries()
        my = [gid for gid, _ in entries]
        start_cursor = ds._state.fetch_cursor
        pending = collections.deque(range(start_cursor, len(my)))  # cursor positions
        lock = threading.Lock()
        cond = threading.Condition(lock)
        results: dict[int, _FetchResult] = {}
        claimed_at: dict[int, float] = {}
        claimed_by: dict[int, int] = {}
        inflight: collections.Counter = collections.Counter()
        latencies: collections.deque = collections.deque(maxlen=32)
        done_flag = threading.Event()
        next_to_yield = start_cursor
        errors: list[BaseException] = []

        def claim(wid: int) -> Optional[int]:
            while True:
                # the suspects are read with cond NOT held: the monitor
                # takes its own lock, which must not nest under cond
                sus = set(self.heartbeat.suspects()) if self.heartbeat is not None else ()
                with cond:
                    if done_flag.is_set() or errors:
                        return None
                    while pending:
                        cur = pending.popleft()
                        if cur in results:
                            continue
                        # backpressure: stay within max_outstanding of delivery
                        if cur >= next_to_yield + self.max_outstanding:
                            pending.appendleft(cur)
                            break
                        claimed_at[cur] = time.monotonic()
                        claimed_by[cur] = wid
                        inflight[cur] += 1
                        return cur
                    # speculation: late fetches, and fetches held by a
                    # suspected worker (those without waiting for a median)
                    if self.enable_speculation and (latencies or sus):
                        med = sorted(latencies)[len(latencies) // 2] if latencies else 0.0
                        deadline = max(self.straggler_min_latency, med * self.straggler_factor)
                        now = time.monotonic()
                        for cur, t0 in list(claimed_at.items()):
                            if cur in results or inflight[cur] != 1:
                                continue
                            hung = f"w{claimed_by.get(cur)}" in sus
                            late = bool(latencies) and now - t0 > deadline
                            if hung or late:
                                claimed_at[cur] = now
                                claimed_by[cur] = wid
                                inflight[cur] += 1
                                self.stats["heartbeat_reissues" if hung
                                           else "speculative_reissues"] += 1
                                return cur
                    if not claimed_at and not pending:
                        return None
                    cond.wait(timeout=0.02)

        # the collection's counters, if it carries them: each execution's
        # counts wait until it is known whether they were delivered
        iostats = getattr(getattr(ds, "collection", None), "iostats", None)
        can_defer = iostats is not None and hasattr(iostats, "deferred")

        def worker(wid: int):
            hb = self.heartbeat
            while True:
                cur = claim(wid)
                if cur is None:
                    return
                if hb is not None:
                    hb.beat(f"w{wid}")
                t0 = time.monotonic()
                pend = None
                try:
                    if can_defer:
                        with iostats.deferred() as pend:
                            batches = ds.fetch(epoch, my[cur])
                    else:
                        batches = ds.fetch(epoch, my[cur])
                except BaseException as e:  # raised to the consumer
                    with cond:
                        errors.append(e)
                        cond.notify_all()
                    return
                dt = time.monotonic() - t0
                if hb is not None:
                    hb.beat(f"w{wid}")
                with cond:
                    inflight[cur] -= 1
                    duplicate = cur in results
                    if duplicate:
                        self.stats["duplicate_completions"] += 1
                    else:
                        results[cur] = _FetchResult(batches, wid, dt)
                        latencies.append(dt)
                        self.stats["fetches"] += 1
                        self.stats["worker_fetches"][wid] += 1
                        claimed_at.pop(cur, None)
                    cond.notify_all()
                if pend is not None:
                    iostats.commit(pend, speculative=duplicate)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f"fetch-pool-{w}") for w in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            resume_skip = ds._state.batch_cursor
            while next_to_yield < len(my):
                with cond:
                    while next_to_yield not in results and not errors:
                        cond.wait(timeout=0.05)
                    if errors:
                        raise errors[0]
                    res = results.pop(next_to_yield)
                    cond.notify_all()
                nb = len(res.batches)
                skip = max(entries[next_to_yield][1], resume_skip)
                for j, batch in enumerate(res.batches):
                    if j < skip:
                        continue
                    # the state is saved BEFORE the yield (batch-exact resume)
                    if j + 1 < nb:
                        ds._state = LoaderState(ds.seed, epoch, next_to_yield, j + 1)
                    else:
                        ds._state = LoaderState(ds.seed, epoch, next_to_yield + 1, 0)
                    yield batch
                resume_skip = 0
                next_to_yield += 1
            ds._fetch_plan = None
            ds._state = LoaderState(ds.seed, epoch + 1, 0, 0)
            ds._notify_epoch_boundary()
        finally:
            done_flag.set()
            with cond:
                cond.notify_all()
            for t in threads:
                t.join(timeout=5.0)


def prefetch_iterator(dataset: ScIterableDataset, num_workers: int = 0, **kw) -> Iterator:
    """``num_workers == 0``: plain synchronous iteration (PyTorch's convention)."""
    if num_workers <= 0:
        return iter(dataset)
    return iter(FetchPool(dataset, num_workers=num_workers, **kw))
