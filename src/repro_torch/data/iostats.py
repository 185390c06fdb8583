"""I/O counters and a calibratable storage-latency model.

The port's copy of ``repro.data.iostats``.  Every backend threads one
:class:`IOCounters` through its reads.  It records the quantities the
paper's cost argument is built on — backend calls, *random runs* (distinct
contiguous extents touched = seeks) and bytes moved — plus the planner's
cache, readahead and admission counters, and can *simulate* a storage
regime by sleeping ``seek_s`` per run and ``1/bw_Bps`` per byte
(:class:`StorageModel`; the presets :data:`SATA_SSD`, :data:`NVME_SSD` and
:data:`CLOUD_OBJECT` are the reference's).  ``snapshot()`` has the
reference's keys, key for key.

:meth:`IOCounters.record_resilience` counts fault recovery (``retries``,
``hedges_*``, ``breaker_*``), :meth:`IOCounters.record_diversity` the
diversity monitor's per-batch label entropy (``div_*``) and
:meth:`IOCounters.record_elastic` the elastic fabric's events: fetches a
:class:`~repro_torch.distributed.elastic.RankSupervisor` issued again for a
suspect rank (``reissued_fetches``) and blocks one rank obtained from
another rank's read (``shared_rank_hits``, which a planned fetch also
records through :meth:`IOCounters.record`).

The classes are named apart from ``IOStats`` / ``PendingIO`` (their
counterparts) for the same reason as
:class:`~repro_torch.core.dataset.ScIterableDataset`: ``tools/analyze``
resolves classes by bare name across ``src/``.  :class:`IOCounters` holds
one lock, because the planner's pool threads record into it; it is taken
with no other lock of the port held, and the simulated latency is slept
outside it.  It pickles without its lock, so a store that carries it still
travels to ``DataLoader`` worker processes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterator, Optional

__all__ = ["IOCounters", "PendingCounters", "StorageModel", "SATA_SSD", "NVME_SSD", "CLOUD_OBJECT"]


@dataclasses.dataclass
class StorageModel:
    """Per-run (seek/request) latency and streaming bandwidth."""

    name: str
    seek_s: float  # cost of one random access / request round-trip
    bw_Bps: float  # sequential streaming bandwidth

    def seconds(self, runs: int, bytes_read: int) -> float:
        return runs * self.seek_s + bytes_read / self.bw_Bps


# The reference's calibration: ~20 samples/s for one-random-row-per-sample
# reads of ~50 KB sparse rows on SATA SSD through HDF5 (paper §1, §4.1).
SATA_SSD = StorageModel("sata_ssd_hdf5", seek_s=0.048, bw_Bps=450e6)
NVME_SSD = StorageModel("nvme_ssd", seek_s=0.0008, bw_Bps=3.2e9)
CLOUD_OBJECT = StorageModel("cloud_object", seek_s=0.030, bw_Bps=1.0e9)


@dataclasses.dataclass
class PendingCounters:
    """One fetch execution's counters, captured before they reach the shared
    totals (the counterpart of ``PendingIO``).  Produced by
    :meth:`IOCounters.deferred`; merged into the main counters or their
    ``spec_*`` mirrors by :meth:`IOCounters.commit`."""

    calls: int = 0  # guarded-by: _lock
    runs: int = 0  # guarded-by: _lock
    rows: int = 0  # guarded-by: _lock
    bytes_read: int = 0  # guarded-by: _lock
    cache_hits: int = 0  # guarded-by: _lock
    cache_misses: int = 0  # guarded-by: _lock
    prefetched: int = 0  # guarded-by: _lock
    requests: int = 0  # guarded-by: _lock
    adm_bypassed: int = 0  # guarded-by: _lock
    adm_rejected: int = 0  # guarded-by: _lock
    retries: int = 0  # guarded-by: _lock
    hedges_issued: int = 0  # guarded-by: _lock
    hedges_won: int = 0  # guarded-by: _lock
    breaker_opens: int = 0  # guarded-by: _lock
    breaker_closes: int = 0  # guarded-by: _lock
    reissued_fetches: int = 0  # guarded-by: _lock
    shared_rank_hits: int = 0  # guarded-by: _lock
    div_batches: int = 0  # guarded-by: _lock
    div_entropy_sum: float = 0.0  # guarded-by: _lock
    div_entropy_min: float = 0.0  # guarded-by: _lock — valid only when div_batches > 0
    wall_s: float = 0.0  # guarded-by: _lock
    modeled_s: float = 0.0  # guarded-by: _lock
    request_wait_s: float = 0.0  # guarded-by: _lock
    retry_wait_s: float = 0.0  # guarded-by: _lock

    def __post_init__(self):
        # pool threads doing a deferred fetch's reads record into this
        # buffer concurrently; not a field, so asdict/eq are unaffected
        self._lock = threading.Lock()


#: counters merged by MIN instead of sum, mapped to the gate counter that
#: marks them valid
_MIN_MERGE = {"div_entropy_min": "div_batches"}

#: the counters of :meth:`IOCounters.record`, beside ``calls``/``wall_s``
_RECORDED = ("runs", "rows", "bytes_read", "cache_hits", "cache_misses", "prefetched",
             "adm_bypassed", "adm_rejected", "shared_rank_hits")


@dataclasses.dataclass
class IOCounters:
    """Counters threaded through backend reads (the counterpart of
    ``IOStats``; its docstring holds the meaning of every counter).

    ``simulate`` — if set, reads sleep according to the model, scaled by
    ``simulate_scale``.  The main counters describe work whose result was
    delivered; the ``spec_*`` mirrors hold executions committed as dropped
    speculative duplicates.  ``prefetched`` counts blocks a fetch obtained
    from a background readahead read; ``adm_bypassed`` / ``adm_rejected``
    count the planner's admission decisions.
    """

    calls: int = 0  # guarded-by: _lock
    runs: int = 0  # guarded-by: _lock — contiguous extents == random accesses
    rows: int = 0  # guarded-by: _lock
    bytes_read: int = 0  # guarded-by: _lock
    cache_hits: int = 0  # guarded-by: _lock — planner block-cache hits
    cache_misses: int = 0  # guarded-by: _lock
    prefetched: int = 0  # guarded-by: _lock — readahead-rendezvous blocks
    requests: int = 0  # guarded-by: _lock — per-request ops (object-store GETs)
    adm_bypassed: int = 0  # guarded-by: _lock — bypassing-admission skips
    adm_rejected: int = 0  # guarded-by: _lock — TinyLFU duels lost
    retries: int = 0  # guarded-by: _lock
    hedges_issued: int = 0  # guarded-by: _lock
    hedges_won: int = 0  # guarded-by: _lock
    breaker_opens: int = 0  # guarded-by: _lock
    breaker_closes: int = 0  # guarded-by: _lock
    reissued_fetches: int = 0  # guarded-by: _lock
    shared_rank_hits: int = 0  # guarded-by: _lock
    div_batches: int = 0  # guarded-by: _lock
    div_entropy_sum: float = 0.0  # guarded-by: _lock
    div_entropy_min: float = 0.0  # guarded-by: _lock — valid iff div_batches > 0
    request_wait_s: float = 0.0  # guarded-by: _lock
    retry_wait_s: float = 0.0  # guarded-by: _lock
    wall_s: float = 0.0  # guarded-by: _lock
    simulate: Optional[StorageModel] = None  # set once at construction
    simulate_scale: float = 1.0
    modeled_s: float = 0.0  # guarded-by: _lock
    spec_calls: int = 0  # guarded-by: _lock
    spec_runs: int = 0  # guarded-by: _lock
    spec_rows: int = 0  # guarded-by: _lock
    spec_bytes_read: int = 0  # guarded-by: _lock
    spec_cache_hits: int = 0  # guarded-by: _lock
    spec_cache_misses: int = 0  # guarded-by: _lock
    spec_prefetched: int = 0  # guarded-by: _lock
    spec_requests: int = 0  # guarded-by: _lock
    spec_adm_bypassed: int = 0  # guarded-by: _lock
    spec_adm_rejected: int = 0  # guarded-by: _lock
    spec_retries: int = 0  # guarded-by: _lock
    spec_hedges_issued: int = 0  # guarded-by: _lock
    spec_hedges_won: int = 0  # guarded-by: _lock
    spec_breaker_opens: int = 0  # guarded-by: _lock
    spec_breaker_closes: int = 0  # guarded-by: _lock
    spec_reissued_fetches: int = 0  # guarded-by: _lock
    spec_shared_rank_hits: int = 0  # guarded-by: _lock
    spec_div_batches: int = 0  # guarded-by: _lock
    spec_div_entropy_sum: float = 0.0  # guarded-by: _lock
    spec_div_entropy_min: float = 0.0  # guarded-by: _lock
    spec_request_wait_s: float = 0.0  # guarded-by: _lock
    spec_retry_wait_s: float = 0.0  # guarded-by: _lock
    spec_wall_s: float = 0.0  # guarded-by: _lock
    spec_modeled_s: float = 0.0  # guarded-by: _lock

    def __post_init__(self):
        # not dataclass fields, so asdict/eq/replace are unaffected
        self._lock = threading.Lock()
        self._tl = threading.local()

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        del state["_lock"], state["_tl"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.__post_init__()

    def record(
        self,
        *,
        runs: int,
        rows: int,
        bytes_read: int,
        wall_s: float,
        cache_hits: int = 0,
        cache_misses: int = 0,
        prefetched: int = 0,
        adm_bypassed: int = 0,
        adm_rejected: int = 0,
        shared_rank_hits: int = 0,
        calls: int = 1,
        slept: bool = False,
    ) -> None:
        """Account one planner/backend call.

        ``calls=0`` — background readahead work, not a consumer's fetch.
        ``slept=True`` — the caller already slept the simulated latency of
        each physical read (the planner does, so that concurrent reads
        overlap it); the modeled time still accumulates here.
        """
        dt = self.simulate.seconds(runs, bytes_read) if self.simulate is not None else 0.0
        got = dict(runs=runs, rows=rows, bytes_read=bytes_read, cache_hits=cache_hits,
                   cache_misses=cache_misses, prefetched=prefetched, adm_bypassed=adm_bypassed,
                   adm_rejected=adm_rejected, shared_rank_hits=shared_rank_hits)
        pend: Optional[PendingCounters] = getattr(self._tl, "pending", None)
        scope: Optional[IOCounters] = getattr(self._tl, "scope", None)
        if pend is not None:
            with pend._lock:
                _add(pend, got, calls, wall_s, dt)
        elif scope is not None:
            scope.record(calls=calls, wall_s=wall_s, slept=slept, **got)
            return  # the scoped child slept the simulated latency already
        else:
            with self._lock:
                _add(self, got, calls, wall_s, dt)
        # sleep outside the lock: simulated latency overlaps across threads
        # as real storage would
        if not slept and self.simulate is not None and self.simulate_scale > 0:
            time.sleep(dt * self.simulate_scale)

    def record_request(self, n: int = 1, *, wait_s: float = 0.0) -> None:
        """Account ``n`` per-request storage operations (object-store GETs),
        honouring :meth:`deferred` and :meth:`scoped` like :meth:`record`."""
        pend: Optional[PendingCounters] = getattr(self._tl, "pending", None)
        scope: Optional[IOCounters] = getattr(self._tl, "scope", None)
        if pend is not None:
            with pend._lock:
                pend.requests += n
                pend.request_wait_s += wait_s
        elif scope is not None:
            scope.record_request(n, wait_s=wait_s)
        else:
            with self._lock:
                self.requests += n
                self.request_wait_s += wait_s

    def record_resilience(
        self,
        *,
        retries: int = 0,
        retry_wait_s: float = 0.0,
        hedges_issued: int = 0,
        hedges_won: int = 0,
        breaker_opens: int = 0,
        breaker_closes: int = 0,
    ) -> None:
        """Account fault-recovery events: re-issued failed read attempts
        (``retries``, with ``retry_wait_s`` their backoff sleeps), duplicate
        tail-latency reads and how many beat their primary (``hedges_*``),
        and per-shard circuit transitions (``breaker_*``).  Honours
        :meth:`deferred` and :meth:`scoped` like :meth:`record`."""
        got = dict(retries=retries, retry_wait_s=retry_wait_s, hedges_issued=hedges_issued,
                   hedges_won=hedges_won, breaker_opens=breaker_opens,
                   breaker_closes=breaker_closes)
        pend: Optional[PendingCounters] = getattr(self._tl, "pending", None)
        scope: Optional[IOCounters] = getattr(self._tl, "scope", None)
        if pend is not None:
            with pend._lock:
                _add_each(pend, got)
        elif scope is not None:
            scope.record_resilience(**got)
        else:
            with self._lock:
                _add_each(self, got)

    def record_elastic(self, *, reissued_fetches: int = 0, shared_rank_hits: int = 0) -> None:
        """Account elastic-fabric events: fetches of a suspect rank issued
        again through the rendezvous table (``reissued_fetches``) and blocks
        one rank obtained from another rank's read (``shared_rank_hits``).
        Neither changes delivered data.  Honours :meth:`deferred` and
        :meth:`scoped` like :meth:`record`."""
        got = dict(reissued_fetches=reissued_fetches, shared_rank_hits=shared_rank_hits)
        pend: Optional[PendingCounters] = getattr(self._tl, "pending", None)
        scope: Optional[IOCounters] = getattr(self._tl, "scope", None)
        if pend is not None:
            with pend._lock:
                _add_each(pend, got)
        elif scope is not None:
            scope.record_elastic(**got)
        else:
            with self._lock:
                _add_each(self, got)

    def record_diversity(self, entropy_bits: float) -> None:
        """Account one materialized minibatch's label entropy (bits).
        ``div_entropy_min`` is valid only while ``div_batches > 0`` (0.0 is
        a legal observation: a single-class batch).  Honours
        :meth:`deferred` and :meth:`scoped` like :meth:`record`, so a
        dropped duplicate's observations land in the ``spec_*`` mirrors."""
        h = float(entropy_bits)
        pend: Optional[PendingCounters] = getattr(self._tl, "pending", None)
        scope: Optional[IOCounters] = getattr(self._tl, "scope", None)
        if pend is not None:
            with pend._lock:
                _observe(pend, h)
        elif scope is not None:
            scope.record_diversity(h)
        else:
            with self._lock:
                _observe(self, h)

    def sleep_for(self, runs: int, bytes_read: int) -> None:
        """Sleep the simulated latency of one physical read in the reading
        thread; no counter moves (pair with ``record(..., slept=True)``)."""
        if self.simulate is not None and self.simulate_scale > 0:
            time.sleep(self.simulate.seconds(runs, bytes_read) * self.simulate_scale)

    def current_pending(self) -> Optional[PendingCounters]:
        """This thread's active :meth:`deferred` buffer, if any."""
        return getattr(self._tl, "pending", None)

    @contextlib.contextmanager
    def borrowed_pending(self, pend: Optional[PendingCounters]) -> Iterator[None]:
        """Install another thread's capture buffer for the duration (a pool
        thread reading for a deferred fetch).  No-op when ``pend`` is None or
        this thread already captures."""
        if pend is None or getattr(self._tl, "pending", None) is not None:
            yield
            return
        self._tl.pending = pend
        try:
            yield
        finally:
            self._tl.pending = None

    @contextlib.contextmanager
    def deferred(self) -> Iterator[PendingCounters]:
        """Capture this thread's recordings into a :class:`PendingCounters`
        instead of the shared totals; :meth:`commit` decides where they go.
        An uncommitted buffer is discarded."""
        if getattr(self._tl, "pending", None) is not None:
            raise RuntimeError("nested IOCounters.deferred() on one thread")
        pend = PendingCounters()
        self._tl.pending = pend
        try:
            yield pend
        finally:
            self._tl.pending = None

    def commit(self, pend: PendingCounters, *, speculative: bool = False) -> None:
        """Merge a captured buffer into the main counters, or into the
        ``spec_*`` mirrors when ``speculative``; inside :meth:`scoped` the
        scope's child takes it."""
        scope: Optional[IOCounters] = getattr(self._tl, "scope", None)
        if scope is not None:
            scope.commit(pend, speculative=speculative)
            return
        with pend._lock:
            src = {f.name: getattr(pend, f.name) for f in dataclasses.fields(PendingCounters)}
        with self._lock:
            self._merge_from(src, "spec_" if speculative else "", prefix_src="")

    def merge(self, other: "IOCounters") -> None:
        """Fold another object's totals (main and ``spec_*``) into this one.
        The source is read through one :meth:`snapshot` before this object's
        lock is taken, so two locks are never held at once."""
        snap = other.snapshot()
        with self._lock:
            for prefix in ("", "spec_"):
                self._merge_from(snap, prefix, prefix_src=prefix)

    def _merge_from(self, src: dict, prefix: str, *, prefix_src: str) -> None:
        # caller holds _lock.  Min-merged counters need the target's
        # pre-merge gate: div_batches may be summed before the min is seen.
        had_div = getattr(self, prefix + "div_batches") > 0
        for f in dataclasses.fields(PendingCounters):
            name, v = prefix + f.name, src[prefix_src + f.name]
            if f.name in _MIN_MERGE:
                if src[prefix_src + _MIN_MERGE[f.name]] > 0:
                    cur = getattr(self, name)
                    setattr(self, name, min(cur, v) if had_div else v)
            else:
                setattr(self, name, getattr(self, name) + v)

    def child(self) -> "IOCounters":
        """A fresh object sharing this one's storage model (route a thread's
        recordings into it with :meth:`scoped`)."""
        return IOCounters(simulate=self.simulate, simulate_scale=self.simulate_scale)

    @contextlib.contextmanager
    def scoped(self, child: Optional["IOCounters"]) -> Iterator[None]:
        """Route this thread's recordings and commits into ``child`` for the
        duration (an active :meth:`deferred` capture still wins).  No-op
        when ``child`` is None; an inner scope shadows an outer one."""
        if child is None:
            yield
            return
        prev = getattr(self._tl, "scope", None)
        self._tl.scope = child
        try:
            yield
        finally:
            self._tl.scope = prev

    def reset(self) -> None:
        with self._lock:
            for f in dataclasses.fields(PendingCounters):
                for name in (f.name, "spec_" + f.name):
                    setattr(self, name, type(getattr(self, name))(0))

    @property
    def cache_hit_rate(self) -> float:
        with self._lock:
            total = self.cache_hits + self.cache_misses
            return self.cache_hits / total if total else 0.0

    def snapshot(self) -> dict:
        """One consistent cut of every counter, with the reference's keys."""
        with self._lock:
            return {k: getattr(self, k) for k in _SNAPSHOT_KEYS}

    def total_seconds(self) -> float:
        """Wall time plus any un-slept modeled time (``simulate_scale < 1``)."""
        with self._lock:
            if self.simulate is None:
                return self.wall_s
            return self.wall_s + self.modeled_s * max(0.0, 1.0 - self.simulate_scale)


def _add(target, got: dict, calls: int, wall_s: float, dt: float) -> None:
    """Add one recording to ``target`` (caller holds its lock)."""
    target.calls += calls
    for k in _RECORDED:
        setattr(target, k, getattr(target, k) + got[k])
    target.wall_s += wall_s
    target.modeled_s += dt


def _add_each(target, got: dict) -> None:
    """Add each counter of ``got`` to ``target`` (caller holds its lock)."""
    for k, v in got.items():
        setattr(target, k, getattr(target, k) + v)


def _observe(target, h: float) -> None:
    """One entropy observation into ``target``'s ``div_*`` counters, summed
    in arrival order (caller holds its lock)."""
    if target.div_batches == 0 or h < target.div_entropy_min:
        target.div_entropy_min = h
    target.div_batches += 1
    target.div_entropy_sum += h


_SNAPSHOT_KEYS = tuple(
    f.name for f in dataclasses.fields(IOCounters) if f.name not in ("simulate", "simulate_scale")
)
