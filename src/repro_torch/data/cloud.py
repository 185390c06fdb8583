"""``cloud://`` — an object store's request semantics over any reader: the
port of ``repro.data.cloud``.

Object stores (S3/GCS-style) charge per request: every GET pays a
first-byte latency whatever its size, streams at a per-request bandwidth,
and the client caps the requests in flight.  :class:`CloudReader` (the
reference's ``CloudAdapter``) wraps any inner reader with exactly that:

- each ``read_range`` is one simulated GET, slept (``first_byte_s +
  nbytes / bw_Bps``, times ``scale``) while it holds one of
  ``max_inflight`` request slots, so concurrency is bounded like a
  connection pool's;
- each GET is counted in the bound :class:`~repro_torch.data.iostats.
  IOCounters` (``requests``, ``request_wait_s``, queueing for a slot
  included); a read the planner's rendezvous shares is issued, and counted,
  once;
- ``tail_p`` sends a deterministic share of GETs, drawn from the GET's
  ordinal, into a ``tail_mult`` times longer tail.

The URI wraps the inner one: ``cloud://sharded-h5ad:///data?driver=shim&
profile=same-region&latency_scale=0.1``.  The cloud knobs (``profile``,
``first_byte_ms``, ``bw_mbps``, ``max_inflight``, ``latency_scale``,
``tail_p``, ``tail_mult``, ``tail_seed``) are consumed here, the rest go to
the inner opener.  Delivered batches are the inner reader's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np

from .backend import StorageReader, open_adapter, piece_nbytes, register_backend
from .faults import mix_u01
from .iostats import IOCounters

__all__ = ["CloudProfile", "CLOUD_PROFILES", "CloudReader"]


@dataclasses.dataclass(frozen=True)
class CloudProfile:
    """Per-request cost model of one object-store tier.

    ``first_byte_s`` — time to first byte of every GET (network RTT + service
    latency); ``bw_Bps`` — per-request streaming bandwidth once data flows;
    ``max_inflight`` — concurrent-request cap (client connection pool /
    service throttle); ``scale`` — multiplier on the slept latency (keep
    ratios, shrink wall-clock for tests and CI).

    ``tail_p`` > 0 adds a **heavy tail**: that fraction of GETs (drawn
    deterministically from ``tail_seed`` and the GET's ordinal, so a run's
    tail events replay exactly) take ``tail_mult`` times the modeled
    duration — the p99-GET pathology hedged reads exist for.  The draw is
    per-ordinal, not per-range, so which request eats the spike depends only
    on issue order, never on the data.
    """

    name: str
    first_byte_s: float
    bw_Bps: float
    max_inflight: int = 64
    scale: float = 1.0
    tail_p: float = 0.0
    tail_mult: float = 4.0
    tail_seed: int = 0

    def request_seconds(self, nbytes: int, seq: Optional[int] = None) -> float:
        """Modeled duration of ONE GET of ``nbytes`` (unscaled).  ``seq`` is
        the GET's ordinal, used for the deterministic tail draw."""
        base = self.first_byte_s + nbytes / self.bw_Bps
        if seq is not None and self.tail_p > 0.0:
            if mix_u01(self.tail_seed, 5, seq) < self.tail_p:
                base *= self.tail_mult
        return base

    def replace(self, **kw) -> "CloudProfile":
        return dataclasses.replace(self, **kw)


#: Named tiers (the reference's): first-byte latency spans ~2 orders
#: of magnitude while bandwidth degrades, mirroring local SSD -> same-region
#: object store -> cross-region -> archive-class retrieval.
CLOUD_PROFILES: dict[str, CloudProfile] = {
    p.name: p
    for p in (
        CloudProfile("local-ssd", first_byte_s=0.0008, bw_Bps=3.2e9, max_inflight=256),
        CloudProfile("same-region", first_byte_s=0.008, bw_Bps=800e6, max_inflight=64),
        CloudProfile("cross-region", first_byte_s=0.030, bw_Bps=200e6, max_inflight=32),
        CloudProfile("cold-archive", first_byte_s=0.090, bw_Bps=100e6, max_inflight=16),
    )
}


class CloudReader(StorageReader):
    """Wrap an inner adapter with per-request object-store semantics.

    Pure pass-through for batch algebra (``take``/``concat``/``nbytes_of``
    and metadata all delegate), so the wrapped collection is bit-identical
    to the inner one — only the timing and the request accounting change.
    """

    def __init__(self, inner: StorageReader, profile: CloudProfile):
        if profile.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.inner = inner
        self.profile = profile
        # In-flight GETs are bounded by a count of free slots, not by a
        # semaphore held across the inner read: no lock of this class is
        # held while the inner reader runs, so wrapping adds no lock edge.
        self._free_slots = int(profile.max_inflight)  # guarded-by: _lock
        self._gets = 0  # guarded-by: _lock — GET ordinal for the tail draw
        self._lock = threading.Lock()
        self._slot_freed = threading.Condition(self._lock)
        # bound once by bind_iostats() before reader threads start; the
        # counters lock themselves
        self._iostats: Optional[IOCounters] = None  # guarded-by: external

    # ----------------------------------------------------- request path
    def bind_iostats(self, iostats: IOCounters) -> None:
        self._iostats = iostats
        self.inner.bind_iostats(iostats)

    def read_range(self, start: int, stop: int) -> Any:
        """ONE GET: at most ``max_inflight`` at once, slept in the calling
        thread (so ``io_workers`` overlap requests as a real client's would)
        and counted once in ``IOCounters.requests``.  The wait for a free
        slot is part of the recorded wait: the throttling a connection pool
        imposes."""
        t0 = time.perf_counter()
        with self._lock:
            seq = self._gets
            self._gets += 1
            while self._free_slots == 0:
                self._slot_freed.wait()  # blocking-ok: Condition.wait releases _lock while it blocks
            self._free_slots -= 1
        try:
            piece = self.inner.read_range(start, stop)
            wait = self.profile.request_seconds(piece_nbytes(piece), seq) * self.profile.scale
            if wait > 0:
                time.sleep(wait)
        finally:
            with self._lock:
                self._free_slots += 1
                self._slot_freed.notify()
        if self._iostats is not None:
            self._iostats.record_request(1, wait_s=time.perf_counter() - t0)
        return piece

    # ------------------------------------------------------ delegation
    def __len__(self) -> int:
        return len(self.inner)

    def boundaries(self) -> Optional[np.ndarray]:
        return self.inner.boundaries()

    def take(self, piece: Any, rows: np.ndarray) -> Any:
        return self.inner.take(piece, rows)

    def concat(self, pieces: Sequence[Any]) -> Any:
        return self.inner.concat(pieces)

    def nbytes_of(self, rows: np.ndarray) -> int:
        return self.inner.nbytes_of(rows)

    @property
    def avg_row_bytes(self) -> float:
        return self.inner.avg_row_bytes

    @property
    def schema(self) -> dict:
        return {
            **self.inner.schema,
            "cloud_profile": self.profile.name,
            "first_byte_s": self.profile.first_byte_s,
            "max_inflight": self.profile.max_inflight,
        }

    def obs_keys(self) -> list[str]:
        return self.inner.obs_keys()

    def obs_column(self, key: str) -> np.ndarray:
        return self.inner.obs_column(key)

    def close(self) -> None:
        self.inner.close()


@register_backend("cloud")
def _open_cloud(
    inner_uri: str,
    *,
    profile: str = "same-region",
    first_byte_ms=None,
    bw_mbps=None,
    max_inflight=None,
    latency_scale=None,
    tail_p=None,
    tail_mult=None,
    tail_seed=None,
    **inner_opts,
) -> CloudReader:
    """Opener: ``cloud://<inner-uri>`` — unknown options forward to the
    inner opener, cloud knobs override fields of the named profile."""
    if profile not in CLOUD_PROFILES:
        raise ValueError(
            f"unknown cloud profile {profile!r}; known: {sorted(CLOUD_PROFILES)}"
        )
    prof = CLOUD_PROFILES[profile]
    if first_byte_ms is not None:
        prof = prof.replace(first_byte_s=float(first_byte_ms) / 1e3)
    if bw_mbps is not None:
        prof = prof.replace(bw_Bps=float(bw_mbps) * 1e6)
    if max_inflight is not None:
        prof = prof.replace(max_inflight=int(max_inflight))
    if latency_scale is not None:
        prof = prof.replace(scale=float(latency_scale))
    if tail_p is not None:
        prof = prof.replace(tail_p=float(tail_p))
    if tail_mult is not None:
        prof = prof.replace(tail_mult=float(tail_mult))
    if tail_seed is not None:
        prof = prof.replace(tail_seed=int(tail_seed))
    return CloudReader(open_adapter(inner_uri, **inner_opts), prof)
