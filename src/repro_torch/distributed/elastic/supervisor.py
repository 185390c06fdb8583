"""Suspect ranks and idempotent fetch re-issue: the port of
``repro.distributed.elastic.supervisor``, whose ``ElasticSupervisor`` is
:class:`RankSupervisor` here (``tools/analyze`` resolves classes by bare
name across ``src/``, and the reference's class holds a lock).

It keeps a fetch ledger beside a
:class:`~repro_torch.distributed.fault.LivenessMonitor`:

- ``issue`` records which rank now owes which global fetch;
- ``ack`` marks a fetch delivered, and answers False for a duplicate (a
  rank presumed dead coming back with work another rank already
  delivered), so that the consumer drops it by fetch id;
- ``recover`` issues the unacknowledged fetches of the suspect ranks again
  through the collection's ``prefetch``: the rendezvous table skips blocks
  cached or in flight, so a fetch the stalled rank had under way costs no
  second read.  Each re-issue counts in the collection's
  ``reissued_fetches``.

The supervisor warms the I/O again; handing the dead rank's fetches to live
ranks is the fabric's repartition (:mod:`.repartition`).

Unlike the reference, ``recover`` decides what to re-issue under the
ledger's lock and issues it after releasing the lock, so that the port adds
no lock-order edge (its lock is a leaf).  A fetch acknowledged while the
re-issue is under way is then warmed once more: a prefetch, which delivers
nothing and costs no read for a block already cached or in flight.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np

from ..fault import LivenessMonitor

__all__ = ["RankSupervisor"]


class RankSupervisor:
    """Liveness and an at-most-once fetch ledger for one loader's global
    stream.  ``dataset`` is a
    :class:`~repro_torch.core.dataset.ScIterableDataset` (duck-typed: its
    ``collection``, ``_epoch_order``, ``fetch_size`` and
    ``sort_fetch_indices``)."""

    def __init__(self, dataset: Any, *, heartbeat: Optional[LivenessMonitor] = None,
                 timeout_s: float = 5.0):
        self.dataset = dataset
        self.collection = dataset.collection
        self.heartbeat = heartbeat or LivenessMonitor(timeout_s=timeout_s)
        self._lock = threading.Lock()
        self._owner: dict = {}  # guarded-by: _lock — (epoch, gid) -> rank
        self._delivered: set = set()  # guarded-by: _lock — acknowledged (epoch, gid)
        self._reissued: set = set()  # guarded-by: _lock — recovered (epoch, gid)

    # ------------------------------------------------------------ liveness
    def beat(self, rank) -> None:
        self.heartbeat.beat(str(rank))

    def suspects(self) -> list:
        return self.heartbeat.suspects()

    # -------------------------------------------------------------- ledger
    def issue(self, rank, epoch: int, global_fetch_id: int) -> None:
        """Record that ``rank`` now owes fetch ``(epoch, global_fetch_id)``."""
        with self._lock:
            self._owner[(int(epoch), int(global_fetch_id))] = str(rank)

    def ack(self, rank, epoch: int, global_fetch_id: int) -> bool:
        """Mark the fetch delivered by ``rank``: True on its first delivery,
        False for a duplicate (drop it)."""
        key = (int(epoch), int(global_fetch_id))
        with self._lock:
            self._owner.pop(key, None)
            if key in self._delivered:
                return False
            self._delivered.add(key)
            return True

    def outstanding(self, rank=None) -> list:
        """Unacknowledged ``(epoch, gid)`` fetches: all, or one rank's."""
        with self._lock:
            if rank is None:
                return sorted(self._owner)
            r = str(rank)
            return sorted(k for k, v in self._owner.items() if v == r)

    # ------------------------------------------------------------ recovery
    def _rows_of(self, epoch: int, gid: int) -> np.ndarray:
        order = self.dataset._epoch_order(epoch)
        fs = self.dataset.fetch_size
        rows = order[gid * fs: min((gid + 1) * fs, len(order))]
        if self.dataset.sort_fetch_indices:
            return np.sort(rows, kind="stable")
        return rows

    def recover(self) -> dict:
        """Issue every suspect rank's unacknowledged fetches again; returns
        ``{rank: [gid, ...]}``.  Each fetch goes through
        ``collection.prefetch`` once, until it is issued to a new owner."""
        sus = set(self.heartbeat.suspects())
        if not sus:
            return {}
        with self._lock:
            todo = sorted((k, r) for k, r in self._owner.items()
                          if r in sus and k not in self._reissued)
            self._reissued.update(k for k, _ in todo)
        out: dict = {}
        for (epoch, gid), rank in todo:
            self.collection.prefetch(self._rows_of(epoch, gid))
            out.setdefault(rank, []).append(gid)
        stats = getattr(self.collection, "iostats", None)
        if stats is not None and hasattr(stats, "record_elastic") and todo:
            stats.record_elastic(reissued_fetches=len(todo))
        return out
