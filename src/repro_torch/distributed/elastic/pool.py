"""Shared collections: co-located consumers of the same data attach to one
opened collection, so they share one block cache and one rendezvous table.
The port of ``repro.distributed.elastic.pool``; its ``CollectionPool`` is
:class:`SharedCollections` here, because ``tools/analyze`` resolves classes
by bare name across ``src/`` and the reference's class holds a lock.

- ``_lock`` is a leaf and guards only the map: the opener (the collection's
  files, threads and handles) always runs outside it.
- An open race has one winner: both sides open, the second to publish
  closes its duplicate and takes the winner's.
- ``release`` only drops the count: the collection stays open, its cache
  warm, for the next acquirer of the same data.  ``close_all`` is the
  owner's teardown.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Callable, Optional

__all__ = ["SharedCollections", "GLOBAL_POOL", "pool_key"]


def pool_key(uri: str, open_opts: Optional[dict] = None) -> str:
    """A collection's identity: the data and how it is opened, not who
    samples it."""
    return f"{uri}|{json.dumps(open_opts or {}, sort_keys=True)}"


class _PoolEntry:
    """A shared collection and its reference count (changed under the
    pool's lock)."""

    __slots__ = ("collection", "refs")

    def __init__(self, collection: Any):
        self.collection = collection
        self.refs = 0


def _close_collection(col: Any) -> None:
    if hasattr(col, "release"):
        col.release()
    elif hasattr(col, "close"):
        col.close()


class SharedCollections:
    """Reference-counted map of shared collections, keyed by data identity."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, _PoolEntry] = {}  # guarded-by: _lock

    def acquire(self, key: str, opener: Callable[[], Any]) -> Any:
        """The shared collection under ``key``, opened by ``opener`` on the
        first acquisition.  The opener runs outside the lock; the loser of
        an open race closes its duplicate and gets the winner's."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.refs += 1
                return entry.collection
        col = opener()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _PoolEntry(col)
                entry.refs = 1
                return col
            entry.refs += 1
            winner = entry.collection
        _close_collection(col)
        return winner

    def release(self, key: str) -> None:
        """Drop one reference; the collection stays open (its cache warm)
        until :meth:`close_all`."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.refs -= 1

    def refs(self, key: str) -> int:
        with self._lock:
            entry = self._entries.get(key)
            return entry.refs if entry is not None else 0

    def entries(self) -> list:
        """``(key, collection, refs)`` of every entry, for stats."""
        with self._lock:
            return [(k, e.collection, e.refs) for k, e in self._entries.items()]

    def close_all(self) -> None:
        """Close every collection and empty the map; the teardown runs
        outside the lock."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            _close_collection(e.collection)


#: The process's pool: co-located rank loaders, and pipelines built with
#: ``shared_pool=True``, attach to one collection per data identity.
GLOBAL_POOL = SharedCollections()
