"""Co-located rank loaders over one shared collection, resizable mid-epoch:
the port of ``repro.distributed.elastic.fabric``.

N rank loaders attach to one planned collection (one block cache, one
rendezvous table), each through a :class:`RankView` that tags the rank's
reads, so that a block read for rank 0 serves rank 2 from the shared cache
and counts in ``shared_rank_hits`` instead of a second request.  On top,
:class:`ElasticFabric` keeps the elastic lifecycle:

- ``kill(rank)`` freezes a dead rank's loader state (its checkpoint);
- ``resize(new_world)`` merges the live and orphaned states
  (:func:`~.repartition.merge_states`), splits them again
  (:func:`~.repartition.partition`) and rebuilds the loaders on explicit
  fetch plans: the merged stream across any history of resizes is the
  never-resized stream, bit for bit.

:func:`tagged_batches` yields ``(global_fetch_id, batch_index, batch)``, so
that the ranks' streams merge into the global order.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional

from ...core.dataset import LoaderState, ScIterableDataset
from .repartition import merge_states, partition

__all__ = ["RankView", "ElasticFabric", "tagged_batches"]


class RankView:
    """One rank's view of a shared collection: ``fetch`` and ``prefetch``
    run under the rank's tag (``collection.tagged``); everything else is
    the collection's."""

    def __init__(self, collection: Any, tag: Any):
        self._col = collection
        self._rank_tag = tag

    def fetch(self, rows) -> Any:
        if hasattr(self._col, "tagged"):
            with self._col.tagged(self._rank_tag):
                return self._col.fetch(rows)
        return self._col.fetch(rows)

    def prefetch(self, rows) -> int:
        pf = getattr(self._col, "prefetch", None)
        if pf is None:
            return 0
        if hasattr(self._col, "tagged"):
            with self._col.tagged(self._rank_tag):
                return pf(rows)
        return pf(rows)

    def __getitem__(self, rows) -> Any:
        return self.fetch(rows)

    def __len__(self) -> int:
        return len(self._col)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._col, name)


class ElasticFabric:
    """N rank loaders sharing one collection, resizable mid-epoch.
    ``dataset_kw`` are :class:`ScIterableDataset`'s (``rank`` and
    ``world_size`` are the fabric's)."""

    def __init__(self, collection: Any, *, world_size: int, strategy: Any = None, **dataset_kw):
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        dataset_kw.pop("rank", None)
        dataset_kw.pop("world_size", None)
        self.collection = collection
        self.strategy = strategy
        self.dataset_kw = dataset_kw
        self.world_size = int(world_size)
        self.seed = int(dataset_kw.get("seed", 0))
        #: the live loaders by rank
        self.loaders: dict[int, ScIterableDataset] = {
            r: self._make(r, self.world_size) for r in range(self.world_size)
        }
        # killed ranks' states, merged (then cleared) at the next resize
        self._orphans: list[LoaderState] = []

    def _make(self, rank: int, world: int) -> ScIterableDataset:
        return ScIterableDataset(RankView(self.collection, rank), self.strategy, rank=rank,
                                 world_size=world, **self.dataset_kw)

    def loader(self, rank: int) -> ScIterableDataset:
        return self.loaders[rank]

    def kill(self, rank: int) -> LoaderState:
        """A rank dies: its loader's state (the position after the last
        batch it delivered, its checkpoint) waits as an orphan for the next
        resize, and its loader is dropped."""
        state = self.loaders.pop(rank).state()
        self._orphans.append(state)
        return state

    def resize(self, new_world: int) -> None:
        """Re-shape the fabric to ``new_world`` ranks mid-epoch: the live
        loaders' states and the orphans' merge into the global remainder,
        which is split into ``new_world`` explicit plans for new loaders.
        From the next epoch on, plain round-robin under the new world."""
        states = [ds.state() for ds in self.loaders.values()] + self._orphans
        seed, epoch, fingerprint, remaining = merge_states(states)
        plans = partition(remaining, new_world)
        self._orphans = []
        self.loaders = {}
        self.world_size = int(new_world)
        for r in range(new_world):
            ds = self._make(r, new_world)
            plan = tuple(plans[r])
            ds.load_state(LoaderState(seed, epoch, 0, 0, fingerprint, new_world,
                                      plan[0][0] if plan else None, plan))
            self.loaders[r] = ds

    def remaining(self) -> list:
        """The gid-sorted global remainder over live loaders and orphans."""
        states = [ds.state() for ds in self.loaders.values()] + self._orphans
        return list(merge_states(states)[3])


def tagged_batches(ds: ScIterableDataset, limit: Optional[int] = None) -> Iterator:
    """Iterate a loader, yielding ``(global_fetch_id, batch_index, batch)``,
    up to the epoch's end (or ``limit`` batches).  The loader's state names
    the next batch before each ``next()``: that is the incoming batch's
    global position."""
    entries = ds._fetch_entries()
    it = iter(ds)
    n = 0
    while limit is None or n < limit:
        st = ds._state
        try:
            batch = next(it)
        except StopIteration:
            return
        gid, base_skip = entries[st.fetch_cursor]
        yield int(gid), max(int(base_skip), st.batch_cursor), batch
        n += 1
