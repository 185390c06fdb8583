"""The elastic data fabric: the port of ``repro.distributed.elastic``.

It composes the deterministic loader (:mod:`repro_torch.core.dataset`), the
liveness monitor (:mod:`repro_torch.distributed.fault`) and the shared
collections into a fabric that survives a rank's death and a resize of the
world mid-epoch with the stream continued bit for bit:

- :mod:`.pool` — :class:`SharedCollections` (the reference's
  ``CollectionPool``): co-located consumers of the same data share one
  block cache and one rendezvous table;
- :mod:`.repartition` — ``merge_states`` / ``partition``: N ranks' loader
  states become M explicit fetch plans covering exactly the global
  remainder;
- :mod:`.supervisor` — :class:`RankSupervisor` (the reference's
  ``ElasticSupervisor``): suspect ranks, idempotent re-issue through the
  rendezvous table, duplicates dropped by fetch id;
- :mod:`.fabric` — :class:`ElasticFabric` / :class:`RankView`, and
  ``tagged_batches`` to merge per-rank streams into the global order.
"""
from .fabric import ElasticFabric, RankView, tagged_batches
from .pool import GLOBAL_POOL, SharedCollections, pool_key
from .repartition import merge_states, partition
from .supervisor import RankSupervisor

__all__ = [
    "ElasticFabric",
    "RankView",
    "tagged_batches",
    "GLOBAL_POOL",
    "SharedCollections",
    "pool_key",
    "merge_states",
    "partition",
    "RankSupervisor",
]
