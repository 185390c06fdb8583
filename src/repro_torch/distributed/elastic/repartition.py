"""Elastic repartition: merge the ranks' loader states, split them again for
a new world; the port of ``repro.distributed.elastic.repartition``.

Every epoch position is a pure function of ``(seed, epoch,
global_fetch_id)`` (paper Alg. 1), so the union of the ranks' ``remaining``
lists is the not-yet-delivered tail of the global stream, whichever rank
delivers which fetch.  A resize from N to M ranks collects N states,
:func:`merge_states` them into one sorted remainder, :func:`partition`\\ s
it into M shares and installs each share as an explicit fetch plan
(:meth:`~repro_torch.core.dataset.ScIterableDataset.repartition`, or a v2
``load_state``).  No sample is skipped and none is delivered twice.
"""
from __future__ import annotations

from typing import Sequence

from ...core.dataset import LoaderState

__all__ = ["merge_states", "partition"]


def merge_states(states: Sequence[LoaderState]) -> tuple:
    """Merge rank states into ``(seed, epoch, fingerprint, remaining)``.

    ``remaining`` is the gid-sorted union of the states' ``(global_fetch_id,
    skip_batches)`` entries.  Refuses states that disagree on seed, epoch or
    spec fingerprint (different streams), that carry no ``remaining``
    (a state from before the global cursor), or that owe one global fetch
    twice (the exactly-once partition is already broken).
    """
    if not states:
        raise ValueError("merge_states: no states to merge")
    seeds = {s.seed for s in states}
    epochs = {s.epoch for s in states}
    prints = {s.fingerprint for s in states}
    if len(seeds) > 1 or len(epochs) > 1:
        raise ValueError(
            f"merge_states: states disagree on seed/epoch "
            f"(seeds={sorted(seeds)}, epochs={sorted(epochs)}); "
            "they do not describe one global stream"
        )
    if len(prints) > 1:
        raise ValueError(
            f"merge_states: spec fingerprints differ ({sorted(map(str, prints))}); "
            "refusing to merge streams built from drifted specs"
        )
    missing = [i for i, s in enumerate(states) if s.remaining is None]
    if missing:
        raise ValueError(
            f"merge_states: states {missing} carry no global cursor "
            "(pre-v2 checkpoint?) — capture them via ScIterableDataset.state()"
        )
    merged: dict[int, int] = {}
    for s in states:
        for gid, skip in s.remaining:
            if gid in merged:
                raise ValueError(
                    f"merge_states: global fetch {gid} owed by two ranks — "
                    "the exactly-once partition is already violated"
                )
            merged[int(gid)] = int(skip)
    remaining = tuple(sorted(merged.items()))
    return (states[0].seed, states[0].epoch, states[0].fingerprint, remaining)


def partition(remaining: Sequence, world_size: int) -> list:
    """Split a merged remainder into ``world_size`` round-robin shares.

    Share ``r`` is ``remaining[r::world_size]`` in gid order, the striding
    Alg. 1 uses for a fresh epoch, so shares differ by at most one fetch.
    A share may be empty (a world larger than the work left).
    """
    if world_size < 1:
        raise ValueError("world_size must be >= 1")
    ordered = sorted((int(g), int(s)) for g, s in remaining)
    return [ordered[r::world_size] for r in range(world_size)]
