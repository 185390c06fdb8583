"""Run coalescing for batched reads — the port's copy of the part of
``repro.data.readplan`` that the on-disk store needs.  The shared read
planner and its block cache are not ported yet."""
from __future__ import annotations

import numpy as np

__all__ = ["coalesce_rows"]

_EMPTY_SPANS = np.empty((0, 2), dtype=np.int64)


def coalesce_rows(sorted_unique: np.ndarray) -> np.ndarray:
    """Maximal ``[start, stop)`` runs of an ascending, duplicate-free array,
    as an ``(n, 2)`` int64 span array."""
    a = np.asarray(sorted_unique, dtype=np.int64)
    if len(a) == 0:
        return _EMPTY_SPANS
    breaks = np.flatnonzero(np.diff(a) != 1)
    firsts = np.concatenate(([0], breaks + 1))
    lasts = np.concatenate((breaks, [len(a) - 1]))
    return np.stack((a[firsts], a[lasts] + 1), axis=1)
