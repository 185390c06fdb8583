"""Run coalescing for batched reads and the ``readahead`` grammar — the
port's copy of the parts of ``repro.data.readplan`` that the on-disk store
and the pipeline spec need.  The shared read planner and its block cache
are not ported yet."""
from __future__ import annotations

import numpy as np

__all__ = ["coalesce_rows", "normalize_readahead"]

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


def normalize_readahead(value):
    """Validate + normalize the one ``readahead`` spelling: a non-negative
    int (fixed depth) or the string ``"auto"`` (adaptive)."""
    if isinstance(value, str):
        if value == "auto":
            return "auto"
        if value.isdigit():  # query-string spelling of a fixed depth
            return int(value)
    elif not isinstance(value, bool):
        iv = int(value)
        if iv == value and iv >= 0:
            return iv
    raise ValueError(f'readahead must be an int >= 0 or "auto", got {value!r}')
