"""Callback hooks and MultiIndexable (paper §3.3, Appendix A).

The port's copy of ``repro.core.callbacks``.  Four optional hooks separate
data access from sampling:

- ``fetch_callback(collection, indices) -> fetched``      (once per fetch)
- ``fetch_transform(fetched) -> transformed``             (once per fetch)
- ``batch_callback(transformed, batch_indices) -> batch`` (once per minibatch)
- ``batch_transform(batch) -> batch``                     (once per minibatch)

and a fifth, ``prefetch_callback(collection, indices)``, which issues a
future fetch's read plan in the background (readahead).

The defaults are module-level functions, not lambdas, so that a dataset
holding them pickles into ``DataLoader`` worker processes started by spawn.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np

__all__ = [
    "MultiIndexable",
    "default_fetch_callback",
    "default_batch_callback",
    "default_prefetch_callback",
    "identity",
    "Callbacks",
]


class MultiIndexable:
    """Groups several indexables so they are always indexed in lockstep.

    ``mi[rows]`` indexes every field with the same rows and returns a new
    MultiIndexable (multi-modal records: expression + labels + metadata).
    """

    def __init__(self, fields: Optional[Mapping[str, Any]] = None, /, **kw: Any):
        merged: dict = dict(fields or {})
        merged.update(kw)
        if not merged:
            raise ValueError("MultiIndexable requires at least one field")
        self._fields = merged
        lens = {k: _length(v) for k, v in merged.items()}
        distinct = set(lens.values())
        if len(distinct) > 1:
            raise ValueError(f"field lengths differ: {lens}")
        self._len = distinct.pop()

    @property
    def fields(self) -> Mapping[str, Any]:
        return dict(self._fields)

    def __len__(self) -> int:
        return self._len

    def keys(self):
        return self._fields.keys()

    def __contains__(self, k) -> bool:
        return k in self._fields

    def field(self, k: str) -> Any:
        return self._fields[k]

    def __getitem__(self, rows) -> "MultiIndexable":
        if isinstance(rows, str):
            return self._fields[rows]
        return MultiIndexable({k: _take(v, rows) for k, v in self._fields.items()})

    def map(self, fn: Callable[[str, Any], Any]) -> "MultiIndexable":
        return MultiIndexable({k: fn(k, v) for k, v in self._fields.items()})

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {type(v).__name__}[{_length(v)}]" for k, v in self._fields.items())
        return f"MultiIndexable({inner})"


def _length(v: Any) -> int:
    if getattr(v, "shape", None) is not None and len(v.shape) > 0:
        return int(v.shape[0])
    return len(v)


def _take(v: Any, rows) -> Any:
    """Row-index an arbitrary indexable: numpy fancy indexing, mappings
    broadcast over their values, else ``v[rows]``, else a per-row gather."""
    if isinstance(v, np.ndarray):
        return v[rows]
    if isinstance(v, Mapping):
        return {k: _take(x, rows) for k, x in v.items()}
    if hasattr(v, "__getitem__"):
        try:
            return v[rows]
        except (TypeError, IndexError, KeyError):
            pass
    return [v[int(r)] for r in np.asarray(rows)]


def default_fetch_callback(collection: Any, indices: np.ndarray) -> Any:
    """One batched read of ``indices``.

    A planned collection (one with ``fetch``, ``nbytes_of`` and ``schema``,
    the structure of :class:`~repro_torch.data.backend.CollectionProtocol`,
    checked by attribute so that ``core`` does not import ``data``) is read
    through ``fetch``, so the planner, its cache and its counters engage;
    anything else is read as ``collection[indices]``.
    """
    if (
        callable(getattr(collection, "fetch", None))
        and hasattr(collection, "nbytes_of")
        and hasattr(collection, "schema")
    ):
        return collection.fetch(indices)
    return _take(collection, indices)


def default_prefetch_callback(collection: Any, indices: np.ndarray) -> int:
    """Non-blocking readahead of a future fetch's ``indices``: a planned
    collection's ``prefetch``, else nothing.  Returns the blocks scheduled."""
    prefetch = getattr(collection, "prefetch", None)
    if callable(prefetch) and hasattr(collection, "nbytes_of"):
        return prefetch(indices)
    return 0


def default_batch_callback(transformed: Any, batch_indices: np.ndarray) -> Any:
    """``transformed[batch_indices]`` over the in-memory fetch buffer."""
    return _take(transformed, batch_indices)


def identity(x: Any) -> Any:
    return x


class Callbacks:
    """Bundle of the hooks with defaults (identity transforms)."""

    __slots__ = ("fetch_callback", "fetch_transform", "batch_callback", "batch_transform",
                 "prefetch_callback")

    def __init__(
        self,
        fetch_callback: Optional[Callable] = None,
        fetch_transform: Optional[Callable] = None,
        batch_callback: Optional[Callable] = None,
        batch_transform: Optional[Callable] = None,
        prefetch_callback: Optional[Callable] = None,
    ):
        self.fetch_callback = fetch_callback or default_fetch_callback
        self.fetch_transform = fetch_transform or identity
        self.batch_callback = batch_callback or default_batch_callback
        self.batch_transform = batch_transform or identity
        self.prefetch_callback = prefetch_callback or default_prefetch_callback
