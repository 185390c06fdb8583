"""Cross-shard read planning and the byte-budgeted block cache: the port of
``repro.data.readplan``.

Every backend behind :mod:`repro_torch.data.backend` reduces a fetch to two
questions: *which contiguous row extents to read* and *which of them are
already resident*.  This module answers both:

- :func:`coalesce_rows` / :func:`plan_reads` — merge sorted rows into
  maximal runs in the global row space, split them at physical shard
  boundaries and cap them at ``max_extent_rows``.  Spans are ``(n, 2)``
  int64 arrays of ``[start, stop)`` rows, one row per physical read; every
  function here returns the reference's arrays bit for bit.
- :class:`RowBlockCache` (LRU with a byte budget and the TinyLFU duel of
  ``put_admit``) and :class:`SegmentedRowBlockCache` (W-TinyLFU: window LRU
  plus a segmented main LRU) — the counterparts of ``BlockCache`` and
  ``SegmentedBlockCache``.
- the adaptive-I/O primitives :class:`ForwardStreamDetector`
  (``StreamDetector``), :class:`BlockFrequencySketch`
  (``FrequencySketch``) and :class:`ReadaheadDepth`
  (``ReadaheadController``).

One difference from the reference: none of these classes holds a lock.
Their owner serializes every call — the planned collection makes each one
under its rendezvous lock — so the port has no lock edge from the planner
into this module.  Classes are named apart from their counterparts because
``tools/analyze`` resolves classes by bare name across ``src/``.
"""
from __future__ import annotations

import collections
from typing import Any, Optional

import numpy as np

__all__ = [
    "coalesce_rows",
    "split_at_boundaries",
    "split_max_extent",
    "plan_reads",
    "block_ids_of",
    "blocks_to_row_spans",
    "normalize_readahead",
    "RowBlockCache",
    "SegmentedRowBlockCache",
    "ForwardStreamDetector",
    "BlockFrequencySketch",
    "ReadaheadDepth",
]

_EMPTY_SPANS = np.empty((0, 2), dtype=np.int64)


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


def _as_spans(spans) -> np.ndarray:
    """Anything span-shaped (list of tuples, (n, 2) array) -> (n, 2) int64."""
    return np.asarray(spans, dtype=np.int64).reshape(-1, 2)


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


def split_at_boundaries(spans, boundaries: Optional[np.ndarray]) -> np.ndarray:
    """Split spans at the interior offsets of ``boundaries`` (``[0, n_0,
    n_0+n_1, ..., n]``): a span crossing one becomes one span per shard.
    Vectorized: two ``searchsorted`` passes and one scatter."""
    spans = _as_spans(spans)
    if boundaries is None or len(boundaries) <= 2 or len(spans) == 0:
        return spans
    interior = np.asarray(boundaries, dtype=np.int64)[1:-1]
    lo, hi = spans[:, 0], spans[:, 1]
    i0 = np.searchsorted(interior, lo, side="right")  # first cut > lo
    i1 = np.searchsorted(interior, hi, side="left")  # first cut >= hi
    counts = i1 - i0  # interior cuts strictly inside each span
    total_cuts = int(counts.sum())
    if total_cuts == 0:
        return spans
    reps = counts + 1  # pieces per span
    starts = np.repeat(lo, reps)
    stops = np.repeat(hi, reps)
    cs = np.cumsum(counts)
    local = np.arange(total_cuts) - np.repeat(cs - counts, counts)
    cut_vals = interior[np.repeat(i0, counts) + local]
    # piece j > 0 of a span starts at its cut j - 1; piece j - 1 stops there
    ends = np.cumsum(reps)
    pos = np.repeat(ends - reps, counts) + 1 + local
    starts[pos] = cut_vals
    stops[pos - 1] = cut_vals
    return np.stack((starts, stops), axis=1)


def split_max_extent(spans, max_extent_rows: Optional[int]) -> np.ndarray:
    """Cap every span at ``max_extent_rows`` rows (None or <= 0: unbounded)."""
    spans = _as_spans(spans)
    if not max_extent_rows or max_extent_rows <= 0 or len(spans) == 0:
        return spans
    M = int(max_extent_rows)
    lo, hi = spans[:, 0], spans[:, 1]
    pieces = (hi - lo + M - 1) // M
    total = int(pieces.sum())
    if total == len(spans):
        return spans
    cs = np.cumsum(pieces)
    local = np.arange(total) - np.repeat(cs - pieces, pieces)
    starts = np.repeat(lo, pieces) + local * M
    stops = np.minimum(starts + M, np.repeat(hi, pieces))
    return np.stack((starts, stops), axis=1)


def plan_reads(
    rows: np.ndarray,
    *,
    boundaries: Optional[np.ndarray] = None,
    max_extent_rows: Optional[int] = None,
) -> np.ndarray:
    """Rows -> the physical read plan: coalesce in the global row space,
    split at boundaries, cap extents.  Each span touches exactly one shard."""
    runs = coalesce_rows(np.unique(np.asarray(rows, dtype=np.int64)))
    runs = split_at_boundaries(runs, boundaries)
    return split_max_extent(runs, max_extent_rows)


def block_ids_of(rows: np.ndarray, block_rows: int) -> np.ndarray:
    """Cache-block id of each row (blocks are global-row aligned)."""
    return np.asarray(rows, dtype=np.int64) // int(block_rows)


def blocks_to_row_spans(block_ids: np.ndarray, block_rows: int, n: int) -> np.ndarray:
    """Block ids -> coalesced row spans, clipped to ``n``."""
    spans = coalesce_rows(np.unique(np.asarray(block_ids, dtype=np.int64)))
    spans = spans * int(block_rows)
    np.minimum(spans[:, 1], n, out=spans[:, 1])
    return spans


class RowBlockCache:
    """Byte-budgeted LRU over opaque cached values (a ``CSRBatch``, an
    ndarray, a dict of arrays), keyed by cache-block id.

    Least-recently-used blocks are evicted until a new value fits; a value
    larger than the whole budget is not cached; ``max_bytes == 0`` disables
    caching.  Not synchronized: the owner serializes every call.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        # key -> (value, nbytes), least recently used first
        self._entries: collections.OrderedDict[Any, tuple[Any, int]] = (
            collections.OrderedDict()
        )  # guarded-by: external
        self.cur_bytes = 0  # guarded-by: external
        self.hits = 0  # guarded-by: external
        self.misses = 0  # guarded-by: external
        self.evictions = 0  # guarded-by: external
        self.insertions = 0  # guarded-by: external
        self.bypasses = 0  # guarded-by: external — admission-policy skips
        self.rejections = 0  # guarded-by: external — lost TinyLFU victim duels

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key) -> Optional[Any]:
        val = self.peek(key)
        if val is None:
            self.misses += 1
        else:
            self.hits += 1
        return val

    def peek(self, key) -> Optional[Any]:
        """Like :meth:`get` without touching the hit/miss counters."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        self._entries.move_to_end(key)
        return ent[0]

    def bypass(self, n: int = 1) -> None:
        """Record that an admission policy skipped ``n`` insertions."""
        self.bypasses += n

    def discard(self, key) -> None:
        """Drop an entry if present (no counters)."""
        ent = self._entries.pop(key, None)
        if ent is not None:
            self.cur_bytes -= ent[1]

    def put(self, key, value, nbytes: int) -> None:
        nbytes = int(nbytes)
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return
        self.discard(key)
        while self._entries and self.cur_bytes + nbytes > self.max_bytes:
            _, (_, old) = self._entries.popitem(last=False)
            self.cur_bytes -= old
            self.evictions += 1
        self._entries[key] = (value, nbytes)
        self.cur_bytes += nbytes
        self.insertions += 1

    def put_admit(self, key, value, nbytes: int, estimate) -> bool:
        """TinyLFU-guarded insertion: evict only victims colder than the
        candidate.

        Plain LRU insertion while the value fits without eviction.  Then the
        whole victim set is decided first: a candidate that is not strictly
        hotter (``estimate(key) -> int``) than every victim it needs is
        rejected (False, counted in ``rejections``) and nothing is evicted.
        Re-inserting a resident key refreshes it without a duel.
        """
        nbytes = int(nbytes)
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return False
        resident = key in self._entries
        if resident:
            _, old = self._entries.pop(key)
            self.cur_bytes -= old
        victims: list = []
        freed = 0
        cand_freq = None
        for vkey in self._entries:  # LRU -> MRU
            if self.cur_bytes - freed + nbytes <= self.max_bytes:
                break
            if not resident:
                if cand_freq is None:
                    cand_freq = int(estimate(key))
                if int(estimate(vkey)) >= cand_freq:
                    self.rejections += 1
                    return False
            victims.append(vkey)
            freed += self._entries[vkey][1]
        for vkey in victims:
            _, old = self._entries.pop(vkey)
            self.cur_bytes -= old
            self.evictions += 1
        self._entries[key] = (value, nbytes)
        self.cur_bytes += nbytes
        self.insertions += 1
        return True

    def clear(self) -> None:
        self._entries.clear()
        self.cur_bytes = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        return {
            "entries": len(self._entries),
            "cur_bytes": self.cur_bytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "insertions": self.insertions,
            "bypasses": self.bypasses,
            "rejections": self.rejections,
            "hit_rate": self.hit_rate,
        }


class SegmentedRowBlockCache(RowBlockCache):
    """W-TinyLFU segmented cache: a window LRU (``window_frac`` of the
    budget) where every new block lands, and a main segmented LRU whose
    protected part (``protected_frac`` of main) holds blocks hit again
    after admission.

    A block leaving the window duels the main segment's coldest victim —
    probation first, protected only once probation is empty — on sketch
    frequency, as :meth:`RowBlockCache.put_admit` does; ``put`` admits
    window victims into probation without a duel.  A probation hit
    promotes the block, demoting protected's LRU back to probation while
    protected overflows.  Not synchronized, like its base.
    """

    def __init__(self, max_bytes: int, *, window_frac: float = 0.10,
                 protected_frac: float = 0.80):
        # no super().__init__(): the single-segment dict would sit unused
        if not (0.0 < window_frac < 1.0) or not (0.0 < protected_frac < 1.0):
            raise ValueError("window_frac and protected_frac must be in (0, 1)")
        self.max_bytes = int(max_bytes)
        self.window_bytes = int(self.max_bytes * window_frac)
        self.protected_bytes = int((self.max_bytes - self.window_bytes) * protected_frac)
        # key -> (value, nbytes); three disjoint key spaces
        self._window: collections.OrderedDict[Any, tuple[Any, int]] = (
            collections.OrderedDict()
        )  # guarded-by: external
        self._probation: collections.OrderedDict[Any, tuple[Any, int]] = (
            collections.OrderedDict()
        )  # guarded-by: external
        self._protected: collections.OrderedDict[Any, tuple[Any, int]] = (
            collections.OrderedDict()
        )  # guarded-by: external
        self.cur_bytes = 0  # guarded-by: external
        self._window_cur = 0  # guarded-by: external
        self._protected_cur = 0  # guarded-by: external
        self.hits = 0  # guarded-by: external
        self.misses = 0  # guarded-by: external
        self.evictions = 0  # guarded-by: external
        self.insertions = 0  # guarded-by: external
        self.bypasses = 0  # guarded-by: external
        self.rejections = 0  # guarded-by: external — window victims losing duels

    def __len__(self) -> int:
        return len(self._window) + len(self._probation) + len(self._protected)

    def peek(self, key) -> Optional[Any]:
        """Lookup with recency and segment maintenance, no counters."""
        for seg in (self._window, self._protected):
            ent = seg.get(key)
            if ent is not None:
                seg.move_to_end(key)
                return ent[0]
        ent = self._probation.pop(key, None)
        if ent is None:
            return None
        # reuse after admission: promote; byte totals are unchanged
        self._protected[key] = ent
        self._protected_cur += ent[1]
        while self._protected_cur > self.protected_bytes and len(self._protected) > 1:
            dkey, dent = self._protected.popitem(last=False)
            self._protected_cur -= dent[1]
            self._probation[dkey] = dent
        return ent[0]

    def discard(self, key) -> None:
        """Drop a resident key from whichever segment holds it."""
        for seg, attr in ((self._window, "_window_cur"), (self._probation, None),
                          (self._protected, "_protected_cur")):
            ent = seg.pop(key, None)
            if ent is not None:
                self.cur_bytes -= ent[1]
                if attr is not None:
                    setattr(self, attr, getattr(self, attr) - ent[1])
                return

    def _main_victim(self) -> Optional[Any]:
        for seg in (self._probation, self._protected):
            if seg:
                return next(iter(seg))
        return None

    def _evict_main(self) -> None:
        if self._probation:
            _, (_, nb) = self._probation.popitem(last=False)
        else:
            _, (_, nb) = self._protected.popitem(last=False)
            self._protected_cur -= nb
        self.cur_bytes -= nb
        self.evictions += 1

    def _insert(self, key, value, nbytes: int, estimate) -> bool:
        # land in the window, then drain window victims through main
        # admission (``estimate`` None: no duel).  Returns whether ``key``
        # is resident afterwards.
        self.discard(key)
        self._window[key] = (value, nbytes)
        self._window_cur += nbytes
        self.cur_bytes += nbytes
        self.insertions += 1
        main_budget = self.max_bytes - self.window_bytes
        resident = True
        while self._window_cur > self.window_bytes and self._window:
            vkey, vent = self._window.popitem(last=False)
            self._window_cur -= vent[1]
            # the victim's bytes stay in cur_bytes while it is in limbo
            admitted = True
            while self.cur_bytes - self._window_cur > main_budget:
                mvic = self._main_victim()
                if mvic is None:
                    admitted = False  # it alone exceeds the main budget
                    self.evictions += 1
                    break
                if estimate is not None and int(estimate(vkey)) <= int(estimate(mvic)):
                    admitted = False  # not strictly hotter: it loses the duel
                    self.rejections += 1
                    break
                self._evict_main()
            if admitted:
                self._probation[vkey] = vent
            else:
                self.cur_bytes -= vent[1]
                if vkey == key:
                    resident = False
        return resident

    def put(self, key, value, nbytes: int) -> None:
        nbytes = int(nbytes)
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return
        self._insert(key, value, nbytes, None)

    def put_admit(self, key, value, nbytes: int, estimate) -> bool:
        """Frequency-guarded insertion; returns whether ``key`` is resident
        after it."""
        nbytes = int(nbytes)
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return False
        return self._insert(key, value, nbytes, estimate)

    def clear(self) -> None:
        self._window.clear()
        self._probation.clear()
        self._protected.clear()
        self.cur_bytes = self._window_cur = self._protected_cur = 0

    def snapshot(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self),
            "cur_bytes": self.cur_bytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "insertions": self.insertions,
            "bypasses": self.bypasses,
            "rejections": self.rejections,
            "hit_rate": self.hits / total if total else 0.0,
            "window_entries": len(self._window),
            "probation_entries": len(self._probation),
            "protected_entries": len(self._protected),
            "window_bytes": self._window_cur,
            "protected_bytes": self._protected_cur,
        }


class ForwardStreamDetector:
    """Detects forward-streaming access over cache blocks.

    Feed each fetch's sorted-unique block ids to :meth:`observe`; after
    ``threshold`` consecutive fetches that are contiguous within the fetch
    and start at or past the previous fetch's last block, ``streaming``
    turns on, and off again at the first fetch that breaks the pattern.
    :meth:`reset` at epoch boundaries.  Not synchronized: the owner
    serializes ``observe``.
    """

    def __init__(self, threshold: int = 3):
        self.threshold = int(threshold)
        self.streak = 0  # guarded-by: external
        self._last_hi: Optional[int] = None  # guarded-by: external

    def observe(self, block_ids: np.ndarray) -> bool:
        """Update with one fetch's sorted-unique block ids; returns the new
        state, which classifies this same fetch."""
        blocks = np.asarray(block_ids)
        contiguous = int(blocks[-1]) - int(blocks[0]) + 1 == len(blocks)
        forward = self._last_hi is not None and int(blocks[0]) >= self._last_hi
        self._last_hi = int(blocks[-1])
        self.streak = self.streak + 1 if (contiguous and forward) else 0
        return self.streaming

    @property
    def streaming(self) -> bool:
        return self.streak >= self.threshold

    def reset(self) -> None:
        self.streak = 0
        self._last_hi = None


class BlockFrequencySketch:
    """TinyLFU block-popularity estimator: a doorkeeper set for once-seen
    blocks and a ``depth x width`` count-min table (conservative update,
    saturating uint8) for repeat visitors.  Every ``reset_interval`` touches
    the counters halve and the doorkeeper clears.  Deterministic: the hash
    is fixed odd-multiplier mixing of the block id.  Not synchronized.
    """

    _MULTS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
              0x27D4EB2F165667C5)
    _MASK64 = (1 << 64) - 1

    def __init__(self, width: int = 4096, depth: int = 4,
                 reset_interval: Optional[int] = None):
        if width <= 0 or (width & (width - 1)) != 0:
            raise ValueError("width must be a positive power of two")
        self.width = int(width)
        self.depth = int(depth)
        self.table = np.zeros((self.depth, self.width), dtype=np.uint8)  # guarded-by: external
        self.door: set[int] = set()  # guarded-by: external
        self.ops = 0  # guarded-by: external
        self.reset_interval = int(reset_interval or width * 8)
        self.ages = 0  # guarded-by: external

    def _slots(self, key: int) -> list[int]:
        k = (int(key) + 1) & self._MASK64  # avoid key 0's all-zero fixed point
        return [(((k * m) & self._MASK64) >> 17) & (self.width - 1)
                for m in self._MULTS[: self.depth]]

    def touch(self, key: int) -> None:
        """Record one access of ``key``."""
        self.ops += 1
        if key not in self.door:
            self.door.add(key)
        else:
            slots = self._slots(key)
            vals = [int(self.table[i, s]) for i, s in enumerate(slots)]
            lo = min(vals)
            if lo < 255:  # conservative update: bump only the minimum rows
                for i, s in enumerate(slots):
                    if int(self.table[i, s]) == lo:
                        self.table[i, s] = lo + 1
        if self.ops >= self.reset_interval:
            self._age()

    def touch_many(self, keys: np.ndarray) -> None:
        """Vectorized :meth:`touch` of one fetch's distinct block ids (the
        same hash lanes; one gather/compare/scatter)."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        self.ops += int(keys.size)
        door = self.door
        known = np.fromiter((int(k) in door for k in keys), bool, keys.size)
        door.update(int(k) for k in keys[~known])
        rep = keys[known]
        if rep.size:
            k64 = rep.astype(np.uint64) + np.uint64(1)
            slots = np.empty((self.depth, rep.size), dtype=np.intp)
            for i, m in enumerate(self._MULTS[: self.depth]):
                slots[i] = (((k64 * np.uint64(m)) >> np.uint64(17))
                            & np.uint64(self.width - 1)).astype(np.intp)
            rows = np.broadcast_to(np.arange(self.depth)[:, None], slots.shape)
            vals = self.table[rows, slots]
            lo = vals.min(axis=0)
            bump = (vals == lo[None, :]) & (lo[None, :] < 255)
            self.table[rows[bump], slots[bump]] = vals[bump] + 1
        if self.ops >= self.reset_interval:
            self._age()

    def estimate(self, key: int) -> int:
        """Estimated access count of ``key`` (the doorkeeper adds its one)."""
        est = min(int(self.table[i, s]) for i, s in enumerate(self._slots(key)))
        return est + (1 if key in self.door else 0)

    def _age(self) -> None:
        self.table >>= 1
        self.door.clear()
        self.ops //= 2
        self.ages += 1


class ReadaheadDepth:
    """Feedback-driven readahead depth, the ``readahead="auto"`` controller
    (the counterpart of ``ReadaheadController``; its docstring holds the
    full rationale).

    Every ``interval`` observed fetches it decides:

    - shrink by one (down to ``min_depth``) when the cache evicted or
      rejected blocks in the last window;
    - step down toward ``min_depth`` while the per-read wait (``wait_s``,
      the caller's smoothed seconds per physical read) stays under
      ``wait_floor_s`` after having been at or over it;
    - grow by one at once when the wait rose ``wait_shift_factor``-fold
      over the last decision's, budget permitting;
    - else grow by one (up to ``max_depth``) while ``depth + 3`` fetches of
      bytes fit the cache and the in-flight table is draining.

    Depth starts at ``max(1, min_depth)``.  It moves only when bytes are
    read, never which rows a batch holds.  Not synchronized: the owner
    calls :meth:`observe` under its rendezvous lock.
    """

    def __init__(
        self,
        cache: RowBlockCache,
        *,
        min_depth: int = 0,
        max_depth: int = 8,
        interval: int = 4,
        wait_floor_s: float = 0.002,
        wait_shift_factor: float = 2.0,
    ):
        if min_depth < 0 or max_depth < max(1, min_depth):
            raise ValueError("need 0 <= min_depth <= max_depth, max_depth >= 1")
        self.cache = cache
        self.min_depth = int(min_depth)
        self.max_depth = int(max_depth)
        self.interval = int(interval)
        self.wait_floor_s = float(wait_floor_s)
        self.wait_shift_factor = float(wait_shift_factor)
        self.depth = max(1, self.min_depth)  # guarded-by: external
        self.grows = 0  # guarded-by: external
        self.shrinks = 0  # guarded-by: external
        self._fetches = 0  # guarded-by: external
        self._ev_mark = cache.evictions + cache.rejections  # guarded-by: external
        self._fetch_bytes = 0.0  # guarded-by: external — EWMA bytes/fetch
        self._fetch_blocks = 0.0  # guarded-by: external — EWMA blocks/fetch
        self._wait_ewma = 0.0  # guarded-by: external — s/physical read
        self._wait_mark = 0.0  # guarded-by: external — the wait at the last decision
        # set by a genuine downward shift of the wait; storage that was
        # always fast never sets it
        self._fast_regime = False  # guarded-by: external
        self.latency_grows = 0  # guarded-by: external
        self.latency_shrinks = 0  # guarded-by: external

    def observe(self, fetch_bytes: float, fetch_blocks: int, inflight_blocks: int,
                wait_s: float = 0.0) -> int:
        """Feed one fetch's staged bytes and blocks, the in-flight table's
        size and (optionally) the smoothed per-read wait; returns the depth."""

        def ewma(prev: float, x: float) -> float:
            return x if prev == 0.0 else 0.75 * prev + 0.25 * x

        self._fetch_bytes = ewma(self._fetch_bytes, float(fetch_bytes))
        self._fetch_blocks = ewma(self._fetch_blocks, float(fetch_blocks))
        if wait_s > 0.0:
            self._wait_ewma = float(wait_s)  # the caller smooths it
        self._fetches += 1
        if self._fetches % self.interval:
            return self.depth
        pressure = self.cache.evictions + self.cache.rejections
        evicted = pressure - self._ev_mark
        self._ev_mark = pressure
        wait, mark = self._wait_ewma, self._wait_mark
        self._wait_mark = wait
        if evicted > 0:
            if self.depth > self.min_depth:
                self.depth -= 1
                self.shrinks += 1
            return self.depth
        if 0.0 < wait < self.wait_floor_s:
            if mark >= self.wait_floor_s:
                self._fast_regime = True
            if self._fast_regime:
                # parked at min_depth, do not fall through to the grow branch
                if self.depth > self.min_depth:
                    self.depth -= 1
                    self.shrinks += 1
                    self.latency_shrinks += 1
                return self.depth
        else:
            self._fast_regime = False
        # (depth + 1) staged fetches, the current one and one of slack
        budget_ok = (self._fetch_bytes > 0
                     and (self.depth + 3) * self._fetch_bytes <= self.cache.max_bytes)
        if (mark > 0.0 and wait >= self.wait_shift_factor * mark
                and self.depth < self.max_depth and budget_ok):
            self.depth += 1
            self.grows += 1
            self.latency_grows += 1
            return self.depth
        draining = inflight_blocks <= (self.depth + 1) * max(1.0, self._fetch_blocks)
        if budget_ok and draining and self.depth < self.max_depth:
            self.depth += 1
            self.grows += 1
        return self.depth

    def epoch_boundary(self) -> None:
        """Open a fresh pressure window; the depth persists."""
        self._ev_mark = self.cache.evictions + self.cache.rejections
        self._fetches = 0

    def snapshot(self) -> dict:
        return {
            "depth": self.depth,
            "min_depth": self.min_depth,
            "max_depth": self.max_depth,
            "grows": self.grows,
            "shrinks": self.shrinks,
            "latency_grows": self.latency_grows,
            "latency_shrinks": self.latency_shrinks,
            "fetch_bytes_ewma": self._fetch_bytes,
            "wait_ewma_s": self._wait_ewma,
        }
