"""ScIterableDataset — block sampling with batched fetching (paper Algorithm 1).

The port's counterpart of ``repro.core.dataset.ScDataset``, as a
``torch.utils.data.IterableDataset``:

- A :class:`~repro_torch.core.sampling.SamplingStrategy` emits the
  deterministic global index sequence of the epoch (Alg. 1 lines 1–4).
- The sequence is split into *fetches* of ``batch_size * fetch_factor``
  indices (line 5).
- Fetches go round-robin across ``world_size`` ranks and, within a rank,
  across ``DataLoader`` workers (paper Appendix B): every rank and worker
  computes the same global sequence from the shared seed, so no
  coordination is needed.
- Per fetch: indices are sorted (line 7) so the store coalesces reads, data
  is loaded in ONE store call (line 8), reshuffled in memory (line 9), split
  into ``fetch_factor`` minibatches (line 10) and yielded (lines 11–12).
- Over a planned collection (:mod:`repro_torch.data.backend`) with
  ``readahead > 0``, each fetch first issues the read plans of this rank's
  next ``readahead`` fetches in the background (and, with
  ``cross_epoch_prefetch``, of the next epoch's first ones at an epoch's
  tail); epoch boundaries reach the collection's ``epoch_boundary``.

Batches, their order and :class:`LoaderState` are bitwise those of the JAX
package's ``ScDataset`` for the same collection and arguments.  The class
has another name than its counterpart because the repository's static lock
analyzer (``tools/analyze``) resolves classes by bare name across ``src/``:
a second ``ScDataset`` would hide the reference's lock edges from it.

``diversity_obs`` names an obs column whose per-batch label entropy an
:class:`EntropyMonitor` records into the collection's counters (the
reference's ``DiversityMonitor``; the stream is untouched), and
:meth:`ScIterableDataset.autotune` probes a planned collection and
recommends ``(block_size, fetch_factor)`` through
:mod:`repro_torch.core.autotune`.

``state()`` describes iteration in this process.  Under ``DataLoader``
workers each worker iterates its own copy, so load a state and call
:meth:`set_epoch` before the ``DataLoader`` starts its workers.  Threads of
a :class:`~repro_torch.core.prefetch.FetchPool` share one dataset: they call
:meth:`fetch`, which reads the epoch's order under a lock, and the pool
keeps the state.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
from torch.utils.data import IterableDataset, get_worker_info

from .callbacks import Callbacks
from .sampling import BlockShuffling, SamplingStrategy, epoch_rng

__all__ = ["ScIterableDataset", "LoaderState", "EntropyMonitor"]


class EntropyMonitor:
    """Per-batch label entropy over one obs column (the §3.4 theory, live).

    The counterpart of ``repro.core.dataset.DiversityMonitor``, renamed for
    the reason :class:`ScIterableDataset` is.  :meth:`observe` takes one
    minibatch's global rows, computes the plug-in entropy (bits) of their
    labels with one ``bincount`` over integer codes, and records it into the
    collection's :class:`~repro_torch.data.iostats.IOCounters` ``div_*``
    counters where the collection has them.  Observation only: the delivered
    stream is untouched, and an observation made inside a dropped duplicate
    fetch lands in the ``spec_*`` mirrors through the counters' deferred
    capture.  The codes resolve on the first observation (``np.unique`` over
    the whole column), once, under a lock: threads of a
    :class:`~repro_torch.core.prefetch.FetchPool` may observe at once.
    """

    def __init__(self, collection: Any, obs: str):
        if not hasattr(collection, "obs_column"):
            raise ValueError(
                f"diversity_obs={obs!r} needs a collection with obs columns "
                f"(obs_column); got {type(collection).__name__}"
            )
        self.obs = str(obs)
        self._collection = collection
        self._codes: Optional[np.ndarray] = None  # guarded-by: _lock
        self._num_classes = 0  # guarded-by: _lock — set with _codes
        self._lock = threading.Lock()

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _resolve(self) -> np.ndarray:
        codes = self._codes  # unlocked-ok: racy fast path on an immutable-once-cached value
        if codes is not None:
            return codes
        with self._lock:
            if self._codes is None:
                values = np.asarray(self._collection.obs_column(self.obs))
                uniq, inv = np.unique(values, return_inverse=True)
                self._num_classes = int(len(uniq))
                self._codes = inv.astype(np.int64, copy=False)
            return self._codes

    @property
    def num_classes(self) -> int:
        self._resolve()
        return self._num_classes  # unlocked-ok: immutable once _resolve returned

    def class_probs(self) -> np.ndarray:
        """The label distribution p over the whole collection: the H(p) an
        entropy floor is predicted against."""
        codes = self._resolve()
        counts = np.bincount(codes, minlength=self._num_classes)  # unlocked-ok: immutable once _resolve returned
        return counts / max(1, len(codes))

    def observe(self, global_rows: np.ndarray) -> float:
        """Record, and return, the label entropy of one batch."""
        from .theory import batch_entropy

        codes = self._resolve()
        h = batch_entropy(codes[np.asarray(global_rows)], self._num_classes)  # unlocked-ok: immutable once _resolve returned
        stats = getattr(self._collection, "iostats", None)
        if stats is not None and hasattr(stats, "record_diversity"):
            stats.record_diversity(h)
        return h


@dataclasses.dataclass
class LoaderState:
    """Everything needed to resume sampling exactly where it stopped.

    ``fetch_cursor`` indexes THIS RANK's fetch list; ``batch_cursor`` counts
    minibatches already delivered from the current fetch.  ``world_size``,
    ``global_cursor`` and ``remaining`` (``(global_fetch_id, skip_batches)``
    entries still owed) make the state global: their union across ranks is
    the not-yet-delivered stream.  ``fingerprint`` carries a pipeline spec's
    content hash where one built the loader (None here).  The JSON form is
    the JAX package's, field for field.
    """

    seed: int
    epoch: int
    fetch_cursor: int
    batch_cursor: int = 0
    fingerprint: Optional[str] = None
    world_size: Optional[int] = None
    global_cursor: Optional[int] = None
    remaining: Optional[tuple] = None  # ((global_fetch_id, skip_batches), ...)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "LoaderState":
        rem = d.get("remaining")
        if rem is not None:  # JSON round-trips tuples as lists
            rem = tuple((int(g), int(s)) for g, s in rem)
        ws = d.get("world_size")
        gc = d.get("global_cursor")
        return LoaderState(int(d["seed"]), int(d["epoch"]),
                           int(d["fetch_cursor"]), int(d.get("batch_cursor", 0)),
                           d.get("fingerprint"),
                           None if ws is None else int(ws),
                           None if gc is None else int(gc),
                           rem)


class ScIterableDataset(IterableDataset):
    """Iterable over minibatches drawn quasi-randomly from an on-disk collection.

    ``batch_size`` = m and ``fetch_factor`` = f of the paper; the block size
    lives in the strategy.  ``rank``/``world_size`` give DDP semantics.
    Iterated directly, or by a ``DataLoader(ds, batch_size=None,
    num_workers=W)``, whose workers split the rank's fetches round-robin.
    """

    def __init__(
        self,
        collection: Any,
        strategy: Optional[SamplingStrategy] = None,
        *,
        batch_size: int = 64,
        fetch_factor: int = 1,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = True,
        callbacks: Optional[Callbacks] = None,
        fetch_callback: Optional[Callable] = None,
        fetch_transform: Optional[Callable] = None,
        batch_callback: Optional[Callable] = None,
        batch_transform: Optional[Callable] = None,
        prefetch_callback: Optional[Callable] = None,
        sort_fetch_indices: bool = True,
        cross_epoch_prefetch: bool = False,
        diversity_obs: Optional[str] = None,
    ):
        if batch_size <= 0 or fetch_factor <= 0:
            raise ValueError("batch_size and fetch_factor must be positive")
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range for world_size {world_size}")
        if callbacks is not None and any(
            cb is not None
            for cb in (fetch_callback, fetch_transform, batch_callback, batch_transform,
                       prefetch_callback)
        ):
            raise ValueError("pass either a Callbacks bundle or individual hooks, not both")
        self.collection = collection
        self.strategy = strategy or BlockShuffling(block_size=16)
        self.batch_size = int(batch_size)
        self.fetch_factor = int(fetch_factor)
        self.seed = int(seed)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.drop_last = bool(drop_last)
        self.sort_fetch_indices = bool(sort_fetch_indices)
        self.cross_epoch_prefetch = bool(cross_epoch_prefetch)
        self.diversity_obs = diversity_obs
        self._div = EntropyMonitor(collection, diversity_obs) if diversity_obs is not None else None
        self.callbacks = callbacks or Callbacks(
            fetch_callback, fetch_transform, batch_callback, batch_transform, prefetch_callback
        )
        # the pipeline spec's content hash, stamped by the Pipeline builder;
        # surfaces in plan_epoch.  None for hand-wired loaders.
        self.spec_fingerprint: Optional[str] = None
        self._state = LoaderState(seed=self.seed, epoch=0, fetch_cursor=0)
        # explicit (gid, skip) plan for the CURRENT epoch, installed by a
        # v2 load_state; None means the round-robin derivation
        self._fetch_plan: Optional[list] = None
        # epoch -> materialized order; keeps at most two epochs.  Locked:
        # FetchPool threads meeting a cold epoch build it once
        self._order_lock = threading.Lock()
        self._order_cache: dict[int, np.ndarray] = {}  # guarded-by: _order_lock
        # autotune's cached fit, the counters at the fit, the readahead
        # controller's moves at the fit and the adopted pick's predicted
        # entropy: the caller's, as in the reference
        self._tuned_model = None  # guarded-by: external
        self._tuned_base = None  # guarded-by: external
        self._tuned_ra_mark = 0  # guarded-by: external
        self._tuned_entropy = None  # guarded-by: external

    def __getstate__(self) -> dict:
        # a lock does not pickle: a spawned DataLoader worker makes its own
        state = self.__dict__.copy()
        del state["_order_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._order_lock = threading.Lock()

    # ------------------------------------------------------------------ sizes
    def __len__(self) -> int:
        """Minibatches yielded by THIS RANK in the CURRENT epoch, tail-exact."""
        order_len = len(self._epoch_order(self._state.epoch))
        return sum(
            max(0, self._fetch_num_batches(g, order_len) - skip)
            for g, skip in self._fetch_entries()
        )

    def _fetch_num_batches(self, global_fetch_id: int, order_len: int) -> int:
        rows = min(self.fetch_size, order_len - global_fetch_id * self.fetch_size)
        if rows <= 0:
            return 0
        m = self.batch_size
        return rows // m if self.drop_last else (rows + m - 1) // m

    @property
    def n(self) -> int:
        return len(self.collection)

    @property
    def fetch_size(self) -> int:
        return self.batch_size * self.fetch_factor

    # ------------------------------------------------------------------- plan
    def _epoch_order(self, epoch: int) -> np.ndarray:
        """Epoch index sequence, cached with the nearest other cached epoch
        (ties to the lower)."""
        order = self._order_cache.get(epoch)  # unlocked-ok: racy fast path on an immutable-once-cached value
        if order is not None:
            return order
        with self._order_lock:
            order = self._order_cache.get(epoch)
            if order is None:
                order = self.strategy.epoch_indices(self.n, self.seed, epoch)
                kept = {epoch: order}
                if self._order_cache:
                    near = min(self._order_cache, key=lambda e: (abs(e - epoch), e))
                    kept[near] = self._order_cache[near]
                self._order_cache = kept
            return order

    def _global_fetch_count(self) -> int:
        total = self.strategy.epoch_len(self.n)
        if self.drop_last:
            return total // self.fetch_size
        return (total + self.fetch_size - 1) // self.fetch_size

    def _fetch_entries(self) -> list:
        """This rank's epoch fetch list as ``(gid, skip_batches)`` entries."""
        if self._fetch_plan is not None:
            return list(self._fetch_plan)
        g = self._global_fetch_count()
        return [(gid, 0) for gid in range(self.rank, g, self.world_size)]

    def plan_epoch(self, epoch: Optional[int] = None) -> dict:
        """The epoch's fetch plan without touching data: sampling, batching,
        placement, the planned collection's async knobs and the spec
        fingerprint (the reference's keys)."""
        epoch = self._state.epoch if epoch is None else epoch
        order = self._epoch_order(epoch)
        entries = self._fetch_entries()
        col = self.collection
        return {
            "epoch": epoch,
            "order_len": len(order),
            "global_fetches": self._global_fetch_count(),
            "rank_fetches": [gid for gid, _ in entries],
            "explicit_plan": self._fetch_plan is not None,
            "fetch_size": self.fetch_size,
            "rank_batches": sum(
                max(0, self._fetch_num_batches(gid, len(order)) - skip) for gid, skip in entries
            ),
            "batch_size": self.batch_size,
            "fetch_factor": self.fetch_factor,
            "drop_last": self.drop_last,
            "sort_fetch_indices": self.sort_fetch_indices,
            "seed": self.seed,
            "rank": self.rank,
            "world_size": self.world_size,
            "io_workers": int(getattr(col, "io_workers", 1) or 1),
            "readahead": int(getattr(col, "readahead", 0) or 0),
            "readahead_auto": bool(getattr(col, "readahead_auto", False)),
            "admission": getattr(col, "admission", None),
            "cross_epoch_prefetch": self.cross_epoch_prefetch,
            "diversity_obs": self.diversity_obs,
            "fingerprint": self.spec_fingerprint,
        }

    def autotune(
        self,
        *,
        mem_budget_bytes: float = 2e9,
        drift_threshold: float = 0.5,
        num_classes: int = 14,
        entropy_slack_bits: float = 0.1,
        throughput_slack: float = 0.0,
        entropy_floor: Optional[float] = None,
        probes: int = 3,
        probe_rows: int = 512,
        apply: bool = False,
        force: bool = False,
    ):
        """Probe this loader's planned collection and recommend ``(b, f)``.

        The fitted :class:`~repro_torch.core.autotune.IOCostModel` is
        cached; a later call probes again only when ``force`` or when the
        collection's counters since the fit (and the readahead controller's
        moves, and a measured entropy under the adopted pick's prediction)
        drift past ``drift_threshold`` (:func:`~repro_torch.core.autotune.
        model_drift`).  ``entropy_floor`` (bits) keeps only cells whose
        predicted E[H] clears it, against the monitor's label distribution
        where the loader has one.  ``apply=True`` adopts the pick
        (``fetch_factor``, and the strategy's ``block_size`` where it has
        one): call it at an epoch boundary, it changes the stream.  Returns
        the :class:`~repro_torch.core.autotune.Recommendation`.
        """
        from .autotune import model_drift, probe_collection, recommend_from

        col = self.collection
        if not (hasattr(col, "iostats") and hasattr(col, "cache")):
            raise TypeError(
                "autotune() needs a planned collection (open_collection); "
                f"got {type(col).__name__}"
            )
        ctl = getattr(col, "_ra_controller", None)
        ra_now = (ctl.grows + ctl.shrinks) if ctl is not None else 0
        model = self._tuned_model
        if model is None or force or model_drift(
            model,
            col.iostats,
            base=self._tuned_base,
            ra_shifts=max(0, ra_now - self._tuned_ra_mark),
            expected_entropy=self._tuned_entropy,
        ) > drift_threshold:
            model = probe_collection(col, probes=probes, probe_rows=probe_rows)
            self._tuned_model = model
            # later drift is measured on the counters' deltas from here
            self._tuned_base = col.iostats.snapshot()
            self._tuned_ra_mark = (ctl.grows + ctl.shrinks) if ctl is not None else 0
        rec = recommend_from(
            model,
            batch_size=self.batch_size,
            budget=mem_budget_bytes,
            num_classes=num_classes,
            entropy_slack_bits=entropy_slack_bits,
            throughput_slack=throughput_slack,
            class_probs=self._div.class_probs() if self._div is not None else None,
            entropy_floor=entropy_floor,
        )
        if apply:
            self._tuned_entropy = rec.predicted_entropy
            self.fetch_factor = int(rec.fetch_factor)
            if hasattr(self.strategy, "block_size"):
                self.strategy = dataclasses.replace(self.strategy, block_size=int(rec.block_size))
            with self._order_lock:
                self._order_cache = {}  # the geometry changed: derive the order anew
        return rec

    def repartition(self, rank: int, world_size: int, plan: Optional[list] = None) -> None:
        """Re-home this loader as ``rank`` of ``world_size`` mid-epoch.

        With ``plan`` (``(global_fetch_id, skip_batches)`` entries, e.g. one
        share of :func:`repro_torch.distributed.elastic.partition`) it
        delivers exactly those fetches for the rest of the CURRENT epoch,
        and round-robin under the new world from the next epoch on; without
        one, the round-robin derivation applies at once.  The cursors
        restart at zero: the entries' skips carry a mid-fetch position.
        """
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range for world_size {world_size}")
        self.rank = int(rank)
        self.world_size = int(world_size)
        if plan is None:
            self._fetch_plan = None
        else:
            g = self._global_fetch_count()
            norm = [(int(gid), int(skip)) for gid, skip in plan]
            bad = [gid for gid, _ in norm if not (0 <= gid < g)]
            if bad:
                raise ValueError(
                    f"plan contains global fetch ids {bad} outside [0, {g}) "
                    f"for this epoch's geometry"
                )
            self._fetch_plan = norm
        self._state = LoaderState(self.seed, self._state.epoch, 0, 0)

    # ------------------------------------------------------------------ state
    def remaining_fetches(self) -> list:
        """The ``(global_fetch_id, skip_batches)`` entries this rank still
        owes the CURRENT epoch; the first carries the in-progress fetch's
        ``batch_cursor``."""
        s = self._state
        out = []
        for i, (gid, skip) in enumerate(self._fetch_entries()[s.fetch_cursor:]):
            if i == 0:
                skip = max(skip, s.batch_cursor)
            out.append((int(gid), int(skip)))
        return out

    def state(self) -> LoaderState:
        rem = self.remaining_fetches()
        return dataclasses.replace(
            self._state,
            world_size=self.world_size,
            global_cursor=rem[0][0] if rem else None,
            remaining=tuple(rem),
        )

    def load_state(self, state: LoaderState) -> None:
        if state.seed != self.seed:
            raise ValueError(
                f"checkpointed loader seed {state.seed} != configured seed {self.seed}; "
                "resuming with a different seed would silently change the data order"
            )
        if state.remaining is not None:
            # v2 state: the remaining list is authoritative, so resumption is
            # bitwise whatever this loader's rank and world
            self._fetch_plan = [(int(g), int(s)) for g, s in state.remaining]
            self._state = LoaderState(self.seed, state.epoch, 0, 0, state.fingerprint)
        else:
            self._fetch_plan = None
            self._state = dataclasses.replace(state)

    def set_epoch(self, epoch: int) -> None:
        self._fetch_plan = None
        self._state = LoaderState(self.seed, int(epoch), 0)
        self._notify_epoch_boundary()

    def _notify_epoch_boundary(self) -> None:
        """Tell a planned collection that an epoch boundary passed (its
        stream detector and readahead controller restart their windows)."""
        eb = getattr(self.collection, "epoch_boundary", None)
        if eb is not None:
            eb()

    # ------------------------------------------------------------------ fetch
    def _issue_prefetch(self, order: np.ndarray, global_fetch_id: int) -> bool:
        """Issue ONE fetch's read plan in the background; False when the
        fetch holds no rows."""
        lo = global_fetch_id * self.fetch_size
        idx = order[lo : min(lo + self.fetch_size, len(order))]
        if len(idx) == 0:
            return False
        self.callbacks.prefetch_callback(
            self.collection, np.sort(idx, kind="stable") if self.sort_fetch_indices else idx
        )
        return True

    def _readahead(self, order: np.ndarray, epoch: int, global_fetch_id: int) -> None:
        """Issue the next fetches' read plans before this fetch blocks on its
        own reads.  ``readahead`` is read per fetch: under ``"auto"`` the
        collection's controller moves it.  Repeat issues are no-ops."""
        ra = int(getattr(self.collection, "readahead", 0) or 0)
        if ra <= 0:
            return
        g = self._global_fetch_count()
        if self._fetch_plan is not None:
            # an explicit plan: the upcoming gids are its next entries
            gids = [gid for gid, _ in self._fetch_plan]
            pos = gids.index(global_fetch_id) if global_fetch_id in gids else len(gids)
            upcoming = gids[pos + 1 : pos + 1 + ra]
        else:
            upcoming = [global_fetch_id + k * self.world_size for k in range(1, ra + 1)]
        issued = 0
        for nxt in upcoming:
            if nxt >= g or not self._issue_prefetch(order, nxt):
                break
            issued += 1
        if self.cross_epoch_prefetch and issued < ra:
            # the epoch's tail: fill the window from this rank's first
            # fetches of the next epoch
            order2 = self._epoch_order(epoch + 1)
            for j in range(ra - issued):
                nxt2 = self.rank + j * self.world_size
                if nxt2 >= g or not self._issue_prefetch(order2, nxt2):
                    break

    def fetch(self, epoch: int, global_fetch_id: int) -> list:
        """Materialize ONE fetch (Alg. 1 lines 7–10): its minibatches.

        Deterministic in ``(seed, epoch, global_fetch_id)`` alone.
        """
        order = self._epoch_order(epoch)
        lo = global_fetch_id * self.fetch_size
        fetch_idx = order[lo : min(lo + self.fetch_size, len(order))]
        if len(fetch_idx) == 0:
            return []
        cbs = self.callbacks
        if self.sort_fetch_indices:
            sorted_idx = fetch_idx[np.argsort(fetch_idx, kind="stable")]  # line 7
        else:
            sorted_idx = fetch_idx
        self._readahead(order, epoch, global_fetch_id)
        fetched = cbs.fetch_transform(cbs.fetch_callback(self.collection, sorted_idx))  # line 8

        perm = epoch_rng(self.seed, epoch, 0xF37C, global_fetch_id).permutation(
            len(sorted_idx)
        )  # line 9
        m = self.batch_size
        nb = len(perm) // m if self.drop_last else (len(perm) + m - 1) // m
        batches = []
        for j in range(nb):  # line 10
            rows = perm[j * m : (j + 1) * m]
            if self._div is not None:
                self._div.observe(sorted_idx[rows])  # telemetry: the batch is untouched
            batches.append(cbs.batch_transform(cbs.batch_callback(fetched, rows)))
        return batches

    # ---------------------------------------------------------------- iterate
    def __iter__(self) -> Iterator:
        """Yield minibatches, resuming from the checkpointed cursor.

        In a ``DataLoader`` worker, only the fetches at positions
        ``cursor + worker_id :: num_workers`` of the rank's list.  State is
        updated BEFORE each yield, so a checkpoint taken while the consumer
        holds batch j resumes at batch j+1.
        """
        info = get_worker_info()
        wid, nw = (0, 1) if info is None else (info.id, info.num_workers)
        epoch = self._state.epoch
        entries = self._fetch_entries()
        cursor = self._state.fetch_cursor
        for pos in range(cursor + wid, len(entries), nw):
            gid, skip = entries[pos]
            if pos == cursor:  # the fetch a mid-fetch checkpoint stopped in
                skip = max(skip, self._state.batch_cursor)
            batches = self.fetch(epoch, gid)
            for j in range(skip, len(batches)):
                if j + 1 < len(batches):
                    self._state = LoaderState(self.seed, epoch, pos, j + 1)
                else:
                    self._state = LoaderState(self.seed, epoch, pos + nw, 0)
                yield batches[j]
        self._fetch_plan = None
        self._state = LoaderState(self.seed, epoch + 1, 0, 0)
        self._notify_epoch_boundary()

    def epochs(self, num_epochs: int) -> Iterator:
        for _ in range(num_epochs):
            yield from iter(self)
