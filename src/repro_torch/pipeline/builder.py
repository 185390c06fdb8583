"""Pipeline — the fluent face of :class:`~repro_torch.pipeline.spec.PipelineSpec`;
the port of ``repro.pipeline.builder``::

    pipe = (Pipeline.from_uri("sharded-csr:///data/tahoe",
                              cache_bytes=64 << 20, io_workers=4, readahead=1)
            .strategy("block", block_size=16)
            .batch(64, fetch_factor=8)
            .shard(rank=0, world_size=1)
            .seed(0)
            .build())
    for minibatch in pipe:
        ...

Every chain method records into the spec and returns the builder, so
``pipe.spec.to_json()`` is the full reproducible description of the
stream, equal to ``repro``'s for the same chain.  The URI opens through the
planned storage layer (:func:`repro_torch.data.backend.open_collection`),
with the planner knobs as keywords or in the query string; a knob changed
after ``build()`` reopens the collection at the next build.  The built
:class:`DataPipeline` iterates minibatches and owns checkpoint state
(:meth:`DataPipeline.state` carries the spec fingerprint;
:meth:`DataPipeline.load_state` refuses a state whose fingerprint does not
match) and closes only the collections it opened.

``prefetch(workers=N)`` with N > 0 iterates through a
:class:`~repro_torch.core.prefetch.FetchPool` of N threads with the spec's
``max_outstanding`` and straggler knobs (:attr:`DataPipeline.last_pool`);
its batches and their order are the synchronous iteration's.

``resilience`` records the retry, hedge and shard-circuit knobs and
``diversity`` the monitored obs column and the entropy floor; all of them
are content-free, so the fingerprint ignores them.  ``autotune`` probes a
freshly opened collection (:func:`repro_torch.core.autotune.
fit_and_recommend`) and records the recommended ``(block_size,
fetch_factor)``, ``io_workers`` and ``readahead`` in the spec; the built
pipeline keeps the recommendation, measures drift from its model
(:meth:`DataPipeline.check_drift`) and probes its live collection again on
request (:meth:`DataPipeline.retune`).

``shared()`` opens the collection through the process's pool of shared
collections (:data:`repro_torch.distributed.elastic.GLOBAL_POOL`, keyed by
the URI and opener options), so that co-located pipelines of the same data
share one block cache and one rendezvous table; closing such a pipeline
drops its reference and leaves the shared collection open.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional

import numpy as np

from ..core.autotune import Recommendation, fit_and_recommend, model_drift
from ..core.dataset import LoaderState, ScIterableDataset
from ..core.prefetch import FetchPool
from ..core.sampling import SamplingStrategy
from ..data.backend import open_collection
from ..data.readplan import normalize_readahead
from ..distributed.elastic.pool import GLOBAL_POOL, pool_key
from .spec import PipelineSpec, strategy_from_spec, strategy_to_spec

__all__ = ["Pipeline", "DataPipeline"]


class Pipeline:
    """Fluent builder accumulating a :class:`PipelineSpec`.

    Construct with :meth:`from_uri`, :meth:`from_spec`, or
    :meth:`from_collection` (an in-process collection; the spec then has
    ``uri=None``, cannot be serialized and stamps no fingerprint).
    """

    #: spec fields that take effect only when the collection is opened
    _COLLECTION_FIELDS = (
        "uri", "cache_bytes", "block_rows", "max_extent_rows", "io_workers", "readahead",
        "admission", "cache_policy", "open_opts", "retries", "retry_backoff_s",
        "retry_max_backoff_s", "retry_deadline_s", "hedge_factor", "hedge_min_s",
        "breaker_threshold", "breaker_cooldown_s", "shared_pool",
    )

    def __init__(self, spec: PipelineSpec, collection: Any = None, iostats: Any = None):
        self._spec = spec
        self._collection = collection
        # True only for a collection this builder opened from the URI: the
        # built pipeline releases those, never a caller's
        self._owns_collection = False
        # the pool key of a collection taken from GLOBAL_POOL (shared_pool):
        # the built pipeline drops the reference, never the collection
        self._pool_key: Optional[str] = None
        # a caller-owned IOCounters (e.g. with a storage model to simulate),
        # threaded into open_collection; runtime only, never in the spec
        self._iostats = iostats
        # the pick of the last autotune(), handed to the built pipeline
        self.last_recommendation: Optional[Recommendation] = None

    # ------------------------------------------------------------ entries
    @classmethod
    def from_uri(
        cls,
        uri: str,
        *,
        cache_bytes: Optional[int] = None,
        block_rows: Optional[int] = None,
        max_extent_rows: Optional[int] = None,
        io_workers: int = 1,
        readahead=0,
        admission: str = "always",
        cache_policy: str = "lru",
        iostats: Any = None,
        **open_opts,
    ) -> "Pipeline":
        """Start from a storage URI plus the planner knobs of
        ``open_collection``; other keywords are opener options
        (``seq_len``), recorded in the spec.  ``None`` knobs mean the
        backend's default; ``max_extent_rows=0`` means unbounded."""
        return cls(PipelineSpec(
            uri=uri,
            cache_bytes=cache_bytes,
            block_rows=block_rows,
            max_extent_rows=max_extent_rows,
            io_workers=io_workers,
            readahead=readahead,
            admission=admission,
            cache_policy=cache_policy,
            open_opts=dict(open_opts),
        ), iostats=iostats)

    @classmethod
    def from_spec(cls, spec: PipelineSpec) -> "Pipeline":
        return cls(spec)

    @classmethod
    def from_collection(cls, collection: Any, **spec_kw) -> "Pipeline":
        """Wrap an in-process collection (an array, a store, an opened
        :class:`~repro_torch.data.backend.PlannedRows`)."""
        return cls(PipelineSpec(uri=None, **spec_kw), collection=collection)

    # ------------------------------------------------------------- chain
    @property
    def spec(self) -> PipelineSpec:
        return self._spec

    def _replace(self, **kw) -> "Pipeline":
        old = self._spec
        self._spec = old.replace(**kw)
        # a collection knob changed after this builder opened its
        # collection: the next build() reopens it with the new knobs (a
        # pipeline already built keeps its own reference)
        if self._owns_collection and any(
            getattr(old, f) != getattr(self._spec, f) for f in self._COLLECTION_FIELDS
        ):
            if self._pool_key is not None:
                GLOBAL_POOL.release(self._pool_key)
                self._pool_key = None
            self._collection = None
            self._owns_collection = False
        return self

    def strategy(self, strategy, /, **params) -> "Pipeline":
        """``.strategy("block", block_size=16)`` (registry name + params) or
        ``.strategy(BlockShuffling(16))`` (an instance, reverse-registered
        into the spec)."""
        if isinstance(strategy, SamplingStrategy):
            if params:
                raise ValueError("pass params only with a strategy NAME")
            name, params = strategy_to_spec(strategy)
            return self._replace(strategy=name, strategy_params=params)
        return self._replace(strategy=str(strategy), strategy_params=dict(params))

    def batch(
        self,
        batch_size: int,
        *,
        fetch_factor: Optional[int] = None,
        drop_last: Optional[bool] = None,
        sort_fetch_indices: Optional[bool] = None,
    ) -> "Pipeline":
        kw: dict = {"batch_size": int(batch_size)}
        if fetch_factor is not None:
            kw["fetch_factor"] = int(fetch_factor)
        if drop_last is not None:
            kw["drop_last"] = bool(drop_last)
        if sort_fetch_indices is not None:
            kw["sort_fetch_indices"] = bool(sort_fetch_indices)
        return self._replace(**kw)

    def shard(self, rank: int, world_size: int) -> "Pipeline":
        return self._replace(rank=int(rank), world_size=int(world_size))

    def seed(self, seed: int) -> "Pipeline":
        return self._replace(seed=int(seed))

    def prefetch(
        self,
        *,
        workers: Optional[int] = None,
        max_outstanding: Optional[int] = None,
        straggler_factor: Optional[float] = None,
        straggler_min_latency: Optional[float] = None,
        readahead=None,
        io_workers: Optional[int] = None,
        cross_epoch: Optional[bool] = None,
    ) -> "Pipeline":
        """The consumer-side pool (``workers`` threads of a
        :class:`FetchPool`, 0 for synchronous iteration, and its straggler
        re-issue knobs) and the collection's ``readahead`` / ``io_workers``
        / ``cross_epoch`` prefetch, recorded as ``repro`` records them.
        Set-if-passed."""
        kw: dict = {}
        if workers is not None:
            kw["prefetch_workers"] = int(workers)
        if max_outstanding is not None:
            kw["max_outstanding"] = int(max_outstanding)
        if straggler_factor is not None:
            kw["straggler_factor"] = float(straggler_factor)
        if straggler_min_latency is not None:
            kw["straggler_min_latency"] = float(straggler_min_latency)
        if readahead is not None:
            kw["readahead"] = normalize_readahead(readahead)
        if io_workers is not None:
            kw["io_workers"] = int(io_workers)
        if cross_epoch is not None:
            kw["cross_epoch_prefetch"] = bool(cross_epoch)
        return self._replace(**kw)

    def cache(
        self,
        *,
        bytes: Optional[int] = None,
        block_rows: Optional[int] = None,
        admission: Optional[str] = None,
        policy: Optional[str] = None,
    ) -> "Pipeline":
        """The block cache's byte budget, block size, admission policy
        (``always`` | ``auto`` | ``never``) and organization (``lru`` |
        ``wtinylfu``); all content-free.  Set-if-passed."""
        kw: dict = {}
        if bytes is not None:
            kw["cache_bytes"] = int(bytes)
        if block_rows is not None:
            kw["block_rows"] = int(block_rows)
        if admission is not None:
            kw["admission"] = str(admission)
        if policy is not None:
            kw["cache_policy"] = str(policy)
        return self._replace(**kw)

    def shared(self, on: bool = True) -> "Pipeline":
        """Open the collection through the process's pool of shared
        collections instead of privately: pipelines of the same URI and
        opener options then share one block cache and one rendezvous
        table, and the first opener's collection knobs hold for all.
        Content-free; closing the built pipeline drops its reference."""
        return self._replace(shared_pool=bool(on))

    def resilience(
        self,
        *,
        retries: Optional[int] = None,
        backoff_s: Optional[float] = None,
        max_backoff_s: Optional[float] = None,
        deadline_s: Optional[float] = None,
        hedge_factor: Optional[float] = None,
        hedge_min_s: Optional[float] = None,
        breaker_threshold: Optional[int] = None,
        breaker_cooldown_s: Optional[float] = None,
    ) -> "Pipeline":
        """Bounded ``retries`` with decorrelated-jitter backoff
        (``backoff_s`` base, ``max_backoff_s`` cap, a per-read
        ``deadline_s``), hedged reads (``hedge_factor`` times the reads'
        wait EWMA, at least ``hedge_min_s``) and a per-shard circuit
        (``breaker_threshold`` consecutive failures open it,
        ``breaker_cooldown_s`` before a half-open probe); see
        :class:`~repro_torch.data.backend.PlannedRows`.  Content-free.
        Set-if-passed."""
        kw: dict = {}
        for key, v, cast in (("retries", retries, int), ("retry_backoff_s", backoff_s, float),
                             ("retry_max_backoff_s", max_backoff_s, float),
                             ("retry_deadline_s", deadline_s, float),
                             ("hedge_factor", hedge_factor, float),
                             ("hedge_min_s", hedge_min_s, float),
                             ("breaker_threshold", breaker_threshold, int),
                             ("breaker_cooldown_s", breaker_cooldown_s, float)):
            if v is not None:
                kw[key] = cast(v)
        return self._replace(**kw)

    def diversity(self, *, obs: Optional[str] = None,
                  entropy_floor: Optional[float] = None) -> "Pipeline":
        """``obs``: the obs column whose per-batch label entropy the built
        loader records into the collection's ``div_*`` counters (an
        :class:`~repro_torch.core.dataset.EntropyMonitor`; the stream is
        untouched).  ``entropy_floor`` (bits): the target :meth:`autotune`
        keeps the predicted E[H] above.  Content-free.  Set-if-passed."""
        kw: dict = {}
        if obs is not None:
            kw["diversity_obs"] = str(obs)
        if entropy_floor is not None:
            kw["entropy_floor"] = float(entropy_floor)
        return self._replace(**kw)

    def autotune(
        self,
        *,
        budget: float = 2e9,
        probes: int = 3,
        probe_rows: int = 512,
        num_classes: int = 14,
        entropy_slack_bits: float = 0.1,
        throughput_slack: float = 0.0,
        entropy_floor: Optional[float] = None,
        apply: bool = True,
    ) -> "Pipeline":
        """Probe the collection this spec opens, recommend ``(block_size,
        fetch_factor)``, and with ``apply`` record the pick in the spec.

        A URI-backed spec is probed on a freshly opened collection, released
        after, so the built pipeline's cache and counters start clean; an
        in-process collection is probed as it is.  With
        ``.diversity(obs=...)`` the prediction uses that column's label
        distribution; ``entropy_floor`` (recorded in the spec) keeps only
        cells whose predicted E[H] clears it, and an unreachable floor
        raises with the best achievable value.  With ``apply``, a URI-backed
        spec also records the pick's ``io_workers``, and its ``readahead``
        where the cache is on.  The pick is kept as
        :attr:`last_recommendation`.
        """
        if entropy_floor is not None:
            self._replace(entropy_floor=float(entropy_floor))
        floor = self._spec.entropy_floor or None  # 0.0: no floor
        own = self._collection is None
        col = _open_from_spec(self._spec) if own else self._collection
        try:
            rec = fit_and_recommend(
                col,
                probes=probes,
                probe_rows=probe_rows,
                batch_size=self._spec.batch_size,
                budget=budget,
                num_classes=num_classes,
                entropy_slack_bits=entropy_slack_bits,
                throughput_slack=throughput_slack,
                class_probs=_class_probs(col, self._spec.diversity_obs),
                entropy_floor=floor,
            )
        finally:
            if own and hasattr(col, "release"):
                col.release()
        self.last_recommendation = rec
        if apply:
            self._replace(fetch_factor=int(rec.fetch_factor))
            if self._spec.strategy in ("block", "block-weighted", "class-balanced"):
                self._replace(strategy_params={**self._spec.strategy_params,
                                               "block_size": int(rec.block_size)})
            if self._spec.uri is not None:
                conc: dict = {"io_workers": int(rec.io_workers)}
                if self._spec.cache_bytes is None or self._spec.cache_bytes > 0:
                    conc["readahead"] = rec.readahead  # readahead stages through the cache
                self._replace(**conc)
        return self

    # -------------------------------------------------------------- build
    def _open(self) -> Any:
        """The collection this spec describes, opened once and reused.  A
        pre-opened collection is returned as it is, so a collection knob
        set on such a spec would act on nothing: that is an error."""
        s = self._spec
        if self._collection is None:
            if s.shared_pool:
                if s.uri is None:
                    raise ValueError("shared_pool=True needs a URI-backed spec (the pool "
                                     "keys collections by data identity)")
                key = pool_key(s.uri, s.open_opts)
                self._collection = GLOBAL_POOL.acquire(
                    key, lambda: _open_from_spec(s, iostats=self._iostats))
                self._pool_key = key
            else:
                self._collection = _open_from_spec(s, iostats=self._iostats)
            self._owns_collection = True
            return self._collection
        if not self._owns_collection:
            defaults = PipelineSpec()
            overridden = [name for name in self._COLLECTION_FIELDS
                          if name != "uri" and getattr(s, name) != getattr(defaults, name)]
            if overridden:
                raise ValueError(
                    f"collection-side knob(s) {overridden} have no effect on a pre-opened "
                    "collection (from_collection): pass them to open_collection yourself, "
                    "or build from_uri"
                )
        return self._collection

    def build(self, **dataset_kw) -> "DataPipeline":
        """Open the collection, resolve the strategy and wire the
        :class:`ScIterableDataset`; ``dataset_kw`` passes hooks through
        (``batch_transform=...``)."""
        s = self._spec
        col = self._open()
        strat = strategy_from_spec(s.strategy, s.strategy_params, col)
        ds = ScIterableDataset(
            col,
            strat,
            batch_size=s.batch_size,
            fetch_factor=s.fetch_factor,
            seed=s.seed,
            rank=s.rank,
            world_size=s.world_size,
            drop_last=s.drop_last,
            sort_fetch_indices=s.sort_fetch_indices,
            cross_epoch_prefetch=s.cross_epoch_prefetch,
            diversity_obs=s.diversity_obs,
            **dataset_kw,
        )
        ds.spec_fingerprint = s.fingerprint() if s.uri is not None else None
        return DataPipeline(s, col, ds, recommendation=self.last_recommendation,
                            owns_collection=self._owns_collection, pool_key=self._pool_key)


def _class_probs(collection: Any, obs: Optional[str]) -> Optional[np.ndarray]:
    """The label distribution of ``obs`` over the collection (None without
    a diversity column): the H(p) an entropy floor is predicted against."""
    if obs is None:
        return None
    _, counts = np.unique(np.asarray(collection.obs_column(obs)), return_counts=True)
    return counts / counts.sum()


def _open_from_spec(spec: PipelineSpec, iostats: Any = None) -> Any:
    """``open_collection`` with exactly the knobs the spec records."""
    if spec.uri is None:
        raise ValueError("pipeline has no collection: use from_uri(...) or from_collection(...)")
    knobs = {k: v for k, v in (("cache_bytes", spec.cache_bytes),
                               ("block_rows", spec.block_rows)) if v is not None}
    if spec.max_extent_rows is not None:
        # the spec spells "unbounded" 0; open_collection spells it None
        knobs["max_extent_rows"] = None if spec.max_extent_rows == 0 else spec.max_extent_rows
    return open_collection(
        spec.uri,
        iostats=iostats,
        io_workers=spec.io_workers,
        readahead=spec.readahead,
        admission=spec.admission,
        cache_policy=spec.cache_policy,
        retries=spec.retries,
        retry_backoff_s=spec.retry_backoff_s,
        retry_max_backoff_s=spec.retry_max_backoff_s,
        retry_deadline_s=spec.retry_deadline_s,
        hedge_factor=spec.hedge_factor,
        hedge_min_s=spec.hedge_min_s,
        breaker_threshold=spec.breaker_threshold,
        breaker_cooldown_s=spec.breaker_cooldown_s,
        **knobs,
        **spec.open_opts,
    )


class DataPipeline:
    """A built pipeline: iterate it, checkpoint it, introspect it, close it.
    Sampling semantics live in :class:`ScIterableDataset`, reads in the
    collection; this object owns the wiring and the fingerprint-checked
    resume contract."""

    def __init__(self, spec: PipelineSpec, collection: Any, dataset: ScIterableDataset, *,
                 recommendation: Optional[Recommendation] = None,
                 owns_collection: bool = False, pool_key: Optional[str] = None):
        self.spec = spec
        self.collection = collection
        self.dataset = dataset
        # the autotune pick this pipeline was built from (its model is what
        # check_drift measures against), or retune's latest
        self.recommendation = recommendation
        self.owns_collection = owns_collection
        #: set when the collection is a GLOBAL_POOL reference: close() then
        #: drops the reference instead of closing the shared collection
        self.pool_key = pool_key
        # the FetchPool behind the most recent __iter__ (None when iterating
        # synchronously): its stats show the workers' balance
        self.last_pool: Optional[FetchPool] = None

    # ------------------------------------------------------------ iterate
    def __iter__(self) -> Iterator:
        if self.spec.prefetch_workers > 0:
            self.last_pool = FetchPool(
                self.dataset,
                num_workers=self.spec.prefetch_workers,
                max_outstanding=self.spec.max_outstanding,
                straggler_factor=self.spec.straggler_factor,
                straggler_min_latency=self.spec.straggler_min_latency,
            )
            return iter(self.last_pool)
        return iter(self.dataset)

    def epochs(self, num_epochs: int) -> Iterator:
        for _ in range(num_epochs):
            yield from iter(self)

    def __len__(self) -> int:
        """Minibatches THIS RANK yields per epoch (tail-exact)."""
        return len(self.dataset)

    # -------------------------------------------------------------- state
    def state(self) -> LoaderState:
        """Loader state stamped with the spec fingerprint (URI-backed specs
        only: an in-process collection has no data identity to hash)."""
        fp = self.spec.fingerprint() if self.spec.uri is not None else None
        return dataclasses.replace(self.dataset.state(), fingerprint=fp)

    def load_state(self, state: LoaderState) -> None:
        """Resume — refusing a checkpoint from a DIFFERENT stream.  A state
        without a fingerprint falls back to the dataset's seed check."""
        if state.fingerprint is not None:
            want = self.spec.fingerprint()
            if state.fingerprint != want:
                raise ValueError(
                    f"checkpoint fingerprint {state.fingerprint} does not "
                    f"match this pipeline's spec ({want}): the spec drifted "
                    "since the checkpoint was taken — resuming would "
                    "silently change the minibatch stream. Rebuild from the "
                    "checkpointed spec (PipelineSpec.from_json) or start fresh."
                )
        self.dataset.load_state(state)

    def set_epoch(self, epoch: int) -> None:
        self.dataset.set_epoch(epoch)

    # ---------------------------------------------------------- introspect
    def plan_epoch(self, epoch: Optional[int] = None) -> dict:
        return self.dataset.plan_epoch(epoch)

    def stats(self) -> dict:
        if hasattr(self.collection, "stats"):
            return self.collection.stats()
        return {}

    @property
    def schema(self) -> dict:
        return getattr(self.collection, "schema", {})

    def check_drift(self) -> Optional[float]:
        """:func:`~repro_torch.core.autotune.model_drift` of the live
        counters from the autotuned model (lifetime totals); None when the
        pipeline was not autotuned or its collection has no counters.
        Compare it with a threshold of your own and :meth:`retune`."""
        model = getattr(self.recommendation, "model", None)
        stats = getattr(self.collection, "iostats", None)
        if model is None or stats is None:
            return None
        return model_drift(model, stats)

    def retune(
        self,
        *,
        budget: float = 2e9,
        probes: int = 3,
        probe_rows: int = 512,
        num_classes: int = 14,
        entropy_slack_bits: float = 0.1,
        throughput_slack: float = 0.0,
    ) -> Recommendation:
        """Probe the live collection (its cache warm) and recommend again
        under the spec's ``diversity_obs`` and ``entropy_floor``.  The spec
        is unchanged: the pick is returned and kept as
        :attr:`recommendation`; rebuild from an updated spec to adopt it."""
        rec = fit_and_recommend(
            self.collection,
            probes=probes,
            probe_rows=probe_rows,
            batch_size=self.spec.batch_size,
            budget=budget,
            num_classes=num_classes,
            entropy_slack_bits=entropy_slack_bits,
            throughput_slack=throughput_slack,
            class_probs=_class_probs(self.collection, self.spec.diversity_obs),
            entropy_floor=self.spec.entropy_floor or None,
        )
        self.recommendation = rec
        return rec

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Release the collection's pool and OS resources, only when this
        pipeline opened it; a caller's collection is the caller's to close,
        and a shared one stays open for the pool's other holders."""
        if not self.owns_collection:
            return
        if self.pool_key is not None:
            GLOBAL_POOL.release(self.pool_key)
            return
        if hasattr(self.collection, "release"):
            self.collection.release()
        elif hasattr(self.collection, "close"):
            self.collection.close()

    def __enter__(self) -> "DataPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
