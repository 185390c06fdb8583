"""PipelineSpec — the one frozen, serializable description of a data stream.

The port of ``repro.pipeline.spec``, field for field with the same
``SPEC_VERSION``: ``to_dict`` / ``to_json`` give the same JSON and
:meth:`PipelineSpec.fingerprint` the same hex as ``repro``'s ``DataSpec``
for the same spec, so a checkpoint from either package names its stream the
same way.  The class has another name than its counterpart because
``tools/analyze`` resolves classes by bare name across ``src/``, and its
dataspec-classification contract checks the reference's ``DataSpec``;
``DataSpec`` stays importable here as an alias.

A :class:`PipelineSpec` captures everything the loader takes — collection
knobs, sampling strategy, batch geometry, seed, rank and world — in one
frozen record that:

- round-trips through JSON (``to_json`` / ``from_json``);
- hashes to a :meth:`fingerprint` stored in
  :class:`~repro_torch.core.dataset.LoaderState`, so a checkpoint REFUSES to
  resume against a drifted spec;
- builds: :meth:`PipelineSpec.build` returns the live
  :class:`~repro_torch.pipeline.builder.DataPipeline`.  The port builds
  specs over every scheme (``cloud://`` and ``fault://`` included) with
  every planner, resilience and diversity knob, prefetch workers and
  ``shared_pool`` (the process's pool of shared collections).

Strategies are serialized by NAME + JSON params via a small registry
(:data:`STRATEGY_REGISTRY`).  Array-valued params (weights, labels) are
stored as lists; the ``weights_obs`` / ``labels_obs`` indirection stores a
collection obs-column NAME instead and resolves it at build time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Optional

import numpy as np

from ..core.sampling import (
    BlockShuffling,
    BlockWeightedSampling,
    ClassBalancedSampling,
    SamplingStrategy,
    Streaming,
)
from ..data.readplan import normalize_readahead

__all__ = [
    "PipelineSpec",
    "DataSpec",
    "STRATEGY_REGISTRY",
    "strategy_to_spec",
    "strategy_from_spec",
    "SPEC_VERSION",
]

#: Bumped when the spec schema changes incompatibly; ``from_json`` rejects
#: specs from a future version instead of silently misreading them.
#: History: 1 = the initial schema; 2 adds ``cross_epoch_prefetch``
#: and the ``readahead="auto"`` spelling (older specs still load — missing
#: fields take their defaults — but a version-2 spec presented to version-1
#: code gets the version refusal rather than an "unknown field" puzzle);
#: 3 adds the resilience fields (retries/backoff, hedging, breaker —
#: all content-free: recovery never changes delivered bytes);
#: 4 adds the diversity-observatory fields (``diversity_obs``,
#: ``entropy_floor`` — content-free: telemetry observes the stream and the
#: floor only steers autotune's choice, which lands in fingerprinted fields);
#: 5 adds ``cache_policy`` (content-free: cache organization changes
#: hit rates, never delivered bytes);
#: 6 adds ``shared_pool`` (content-free: co-located consumers
#: attaching to one pooled collection dedup physical reads — the elastic
#: fabric's RINAS path — without changing any delivered byte).
SPEC_VERSION = 6

#: name -> strategy class.  Params are the dataclass fields, JSON-typed;
#: ``weights`` / ``labels`` may instead arrive as ``weights_obs`` /
#: ``labels_obs`` (an obs-column name resolved against the collection).
STRATEGY_REGISTRY: dict[str, type] = {
    "streaming": Streaming,
    "block": BlockShuffling,
    "block-weighted": BlockWeightedSampling,
    "class-balanced": ClassBalancedSampling,
}
_STRATEGY_NAMES = {cls: name for name, cls in STRATEGY_REGISTRY.items()}

# Array-valued strategy params and their obs-column indirection keys.
_ARRAY_PARAMS = {"weights": "weights_obs", "labels": "labels_obs"}


def strategy_to_spec(strategy: SamplingStrategy) -> tuple[str, dict]:
    """(name, JSON-safe params) for a registered strategy instance."""
    cls = type(strategy)
    name = _STRATEGY_NAMES.get(cls)
    if name is None:
        raise ValueError(
            f"{cls.__name__} is not a registered strategy "
            f"({sorted(STRATEGY_REGISTRY)}); pass .strategy(name, **params) "
            "or register the class in STRATEGY_REGISTRY"
        )
    params = {}
    for f in dataclasses.fields(strategy):
        v = getattr(strategy, f.name)
        if v is None:
            continue
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, np.generic):
            v = v.item()
        params[f.name] = v
    return name, params


def strategy_from_spec(
    name: str, params: Mapping[str, Any], collection: Any = None
) -> SamplingStrategy:
    """Instantiate a strategy from its spec form.

    ``weights_obs`` / ``labels_obs`` params name an obs column of
    ``collection`` (any object with ``obs_column``); list-valued ``weights``
    / ``labels`` become arrays.
    """
    cls = STRATEGY_REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown strategy {name!r}; known: {sorted(STRATEGY_REGISTRY)}"
        )
    kw = dict(params)
    for array_key, obs_key in _ARRAY_PARAMS.items():
        col_name = kw.pop(obs_key, None)
        if col_name is not None:
            if collection is None or not hasattr(collection, "obs_column"):
                raise ValueError(
                    f"strategy param {obs_key}={col_name!r} needs a collection "
                    "with obs columns to resolve against"
                )
            kw[array_key] = np.asarray(collection.obs_column(col_name))
        elif isinstance(kw.get(array_key), list):
            kw[array_key] = np.asarray(kw[array_key])
    return cls(**kw)


def _jsonable(x: Any) -> Any:
    """Coerce numpy scalars/arrays so the spec dict is pure-JSON."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


# Every PipelineSpec field is classified into exactly one of these two sets —
# machine-checked by `python tools/analyze` (dataspec-classification).  A
# FINGERPRINT field changes the delivered byte stream, so it feeds
# fingerprint() and a resume across a change of it is refused; a
# CONTENT_FREE field changes wall-clock behaviour only (worker counts,
# caching, placement of THIS rank in a shared sequence) and is excluded.
# Adding a field without classifying it here fails CI.
FINGERPRINT_FIELDS = frozenset({
    "uri", "open_opts", "strategy", "strategy_params", "batch_size",
    "fetch_factor", "drop_last", "sort_fetch_indices", "seed",
    "world_size", "version",
})
CONTENT_FREE_FIELDS = frozenset({
    "rank", "prefetch_workers", "max_outstanding", "straggler_factor",
    "straggler_min_latency", "cache_bytes", "block_rows",
    "max_extent_rows", "io_workers", "readahead", "admission",
    "cache_policy", "cross_epoch_prefetch",
    # resilience: recovery re-reads the same bytes — delivered batches are
    # bitwise invariant under every one of these (the chaos determinism
    # tests pin that), so a resume across a retry-policy change is legal
    "retries", "retry_backoff_s", "retry_max_backoff_s", "retry_deadline_s",
    "hedge_factor", "hedge_min_s", "breaker_threshold", "breaker_cooldown_s",
    # diversity observatory: telemetry over an obs column never touches the
    # delivered stream (pinned by tests/test_diversity.py), and the entropy
    # floor is an autotune TARGET — the (b, f) it picks land in fingerprinted
    # fields, so the floor itself carries no content
    "diversity_obs", "entropy_floor",
    # elastic fabric: attaching to the process-global shared-collection
    # pool changes WHO performs a physical read (cross-rank dedup), never
    # which bytes a consumer is delivered
    "shared_pool",
})


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Everything that determines a minibatch stream, in one frozen record.

    See ``docs/pipeline.md`` for the field reference.  Instances are
    authored by :class:`~repro_torch.pipeline.builder.Pipeline` (fluent) or
    directly; ``from_json(to_json())`` rebuilds a pipeline whose stream is
    bitwise-identical (``tests/test_torch_pipeline.py``).
    """

    # ---- collection: WHAT data, through WHICH planner configuration
    uri: Optional[str] = None  # scheme://path; None = in-process collection
    cache_bytes: Optional[int] = None  # LRU budget; None = backend default
    block_rows: Optional[int] = None  # cache granularity (rows per block)
    max_extent_rows: Optional[int] = None  # cap on one physical read;
    # None = backend default (32768), 0 = UNBOUNDED (JSON has no way to
    # distinguish "unset" from "explicit None", so 0 carries that meaning)
    io_workers: int = 1  # >1: concurrent miss-extent reads
    readahead: Any = 0  # >0: fetches double-buffered ahead; "auto" = adaptive
    admission: str = "always"  # always | auto (stream + TinyLFU) | never
    cache_policy: str = "lru"  # lru | wtinylfu (windowed segmented cache)
    open_opts: dict = dataclasses.field(default_factory=dict)  # opener kwargs

    # ---- sampling: WHICH rows, in WHAT order
    strategy: str = "block"  # STRATEGY_REGISTRY name
    strategy_params: dict = dataclasses.field(
        default_factory=lambda: {"block_size": 16}
    )

    # ---- geometry: HOW the order becomes minibatches
    batch_size: int = 64  # paper's m
    fetch_factor: int = 1  # paper's f (rows per fetch = m*f)
    drop_last: bool = True  # drop the ragged tail fetch/batch
    sort_fetch_indices: bool = True  # Alg. 1 line 7

    # ---- placement: WHO consumes which fetches
    seed: int = 0
    rank: int = 0
    world_size: int = 1

    # ---- prefetch: the consumer-side worker pool
    prefetch_workers: int = 0  # 0 = synchronous iteration
    max_outstanding: int = 4  # resident fetch buffers in the pool
    straggler_factor: float = 3.0  # re-issue at this x median fetch latency
    straggler_min_latency: float = 0.05  # floor (s) before re-issue fires
    cross_epoch_prefetch: bool = False  # readahead window spills into epoch e+1

    # ---- resilience: surviving storage faults (delivery-invariant)
    retries: int = 0  # retry budget per physical read; 0 = fail fast
    retry_backoff_s: float = 0.005  # backoff base (decorrelated jitter)
    retry_max_backoff_s: float = 0.25  # backoff cap per retry sleep
    retry_deadline_s: float = 0.0  # per-read retry wall budget; 0 = none
    hedge_factor: float = 0.0  # hedge at factor x wait EWMA; 0 = off
    hedge_min_s: float = 0.05  # floor on the hedge deadline
    breaker_threshold: int = 0  # consecutive failures to open; 0 = off
    breaker_cooldown_s: float = 1.0  # open -> half-open probe delay

    # ---- diversity observatory: live §3.4 entropy telemetry + SLO
    diversity_obs: Optional[str] = None  # obs column to track; None = off
    entropy_floor: float = 0.0  # autotune E[H] target (bits); 0 = no floor

    # ---- elastic fabric: share one collection across co-located consumers
    shared_pool: bool = False  # open via the process-global CollectionPool

    version: int = SPEC_VERSION

    # ------------------------------------------------------------ validate
    def __post_init__(self):
        if self.batch_size <= 0 or self.fetch_factor <= 0:
            raise ValueError("batch_size and fetch_factor must be positive")
        if not (0 <= self.rank < self.world_size):
            raise ValueError(
                f"rank {self.rank} out of range for world_size {self.world_size}"
            )
        if self.admission not in ("always", "auto", "never"):
            raise ValueError(
                f"admission must be always|auto|never, got {self.admission!r}"
            )
        if self.cache_policy not in ("lru", "wtinylfu"):
            raise ValueError(
                f"cache_policy must be lru|wtinylfu, got {self.cache_policy!r}"
            )
        # the one readahead grammar (int >= 0 | "auto"); raises on anything
        # else, and normalizes e.g. a query-style "2" to the int spelling
        object.__setattr__(self, "readahead", normalize_readahead(self.readahead))
        if self.prefetch_workers < 0 or self.io_workers < 1:
            raise ValueError("prefetch_workers must be >= 0, io_workers >= 1")
        if self.strategy not in STRATEGY_REGISTRY:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; known: "
                f"{sorted(STRATEGY_REGISTRY)}"
            )
        if (
            self.retries < 0
            or self.retry_backoff_s < 0
            or self.retry_max_backoff_s < 0
            or self.retry_deadline_s < 0
            or self.hedge_factor < 0
            or self.breaker_threshold < 0
            or self.breaker_cooldown_s < 0
        ):
            raise ValueError("resilience fields must be non-negative")
        if self.hedge_min_s <= 0:
            raise ValueError("hedge_min_s must be positive")
        if self.entropy_floor < 0:
            raise ValueError("entropy_floor must be non-negative (bits)")

    # ----------------------------------------------------------- serialize
    def replace(self, **kw) -> "PipelineSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return _jsonable(dataclasses.asdict(self))

    def to_json(self, *, indent: Optional[int] = None) -> str:
        if self.uri is None:
            raise ValueError(
                "spec holds an in-process collection (uri=None) and cannot "
                "be serialized; build from a URI for a portable spec"
            )
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "PipelineSpec":
        d = dict(d)
        version = int(d.pop("version", SPEC_VERSION))
        if version > SPEC_VERSION:
            raise ValueError(
                f"spec version {version} is newer than this code's "
                f"{SPEC_VERSION}; refusing to guess at its meaning"
            )
        known = {f.name for f in dataclasses.fields(PipelineSpec)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown PipelineSpec field(s): {sorted(unknown)}")
        return PipelineSpec(version=version, **d)

    @staticmethod
    def from_json(s: str) -> "PipelineSpec":
        return PipelineSpec.from_dict(json.loads(s))

    def fingerprint(self) -> str:
        """Stable short hash of everything that determines the stream.

        Rank-independent and prefetch-independent ON PURPOSE: every rank of
        one job shares a fingerprint (the global sequence is shared), and
        worker counts / planner caching change wall-clock, not content.
        Stored in :class:`~repro_torch.core.dataset.LoaderState`; checked on
        resume by :meth:`DataPipeline.load_state`.
        """
        d = self.to_dict()
        for content_free in CONTENT_FREE_FIELDS:
            d.pop(content_free, None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    # --------------------------------------------------------------- build
    def build(self):
        """Open, wire and return the live :class:`DataPipeline`."""
        from .builder import Pipeline

        return Pipeline.from_spec(self).build()


#: the reference's name, kept for callers of the port
DataSpec = PipelineSpec
