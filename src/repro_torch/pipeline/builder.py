"""Pipeline — the fluent face of :class:`~repro_torch.pipeline.spec.DataSpec`;
the port of ``repro.pipeline.builder`` as far as the training driver
(``launch/train.py::build_loader``) uses it::

    pipe = (Pipeline.from_uri("tokens:///data/corpus", seq_len=2048)
            .strategy("block", block_size=16)
            .batch(4, fetch_factor=8)
            .shard(rank=0, world_size=1)
            .seed(0)
            .prefetch(workers=0)
            .build())
    for minibatch in pipe:
        ...

Every chain method records into the spec and returns the builder, so
``pipe.spec.to_json()`` is the full reproducible description of the
stream, equal to ``repro``'s for the same chain.  The built
:class:`DataPipeline` iterates minibatches and owns checkpoint state:
:meth:`DataPipeline.state` carries the spec fingerprint and
:meth:`DataPipeline.load_state` refuses a state whose fingerprint does not
match.

``tokens://`` opens the port's :class:`~repro_torch.data.tokens.TokenStore`
directly: its batches are bitwise those of ``repro``'s planned collection
over the same store, whose block cache and extent merging change how the
bytes are read, not which.  Other schemes, ``prefetch(workers > 0)``,
``autotune`` and specs with non-default planner, prefetch, resilience,
diversity or pooling fields raise ``NotImplementedError``: the planner
behind them is ROADMAP.md queue A #1.
"""
from __future__ import annotations

import dataclasses
import urllib.parse
from typing import Iterator, Optional

from ..core.dataset import LoaderState, ScIterableDataset
from ..core.sampling import SamplingStrategy
from ..data.tokens import TokenStore
from .spec import DataSpec, strategy_from_spec, strategy_to_spec

__all__ = ["Pipeline", "DataPipeline"]

_TODO = "is not ported yet (ROADMAP.md queue A #1: the planner behind Pipeline)"

# spec fields the port builds only at their defaults: the planner's, the
# prefetch pool's, resilience, diversity and pooling knobs
_PLANNER_FIELDS = (
    "cache_bytes", "block_rows", "max_extent_rows", "io_workers", "readahead", "admission",
    "cache_policy", "prefetch_workers", "cross_epoch_prefetch", "retries",
    "retry_backoff_s", "retry_max_backoff_s", "retry_deadline_s", "hedge_factor",
    "hedge_min_s", "breaker_threshold", "breaker_cooldown_s", "diversity_obs",
    "entropy_floor", "shared_pool",
)
# opener options of tokens://; anything else in a URI's query is a planner knob
_TOKEN_OPTS = ("seq_len",)


class Pipeline:
    """Fluent builder accumulating a :class:`DataSpec`.  Construct with
    :meth:`from_uri` or :meth:`from_spec`."""

    def __init__(self, spec: DataSpec):
        self._spec = spec

    # ------------------------------------------------------------ entries
    @classmethod
    def from_uri(cls, uri: str, **open_opts) -> "Pipeline":
        """Start from a storage URI; keywords are opener options
        (``seq_len``), recorded in the spec as ``repro`` records them.
        ``repro``'s planner knobs are not taken here: their planner is not
        ported."""
        return cls(DataSpec(uri=uri, open_opts=dict(open_opts)))

    @classmethod
    def from_spec(cls, spec: DataSpec) -> "Pipeline":
        return cls(spec)

    # ------------------------------------------------------------- chain
    @property
    def spec(self) -> DataSpec:
        return self._spec

    def _replace(self, **kw) -> "Pipeline":
        self._spec = self._spec.replace(**kw)
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

    def batch(self, batch_size: int, *, fetch_factor: Optional[int] = None) -> "Pipeline":
        kw: dict = {"batch_size": int(batch_size)}
        if fetch_factor is not None:
            kw["fetch_factor"] = int(fetch_factor)
        return self._replace(**kw)

    def shard(self, rank: int, world_size: int) -> "Pipeline":
        return self._replace(rank=int(rank), world_size=int(world_size))

    def seed(self, seed: int) -> "Pipeline":
        return self._replace(seed=int(seed))

    def prefetch(self, *, workers: Optional[int] = None) -> "Pipeline":
        """The consumer-side pool's worker count, recorded as ``repro``
        records it; building takes ``workers=0`` (synchronous iteration)
        only."""
        if workers is None:
            return self
        return self._replace(prefetch_workers=int(workers))

    def autotune(self, **kwargs) -> "Pipeline":
        raise NotImplementedError(f"Pipeline.autotune {_TODO}")

    # -------------------------------------------------------------- build
    def build(self) -> "DataPipeline":
        """Open the store, resolve the strategy and wire the
        :class:`ScIterableDataset`; returns the iterable
        :class:`DataPipeline`."""
        s = self._spec
        store = _open_from_spec(s)
        strat = strategy_from_spec(s.strategy, s.strategy_params, store)
        ds = ScIterableDataset(
            store,
            strat,
            batch_size=s.batch_size,
            fetch_factor=s.fetch_factor,
            seed=s.seed,
            rank=s.rank,
            world_size=s.world_size,
            drop_last=s.drop_last,
            sort_fetch_indices=s.sort_fetch_indices,
        )
        return DataPipeline(s, store, ds)


def _open_from_spec(spec: DataSpec) -> TokenStore:
    """The store a ``tokens://`` spec names, refusing what the port does
    not build."""
    if spec.uri is None:
        raise ValueError("pipeline has no collection: use from_uri(...)")
    defaults = DataSpec()
    changed = [f for f in _PLANNER_FIELDS if getattr(spec, f) != getattr(defaults, f)]
    if changed:
        raise NotImplementedError(f"non-default {changed} {_TODO}")
    scheme, _, rest = spec.uri.partition("://")
    if scheme != "tokens" or not rest:
        raise NotImplementedError(f"the storage URI {spec.uri!r}: only tokens:// is ported; "
                                  f"the other schemes {_TODO}")
    opts = dict(spec.open_opts)
    if "?" in rest:
        rest, query = rest.split("?", 1)
        opts = {**dict(urllib.parse.parse_qsl(query)), **opts}
    unknown = sorted(set(opts) - set(_TOKEN_OPTS))
    if unknown:
        raise NotImplementedError(f"tokens:// options {unknown}: the planner's knobs {_TODO}")
    if opts.get("seq_len") is None:
        raise ValueError("tokens:// requires seq_len (e.g. tokens:///corpus?seq_len=128)")
    return TokenStore(rest, seq_len=int(opts["seq_len"]))


class DataPipeline:
    """A built pipeline: iterate it and checkpoint it.  Sampling semantics
    live in :class:`ScIterableDataset`, reads in the store; this object owns
    the wiring and the fingerprint-checked resume contract."""

    def __init__(self, spec: DataSpec, collection: TokenStore, dataset: ScIterableDataset):
        self.spec = spec
        self.collection = collection
        self.dataset = dataset

    # ------------------------------------------------------------ iterate
    def __iter__(self) -> Iterator:
        return iter(self.dataset)

    def __len__(self) -> int:
        """Minibatches THIS RANK yields per epoch (tail-exact)."""
        return len(self.dataset)

    # -------------------------------------------------------------- state
    def state(self) -> LoaderState:
        """Loader state stamped with the spec fingerprint."""
        return dataclasses.replace(self.dataset.state(), fingerprint=self.spec.fingerprint())

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
                    "checkpointed spec (DataSpec.from_json) or start fresh."
                )
        self.dataset.load_state(state)

    def set_epoch(self, epoch: int) -> None:
        self.dataset.set_epoch(epoch)
