"""Sampling and loading: the port of ``repro.core``.

:mod:`repro_torch.core.theory` (the §3.4 entropy bounds) is a submodule,
as in the reference, and is not re-exported here."""
from .callbacks import Callbacks, MultiIndexable
from .dataset import LoaderState, ScIterableDataset
from .prefetch import FetchPool, prefetch_iterator
from .sampling import (
    BlockShuffling,
    BlockWeightedSampling,
    ClassBalancedSampling,
    SamplingStrategy,
    Streaming,
)

__all__ = [
    "Callbacks", "MultiIndexable", "LoaderState", "ScIterableDataset", "FetchPool",
    "prefetch_iterator",
    "SamplingStrategy", "Streaming", "BlockShuffling", "BlockWeightedSampling",
    "ClassBalancedSampling",
]
