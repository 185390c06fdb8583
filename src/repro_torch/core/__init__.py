"""Sampling and loading: the port of ``repro.core``."""
from .callbacks import Callbacks, MultiIndexable
from .dataset import LoaderState, ScIterableDataset
from .sampling import (
    BlockShuffling,
    BlockWeightedSampling,
    ClassBalancedSampling,
    SamplingStrategy,
    Streaming,
)

__all__ = [
    "Callbacks", "MultiIndexable", "LoaderState", "ScIterableDataset",
    "SamplingStrategy", "Streaming", "BlockShuffling", "BlockWeightedSampling",
    "ClassBalancedSampling",
]
