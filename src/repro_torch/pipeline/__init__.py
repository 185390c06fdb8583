"""The declarative data-pipeline API: the port of ``repro.pipeline`` for
``tokens://`` streams."""
from .builder import DataPipeline, Pipeline
from .spec import SPEC_VERSION, STRATEGY_REGISTRY, DataSpec, strategy_from_spec, strategy_to_spec

__all__ = [
    "Pipeline", "DataPipeline", "DataSpec", "SPEC_VERSION", "STRATEGY_REGISTRY",
    "strategy_to_spec", "strategy_from_spec",
]
