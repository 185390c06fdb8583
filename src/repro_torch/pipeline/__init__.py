"""The declarative data-pipeline API: the port of ``repro.pipeline``.
``DataSpec`` is the reference's name of :class:`PipelineSpec`."""
from .builder import DataPipeline, Pipeline
from .spec import (
    SPEC_VERSION,
    STRATEGY_REGISTRY,
    DataSpec,
    PipelineSpec,
    strategy_from_spec,
    strategy_to_spec,
)

__all__ = [
    "Pipeline", "DataPipeline", "PipelineSpec", "DataSpec", "SPEC_VERSION",
    "STRATEGY_REGISTRY", "strategy_to_spec", "strategy_from_spec",
]
