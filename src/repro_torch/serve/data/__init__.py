"""Multi-tenant batch serving: the port of ``repro.serve.data``.

Tenants submit a :class:`~repro_torch.pipeline.spec.PipelineSpec` over a
length-prefixed socket protocol (:mod:`.protocol`, wire version 1, the
reference's bytes) and stream their minibatches back through one shared I/O
plane, one block cache, one rendezvous table and one counter base per
dataset, with admission, backpressure, quotas and attribution per tenant
(:mod:`.server`, whose server is :class:`BatchServer`), consumed by a
:class:`~.client.DataClient` that behaves as a local pipeline
(:mod:`.client`).
"""
from .client import DataClient
from .protocol import (
    COMPRESSIONS,
    WIRE_VERSION,
    ProtocolError,
    ServeError,
    decode_batch,
    encode_batch,
)
from .server import BatchServer, ServeConfig, ServeStats

__all__ = [
    "DataClient",
    "BatchServer",
    "ServeConfig",
    "ServeStats",
    "ProtocolError",
    "ServeError",
    "encode_batch",
    "decode_batch",
    "WIRE_VERSION",
    "COMPRESSIONS",
]
