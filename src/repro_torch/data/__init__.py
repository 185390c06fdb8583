"""On-disk data: the port of ``repro.data`` — the CSR, chunked and token
stores, and the planned storage layer over them (``open_collection``)."""
from .backend import (
    CollectionProtocol,
    PlannedRows,
    StorageReader,
    open_adapter,
    open_collection,
    piece_nbytes,
    register_backend,
    registered_schemes,
)
from .chunked_store import ChunkedDenseStore, write_chunked_store
from .csr_store import CSRBatch, CSRStore, ShardedCSRStore, write_csr_shard
from .iostats import CLOUD_OBJECT, NVME_SSD, SATA_SSD, IOCounters, PendingCounters, StorageModel
from .synth import TAHOE_PLATE_FRACS, generate_tahoe_like, load_tahoe_like
from .tokens import TokenStore, generate_token_corpus

__all__ = [
    "CSRBatch", "CSRStore", "ShardedCSRStore", "write_csr_shard", "IOCounters",
    "PendingCounters", "StorageModel", "SATA_SSD", "NVME_SSD", "CLOUD_OBJECT",
    "ChunkedDenseStore", "write_chunked_store", "CollectionProtocol", "StorageReader",
    "PlannedRows", "open_adapter", "open_collection", "piece_nbytes", "register_backend",
    "registered_schemes", "TAHOE_PLATE_FRACS", "generate_tahoe_like", "load_tahoe_like",
    "TokenStore", "generate_token_corpus",
]
