"""On-disk data: the port of ``repro.data`` — the CSR, chunked, token and
h5ad stores, the planned storage layer over them (``open_collection``), and
the wrapping ``cloud://`` (object-store request semantics) and ``fault://``
(seeded fault injection) readers.  Importing the package registers every
scheme."""
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
from .cloud import CLOUD_PROFILES, CloudProfile, CloudReader
from .csr_store import CSRBatch, CSRStore, ShardedCSRStore, write_csr_shard
from .faults import (
    FaultInjectingReader,
    FaultProfile,
    RetryBudgetExhausted,
    RetryPolicy,
    ShardCircuit,
    TransientStorageError,
)
from .h5ad import H5adReader, H5adStore, ShardedH5adReader
from .iostats import CLOUD_OBJECT, NVME_SSD, SATA_SSD, IOCounters, PendingCounters, StorageModel
from .synth import (
    TAHOE_PLATE_FRACS,
    csr_shard_to_h5ad,
    export_sharded_h5ad,
    generate_h5ad_like,
    generate_sharded_h5ad_like,
    generate_tahoe_like,
    load_tahoe_like,
    write_h5ad,
)
from .tokens import TokenStore, generate_token_corpus

__all__ = [
    "CSRBatch", "CSRStore", "ShardedCSRStore", "write_csr_shard", "IOCounters",
    "PendingCounters", "StorageModel", "SATA_SSD", "NVME_SSD", "CLOUD_OBJECT",
    "ChunkedDenseStore", "write_chunked_store", "CollectionProtocol", "StorageReader",
    "PlannedRows", "open_adapter", "open_collection", "piece_nbytes", "register_backend",
    "registered_schemes", "TAHOE_PLATE_FRACS", "generate_tahoe_like", "load_tahoe_like",
    "TokenStore", "generate_token_corpus", "H5adStore", "H5adReader", "ShardedH5adReader",
    "write_h5ad", "csr_shard_to_h5ad", "generate_h5ad_like", "generate_sharded_h5ad_like",
    "export_sharded_h5ad", "CloudProfile", "CloudReader", "CLOUD_PROFILES", "FaultProfile",
    "FaultInjectingReader", "TransientStorageError", "RetryBudgetExhausted", "RetryPolicy",
    "ShardCircuit",
]
