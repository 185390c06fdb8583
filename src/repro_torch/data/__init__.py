"""On-disk cells: the port of the CSR part of ``repro.data``."""
from .csr_store import CSRBatch, CSRStore, ShardedCSRStore, write_csr_shard
from .iostats import IOCounters
from .synth import TAHOE_PLATE_FRACS, generate_tahoe_like, load_tahoe_like

__all__ = [
    "CSRBatch", "CSRStore", "ShardedCSRStore", "write_csr_shard", "IOCounters",
    "TAHOE_PLATE_FRACS", "generate_tahoe_like", "load_tahoe_like",
]
