"""On-disk data: the port of the CSR part of ``repro.data`` and of its
token corpus."""
from .csr_store import CSRBatch, CSRStore, ShardedCSRStore, write_csr_shard
from .iostats import IOCounters
from .synth import TAHOE_PLATE_FRACS, generate_tahoe_like, load_tahoe_like
from .tokens import TokenStore, generate_token_corpus

__all__ = [
    "CSRBatch", "CSRStore", "ShardedCSRStore", "write_csr_shard", "IOCounters",
    "TAHOE_PLATE_FRACS", "generate_tahoe_like", "load_tahoe_like", "TokenStore",
    "generate_token_corpus",
]
