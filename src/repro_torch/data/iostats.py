"""I/O counters of the on-disk store.

The port keeps the part of ``repro.data.iostats.IOStats`` that
:class:`~repro_torch.data.csr_store.CSRStore` records: calls, random runs
(contiguous extents = seeks), rows and bytes read, and wall time.  The
snapshot uses the JAX package's key names.  The storage-latency models and
the speculative, cache and resilience counters belong to the planned
storage layer, which is not ported yet.

The class is named apart from ``IOStats`` for the same reason as
:class:`~repro_torch.core.dataset.ScIterableDataset`.  It holds no lock:
the port shares no counters between threads, and each ``DataLoader``
worker process counts into its own copy.
"""
from __future__ import annotations

import dataclasses

__all__ = ["IOCounters"]


@dataclasses.dataclass
class IOCounters:
    calls: int = 0
    runs: int = 0  # contiguous extents == random accesses
    rows: int = 0
    bytes_read: int = 0
    wall_s: float = 0.0

    def record(self, *, runs: int, rows: int, bytes_read: int, wall_s: float) -> None:
        """Account one store call."""
        self.calls += 1
        self.runs += runs
        self.rows += rows
        self.bytes_read += bytes_read
        self.wall_s += wall_s

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)
