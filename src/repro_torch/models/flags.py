"""Paper-baseline switch: the port of ``repro.models.flags``.

``REPRO_PAPER_BASELINE=1`` asks for the naive configuration that the
reference's dry-run sweep records beside its optimized one.  The port
honours it only where its result would otherwise differ from the
reference's under the same setting, both in :mod:`.moe`:

- the MoE group count: one group per batch element times ``group_mult``,
  not groups sized to ``target_group_tokens``;
- the MoE dispatch and combine tensors in float32, not in the compute
  type.

The reference's other gates change nothing the port computes: banded or
chunked attention for a sliding window or a long prompt computes the same
function as the port's attention kernel, which skips the tiles a window
leaves empty and streams long sequences itself; the one-hot embedding
under a sharding context and the ZeRO-2 gradient layouts belong to
sharding, which the port (one device) does not have: it always gathers
the embedding.
"""
from __future__ import annotations

import os

__all__ = ["paper_baseline"]


def paper_baseline() -> bool:
    return os.environ.get("REPRO_PAPER_BASELINE", "") == "1"
