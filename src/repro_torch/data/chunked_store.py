"""Zarr-style chunked dense store: the port of ``repro.data.chunked_store``.

Fixed-size row chunks, each an independent ``.npy`` object (paper §5's
"future storage formats"), so the interaction between the block size and
the storage chunk size is measurable: a fetch touches one object per
distinct chunk, and :class:`IOCounters` counts one run per touched chunk
(object-store request semantics).  :func:`write_chunked_store` writes files
byte-identical to the reference's for the same arguments (``obs.npz`` is a
zip whose member headers carry the write time; its members agree).

:class:`ChunkedDenseStore` is the counterpart of ``ChunkedStore``, named
apart from it for the same reason as
:class:`~repro_torch.core.dataset.ScIterableDataset`.  Rows come back as
dense float32.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from .iostats import IOCounters

__all__ = ["ChunkedDenseStore", "write_chunked_store"]


def write_chunked_store(
    path: str,
    X: np.ndarray,  # (n, d) dense
    obs: Optional[dict] = None,
    *,
    chunk_rows: int = 256,
) -> str:
    os.makedirs(path, exist_ok=True)
    n, d = X.shape
    n_chunks = -(-n // chunk_rows)
    for c in range(n_chunks):
        lo, hi = c * chunk_rows, min((c + 1) * chunk_rows, n)
        np.save(os.path.join(path, f"chunk_{c:06d}.npy"), np.asarray(X[lo:hi], np.float32))
    np.savez(os.path.join(path, "obs.npz"), **{k: np.asarray(v) for k, v in (obs or {}).items()})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n": int(n), "d": int(d), "chunk_rows": int(chunk_rows),
                   "n_chunks": int(n_chunks)}, f)
    return path


class ChunkedDenseStore:
    """One chunked store on disk.  The reference's ``cache_chunks`` is not
    kept: the planned collection's block cache does that job."""

    def __init__(self, path: str, iostats: Optional[IOCounters] = None):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            m = json.load(f)
        self.n, self.d = m["n"], m["d"]
        self.chunk_rows = m["chunk_rows"]
        self.n_chunks = m["n_chunks"]
        with np.load(os.path.join(path, "obs.npz"), allow_pickle=False) as obs:
            self.obs = {k: obs[k] for k in obs.files}
        self.iostats = iostats if iostats is not None else IOCounters()

    def __len__(self) -> int:
        return self.n

    @property
    def avg_row_bytes(self) -> float:
        return float(self.d * 4)

    def _load_chunk(self, c: int) -> np.ndarray:
        return np.load(os.path.join(self.path, f"chunk_{c:06d}.npy"))

    def read_range(self, start: int, stop: int) -> np.ndarray:
        """Contiguous read of rows ``[start, stop)``, not counted.  The
        planner splits runs at chunk edges, so there it touches one chunk."""
        c0, c1 = int(start) // self.chunk_rows, (int(stop) - 1) // self.chunk_rows
        parts = []
        for c in range(c0, c1 + 1):
            arr = self._load_chunk(c)
            lo = max(start - c * self.chunk_rows, 0)
            hi = min(stop - c * self.chunk_rows, arr.shape[0])
            parts.append(arr[lo:hi])
        return parts[0].copy() if len(parts) == 1 else np.concatenate(parts)

    def __getitem__(self, rows) -> np.ndarray:
        """One object read per distinct chunk touched (request semantics)."""
        t0 = time.perf_counter()
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim == 0:
            rows = rows[None]
        chunks = rows // self.chunk_rows
        uniq = np.unique(chunks)
        out = np.empty((len(rows), self.d), np.float32)
        nbytes = 0
        for c in uniq.tolist():
            arr = self._load_chunk(int(c))
            nbytes += arr.nbytes
            mask = chunks == c
            out[mask] = arr[rows[mask] - c * self.chunk_rows]
        self.iostats.record(runs=len(uniq), rows=len(rows), bytes_read=nbytes,
                            wall_s=time.perf_counter() - t0)
        return out
