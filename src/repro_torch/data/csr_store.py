"""On-disk CSR cell-by-gene store, and the collation of its batches to tensors.

The port's copy of ``repro.data.csr_store``: the same shard layout
(``data.npy`` / ``indices.npy`` / ``indptr.npy`` / ``obs.npz`` /
``meta.json``, opened with ``mmap_mode='r'``), the same run-coalesced
batched reads and the same :class:`CSRBatch`.  Two things differ:

- :meth:`CSRBatch.to_ell` refuses a ``k_max`` below the longest row instead
  of dropping the nonzeros past it, and :meth:`CSRBatch.to_dense` adds
  duplicate columns up, as the densify kernel and its oracle do.
- :meth:`CSRBatch.to_tensors` collates a batch into the ELL tensors the
  densify kernel takes, optionally straight into pinned host memory.

Stores pickle as their paths, so a dataset over them travels to
``DataLoader`` workers started by spawn without copying the shards.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .iostats import IOCounters
from .readplan import coalesce_rows

__all__ = ["CSRBatch", "CSRStore", "ShardedCSRStore", "write_csr_shard"]


@dataclasses.dataclass
class CSRBatch:
    """A materialized batch of sparse rows (local CSR) + aligned obs columns.

    Row indexing lets it flow through the dataset's in-memory reshuffle and
    batching (Algorithm 1 lines 9–10) without densification.
    """

    data: np.ndarray  # (nnz,) float32
    indices: np.ndarray  # (nnz,) int32 gene ids
    indptr: np.ndarray  # (rows+1,) int64
    n_var: int
    obs: dict  # column -> (rows,) array

    def __len__(self) -> int:
        return len(self.indptr) - 1

    def __getitem__(self, rows) -> "CSRBatch":
        rows = np.asarray(rows)
        if rows.dtype == bool:
            rows = np.flatnonzero(rows)
        starts = self.indptr[rows]
        lens = self.indptr[rows + 1] - starts
        new_indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_indptr[1:])
        gather = _ranges_concat(starts, lens)
        return CSRBatch(
            data=self.data[gather],
            indices=self.indices[gather],
            indptr=new_indptr,
            n_var=self.n_var,
            obs={k: v[rows] for k, v in self.obs.items()},
        )

    def _row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def to_dense(self) -> np.ndarray:
        """Dense (rows, n_var) float32; duplicate columns add up."""
        out = np.zeros((len(self), self.n_var), dtype=np.float32)
        rows = np.repeat(np.arange(len(self)), self._row_lengths())
        src = _ranges_concat(self.indptr[:-1], self._row_lengths())
        np.add.at(out, (rows, self.indices[src].astype(np.int64)), self.data[src])
        return out

    def ell_width(self, k_max: Optional[int] = None) -> int:
        """The ELL width K: the longest row, or ``k_max`` when it holds it.

        Raises ``ValueError`` when ``k_max`` is below the longest row: ELL
        that narrow would have to drop nonzeros.
        """
        lens = self._row_lengths()
        longest = int(lens.max()) if len(lens) else 0
        if k_max is None:
            return longest
        if k_max < longest:
            raise ValueError(
                f"k_max={k_max} is below the longest row ({longest} nonzeros): "
                "ELL that narrow would drop nonzeros"
            )
        return int(k_max)

    def _fill_ell(self, vals: np.ndarray, cols: np.ndarray) -> None:
        """Write the batch as ELL into ``vals`` (rows, K) and ``cols``
        (rows, K), padding with value 0 and column -1."""
        lens = self._row_lengths()
        vals.fill(0.0)
        cols.fill(-1)
        row_ids = np.repeat(np.arange(len(self)), lens)
        pos = _within_run_positions(lens)
        src = _ranges_concat(self.indptr[:-1], lens)
        vals[row_ids, pos] = self.data[src]
        cols[row_ids, pos] = self.indices[src]

    def to_ell(self, k_max: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        """Pad to ELL: ``(vals float32, cols int32)``, each (rows, K), with
        column -1 as padding.  See :meth:`ell_width` for K."""
        K = self.ell_width(k_max)
        vals = np.empty((len(self), K), dtype=np.float32)
        cols = np.empty((len(self), K), dtype=np.int32)
        self._fill_ell(vals, cols)
        return vals, cols

    def to_tensors(self, k_max: Optional[int] = None, *, pin_memory: bool = False) -> dict:
        """Collate to host tensors: ``{"vals", "cols", "obs": {column: tensor}}``.

        ``vals``/``cols`` are the ELL of :meth:`to_ell`, built in place in
        the tensors' memory; ``pin_memory=True`` puts everything in pinned
        memory, ready for an asynchronous copy to the card.
        """
        K = self.ell_width(k_max)
        vals = torch.empty((len(self), K), dtype=torch.float32, pin_memory=pin_memory)
        cols = torch.empty((len(self), K), dtype=torch.int32, pin_memory=pin_memory)
        self._fill_ell(vals.numpy(), cols.numpy())
        obs = {}
        for k, v in self.obs.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            obs[k] = t.pin_memory() if pin_memory else t
        return {"vals": vals, "cols": cols, "obs": obs}

    @property
    def nbytes(self) -> int:
        """Bytes of the CSR arrays (the planner's cache budget counts these)."""
        return int(self.data.nbytes + self.indices.nbytes + self.indptr.nbytes)


def _ranges_concat(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+len) ranges, vectorized."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    # cumulative offsets with resets at range boundaries
    out = np.ones(total, dtype=np.int64)
    ends = np.cumsum(lens)
    nz = lens > 0
    first_pos = np.concatenate(([0], ends[:-1]))[nz]
    starts_nz = starts[nz]
    prev_end = starts_nz[:-1] + lens[nz][:-1]
    out[first_pos[0]] = starts_nz[0]
    if len(starts_nz) > 1:
        out[first_pos[1:]] = starts_nz[1:] - prev_end + 1
    return np.cumsum(out)


def _within_run_positions(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ids = np.repeat(np.arange(len(lens)), lens)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return np.arange(total) - offsets[ids]


class CSRStore:
    """One on-disk CSR shard (one plate file of Tahoe-100M)."""

    def __init__(self, path: str, iostats: Optional[IOCounters] = None):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.n_obs = int(self.meta["n_obs"])
        self.n_var = int(self.meta["n_var"])
        self._data = np.load(os.path.join(path, "data.npy"), mmap_mode="r")
        self._indices = np.load(os.path.join(path, "indices.npy"), mmap_mode="r")
        self._indptr = np.load(os.path.join(path, "indptr.npy"))  # small; in RAM
        with np.load(os.path.join(path, "obs.npz"), allow_pickle=False) as obs_npz:
            self._obs = {k: obs_npz[k] for k in obs_npz.files}
        self.iostats = iostats if iostats is not None else IOCounters()
        self._row_bytes = (self._data.nbytes + self._indices.nbytes) / max(1, self.n_obs)

    def __reduce__(self):
        return (CSRStore, (self.path, self.iostats))

    def __len__(self) -> int:
        return self.n_obs

    @property
    def obs(self) -> dict:
        return self._obs

    @property
    def avg_row_bytes(self) -> float:
        return self._row_bytes

    def read_range(self, start: int, stop: int) -> CSRBatch:
        """ONE contiguous read of local rows ``[start, stop)``, not counted:
        the planner (:mod:`repro_torch.data.backend`) executes and counts
        these.  The arrays are copies, not memmap views, because the planner
        caches what this returns."""
        lo, hi = int(self._indptr[start]), int(self._indptr[stop])
        return CSRBatch(
            data=np.array(self._data[lo:hi]),
            indices=np.array(self._indices[lo:hi]),
            indptr=np.asarray(self._indptr[start : stop + 1], dtype=np.int64) - lo,
            n_var=self.n_var,
            obs={k: v[start:stop] for k, v in self._obs.items()},
        )

    def __getitem__(self, rows) -> CSRBatch:
        """Run-coalesced batched read (Algorithm 1 line 8).

        One memmap slice copy per contiguous run; ``iostats.runs`` counts
        them.  Rows may be unsorted or repeat; data comes back in the order
        given.
        """
        t0 = time.perf_counter()
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim == 0:
            rows = rows[None]
        runs = coalesce_rows(np.unique(rows))

        # read each run once (the only disk I/O) into one buffer
        run_data, run_idx = [], []
        run_buf_off = np.zeros(len(runs), dtype=np.int64)  # run -> offset in buf
        run_lo = np.zeros(len(runs), dtype=np.int64)  # run -> indptr at run start
        bytes_read = 0
        cum = 0
        for k, (a, b) in enumerate(runs):
            lo, hi = int(self._indptr[a]), int(self._indptr[b])
            d = np.asarray(self._data[lo:hi])
            i = np.asarray(self._indices[lo:hi])
            bytes_read += d.nbytes + i.nbytes
            run_data.append(d)
            run_idx.append(i)
            run_buf_off[k] = cum
            run_lo[k] = lo
            cum += hi - lo
        buf_data = np.concatenate(run_data) if run_data else np.empty(0, self._data.dtype)
        buf_idx = np.concatenate(run_idx) if run_idx else np.empty(0, self._indices.dtype)

        # each requested row maps to a source span inside the run buffer
        out_lens = np.diff(self._indptr)[rows].astype(np.int64)
        out_indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(out_lens, out=out_indptr[1:])
        which_run = np.searchsorted(runs[:, 1], rows, side="right")
        src_starts = run_buf_off[which_run] + (self._indptr[rows] - run_lo[which_run])
        gather = _ranges_concat(src_starts, out_lens)

        obs = {k: v[rows] for k, v in self._obs.items()}
        self.iostats.record(
            runs=len(runs), rows=len(rows), bytes_read=bytes_read,
            wall_s=time.perf_counter() - t0,
        )
        return CSRBatch(data=buf_data[gather], indices=buf_idx[gather],
                        indptr=out_indptr, n_var=self.n_var, obs=obs)


class ShardedCSRStore:
    """Lazy concatenation of CSR shards (the 14 Tahoe plate files).

    Global row ids map to (shard, local row); a batched read makes one call
    per shard and returns rows in the caller's order.
    """

    def __init__(self, shard_paths: Sequence[str], iostats: Optional[IOCounters] = None):
        if not shard_paths:
            raise ValueError("need at least one shard")
        self.iostats = iostats if iostats is not None else IOCounters()
        self.shards = [CSRStore(p, iostats=self.iostats) for p in shard_paths]
        n_vars = {s.n_var for s in self.shards}
        if len(n_vars) != 1:
            raise ValueError(f"shards disagree on n_var: {n_vars}")
        self.n_var = n_vars.pop()
        sizes = np.array([len(s) for s in self.shards], dtype=np.int64)
        self.offsets = np.concatenate(([0], np.cumsum(sizes)))
        self.n_obs = int(self.offsets[-1])

    def __reduce__(self):
        return (ShardedCSRStore, ([s.path for s in self.shards], self.iostats))

    def __len__(self) -> int:
        return self.n_obs

    @property
    def avg_row_bytes(self) -> float:
        return float(np.mean([s.avg_row_bytes for s in self.shards]))

    @property
    def obs_keys(self) -> list[str]:
        return list(self.shards[0].obs.keys())

    def obs_column(self, key: str) -> np.ndarray:
        """A whole metadata column across shards."""
        return np.concatenate([s.obs[key] for s in self.shards])

    def __getitem__(self, rows) -> CSRBatch:
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim == 0:
            rows = rows[None]
        shard_ids = np.searchsorted(self.offsets, rows, side="right") - 1
        got = []
        back_perm = np.empty(len(rows), dtype=np.int64)
        cursor = 0
        for sid in np.unique(shard_ids):
            mask = shard_ids == sid
            got.append(self.shards[sid][rows[mask] - self.offsets[sid]])
            back_perm[np.flatnonzero(mask)] = np.arange(cursor, cursor + mask.sum())
            cursor += int(mask.sum())
        return _concat_batches(got, self.n_var)[back_perm]  # caller's order


def _concat_batches(batches: Sequence[CSRBatch], n_var: int) -> CSRBatch:
    if len(batches) == 1:
        return batches[0]
    lens = np.concatenate([np.diff(b.indptr) for b in batches])
    indptr = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    return CSRBatch(
        data=np.concatenate([b.data for b in batches]),
        indices=np.concatenate([b.indices for b in batches]),
        indptr=indptr,
        n_var=n_var,
        obs={k: np.concatenate([b.obs[k] for b in batches]) for k in batches[0].obs},
    )


def write_csr_shard(
    path: str,
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    n_var: int,
    obs: dict,
    extra_meta: Optional[dict] = None,
) -> None:
    """Write one shard to disk: a temporary directory, then a rename."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.save(os.path.join(tmp, "data.npy"), np.asarray(data, dtype=np.float32))
    np.save(os.path.join(tmp, "indices.npy"), np.asarray(indices, dtype=np.int32))
    np.save(os.path.join(tmp, "indptr.npy"), np.asarray(indptr, dtype=np.int64))
    np.savez(os.path.join(tmp, "obs.npz"), **{k: np.asarray(v) for k, v in obs.items()})
    meta = {"n_obs": int(len(indptr) - 1), "n_var": int(n_var)}
    meta.update(extra_meta or {})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
