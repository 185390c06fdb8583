"""``h5ad://`` and ``sharded-h5ad://``: AnnData files behind the planned
storage layer; the port of ``repro.data.h5ad``.

An ``.h5ad`` file stores the cell-by-gene matrix ``X`` as on-disk CSR —
``X/data`` (values), ``X/indices`` (gene ids), ``X/indptr`` (row offsets) —
plus per-cell metadata columns under ``obs``.  :class:`H5adReader` maps that
layout onto :class:`~repro_torch.data.backend.StorageReader`, so h5ad files
get the planner, the block cache, the asynchronous reads and the
:class:`~repro_torch.data.iostats.IOCounters` accounting of every other
format; :class:`ShardedH5adReader` puts many plate files behind one row
space, as ``sharded-csr://`` does for CSR shards.

Two drivers:

- ``h5py`` — the HDF5 library, where it imports;
- ``shim`` — the pure-Python subset reader (:mod:`repro_torch.data.h5shim`),
  which needs nothing beyond numpy.  ``auto`` takes h5py where it imports
  and the shim elsewhere (the card's machine has no h5py).

Force one with ``open_collection("h5ad:///data/cells.h5ad?driver=shim")``.
Bare paths ending in ``.h5ad``, or carrying the HDF5 signature, are sniffed,
and so are directories whose ``manifest.json`` lists ``.h5ad`` shards.

Layout assumptions, checked at open: CSR orientation (``indptr`` has
``n_obs + 1`` entries), ``n_var`` from the ``X`` group's ``shape`` attribute
with the length of ``var/_index`` as a fallback.  ``indptr`` and the obs
columns are loaded at open (O(n_obs)); ``data``/``indices`` are read on
demand, one byte range each per planner extent.  Obs columns decode under
both drivers: plain datasets, variable-length strings and anndata
categorical subgroups (``codes`` + ``categories``); anything else is
skipped.  Batches, obs, schema and byte estimates are the reference's, bit
for bit.

The readers are named after the port's ``CSRReader``/``ShardedCSRReader``,
not after the reference's adapters: ``tools/analyze`` resolves classes by
bare name across ``src/``.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from .backend import CompositeCSRReader, StorageReader, register_backend
from .csr_store import CSRBatch, _concat_batches

__all__ = ["H5adStore", "H5adReader", "ShardedH5adReader"]

try:  # optional: the shim is the no-dependency driver
    import h5py  # type: ignore

    _HAVE_H5PY = True
except Exception:  # pragma: no cover - import guard
    h5py = None
    _HAVE_H5PY = False


def _as_str_array(col: np.ndarray) -> np.ndarray:
    """h5py returns vlen strings as object arrays of ``bytes``; normalize to
    a unicode array so that both drivers give consumers the same dtype."""
    if col.dtype.kind == "O":
        return np.array(
            [c.decode("utf-8") if isinstance(c, bytes) else str(c) for c in col],
            dtype=str,
        )
    return col


def _decode_categorical(codes: np.ndarray, categories: np.ndarray) -> np.ndarray:
    """anndata categorical -> label array: ``categories[codes]`` with the
    pandas missing sentinel (``codes == -1``) mapped to the empty string."""
    cats = np.asarray(categories)
    if cats.dtype.kind == "S":  # one label dtype per column
        cats = np.array([c.decode("utf-8") for c in cats], dtype=str)
    elif cats.dtype.kind == "O":
        cats = np.array(
            [c.decode("utf-8") if isinstance(c, bytes) else str(c) for c in cats],
            dtype=str,
        )
    codes = np.asarray(codes, dtype=np.int64)
    out = np.empty(len(codes), dtype=cats.dtype if cats.dtype.kind == "U" else object)
    valid = codes >= 0
    out[valid] = cats[codes[valid]]
    if cats.dtype.kind == "U":
        out[~valid] = ""
        return out
    out[~valid] = None
    return out


class H5adStore:
    """Row-range reader over one ``.h5ad`` file (CSR ``X`` + ``obs``).

    Under the shim, reads are positioned (``os.pread``): threads may share
    the store, and so may processes forked after it was opened."""

    def __init__(self, path: str, driver: str = "auto"):
        if driver not in ("auto", "h5py", "shim"):
            raise ValueError(f"driver must be auto|h5py|shim, got {driver!r}")
        if driver == "h5py" and not _HAVE_H5PY:
            raise ImportError("driver='h5py' requested but h5py is not installed")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.driver = "h5py" if (driver == "h5py" or (driver == "auto" and _HAVE_H5PY)) else "shim"
        if self.driver == "h5py":
            self._f = h5py.File(path, "r")
            self._data = self._f["X/data"]
            self._indices = self._f["X/indices"]
            x_attrs = dict(self._f["X"].attrs)
            indptr = np.asarray(self._f["X/indptr"][:], dtype=np.int64)
            obs_names = list(self._f["obs"].keys()) if "obs" in self._f else []
        else:
            from .h5shim import ShimFile

            self._f = ShimFile(path)
            self._data = self._f.dataset("X/data")
            self._indices = self._f.dataset("X/indices")
            x_attrs = self._f.attrs("X")
            indptr = np.asarray(self._f.dataset("X/indptr")[:], dtype=np.int64)
            obs_names = self._f.keys("obs") if self._has_group("obs") else []
        self._indptr = indptr
        self.n_obs = len(indptr) - 1
        self.n_var = self._resolve_n_var(x_attrs)
        enc = x_attrs.get("encoding-type")
        if enc is not None:
            enc = enc.decode() if isinstance(enc, bytes) else str(enc)
            if "csr" not in enc:
                raise ValueError(
                    f"{path}: X encoding {enc!r} is not CSR; only csr_matrix "
                    "h5ad layouts are supported"
                )
        self._obs = self._load_obs(obs_names)
        self._row_bytes = (self._data.nbytes + self._indices.nbytes) / max(1, self.n_obs)

    def _has_group(self, name: str) -> bool:
        try:
            return self._f.is_group(name)
        except KeyError:
            return False

    def _resolve_n_var(self, x_attrs: dict) -> int:
        shape = x_attrs.get("shape")
        if shape is not None and len(np.atleast_1d(shape)) == 2:
            return int(np.atleast_1d(shape)[1])
        # the var axis's length (anndata always writes var/_index)
        try:
            if self.driver == "h5py":
                return int(self._f["var/_index"].shape[0])
            return int(self._f.dataset("var/_index").shape[0])
        except KeyError:
            raise ValueError(
                f"{self.path}: cannot determine n_var (no X 'shape' attribute "
                "and no var/_index dataset)"
            ) from None

    def _load_obs(self, names: Sequence[str]) -> dict:
        out: dict = {}
        for name in names:
            if name.startswith("_") or name == "index":
                continue  # the axis index, not a label column
            col = self._load_obs_column(name)
            if col is not None and col.ndim == 1 and len(col) == self.n_obs:
                out[name] = col
        return out

    def _load_obs_column(self, name: str) -> Optional[np.ndarray]:
        """``obs/<name>`` under either driver, or None if unreadable: plain
        datasets load directly, categorical subgroups decode to labels."""
        path = f"obs/{name}"
        try:
            if self.driver == "h5py":
                node = self._f[path]
                if not hasattr(node, "shape"):  # subgroup
                    if "codes" in node and "categories" in node:
                        return _decode_categorical(np.asarray(node["codes"][:]),
                                                   np.asarray(node["categories"][:]))
                    return None
                return _as_str_array(np.asarray(node[:]))
            if self._f.is_group(path):
                kids = set(self._f.keys(path))
                if {"codes", "categories"} <= kids:
                    return _decode_categorical(
                        np.asarray(self._f.dataset(f"{path}/codes")[:]),
                        np.asarray(self._f.dataset(f"{path}/categories")[:]),
                    )
                return None
            return np.asarray(self._f.dataset(path)[:])
        except (KeyError, NotImplementedError, TypeError):
            return None  # an undecodable column is skipped

    def __len__(self) -> int:
        return self.n_obs

    @property
    def obs(self) -> dict:
        return self._obs

    @property
    def avg_row_bytes(self) -> float:
        return self._row_bytes

    def read_range(self, start: int, stop: int) -> CSRBatch:
        """ONE contiguous read of rows ``[start, stop)``: a single
        ``data``/``indices`` byte range each.  Records nothing."""
        lo, hi = int(self._indptr[start]), int(self._indptr[stop])
        return CSRBatch(
            data=np.asarray(self._data[lo:hi], dtype=np.float32),
            indices=np.asarray(self._indices[lo:hi]),
            indptr=self._indptr[start:stop + 1].astype(np.int64) - lo,
            n_var=self.n_var,
            obs={k: v[start:stop] for k, v in self._obs.items()},
        )

    def close(self) -> None:
        self._f.close()


class H5adReader(StorageReader):
    """One AnnData ``.h5ad`` file behind the planner (CSR batches)."""

    def __init__(self, store: H5adStore):
        self.store = store

    def __len__(self) -> int:
        return len(self.store)

    def read_range(self, start: int, stop: int) -> CSRBatch:
        return self.store.read_range(start, stop)

    def take(self, piece: CSRBatch, rows: np.ndarray) -> CSRBatch:
        return piece[rows]

    def concat(self, pieces: Sequence[CSRBatch]) -> CSRBatch:
        return _concat_batches(list(pieces), self.store.n_var)

    def nbytes_of(self, rows: np.ndarray) -> int:
        rows = np.asarray(rows, dtype=np.int64)
        nnz = (self.store._indptr[rows + 1] - self.store._indptr[rows]).sum()
        per = self.store._data.dtype.itemsize + self.store._indices.dtype.itemsize
        return int(nnz) * per

    @property
    def avg_row_bytes(self) -> float:
        return self.store.avg_row_bytes

    @property
    def schema(self) -> dict:
        return {"kind": "csr", "n_obs": self.store.n_obs, "n_var": self.store.n_var,
                "obs_keys": list(self.store.obs.keys()), "driver": self.store.driver}

    def obs_keys(self) -> list[str]:
        return list(self.store.obs.keys())

    def obs_column(self, key: str) -> np.ndarray:
        return self.store.obs[key]

    def close(self) -> None:
        self.store.close()


class ShardedH5adReader(CompositeCSRReader):
    """Many ``.h5ad`` plate files behind ONE row space (``sharded-h5ad://``):
    plate edges are the planner's boundaries, so a run never crosses files."""

    def __init__(self, stores: Sequence[H5adStore]):
        if not stores:
            raise ValueError("need at least one h5ad shard")
        n_vars = {s.n_var for s in stores}
        if len(n_vars) != 1:
            raise ValueError(f"h5ad shards disagree on n_var: {n_vars}")
        super().__init__(stores, n_vars.pop())
        # the obs columns every shard decodes, in the first shard's order
        keys = set(self.stores[0].obs.keys())
        for s in self.stores[1:]:
            keys &= set(s.obs.keys())
        self._obs_keys = [k for k in self.stores[0].obs.keys() if k in keys]

    @property
    def schema(self) -> dict:
        return {"kind": "csr", "n_obs": self.n_obs, "n_var": self.n_var,
                "n_shards": len(self.stores), "obs_keys": list(self._obs_keys),
                "driver": self.stores[0].driver}

    def obs_keys(self) -> list[str]:
        return list(self._obs_keys)

    def obs_column(self, key: str) -> np.ndarray:
        if key not in self._obs_keys:
            raise KeyError(key)
        return np.concatenate([s.obs[key] for s in self.stores])

    def close(self) -> None:
        for s in self.stores:
            s.close()


@register_backend("h5ad")
def _open_h5ad(path: str, *, driver: str = "auto") -> H5adReader:
    return H5adReader(H5adStore(path, driver=str(driver)))


@register_backend("sharded-h5ad")
def _open_sharded_h5ad(path: str, *, driver: str = "auto") -> ShardedH5adReader:
    """``sharded-h5ad://<dir>`` (a directory whose ``manifest.json`` lists
    ``.h5ad`` shards), ``sharded-h5ad://<manifest.json>`` or comma-joined
    ``.h5ad`` paths."""
    if "," in path:
        shard_paths = path.split(",")
    else:
        manifest_path = path if path.endswith(".json") else os.path.join(path, "manifest.json")
        with open(manifest_path) as f:
            manifest = json.load(f)
        base = os.path.dirname(manifest_path)
        shard_paths = [os.path.join(base, s) for s in manifest["shards"]]
    return ShardedH5adReader([H5adStore(p, driver=str(driver)) for p in shard_paths])
