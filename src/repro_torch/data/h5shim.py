"""A pure-Python subset of HDF5: the port's own copy of ``repro.data.h5shim``.

AnnData ``.h5ad`` files are HDF5 containers, and the card's machine has no
h5py, so the port's ``h5ad://`` readers cannot depend on it.  This module
implements the small, stable corner of the HDF5 1.x file format that h5ad
uses, byte for byte as the reference does:

- **Reader** (:class:`ShimFile`): superblock v0, old-style groups (v1 B-tree
  over symbol-table nodes + local heap), v1 object headers (with
  continuation blocks), dataspace / datatype / layout / attribute / filter
  messages.  Datasets may be *contiguous* (a partial read is one positioned
  read of the row range) or *1-D chunked* with the deflate and shuffle
  filters (the chunk B-tree is walked once; only overlapping chunks are
  read and decompressed).  Variable-length strings (anndata's string obs
  columns and categorical ``categories``) resolve through the global heap:
  each element is a 16-byte descriptor into a ``GCOL`` collection, read and
  cached per collection address.  This covers files written by h5py with
  default settings and by ``anndata.write_h5ad`` for the CSR ``X`` layout
  and obs metadata.
- **Writer** (:func:`write_shim_file`): superblock v0, old-style groups,
  contiguous datasets (1-D vlen-string datasets backed by one global heap
  collection included) and compact attributes.  It writes no time stamp, so
  the same inputs give the same bytes, equal to the reference writer's.
  h5py and anndata open its output natively.

Out of scope, each refused with an error that says so: superblock v2/v3
(``libver='latest'``), new-style groups, compound/enum datatypes, N-D
chunked data.  The h5ad readers need only 1-D ``X/data`` / ``X/indices`` /
``X/indptr`` and small obs/var columns, all covered.

Byte layouts follow the HDF5 File Format Specification v1 (old-style
objects); all integers little-endian, offsets and lengths 8 bytes.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Any, Optional, Sequence, Union

import numpy as np

__all__ = ["ShimFile", "ShimDataset", "GroupSpec", "write_shim_file"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types we understand
_MSG_NIL = 0x0000
_MSG_DATASPACE = 0x0001
_MSG_DATATYPE = 0x0003
_MSG_FILL_OLD = 0x0004
_MSG_FILL = 0x0005
_MSG_LAYOUT = 0x0008
_MSG_FILTERS = 0x000B
_MSG_ATTRIBUTE = 0x000C
_MSG_CONTINUATION = 0x0010
_MSG_SYMBOL_TABLE = 0x0011
_MSG_MODIFIED = 0x0012

_FILTER_DEFLATE = 1
_FILTER_SHUFFLE = 2


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _VlenStrType:
    """Sentinel returned by ``_parse_datatype`` for variable-length string
    datatypes (class 9, string flavor) — not an ``np.dtype``, callers branch
    to the global-heap read path."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<vlen-str>"


_VLEN_STR = _VlenStrType()
_VLEN_DESC = 16  # file descriptor: uint32 length + 8-byte heap addr + uint32 index


# =========================================================== reader side
@dataclasses.dataclass
class _Layout:
    kind: str  # "contiguous" | "chunked" | "compact"
    addr: int = _UNDEF  # contiguous: data address; chunked: btree address
    size: int = 0  # contiguous: total bytes
    chunk_shape: tuple = ()  # chunked only (element dims, no type dim)
    compact: bytes = b""  # compact only
    filters: tuple = ()  # ((filter_id, client_values), ...) write order


class ShimDataset:
    """Read-only handle to one HDF5 dataset (contiguous or 1-D chunked).

    Slicing along axis 0 reads only the bytes required: contiguous layout
    seeks straight to the row range; chunked layout decompresses only the
    overlapping chunks.  Thread-safe (``os.pread``, no shared file cursor) —
    safe under ``PlannedRows``' ``io_workers`` and in forked processes.
    """

    def __init__(self, file: "ShimFile", shape: tuple, dtype: np.dtype,
                 layout: _Layout, vlen: bool = False):
        self._file = file
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.vlen = vlen  # variable-length strings via the global heap
        self._layout = layout
        # lazy chunk index: [(start_elem, nbytes, addr, mask)] ascending in
        # start_elem (B-tree key order) + the start_elem array for bisection
        self._chunks: Optional[list] = None
        self._chunk_starts: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.shape[0] if self.shape else 1

    @property
    def nbytes(self) -> int:
        if self.vlen:  # descriptor bytes (payloads live in the global heap)
            return int(np.prod(self.shape, dtype=np.int64)) * _VLEN_DESC
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def __getitem__(self, key) -> np.ndarray:
        if key is Ellipsis or (isinstance(key, slice) and key == slice(None)):
            return self.read(0, len(self))
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step != 1:
                return self.read(0, len(self))[key]
            return self.read(start, stop)
        if isinstance(key, (int, np.integer)):
            return self.read(int(key), int(key) + 1)[0]
        # fancy indexing: coalesce to a bounding read (callers pass small sets)
        idx = np.asarray(key)
        if idx.size == 0:
            return np.empty((0,) + self.shape[1:], dtype=self.dtype)
        lo, hi = int(idx.min()), int(idx.max()) + 1
        return self.read(lo, hi)[idx - lo]

    def read(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` along axis 0 — one contiguous byte range
        for contiguous layout, minimal chunk set for chunked layout."""
        n = len(self)
        start, stop = max(0, int(start)), min(n, int(stop))
        if stop <= start:
            return np.empty((0,) + self.shape[1:], dtype=self.dtype)
        if self.vlen:
            return self._read_vlen(start, stop)
        row_elems = int(np.prod(self.shape[1:], dtype=np.int64)) if len(self.shape) > 1 else 1
        if self._layout.kind == "compact":
            arr = np.frombuffer(self._layout.compact, dtype=self.dtype)
            return arr.reshape(self.shape)[start:stop].copy()
        if self._layout.kind == "contiguous":
            itemsize = self.dtype.itemsize
            off = self._layout.addr + start * row_elems * itemsize
            nbytes = (stop - start) * row_elems * itemsize
            raw = self._file._pread(off, nbytes)
            arr = np.frombuffer(raw, dtype=self.dtype)
            return arr.reshape((stop - start,) + self.shape[1:]).copy()
        return self._read_chunked(start, stop)

    def _read_vlen(self, start: int, stop: int) -> np.ndarray:
        """Vlen-string rows ``[start, stop)``: read the 16-byte descriptors,
        resolve each through the (cached) global heap collection."""
        if len(self.shape) != 1:
            raise NotImplementedError(
                "pure-Python shim reads vlen-string datasets in 1-D only "
                f"(got shape {self.shape}); install h5py for this file"
            )
        if self._layout.kind == "compact":
            raw = self._layout.compact[start * _VLEN_DESC:stop * _VLEN_DESC]
        elif self._layout.kind == "contiguous":
            raw = self._file._pread(self._layout.addr + start * _VLEN_DESC,
                                    (stop - start) * _VLEN_DESC)
        else:
            raise NotImplementedError(
                "chunked vlen-string datasets unsupported by the pure-Python "
                "shim; install h5py for this file"
            )
        return np.array([self._file._vlen_str(raw, i * _VLEN_DESC)
                         for i in range(stop - start)], dtype=str)

    def _read_chunked(self, start: int, stop: int) -> np.ndarray:
        if len(self.shape) != 1:
            raise NotImplementedError(
                "pure-Python shim reads chunked datasets in 1-D only "
                f"(got shape {self.shape}); install h5py for this file"
            )
        if self._chunks is None:
            self._chunks = self._file._walk_chunk_btree(
                self._layout.addr, ndims=len(self.shape)
            )
            self._chunk_starts = np.array([c[0] for c in self._chunks],
                                          dtype=np.int64)
        out = np.empty(stop - start, dtype=self.dtype)
        # bisect the sorted chunk index: only overlapping chunks are visited
        # (and read), so a planner extent costs O(log n + chunks touched)
        i0 = max(0, int(np.searchsorted(self._chunk_starts, start, side="right")) - 1)
        i1 = int(np.searchsorted(self._chunk_starts, stop, side="left"))
        for elem0, stored_nbytes, addr, mask in self._chunks[i0:i1]:
            raw = self._file._pread(addr, stored_nbytes)
            raw = self._defilter(raw, mask)
            chunk = np.frombuffer(raw, dtype=self.dtype)
            lo = max(start, elem0)
            hi = min(stop, elem0 + len(chunk))
            out[lo - start:hi - start] = chunk[lo - elem0:hi - elem0]
        return out

    def _defilter(self, raw: bytes, mask: int) -> bytes:
        # filters applied in REVERSE write order on read
        for i, (fid, cvals) in enumerate(reversed(self._layout.filters)):
            if mask & (1 << (len(self._layout.filters) - 1 - i)):
                continue  # filter skipped for this chunk
            if fid == _FILTER_DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == _FILTER_SHUFFLE:
                elem = cvals[0] if cvals else self.dtype.itemsize
                arr = np.frombuffer(raw, dtype=np.uint8)
                raw = arr.reshape(elem, -1).T.tobytes()
            else:
                raise NotImplementedError(
                    f"HDF5 filter id {fid} not supported by the pure-Python "
                    "shim (deflate and shuffle are); install h5py"
                )
        return raw


class ShimFile:
    """Pure-Python, read-only view of an HDF5 file (see module docstring).

    Navigation is by POSIX-style paths: ``f.dataset("X/data")``,
    ``f.keys("obs")``, ``f.attrs("X")["shape"]``.  Unreadable attributes
    (variable-length strings, shared datatypes) are silently omitted rather
    than failing the whole file — the h5ad reader only needs ``shape``.
    """

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self._groups: dict[str, dict[str, int]] = {}  # path -> name -> header addr
        self._gheaps: dict[int, dict[int, bytes]] = {}  # GCOL addr -> idx -> bytes
        try:
            self._root_addr = self._read_superblock()
        except Exception:
            os.close(self._fd)
            raise

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):  # last-resort fd release (GC / interpreter exit)
        try:
            self.close()
        except Exception:  # pragma: no cover - shutdown races
            pass

    def __enter__(self) -> "ShimFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _pread(self, off: int, n: int) -> bytes:
        if self._fd is None:
            raise ValueError(f"read on closed ShimFile: {self.path}")
        buf = os.pread(self._fd, n, off)
        if len(buf) != n:
            raise IOError(f"short read at {off} ({len(buf)}/{n} bytes): {self.path}")
        return buf

    # -- superblock ------------------------------------------------------
    def _read_superblock(self) -> int:
        head = self._pread(0, 96)
        if head[:8] != _SIGNATURE:
            raise ValueError(f"not an HDF5 file: {self.path}")
        version = head[8]
        if version != 0:
            raise NotImplementedError(
                f"HDF5 superblock v{version} not supported by the pure-Python "
                "shim (h5py default files use v0); install h5py"
            )
        size_off, size_len = head[13], head[14]
        if (size_off, size_len) != (8, 8):
            raise NotImplementedError(
                f"offset/length sizes {size_off}/{size_len} unsupported (need 8/8)"
            )
        # root group symbol-table entry starts at byte 24 + 32 = 56
        (root_header_addr,) = struct.unpack_from("<Q", head, 56 + 8)
        return root_header_addr

    # -- object headers --------------------------------------------------
    def _read_messages(self, addr: int) -> list[tuple[int, bytes]]:
        """All (type, body) messages of a v1 object header, following
        continuation blocks."""
        prefix = self._pread(addr, 16)
        version = prefix[0]
        if version != 1:
            raise NotImplementedError(
                f"object header v{version} at {addr} unsupported (v1 only)"
            )
        (nmsgs,) = struct.unpack_from("<H", prefix, 2)
        (block_size,) = struct.unpack_from("<I", prefix, 8)
        blocks = [(addr + 16, block_size)]
        msgs: list[tuple[int, bytes]] = []
        while blocks and len(msgs) < nmsgs:
            baddr, bsize = blocks.pop(0)
            raw = self._pread(baddr, bsize)
            pos = 0
            while pos + 8 <= bsize and len(msgs) < nmsgs:
                mtype, msize, flags = struct.unpack_from("<HHB", raw, pos)
                body = raw[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _MSG_CONTINUATION:
                    coff, clen = struct.unpack_from("<QQ", body, 0)
                    blocks.append((coff, clen))
                elif flags & 0x02:
                    continue  # shared message: not supported, skip
                else:
                    msgs.append((mtype, body))
        return msgs

    # -- group traversal -------------------------------------------------
    def _group_entries(self, path: str) -> dict[str, int]:
        path = path.strip("/")
        if path in self._groups:
            return self._groups[path]
        if path == "":
            entries = self._symbol_table_entries(self._root_addr)
        else:
            parent, _, name = path.rpartition("/")
            pentries = self._group_entries(parent)
            if name not in pentries:
                raise KeyError(f"no object {path!r} in {self.path}")
            entries = self._symbol_table_entries(pentries[name])
        self._groups[path] = entries
        return entries

    def _symbol_table_entries(self, header_addr: int) -> dict[str, int]:
        msgs = self._read_messages(header_addr)
        for mtype, body in msgs:
            if mtype == _MSG_SYMBOL_TABLE:
                btree_addr, heap_addr = struct.unpack_from("<QQ", body, 0)
                heap_data = self._local_heap(heap_addr)
                out: dict[str, int] = {}
                self._walk_group_btree(btree_addr, heap_data, out)
                return out
        raise KeyError(f"object at {header_addr} is not an old-style group")

    def _local_heap(self, addr: int) -> bytes:
        head = self._pread(addr, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"bad local heap signature at {addr}")
        (seg_size,) = struct.unpack_from("<Q", head, 8)
        (seg_addr,) = struct.unpack_from("<Q", head, 24)
        return self._pread(seg_addr, seg_size)

    @staticmethod
    def _heap_string(heap: bytes, off: int) -> str:
        end = heap.index(b"\x00", off)
        return heap[off:end].decode("utf-8")

    def _walk_group_btree(self, addr: int, heap: bytes, out: dict[str, int]) -> None:
        head = self._pread(addr, 24)
        if head[:4] == b"SNOD":  # leaf symbol-table node reached directly
            self._read_snod(addr, heap, out)
            return
        if head[:4] != b"TREE":
            raise ValueError(f"bad B-tree signature at {addr}")
        node_type, level = head[4], head[5]
        (nused,) = struct.unpack_from("<H", head, 6)
        if node_type != 0:
            raise ValueError(f"B-tree node type {node_type} in group context")
        # keys and children alternate: key0, child0, key1, child1, ... keyN
        body = self._pread(addr + 24, (2 * nused + 1) * 8)
        for i in range(nused):
            (child,) = struct.unpack_from("<Q", body, (2 * i + 1) * 8)
            if level > 0:
                self._walk_group_btree(child, heap, out)
            else:
                self._read_snod(child, heap, out)

    def _read_snod(self, addr: int, heap: bytes, out: dict[str, int]) -> None:
        head = self._pread(addr, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"bad symbol node signature at {addr}")
        (nsyms,) = struct.unpack_from("<H", head, 6)
        raw = self._pread(addr + 8, nsyms * 40)
        for i in range(nsyms):
            name_off, obj_addr = struct.unpack_from("<QQ", raw, i * 40)
            out[self._heap_string(heap, name_off)] = obj_addr

    # -- global heap (vlen strings) --------------------------------------
    def _gheap_objects(self, addr: int) -> dict[int, bytes]:
        """Objects of one global-heap collection (``GCOL``), cached by
        collection address — a column's strings share a few collections, so
        one pread serves every element pointing into it."""
        cached = self._gheaps.get(addr)
        if cached is not None:
            return cached
        head = self._pread(addr, 16)
        if head[:4] != b"GCOL":
            raise ValueError(f"bad global heap signature at {addr}: {self.path}")
        (size,) = struct.unpack_from("<Q", head, 8)
        blob = self._pread(addr, size)
        out: dict[int, bytes] = {}
        pos = 16
        while pos + 16 <= size:
            idx, _refs = struct.unpack_from("<HH", blob, pos)
            (osize,) = struct.unpack_from("<Q", blob, pos + 8)
            if idx == 0:  # free-space object terminates the collection
                break
            out[idx] = bytes(blob[pos + 16:pos + 16 + osize])
            pos += 16 + _pad8(osize)
        self._gheaps[addr] = out
        return out

    def _vlen_str(self, raw: bytes, off: int) -> str:
        """One 16-byte vlen descriptor at ``raw[off:]`` -> python string."""
        length, gaddr, gidx = struct.unpack_from("<IQI", raw, off)
        if length == 0 or gaddr in (0, _UNDEF) or gidx == 0:
            return ""  # null / empty element
        data = self._gheap_objects(gaddr)[gidx]
        return data[:length].decode("utf-8")

    def _walk_chunk_btree(self, addr: int, ndims: int) -> list:
        """Chunk index (B-tree node type 1) -> [(start_elem, nbytes, addr, mask)]."""
        out: list = []
        head = self._pread(addr, 24)
        if head[:4] != b"TREE":
            raise ValueError(f"bad chunk B-tree signature at {addr}")
        node_type, level = head[4], head[5]
        (nused,) = struct.unpack_from("<H", head, 6)
        if node_type != 1:
            raise ValueError(f"B-tree node type {node_type} in chunk context")
        key_size = 8 + 8 * (ndims + 1)  # size(4)+mask(4)+offsets(8 per dim +1)
        body = self._pread(addr + 24, (nused + 1) * key_size + nused * 8)
        pos = 0
        for _ in range(nused):
            nbytes, mask = struct.unpack_from("<II", body, pos)
            (elem0,) = struct.unpack_from("<Q", body, pos + 8)  # dim-0 offset
            (child,) = struct.unpack_from("<Q", body, pos + key_size)
            pos += key_size + 8
            if level > 0:
                out.extend(self._walk_chunk_btree(child, ndims))
            else:
                out.append((elem0, nbytes, child, mask))
        return out

    # -- message decoding ------------------------------------------------
    @staticmethod
    def _parse_dataspace(body: bytes) -> Optional[tuple]:
        version = body[0]
        if version == 1:
            rank, flags = body[1], body[2]
            pos = 8
        elif version == 2:
            rank, flags = body[1], body[2]
            pos = 4
        else:
            return None
        dims = struct.unpack_from(f"<{rank}Q", body, pos) if rank else ()
        return tuple(dims)

    @staticmethod
    def _parse_datatype(body: bytes) -> Any:  # np.dtype | _VLEN_STR | None
        cls_ver = body[0]
        cls = cls_ver & 0x0F
        bits0 = body[1]
        (size,) = struct.unpack_from("<I", body, 4)
        order = ">" if (bits0 & 1) else "<"
        if cls == 0:  # fixed-point
            signed = "i" if (bits0 & 0x08) else "u"
            return np.dtype(f"{order}{signed}{size}")
        if cls == 1:  # floating point (assume IEEE)
            return np.dtype(f"{order}f{size}")
        if cls == 3:  # fixed-length string
            return np.dtype(f"S{size}")
        if cls == 9 and (bits0 & 0x0F) == 1:  # variable-length STRING
            return _VLEN_STR  # sentinel: resolved through the global heap
        return None  # vlen sequence / compound / enum: caller decides how to fail

    @staticmethod
    def _parse_layout(body: bytes) -> Optional[_Layout]:
        version = body[0]
        if version != 3:
            return None
        cls = body[1]
        if cls == 0:  # compact
            (csize,) = struct.unpack_from("<H", body, 2)
            return _Layout(kind="compact", compact=body[4:4 + csize])
        if cls == 1:  # contiguous
            addr, size = struct.unpack_from("<QQ", body, 2)
            return _Layout(kind="contiguous", addr=addr, size=size)
        if cls == 2:  # chunked
            ndims = body[2]  # element dims + 1 (type size dim)
            (btree,) = struct.unpack_from("<Q", body, 3)
            dims = struct.unpack_from(f"<{ndims}I", body, 11)
            return _Layout(kind="chunked", addr=btree, chunk_shape=tuple(dims[:-1]))
        return None

    @staticmethod
    def _parse_filters(body: bytes) -> tuple:
        version, nfilters = body[0], body[1]
        if version != 1:
            return ()
        pos = 8
        out = []
        for _ in range(nfilters):
            fid, name_len, _flags, ncv = struct.unpack_from("<HHHH", body, pos)
            pos += 8 + _pad8(name_len)
            cvals = struct.unpack_from(f"<{ncv}I", body, pos)
            pos += 4 * ncv
            if ncv % 2:  # v1 pads odd client-value counts
                pos += 4
            out.append((fid, tuple(cvals)))
        return tuple(out)

    def _parse_attribute(self, body: bytes) -> Optional[tuple[str, Any]]:
        version = body[0]
        if version != 1:
            return None
        name_size, dt_size, ds_size = struct.unpack_from("<HHH", body, 2)
        pos = 8
        name = body[pos:pos + name_size].split(b"\x00")[0].decode("utf-8")
        pos += _pad8(name_size)
        dtype = self._parse_datatype(body[pos:pos + dt_size])
        pos += _pad8(dt_size)
        shape = self._parse_dataspace(body[pos:pos + ds_size])
        pos += _pad8(ds_size)
        if dtype is None or shape is None:
            return None  # compound attrs etc.: omit, don't fail the file
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if dtype is _VLEN_STR:
            raw = body[pos:pos + count * _VLEN_DESC]
            if len(raw) < count * _VLEN_DESC:
                return None
            try:
                vals = [self._vlen_str(raw, i * _VLEN_DESC) for i in range(count)]
            except (ValueError, KeyError, OSError):
                return None  # dangling heap reference: omit like before
            return name, (vals if shape else vals[0])
        raw = body[pos:pos + count * dtype.itemsize]
        if len(raw) < count * dtype.itemsize:
            return None
        val = np.frombuffer(raw, dtype=dtype, count=count)
        if dtype.kind == "S":
            out: Any = val[0].split(b"\x00")[0].decode("utf-8") if not shape else [
                v.split(b"\x00")[0].decode("utf-8") for v in val
            ]
        elif not shape:
            out = val[0].item()
        else:
            out = val.reshape(shape).copy()
        return name, out

    # -- public API ------------------------------------------------------
    def keys(self, path: str = "/") -> list[str]:
        """Child names of a group."""
        return sorted(self._group_entries(path))

    def _object_addr(self, path: str) -> int:
        path = path.strip("/")
        if path == "":
            return self._root_addr
        parent, _, name = path.rpartition("/")
        entries = self._group_entries(parent)
        if name not in entries:
            raise KeyError(f"no object {path!r} in {self.path}")
        return entries[name]

    def is_group(self, path: str) -> bool:
        msgs = self._read_messages(self._object_addr(path))
        return any(t == _MSG_SYMBOL_TABLE for t, _ in msgs)

    def attrs(self, path: str) -> dict:
        """Readable attributes of an object (unreadable ones omitted)."""
        out: dict = {}
        for mtype, body in self._read_messages(self._object_addr(path)):
            if mtype == _MSG_ATTRIBUTE:
                parsed = self._parse_attribute(body)
                if parsed is not None:
                    out[parsed[0]] = parsed[1]
        return out

    def dataset(self, path: str) -> ShimDataset:
        msgs = self._read_messages(self._object_addr(path))
        shape = dtype = layout = None
        filters: tuple = ()
        for mtype, body in msgs:
            if mtype == _MSG_DATASPACE:
                shape = self._parse_dataspace(body)
            elif mtype == _MSG_DATATYPE:
                dtype = self._parse_datatype(body)
                if dtype is None:
                    raise NotImplementedError(
                        f"dataset {path!r} has a datatype the pure-Python shim "
                        "cannot read (compound/enum/vlen-sequence); install h5py"
                    )
            elif mtype == _MSG_LAYOUT:
                layout = self._parse_layout(body)
            elif mtype == _MSG_FILTERS:
                filters = self._parse_filters(body)
        if shape is None or dtype is None or layout is None:
            raise KeyError(f"{path!r} is not a readable dataset in {self.path}")
        layout.filters = filters
        if dtype is _VLEN_STR:
            return ShimDataset(self, shape, np.dtype(str), layout, vlen=True)
        return ShimDataset(self, shape, dtype, layout)


# =========================================================== writer side
@dataclasses.dataclass
class GroupSpec:
    """Declarative tree node for :func:`write_shim_file` — children are
    ``GroupSpec`` (subgroup) or ``np.ndarray`` (contiguous dataset);
    attribute values are scalars, strings, or small arrays."""

    children: dict = dataclasses.field(default_factory=dict)
    attrs: dict = dataclasses.field(default_factory=dict)


_LEAF_K = 4  # symbol-table node capacity = 2k entries (matches superblock)


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def alloc(self, data: bytes) -> int:
        while len(self.buf) % 8:
            self.buf += b"\x00"
        addr = len(self.buf)
        self.buf += data
        return addr

    # -- datatype/dataspace encodings (shared by datasets and attributes)
    @staticmethod
    def _datatype_msg(dtype: np.dtype) -> bytes:
        dtype = np.dtype(dtype)
        if dtype.kind in "iu":
            bits0 = 0x08 if dtype.kind == "i" else 0x00
            body = struct.pack("<BBBBI", 0x10, bits0, 0, 0, dtype.itemsize)
            body += struct.pack("<HH", 0, dtype.itemsize * 8)  # offset, precision
        elif dtype.kind == "f":
            if dtype.itemsize == 4:
                sign, exp_loc, exp_sz, man_sz, bias = 31, 23, 8, 23, 127
            elif dtype.itemsize == 8:
                sign, exp_loc, exp_sz, man_sz, bias = 63, 52, 11, 52, 1023
            else:
                raise NotImplementedError(f"float{dtype.itemsize * 8} unsupported")
            body = struct.pack("<BBBBI", 0x11, 0x20, sign, 0, dtype.itemsize)
            body += struct.pack(
                "<HHBBBBI", 0, dtype.itemsize * 8, exp_loc, exp_sz, 0, man_sz, bias
            )
        elif dtype.kind == "S":
            # null-terminated ASCII fixed string
            body = struct.pack("<BBBBI", 0x13, 0x00, 0, 0, dtype.itemsize)
        else:
            raise NotImplementedError(
                f"dtype {dtype} unsupported by the shim writer (int/float/bytes only)"
            )
        return body

    @staticmethod
    def _dataspace_msg(shape: tuple) -> bytes:
        body = struct.pack("<BBBB4x", 1, len(shape), 0, 0)
        for d in shape:
            body += struct.pack("<Q", d)
        return body

    def _attr_msg(self, name: str, value: Any) -> bytes:
        if isinstance(value, str):
            data = value.encode("utf-8") + b"\x00"
            dtype = np.dtype(f"S{len(data)}")
            shape: tuple = ()
        else:
            arr = np.asarray(value)
            if arr.dtype.kind == "U":
                raise NotImplementedError("unicode array attrs unsupported; use bytes")
            if arr.dtype.kind == "i":
                arr = arr.astype(np.int64)
            dtype = arr.dtype
            shape = arr.shape
            data = arr.tobytes()
        nameb = name.encode("utf-8") + b"\x00"
        dt = self._datatype_msg(dtype)
        ds = self._dataspace_msg(shape)
        body = struct.pack("<BBHHH", 1, 0, len(nameb), len(dt), len(ds))
        body += nameb.ljust(_pad8(len(nameb)), b"\x00")
        body += dt.ljust(_pad8(len(dt)), b"\x00")
        body += ds.ljust(_pad8(len(ds)), b"\x00")
        body += data
        return body

    def _object_header(self, messages: list[tuple[int, bytes]]) -> int:
        blob = bytearray()
        for mtype, body in messages:
            body = body.ljust(_pad8(len(body)), b"\x00")
            blob += struct.pack("<HHB3x", mtype, len(body), 0)
            blob += body
        head = struct.pack("<BxHII4x", 1, len(messages), 1, len(blob))
        return self.alloc(head + bytes(blob))

    def write_dataset(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        data_addr = self.alloc(arr.tobytes())
        msgs = [
            (_MSG_DATASPACE, self._dataspace_msg(arr.shape)),
            (_MSG_DATATYPE, self._datatype_msg(arr.dtype)),
            # fill value: version 2, early allocation, never written, undefined
            (_MSG_FILL, struct.pack("<BBBB", 2, 1, 1, 0)),
            (_MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)),
        ]
        return self._object_header(msgs)

    def write_vlen_dataset(self, strs: Sequence[str]) -> int:
        """1-D variable-length UTF-8 string dataset (what anndata uses for
        string obs columns / categorical ``categories``): payloads go into
        one global heap collection, the dataset's raw data is the 16-byte
        descriptors pointing at it."""
        payloads = [str(s).encode("utf-8") for s in strs]
        gcol = bytearray(b"GCOL" + struct.pack("<B3xQ", 1, 0))  # size patched
        descs: list[tuple[int, int]] = []
        for i, p in enumerate(payloads, start=1):
            gcol += struct.pack("<HH4xQ", i, 1, len(p))
            gcol += p.ljust(_pad8(len(p)), b"\x00")
            descs.append((len(p), i))
        # free-space object (index 0) covers the tail; libhdf5 requires
        # collections of >= 4096 bytes (H5HG_MINSIZE), so pad up to that
        total = max(4096, _pad8(len(gcol) + 16))
        free = total - len(gcol)
        gcol += struct.pack("<HH4xQ", 0, 0, free)
        gcol += b"\x00" * (total - len(gcol))
        struct.pack_into("<Q", gcol, 8, total)
        gaddr = self.alloc(bytes(gcol))
        data = b"".join(struct.pack("<IQI", ln, gaddr, gi) for ln, gi in descs)
        data_addr = self.alloc(data)
        # datatype: v1 class 9 (vlen), type=string, null-pad, UTF-8 charset;
        # the base type (1-byte unsigned int, what h5py records) follows
        dt = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, _VLEN_DESC)
        dt += struct.pack("<BBBBI", 0x10, 0x00, 0, 0, 1) + struct.pack("<HH", 0, 8)
        msgs = [
            (_MSG_DATASPACE, self._dataspace_msg((len(payloads),))),
            (_MSG_DATATYPE, dt),
            (_MSG_FILL, struct.pack("<BBBB", 2, 1, 1, 0)),
            (_MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, len(data))),
        ]
        return self._object_header(msgs)

    def write_group(self, spec: GroupSpec) -> int:
        # children first (bottom-up): their header addresses go in the SNODs
        child_addrs: dict[str, int] = {}
        for name, child in spec.children.items():
            if isinstance(child, GroupSpec):
                child_addrs[name] = self.write_group(child)
            else:
                arr = np.asarray(child)
                if arr.dtype.kind in ("U", "O"):  # python/unicode strings
                    if arr.ndim != 1:
                        raise NotImplementedError(
                            "shim writer supports vlen-string datasets in 1-D only"
                        )
                    child_addrs[name] = self.write_vlen_dataset(
                        [str(x) for x in arr.tolist()]
                    )
                else:
                    child_addrs[name] = self.write_dataset(arr)

        names = sorted(child_addrs)  # symbol tables are name-ordered
        # local heap: offset 0 is the empty string (8 zero bytes), then names
        heap = bytearray(b"\x00" * 8)
        name_off: dict[str, int] = {}
        for n in names:
            name_off[n] = len(heap)
            nb = n.encode("utf-8") + b"\x00"
            heap += nb.ljust(_pad8(len(nb)), b"\x00")
        heap_data_addr = self.alloc(bytes(heap))
        heap_addr = self.alloc(
            b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data_addr)
        )

        # symbol-table nodes of <= 2*_LEAF_K entries each, then one B-tree node
        snod_addrs: list[int] = []
        snod_last_name: list[str] = []
        cap = 2 * _LEAF_K
        for i in range(0, max(len(names), 1), cap):
            batch = names[i:i + cap]
            blob = b"SNOD" + struct.pack("<BxH", 1, len(batch))
            for n in batch:
                blob += struct.pack("<QQI4x16x", name_off[n], child_addrs[n], 0)
            # pad the node to full capacity so libraries may grow it in place
            blob = blob.ljust(8 + cap * 40, b"\x00")
            snod_addrs.append(self.alloc(blob))
            snod_last_name.append(batch[-1] if batch else "")
        # B-tree: key0 ("" bounds everything below), then child_i, key_{i+1}
        # (heap offset of the greatest name in child_i), alternating
        tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snod_addrs), _UNDEF, _UNDEF)
        tree += struct.pack("<Q", 0)
        for addr, last in zip(snod_addrs, snod_last_name):
            tree += struct.pack("<QQ", addr, name_off.get(last, 0))
        # libraries read the node at its FULL capacity (internal k=16 ->
        # 24 + 33 keys + 32 children = 544 bytes); pad to that size
        btree_addr = self.alloc(tree.ljust(24 + (2 * 16 + 1) * 8 + 2 * 16 * 8, b"\x00"))

        msgs: list[tuple[int, bytes]] = [
            (_MSG_SYMBOL_TABLE, struct.pack("<QQ", btree_addr, heap_addr))
        ]
        for aname, aval in spec.attrs.items():
            msgs.append((_MSG_ATTRIBUTE, self._attr_msg(aname, aval)))
        return self._object_header(msgs)


def write_shim_file(path: str, root: GroupSpec) -> None:
    """Write ``root`` as a v0-superblock HDF5 file readable by h5py/anndata.

    Datasets are contiguous and uncompressed; groups are old-style; writes
    go to ``path + '.tmp'`` then rename, so readers never see a torn file.
    """
    w = _Writer()
    w.alloc(b"\x00" * 96)  # reserve the superblock; patched below
    root_addr = w.write_group(root)
    sb = bytearray()
    sb += _SIGNATURE
    sb += struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0)
    sb += struct.pack("<HHI", _LEAF_K, 16, 0)
    sb += struct.pack("<QQQQ", 0, _UNDEF, len(w.buf), _UNDEF)
    sb += struct.pack("<QQI4x16x", 0, root_addr, 0)  # root symbol-table entry
    assert len(sb) == 96
    w.buf[:96] = sb
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(w.buf)
    os.replace(tmp, path)
