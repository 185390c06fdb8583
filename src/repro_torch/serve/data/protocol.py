"""Wire protocol of the batch server, version 1: the port of
``repro.serve.data.protocol``, byte for byte.

Length-prefixed binary frames over a stream socket.  Every frame is::

    +--------+---------+-------+------------+----------------+
    | b"SD"  | version | ftype | length u32 | payload bytes  |
    | 2 B    | 1 B     | 1 B   | 4 B (BE)   | length B       |
    +--------+---------+-------+------------+----------------+

``version`` is :data:`WIRE_VERSION`; a peer speaking a newer version is
refused rather than guessed at.

Frame types (payloads are UTF-8 JSON unless noted):

===============  =====  ========================================================
type             value  payload
===============  =====  ========================================================
``F_OPEN``       1      ``{"spec": <spec dict>, "compression": "none"|"qint8"|null}``
``F_ACK``        2      ``{"tenant", "fingerprint", "compression", "n_batches"}``
``F_ITER``       3      ``{"state": <LoaderState dict>}`` — stream one epoch from here
``F_BATCH``      4      binary — see :func:`encode_batch` (its header carries the
                        state after the batch)
``F_EPOCH_END``  5      ``{"state": <LoaderState dict>}`` — the position after the epoch
``F_STATS``      6      request: ``{}``; reply: the server's stats dict
``F_ERROR``      7      ``{"error": <code>, "detail": <msg>}``
``F_CLOSE``      8      ``{}`` — orderly shutdown, either side
===============  =====  ========================================================

Error codes: ``bad_spec``, ``bad_state``, ``fingerprint_mismatch``,
``admission_timeout``, ``quota_exhausted``, ``protocol``, ``internal``.

A batch payload ships each array raw (dtype, shape, C-order bytes), so with
``compression="none"`` the decoded batch is bitwise the server's.  With
``"qint8"`` float arrays go through the error-feedback int8 quantizer
(:func:`repro_torch.distributed.compression.quantize_ef_np`, per batch, no
residual carried across frames, since a frame decodes on its own): about 4x
fewer bytes for float32 expression values, a bounded error per block of 256
values, integer arrays (indices, row pointers, labels) exact.  For the same
batch and state, :func:`encode_batch` gives the reference's bytes, so either
package decodes the other's frames.
"""
from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np

from ...data.csr_store import CSRBatch
from ...distributed.compression import dequantize_np, quantize_ef_np

__all__ = [
    "WIRE_VERSION", "MAGIC", "MAX_FRAME_BYTES",
    "F_OPEN", "F_ACK", "F_ITER", "F_BATCH", "F_EPOCH_END", "F_STATS",
    "F_ERROR", "F_CLOSE",
    "COMPRESSIONS", "ProtocolError", "ServeError",
    "send_frame", "recv_frame", "send_json", "loads",
    "encode_batch", "decode_batch",
]

MAGIC = b"SD"
WIRE_VERSION = 1
#: refuse absurd frame lengths before allocating (corrupt header / not our
#: protocol); a real minibatch frame is a few MB.
MAX_FRAME_BYTES = 1 << 30

_HEADER = struct.Struct("!2sBBI")

F_OPEN = 1
F_ACK = 2
F_ITER = 3
F_BATCH = 4
F_EPOCH_END = 5
F_STATS = 6
F_ERROR = 7
F_CLOSE = 8

_KNOWN_FRAMES = frozenset(
    (F_OPEN, F_ACK, F_ITER, F_BATCH, F_EPOCH_END, F_STATS, F_ERROR, F_CLOSE)
)

COMPRESSIONS = ("none", "qint8")


class ProtocolError(RuntimeError):
    """Malformed frame / unsupported payload — the connection is unusable."""


class ServeError(RuntimeError):
    """An F_ERROR frame surfaced client-side; ``code`` is the wire code."""

    def __init__(self, code: str, detail: str):
        super().__init__(detail)
        self.code = code
        self.detail = detail


# ------------------------------------------------------------------ framing
def recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` on EOF."""
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError(f"peer closed mid-frame ({got}/{n} bytes)")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def send_frame(sock, ftype: int, payload: bytes) -> None:
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame payload {len(payload)} B over the cap")
    sock.sendall(_HEADER.pack(MAGIC, WIRE_VERSION, ftype, len(payload)) + payload)


def recv_frame(sock, *, first: bytes = b"") -> tuple[int, bytes]:
    """Read one frame; ``first`` holds header bytes already consumed (the
    server peeks the first 4 to sniff HTTP ``GET /stats`` requests)."""
    head = first + recv_exact(sock, _HEADER.size - len(first))
    magic, version, ftype, length = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r} (not an SD v1 stream)")
    if version > WIRE_VERSION:
        raise ProtocolError(
            f"peer speaks wire version {version}, this side {WIRE_VERSION}; "
            "refusing to guess at the frame layout"
        )
    if ftype not in _KNOWN_FRAMES:
        raise ProtocolError(f"unknown frame type {ftype}")
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {length} over the cap")
    return ftype, recv_exact(sock, length)


def send_json(sock, ftype: int, obj: Any) -> None:
    send_frame(sock, ftype, json.dumps(obj).encode())


def loads(payload: bytes) -> dict:
    try:
        d = json.loads(payload.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable JSON payload: {e}") from e
    if not isinstance(d, dict):
        raise ProtocolError("JSON payload must be an object")
    return d


# ------------------------------------------------------------- batch codec
def _pack_arrays(
    named: list[tuple[str, np.ndarray]], compression: str
) -> tuple[list[dict], list[bytes]]:
    metas: list[dict] = []
    chunks: list[bytes] = []
    for name, arr in named:
        arr = np.asarray(arr)
        if arr.dtype == object:
            # object columns (python strings) have no stable byte layout;
            # ship as fixed-width unicode — compares equal element-wise
            arr = arr.astype(str)
        if compression == "qint8" and arr.dtype.kind == "f":
            q, s, _ = quantize_ef_np(arr)
            metas.append({
                "n": name, "dtype": arr.dtype.str, "shape": list(arr.shape),
                "enc": "qint8", "blocks": int(q.shape[0]),
            })
            chunks.append(q.tobytes())
            chunks.append(np.ascontiguousarray(s).tobytes())
        else:
            a = np.ascontiguousarray(arr)
            metas.append({
                "n": name, "dtype": a.dtype.str, "shape": list(a.shape),
                "enc": "raw",
            })
            chunks.append(a.tobytes())
    return metas, chunks


def encode_batch(batch: Any, state: dict, compression: str = "none") -> bytes:
    """Serialize one minibatch + its post-batch resume state into an
    ``F_BATCH`` payload: ``u32 header_len | header JSON | array bytes``.

    Supported batch shapes — :class:`~repro_torch.data.csr_store.CSRBatch`
    (sparse rows + obs columns, the repo's native fetch product), a bare
    ``np.ndarray`` (densified via ``batch_transform``), and a flat mapping
    of arrays.  Anything else raises :class:`ProtocolError`: a bespoke
    batch type needs a codec entry here, not a pickle.
    """
    if compression not in COMPRESSIONS:
        raise ProtocolError(f"unknown compression {compression!r}")
    meta: dict = {}
    if isinstance(batch, CSRBatch):
        kind = "csr"
        meta = {"n_var": int(batch.n_var), "obs_keys": list(batch.obs)}
        named = [
            ("data", batch.data), ("indices", batch.indices),
            ("indptr", batch.indptr),
        ] + [(f"obs:{k}", v) for k, v in batch.obs.items()]
    elif isinstance(batch, np.ndarray):
        kind = "dense"
        named = [("x", batch)]
    elif isinstance(batch, dict):
        kind = "map"
        meta = {"keys": list(batch)}
        named = [(f"k:{k}", v) for k, v in batch.items()]
    else:
        raise ProtocolError(
            f"unsupported batch type {type(batch).__name__}; the wire codec "
            "handles CSRBatch, ndarray and dict-of-arrays"
        )
    metas, chunks = _pack_arrays(named, compression)
    header = json.dumps(
        {"kind": kind, "state": state, "meta": meta, "arrays": metas}
    ).encode()
    return struct.pack("!I", len(header)) + header + b"".join(chunks)


def _unpack_arrays(metas: list[dict], buf: memoryview) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    off = 0
    for m in metas:
        dtype = np.dtype(m["dtype"])
        shape = tuple(m["shape"])
        if m["enc"] == "qint8":
            blocks = int(m["blocks"])
            nb_q, nb_s = blocks * 256, blocks * 4
            q = np.frombuffer(buf[off:off + nb_q], np.int8).reshape(blocks, 256)
            off += nb_q
            s = np.frombuffer(buf[off:off + nb_s], np.dtype("<f4"))
            off += nb_s
            out[m["n"]] = dequantize_np(q, s, shape, dtype)
        elif m["enc"] == "raw":
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            nb = n * dtype.itemsize
            # .copy(): frombuffer views are read-only; downstream transforms
            # (and CSRBatch row slicing) expect ordinary writable arrays
            out[m["n"]] = np.frombuffer(buf[off:off + nb], dtype).reshape(shape).copy()
            off += nb
        else:
            raise ProtocolError(f"unknown array encoding {m['enc']!r}")
    if off != len(buf):
        raise ProtocolError(f"batch payload has {len(buf) - off} trailing bytes")
    return out


def decode_batch(payload: bytes) -> tuple[Any, dict]:
    """Inverse of :func:`encode_batch` -> ``(batch, state_dict)``."""
    if len(payload) < 4:
        raise ProtocolError("truncated batch payload")
    (hlen,) = struct.unpack("!I", payload[:4])
    if 4 + hlen > len(payload):
        raise ProtocolError("batch header overruns the payload")
    header = loads(payload[4:4 + hlen])
    arrays = _unpack_arrays(header["arrays"], memoryview(payload)[4 + hlen:])
    kind, meta = header["kind"], header.get("meta", {})
    if kind == "csr":
        batch: Any = CSRBatch(
            data=arrays["data"], indices=arrays["indices"],
            indptr=arrays["indptr"], n_var=int(meta["n_var"]),
            obs={k: arrays[f"obs:{k}"] for k in meta["obs_keys"]},
        )
    elif kind == "dense":
        batch = arrays["x"]
    elif kind == "map":
        batch = {k: arrays[f"k:{k}"] for k in meta["keys"]}
    else:
        raise ProtocolError(f"unknown batch kind {kind!r}")
    return batch, header["state"]
