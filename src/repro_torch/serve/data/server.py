"""The multi-tenant batch server: one shared I/O plane; the port of
``repro.serve.data.server``.

Tenants submit a :class:`~repro_torch.pipeline.spec.PipelineSpec` over a
local socket (:mod:`.protocol`) and stream their minibatches back, all
through one planned collection per dataset: one block cache, one rendezvous
table, one :class:`~repro_torch.data.iostats.IOCounters` base.  Tenants
reading the same data share each other's reads: a block one tenant read is
a cache hit, or a join of the read in flight, for every other.  The server
is :class:`BatchServer`, not the reference's ``DataServeServer``:
``tools/analyze`` resolves classes by bare name across ``src/``, and the
reference's class holds a lock.

Isolation, all set on :class:`ServeConfig`:

- **admission** — at most ``max_tenants`` streaming slots, handed over in
  FIFO order, the tenant's pipeline built outside the lock; a tenant that
  waits longer than ``admit_timeout_s`` gets ``F_ERROR admission_timeout``;
- **backpressure** — a tenant's producer runs at most ``queue_depth``
  encoded batches ahead of its socket, so a slow consumer holds back only
  itself;
- **quota** — ``quota_bytes`` caps a tenant's payload bytes over its
  connection; the batch that would pass it becomes ``F_ERROR
  quota_exhausted``, never a silent truncation;
- **attribution** — each tenant's producer iterates under
  ``IOCounters.scoped(child)``, so its reads land in a child of its own,
  while the collection's own threads (io workers, readahead) record on the
  shared base; the stats' aggregate is base + departed tenants + live
  children, merged.

Resume is checked here: an ``F_ITER`` state whose fingerprint does not match
the tenant's spec is refused (``F_ERROR fingerprint_mismatch``), whatever
the client checked.  Stats answer both an ``F_STATS`` frame and a plain
HTTP/1.0 ``GET /stats``, told apart by the connection's first bytes.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import socket
import threading
import time
from collections import deque
from typing import Any, Optional

from ...core.dataset import LoaderState, ScIterableDataset
from ...data.backend import open_collection
from ...data.iostats import IOCounters
from ...distributed.elastic.pool import SharedCollections, pool_key
from ...pipeline.builder import DataPipeline
from ...pipeline.spec import PipelineSpec, strategy_from_spec

from .protocol import (
    COMPRESSIONS,
    F_ACK,
    F_BATCH,
    F_CLOSE,
    F_EPOCH_END,
    F_ERROR,
    F_ITER,
    F_OPEN,
    F_STATS,
    ProtocolError,
    encode_batch,
    loads,
    recv_exact,
    recv_frame,
    send_frame,
    send_json,
)

__all__ = ["ServeConfig", "ServeStats", "BatchServer"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Declarative server configuration — every knob, one place.

    The server owns the COLLECTION-side knobs (cache size/policy, cache
    admission, io workers): tenants share one I/O plane, so a tenant
    spec's collection-side fields are content-free overrides the server
    ignores by design (the stream they describe is identical — that is
    what content-free means).
    """

    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral; read the bound port off ``address``
    max_tenants: int = 4
    queue_depth: int = 2
    quota_bytes: int = 0  # per-tenant lifetime payload cap; 0 = unlimited
    compression: str = "none"  # default wire encoding; OPEN may override
    cache_bytes: int = 64 << 20  # the SHARED block-cache budget
    cache_policy: str = "lru"  # lru | wtinylfu (scan-resistant segmented)
    admission: str = "always"  # block-cache admission: always | auto | never
    block_rows: Optional[int] = None  # shared-cache granularity (None = default)
    # > 1 by default: async planned execution turns on the rendezvous
    # table, and concurrent tenants duplicating each other's in-flight
    # reads is exactly the serving-plane failure mode it exists for
    io_workers: int = 2
    admit_timeout_s: float = 30.0  # max FIFO wait for a streaming slot

    def __post_init__(self):
        if self.max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.quota_bytes < 0:
            raise ValueError("quota_bytes must be >= 0 (0 = unlimited)")
        if self.compression not in COMPRESSIONS:
            raise ValueError(
                f"compression must be one of {COMPRESSIONS}, got "
                f"{self.compression!r}"
            )
        if self.cache_policy not in ("lru", "wtinylfu"):
            raise ValueError("cache_policy must be 'lru' or 'wtinylfu'")
        if self.admission not in ("always", "auto", "never"):
            raise ValueError("admission must be 'always', 'auto' or 'never'")
        if self.io_workers < 1:
            raise ValueError("io_workers must be >= 1")
        if self.admit_timeout_s <= 0:
            raise ValueError("admit_timeout_s must be positive")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ServeConfig":
        known = {f.name for f in dataclasses.fields(ServeConfig)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServeConfig field(s): {sorted(unknown)}")
        return ServeConfig(**d)


@dataclasses.dataclass
class ServeStats:
    """One consistent snapshot of the serving plane (the ``/stats`` body).

    ``aggregate`` is the merged IOCounters across everything the process did
    (shared base + departed tenants + live tenant children); ``shared`` is
    the base alone (collection-internal threads no tenant can claim);
    ``tenants`` carries one dict per live tenant including its child
    IOCounters snapshot; ``collections`` one dict per pooled collection with
    its cache snapshot — the cross-tenant dedup evidence (requests /
    hit rate) lives there.
    """

    tenants: list[dict]
    aggregate: dict
    shared: dict
    admission: dict
    collections: list[dict]
    config: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Tenant:
    """Per-connection serving state; mutated only by its own threads."""

    def __init__(self, tid: int, spec: PipelineSpec, pipe: DataPipeline,
                 stats: IOCounters, compression: str, pool_key: str):
        self.id = tid
        self.spec = spec
        self.pipe = pipe
        self.stats = stats  # the IOCounters child producer records scope into
        self.compression = compression
        self.pool_key = pool_key
        self.fingerprint = spec.fingerprint()
        self.stop = threading.Event()
        # counters below are written by the connection thread only and read
        # racily for telemetry (monotonic ints — a stale read is fine)
        self.batches_sent = 0  # guarded-by: external — connection thread
        self.bytes_sent = 0  # guarded-by: external — connection thread
        self.epochs_served = 0  # guarded-by: external — connection thread
        self.errors_sent = 0  # guarded-by: external — connection thread

    def snapshot(self, quota_bytes: int) -> dict:
        return {
            "id": self.id,
            "fingerprint": self.fingerprint,
            "compression": self.compression,
            "collection": self.pool_key,
            "batches_sent": self.batches_sent,
            "bytes_sent": self.bytes_sent,
            "epochs_served": self.epochs_served,
            "errors_sent": self.errors_sent,
            "quota_bytes_left": (
                max(0, quota_bytes - self.bytes_sent) if quota_bytes else None
            ),
            "iostats": self.stats.snapshot(),
        }


def _pool_key(spec: PipelineSpec) -> str:
    """Collection identity: the data, not the tenant's sampling of it."""
    return pool_key(spec.uri, spec.open_opts)


def _put_until(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Bounded put that yields to ``stop`` — a producer must never deadlock
    on a full queue whose consumer has left."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class BatchServer:
    """Accepts PipelineSpec tenants on a local socket; streams their batches.

    Lock discipline: ``_lock`` is a LEAF — nothing that can take another
    lock (collection open, cache access, IOCounters merge, socket I/O) runs
    while holding it.  Admission handoff uses per-waiter Events, so no
    Condition ever nests under it.
    """

    def __init__(self, config: Optional[ServeConfig] = None, *,
                 iostats: Optional[IOCounters] = None):
        self.config = config or ServeConfig()
        #: the shared IOCounters base every pooled collection records into
        self.iostats = iostats if iostats is not None else IOCounters()
        self._lock = threading.Lock()
        self._tenants: dict[int, _Tenant] = {}  # guarded-by: _lock
        # streaming slots: tenant id or None (a slot array, as
        # SlotBatcher keeps for requests, here per tenant)
        self._slots: list = [None] * self.config.max_tenants  # guarded-by: _lock
        # FIFO of (event, box) waiters; the releasing thread writes
        # box["slot"] BEFORE set(), so a woken waiter owns its slot
        self._waiting: deque = deque()  # guarded-by: _lock
        # the shared collections (repro_torch.distributed.elastic.pool), with
        # their own leaf lock; _lock never extends over a pool operation
        self._pool = SharedCollections()
        self._conns: set = set()  # guarded-by: _lock — open sockets, for stop()
        self._conn_threads: list = []  # guarded-by: _lock
        self._next_tenant_id = 0  # guarded-by: _lock
        self._admitted_total = 0  # guarded-by: _lock
        self._admit_timeouts = 0  # guarded-by: _lock
        self._peak_active = 0  # guarded-by: _lock
        # IOCounters of DEPARTED tenants, folded in on disconnect so the
        # aggregate never loses history; IOCounters is internally locked
        self._drained = self.iostats.child()
        self._stopping = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self) -> tuple:
        """``(host, port)`` actually bound — read the ephemeral port here."""
        if self._listener is None:
            raise RuntimeError("server not started")
        return self._listener.getsockname()[:2]

    def start(self) -> "BatchServer":
        if self._listener is not None:
            raise RuntimeError("server already started")
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind((self.config.host, self.config.port))
        lst.listen(64)
        self._listener = lst
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="scds-serve-accept"
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting, break live connections, release collections."""
        self._stopping.set()
        if self._listener is not None:
            # shutdown() wakes the accept loop at once; close() alone leaves
            # it parked in accept() until the join below times out
            for end in (lambda: self._listener.shutdown(socket.SHUT_RDWR), self._listener.close):
                try:
                    end()
                except OSError:
                    pass
        with self._lock:
            tenants = list(self._tenants.values())
            conns = list(self._conns)
            threads = list(self._conn_threads)
        for t in tenants:
            t.stop.set()
        for c in conns:  # unblocks threads parked in recv()
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        for th in threads:
            th.join(timeout=5.0)
        self._pool.close_all()

    def __enter__(self) -> "BatchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ admission
    def _admit_slot(self, tid: int) -> Optional[int]:
        """Block until this tenant owns a streaming slot (FIFO), or None on
        timeout/shutdown: decide under the lock; wait — and build —
        strictly outside it."""
        with self._lock:
            if not self._waiting:  # nobody queued ahead: try direct claim
                for i, occupant in enumerate(self._slots):
                    if occupant is None:
                        self._slots[i] = tid
                        self._admitted_total += 1
                        active = sum(s is not None for s in self._slots)
                        self._peak_active = max(self._peak_active, active)
                        return i
            ev = threading.Event()
            box: dict = {"slot": None, "tid": tid}
            self._waiting.append((ev, box))
        deadline = time.monotonic() + self.config.admit_timeout_s
        while not self._stopping.is_set() and time.monotonic() < deadline:
            if ev.wait(timeout=0.05):
                return box["slot"]
        # timed out / shutting down: withdraw — unless the handoff already
        # happened, in which case the slot is ours after all
        with self._lock:
            if box["slot"] is not None:
                return box["slot"]
            try:
                self._waiting.remove((ev, box))
            except ValueError:
                pass
            self._admit_timeouts += 1
        return None

    def _release_slot(self, slot: int) -> None:
        """Free a slot; hand it straight to the FIFO head, if any."""
        with self._lock:
            self._slots[slot] = None
            if self._waiting:
                ev, box = self._waiting.popleft()
                self._slots[slot] = box["tid"]
                box["slot"] = slot
                self._admitted_total += 1
                active = sum(s is not None for s in self._slots)
                self._peak_active = max(self._peak_active, active)
                ev.set()

    # ------------------------------------------------------- collection pool
    def _acquire_collection(self, spec: PipelineSpec) -> tuple:
        """The SHARED collection for this spec's data identity, opened once
        with the server's collection-side knobs and the shared IOCounters
        base.  Returns ``(pool_key, collection)``."""
        key = _pool_key(spec)
        cfg = self.config

        def opener():
            knobs: dict = {}
            if cfg.block_rows is not None:
                knobs["block_rows"] = cfg.block_rows
            return open_collection(
                spec.uri,
                iostats=self.iostats,
                cache_bytes=cfg.cache_bytes,
                cache_policy=cfg.cache_policy,
                admission=cfg.admission,
                io_workers=cfg.io_workers,
                **knobs,
                **spec.open_opts,
            )

        return key, self._pool.acquire(key, opener)

    def _release_collection(self, key: str) -> None:
        # refcount only — the collection stays open (cache warm) for the
        # next tenant of the same data; stop() closes everything
        self._pool.release(key)

    # ---------------------------------------------------------------- stats
    def stats(self) -> ServeStats:
        with self._lock:
            tenants = list(self._tenants.values())
            admission = {
                "max_tenants": self.config.max_tenants,
                "active": sum(s is not None for s in self._slots),
                "waiting": len(self._waiting),
                "admitted_total": self._admitted_total,
                "admit_timeouts": self._admit_timeouts,
                "peak_active": self._peak_active,
            }
        # merges/cache snapshots/pool reads take other locks — strictly
        # outside _lock
        entries = self._pool.entries()
        agg = self.iostats.child()
        agg.merge(self.iostats)
        agg.merge(self._drained)
        for t in tenants:
            agg.merge(t.stats)
        collections = []
        for key, col, refs in entries:
            d: dict = {"key": key, "refs": refs}
            cache = getattr(col, "cache", None)
            if cache is not None and hasattr(cache, "snapshot"):
                d["cache"] = cache.snapshot()
            collections.append(d)
        return ServeStats(
            tenants=[t.snapshot(self.config.quota_bytes) for t in tenants],
            aggregate=agg.snapshot(),
            shared=self.iostats.snapshot(),
            admission=admission,
            collections=collections,
            config=self.config.to_dict(),
        )

    # ------------------------------------------------------------ accepting
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            th = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="scds-serve-conn",
            )
            with self._lock:
                self._conns.add(conn)
                self._conn_threads.append(th)
            th.start()

    # ----------------------------------------------------------- connection
    def _serve_conn(self, conn: socket.socket) -> None:
        tenant: Optional[_Tenant] = None
        slot: Optional[int] = None
        pool_key: Optional[str] = None
        try:
            first = recv_exact(conn, 4)
            if first == b"GET ":
                self._serve_http_stats(conn)
                return
            ftype, payload = recv_frame(conn, first=first)
            # stats-only connections need no OPEN and no slot
            while ftype == F_STATS:
                send_json(conn, F_STATS, self.stats().to_dict())
                ftype, payload = recv_frame(conn)
            if ftype == F_CLOSE:
                return
            if ftype != F_OPEN:
                send_json(conn, F_ERROR, {
                    "error": "protocol",
                    "detail": f"expected F_OPEN, got frame type {ftype}",
                })
                return
            tenant, slot, pool_key = self._open_tenant(conn, loads(payload))
            if tenant is not None:
                self._tenant_loop(conn, tenant)
        except (ConnectionError, OSError, ProtocolError):
            pass  # peer vanished or spoke garbage; cleanup below
        finally:
            if tenant is not None:
                tenant.stop.set()
                self._drained.merge(tenant.stats)
                with self._lock:
                    self._tenants.pop(tenant.id, None)
            if slot is not None:
                self._release_slot(slot)
            if pool_key is not None:
                self._release_collection(pool_key)
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _open_tenant(self, conn: socket.socket, open_msg: dict) -> tuple:
        """Validate the spec, admit a slot, build the tenant pipeline
        against the shared collection, ACK.  Returns
        ``(tenant | None, slot | None, pool_key | None)`` — all None after
        an F_ERROR was sent."""
        try:
            spec = PipelineSpec.from_dict(open_msg.get("spec") or {})
            if spec.uri is None:
                raise ValueError("serve tenants need a URI-backed spec")
        except (ValueError, TypeError) as e:
            send_json(conn, F_ERROR, {"error": "bad_spec", "detail": str(e)})
            return None, None, None
        compression = open_msg.get("compression") or self.config.compression
        if compression not in COMPRESSIONS:
            send_json(conn, F_ERROR, {
                "error": "bad_spec",
                "detail": f"unknown compression {compression!r}",
            })
            return None, None, None

        with self._lock:
            tid = self._next_tenant_id
            self._next_tenant_id += 1

        slot = self._admit_slot(tid)
        if slot is None:
            send_json(conn, F_ERROR, {
                "error": "admission_timeout",
                "detail": (
                    f"no streaming slot within {self.config.admit_timeout_s}s "
                    f"(max_tenants={self.config.max_tenants})"
                ),
            })
            return None, None, None

        pool_key = None
        try:
            pool_key, col = self._acquire_collection(spec)
            strat = strategy_from_spec(spec.strategy, spec.strategy_params, col)
            ds = ScIterableDataset(
                col, strat,
                batch_size=spec.batch_size, fetch_factor=spec.fetch_factor,
                seed=spec.seed, rank=spec.rank, world_size=spec.world_size,
                drop_last=spec.drop_last,
                sort_fetch_indices=spec.sort_fetch_indices,
                cross_epoch_prefetch=spec.cross_epoch_prefetch,
                diversity_obs=spec.diversity_obs,
            )
            ds.spec_fingerprint = spec.fingerprint()
            pipe = DataPipeline(spec, col, ds, owns_collection=False)
            n_batches = len(pipe)
        except Exception as e:  # noqa: BLE001 - anything here is the spec's fault
            send_json(conn, F_ERROR, {"error": "bad_spec", "detail": str(e)})
            self._release_slot(slot)
            if pool_key is not None:
                self._release_collection(pool_key)
            return None, None, None

        tenant = _Tenant(tid, spec, pipe, self.iostats.child(), compression,
                         pool_key)
        with self._lock:
            self._tenants[tid] = tenant
        send_json(conn, F_ACK, {
            "tenant": tid,
            "fingerprint": tenant.fingerprint,
            "compression": compression,
            "n_batches": n_batches,
        })
        return tenant, slot, pool_key

    # ------------------------------------------------------------ streaming
    def _tenant_loop(self, conn: socket.socket, tenant: _Tenant) -> None:
        while not self._stopping.is_set():
            ftype, payload = recv_frame(conn)
            if ftype == F_CLOSE:
                return
            if ftype == F_STATS:
                send_json(conn, F_STATS, self.stats().to_dict())
                continue
            if ftype != F_ITER:
                send_json(conn, F_ERROR, {
                    "error": "protocol",
                    "detail": f"unexpected frame type {ftype} on a tenant "
                              "connection",
                })
                tenant.errors_sent += 1
                continue
            msg = loads(payload)
            if msg.get("state") is not None:
                try:
                    st = LoaderState.from_dict(msg["state"])
                except (KeyError, TypeError, ValueError) as e:
                    send_json(conn, F_ERROR,
                              {"error": "bad_state", "detail": str(e)})
                    tenant.errors_sent += 1
                    continue
                try:
                    # SERVER-side refusal: the pipeline's fingerprint check
                    # runs here, against the tenant's registered spec
                    tenant.pipe.load_state(st)
                except ValueError as e:
                    code = ("fingerprint_mismatch"
                            if "fingerprint" in str(e) else "bad_state")
                    send_json(conn, F_ERROR, {"error": code, "detail": str(e)})
                    tenant.errors_sent += 1
                    continue
            if not self._stream_epoch(conn, tenant):
                return

    def _stream_epoch(self, conn: socket.socket, tenant: _Tenant) -> bool:
        """Producer/consumer for one epoch.  The producer thread iterates
        the tenant pipeline under the tenant's IOCounters scope and encodes
        batches into a BOUNDED queue (``queue_depth`` — the per-tenant
        backpressure window); this thread drains it onto the socket,
        enforcing the byte quota.  Returns False when the connection is
        done for (quota breach / stream failure)."""
        q: queue.Queue = queue.Queue(maxsize=self.config.queue_depth)
        pipe, comp, stop = tenant.pipe, tenant.compression, tenant.stop

        def produce() -> None:
            try:
                with self.iostats.scoped(tenant.stats):
                    for batch in iter(pipe):
                        st = pipe.state()
                        item = ("batch", encode_batch(batch, st.to_dict(), comp))
                        if not _put_until(q, item, stop):
                            return
                    _put_until(q, ("end", pipe.state().to_dict()), stop)
            except Exception as e:  # noqa: BLE001 - shipped to the consumer
                _put_until(q, ("error", f"{type(e).__name__}: {e}"), stop)

        producer = threading.Thread(
            target=produce, daemon=True, name=f"scds-serve-t{tenant.id}"
        )
        producer.start()
        quota = self.config.quota_bytes
        try:
            while True:
                try:
                    kind, item = q.get(timeout=0.2)
                except queue.Empty:
                    if stop.is_set() or self._stopping.is_set():
                        return False
                    continue
                if kind == "batch":
                    if quota and tenant.bytes_sent + len(item) > quota:
                        send_json(conn, F_ERROR, {
                            "error": "quota_exhausted",
                            "detail": (
                                f"tenant {tenant.id} would exceed its "
                                f"{quota}-byte payload quota "
                                f"({tenant.bytes_sent} B already sent)"
                            ),
                        })
                        tenant.errors_sent += 1
                        return False
                    send_frame(conn, F_BATCH, item)
                    tenant.batches_sent += 1
                    tenant.bytes_sent += len(item)
                elif kind == "end":
                    send_json(conn, F_EPOCH_END, {"state": item})
                    tenant.epochs_served += 1
                    return True
                else:  # "error"
                    send_json(conn, F_ERROR,
                              {"error": "internal", "detail": item})
                    tenant.errors_sent += 1
                    return False
        finally:
            # whatever path got us here, never leave the producer parked on
            # a full queue: stop it and drain until it exits
            producer.join(timeout=0.2)
            if producer.is_alive():
                stop.set()
                while producer.is_alive():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        producer.join(timeout=0.05)

    # --------------------------------------------------------- HTTP /stats
    def _serve_http_stats(self, conn: socket.socket) -> None:
        """Plain-HTTP fallback: ``curl http://host:port/stats``.  The first
        4 bytes (``GET ``) were already consumed by the protocol sniff."""
        buf = b""
        while b"\r\n\r\n" not in buf and len(buf) < 8192:
            chunk = conn.recv(1024)
            if not chunk:
                break
            buf += chunk
        path = buf.split(b" ", 1)[0].decode("latin-1") if buf else ""
        if path.startswith("/stats") or path == "":
            body = json.dumps(self.stats().to_dict()).encode()
            status = b"200 OK"
        else:
            body = b'{"error": "not found; try GET /stats"}'
            status = b"404 Not Found"
        conn.sendall(
            b"HTTP/1.0 " + status + b"\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body
        )
