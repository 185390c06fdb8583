"""DataClient: iterate a served stream as a local pipeline; the port of
``repro.serve.data.client``.

It stands in for the consumer side of
:class:`~repro_torch.pipeline.builder.DataPipeline`: ``iter()`` yields one
epoch's minibatches (the next ``iter()`` starts the following epoch),
``state()`` / ``load_state()`` checkpoint and resume batch-exactly,
``set_epoch()`` repositions and ``len()`` is this rank's batches per epoch.
With ``compression="none"`` (the default) every decoded batch is bitwise
what the server's pipeline produced.  It speaks the reference's wire
protocol, so it streams from either package's server.

``load_state`` only records the state: the fingerprint check runs on the
server when the next epoch is requested, so a drifted checkpoint is refused
even by a client that skipped the check.  The refusal surfaces as
``ValueError`` from ``iter``, as from ``DataPipeline.load_state``.  Every
socket operation has the client's timeout (``timeout_s``), so a stalled
server raises ``TimeoutError`` instead of hanging its caller.
"""
from __future__ import annotations

import dataclasses
import socket
from typing import Any, Iterator, Optional, Union

from ...core.dataset import LoaderState
from ...pipeline.spec import PipelineSpec

from .protocol import (
    F_ACK,
    F_BATCH,
    F_CLOSE,
    F_EPOCH_END,
    F_ERROR,
    F_ITER,
    F_OPEN,
    F_STATS,
    ProtocolError,
    ServeError,
    decode_batch,
    loads,
    recv_frame,
    send_json,
)

__all__ = ["DataClient"]


class DataClient:
    """A tenant of a :class:`~repro_torch.serve.data.BatchServer`.

    ``address`` is the server's ``(host, port)``; ``spec`` the
    :class:`PipelineSpec` (or its dict) describing the stream.  ``compression``
    requests a wire encoding (``None`` = server default; ``"qint8"`` is
    lossy on float arrays — never use it when bitwise parity matters).
    Connecting OPENs the tenant, which may WAIT for a streaming slot
    (server-side FIFO admission) up to the server's ``admit_timeout_s``.
    """

    def __init__(self, address: tuple, spec: Union[PipelineSpec, dict], *,
                 compression: Optional[str] = None, timeout_s: float = 60.0):
        self.spec = (
            spec if isinstance(spec, PipelineSpec) else PipelineSpec.from_dict(spec)
        )
        self.address = (address[0], int(address[1]))
        self.timeout_s = timeout_s
        self._requested_compression = compression
        self._sock: Optional[socket.socket] = None
        # True while BATCH frames for an abandoned epoch may still be in
        # flight — the next iteration must resync (reconnect) first
        self._dirty = False
        self.tenant_id: Optional[int] = None
        self.fingerprint: Optional[str] = None
        self.compression: Optional[str] = None
        self._n_batches = 0
        self._connect()
        self._state = LoaderState(
            seed=self.spec.seed, epoch=0, fetch_cursor=0, batch_cursor=0,
            fingerprint=self.fingerprint,
        )

    # ------------------------------------------------------------- plumbing
    def _connect(self) -> None:
        sock = socket.create_connection(self.address, timeout=self.timeout_s)
        try:
            send_json(sock, F_OPEN, {
                "spec": self.spec.to_dict(),
                "compression": self._requested_compression,
            })
            ftype, payload = recv_frame(sock)
            if ftype == F_ERROR:
                d = loads(payload)
                raise ServeError(d.get("error", "error"), d.get("detail", ""))
            if ftype != F_ACK:
                raise ProtocolError(f"expected F_ACK, got frame type {ftype}")
            ack = loads(payload)
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        self._dirty = False
        self.tenant_id = int(ack["tenant"])
        self.fingerprint = ack["fingerprint"]
        self.compression = ack["compression"]
        self._n_batches = int(ack["n_batches"])

    def _resync(self) -> None:
        """Reconnect after an abandoned mid-epoch stream: the old socket
        still carries BATCH frames for a position we no longer want, and a
        fresh OPEN is cheaper (and unambiguous) versus draining them."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._connect()

    def _raise_error(self, payload: bytes) -> None:
        d = loads(payload)
        code, detail = d.get("error", "error"), d.get("detail", "")
        if code == "fingerprint_mismatch":
            # mirror DataPipeline.load_state's exception type so remote and
            # local consumers handle refusal with the same except clause
            raise ValueError(detail)
        raise ServeError(code, detail)

    # -------------------------------------------------------------- iterate
    def __iter__(self) -> Iterator[Any]:
        """Yield the rest of the current epoch (from ``self._state``), then
        position on the next epoch — exactly ``DataPipeline.__iter__``'s
        contract, delivered over the wire."""
        if self._sock is None or self._dirty:
            self._resync()
        send_json(self._sock, F_ITER, {"state": self._state.to_dict()})
        self._dirty = True  # cleared by EPOCH_END; a break mid-epoch resyncs
        while True:
            ftype, payload = recv_frame(self._sock)
            if ftype == F_BATCH:
                batch, st = decode_batch(payload)
                self._state = LoaderState.from_dict(st)
                yield batch
            elif ftype == F_EPOCH_END:
                self._state = LoaderState.from_dict(loads(payload)["state"])
                self._dirty = False
                return
            elif ftype == F_ERROR:
                self._dirty = False  # server aborted the stream cleanly
                self._raise_error(payload)
            else:
                raise ProtocolError(f"unexpected frame type {ftype} mid-epoch")

    def epochs(self, num_epochs: int) -> Iterator[Any]:
        for _ in range(num_epochs):
            yield from iter(self)

    def __len__(self) -> int:
        """Minibatches this tenant's rank yields per epoch."""
        return self._n_batches

    # ---------------------------------------------------------------- state
    def state(self) -> LoaderState:
        """Resume point (fingerprint-stamped) — same position the local
        ``DataPipeline.state()`` would report after the same batches."""
        return dataclasses.replace(self._state)

    def load_state(self, state: Union[LoaderState, dict]) -> None:
        """Record a resume point.  No local validation on purpose: the
        server refuses a mismatched fingerprint when the stream is next
        requested (``ValueError``, same as the local pipeline)."""
        if isinstance(state, dict):
            state = LoaderState.from_dict(state)
        self._state = dataclasses.replace(state)
        self._dirty = self._dirty and self._sock is not None

    def set_epoch(self, epoch: int) -> None:
        self._state = LoaderState(
            self.spec.seed, int(epoch), 0, 0, self.fingerprint
        )

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The server's :class:`ServeStats` snapshot, as a dict."""
        if self._sock is None or self._dirty:
            self._resync()
        send_json(self._sock, F_STATS, {})
        ftype, payload = recv_frame(self._sock)
        if ftype == F_ERROR:
            self._raise_error(payload)
        if ftype != F_STATS:
            raise ProtocolError(f"expected F_STATS reply, got type {ftype}")
        return loads(payload)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if self._sock is None:
            return
        try:
            send_json(self._sock, F_CLOSE, {})
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None

    def __enter__(self) -> "DataClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
