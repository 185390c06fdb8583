"""Host batches -> device tensors: the port's counterpart of
``repro.distributed.dataio.device_prefetch``."""
from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import torch

from ..data.csr_store import CSRBatch

__all__ = ["device_prefetch"]

DEPTH = 2  # batches collated and in flight ahead of the consumer


def device_prefetch(batches: Iterable[CSRBatch], device="cuda") -> Iterator[dict]:
    """A two-deep host->device feed of collated CSR batches.

    Each batch is collated (:meth:`CSRBatch.to_tensors`: ELL ``vals`` and
    ``cols`` and the obs columns) into pinned memory and copied with
    ``non_blocking=True`` on a side stream; an event recorded after the
    copies is what the consumer's stream waits on before it may use them.
    While the consumer runs step t on the card, batches t+1 and t+2 are
    collated and in flight (``DEPTH``), so disk -> host RAM -> device
    overlaps the step.
    Yields ``{"vals", "cols", "obs": {column: tensor}}`` on ``device``; on
    the CPU the collated tensors as they are.
    """
    device = torch.device(device)
    it = iter(batches)
    if device.type != "cuda":
        for batch in it:
            yield batch.to_tensors()
        return
    copy_stream = torch.cuda.Stream(device)

    def stage(batch: CSRBatch):
        host = batch.to_tensors(pin_memory=True)
        with torch.cuda.stream(copy_stream):
            dev = {
                "vals": host["vals"].to(device, non_blocking=True),
                "cols": host["cols"].to(device, non_blocking=True),
                "obs": {k: t.to(device, non_blocking=True) for k, t in host["obs"].items()},
            }
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return dev, ready

    pending = collections.deque(stage(b) for b in itertools.islice(it, DEPTH))
    while pending:
        dev, ready = pending.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        # allocated on the copy stream, used on the consumer's: tell the
        # caching allocator, or it may hand the memory out again too early
        for t in (dev["vals"], dev["cols"], *dev["obs"].values()):
            t.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            pending.append(stage(nxt))
        yield dev
