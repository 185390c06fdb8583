"""Continuous batching for decoder-only serving (slot-level admission): the
port of ``repro.serve.scheduler``.

A batched KV cache of B slots decodes in lockstep at a shared absolute
position; requests join mid-stream whenever a slot frees, without stalling
the running batch.

Alignment: a request with prompt length P that joins at shared position
``pos`` is prefilled at absolute offset ``pos - P`` (its prompt occupies
the P positions behind the cursor):

- RoPE sees positions [pos-P, pos): relative distances inside the request
  are exact;
- the prompt's KV lands in ring slots [(pos-P) % W ..], where decode
  expects them;
- a per-slot ``start`` mask stops the request from attending the previous
  occupant's stale cache entries;
- SSM caches (falcon-mamba, jamba's Mamba layers) hold no positions: the
  request's convolution window and scan state overwrite the slot's
  wholesale at admission, and ``pos_offset`` and ``start`` do not apply
  to them; a hybrid cache (jamba) holds both kinds, each handled so.

Decoder-only text families only, as in the reference: the encdec family
(whisper) is refused at construction with the reference's
``ValueError``, and a vlm request (internvl2) fails at its first prefill
with the reference's ``KeyError('patch_embeds')``: a request holds only
its prompt tokens, and the reference's batcher has no image prefix
either.

The moe family (mixtral, phi3.5-moe) batches as the dense one: a decode
step routes each slot's token in a dispatch group of its own (G = B, one
token a group), so a slot's experts and gates do not depend on the other
slots, and a batched step computes what B standalone steps would.

Every request's greedy continuation equals the standalone batch-1 serve
of the same prompt (``tests/test_torch_serve.py``).  The batcher is named
``SlotBatcher``, not ``ContinuousBatcher``: the repo's lock analyzer
resolves classes by bare name across ``src/``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..models import Model

__all__ = ["Request", "SlotBatcher"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _write_slot(batched: dict, single: dict, slot: int) -> None:
    """Copy a batch-1 cache into slot ``slot`` of the batched cache, in
    place.  Every cache tensor, KV or SSM, has the batch axis at position
    1, after the layer axis."""
    for sub, bufs in single.items():
        for name, t in bufs.items():
            batched[sub][name][:, slot] = t[:, 0]


class SlotBatcher:
    """Fixed B slots; admit-on-free; shared decode cursor."""

    def __init__(self, model: Model, params, *, batch_slots: int, max_len: int,
                 eos_id: Optional[int] = None):
        if model.cfg.family == "encdec":
            raise ValueError("continuous batching supports decoder-only families")
        self.model = model
        self.params = params
        self.device = params.embed.device
        self.B = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = model.init_cache(batch_slots, max_len, device=self.device)
        # slots/cursor/completed belong to the one thread running
        # step()/run(); only the submission queue takes concurrent producers
        self.slots: list[Optional[Request]] = [None] * batch_slots  # guarded-by: external
        self.start = np.zeros(batch_slots, np.int64)
        self.tokens = np.zeros(batch_slots, np.int64)
        self._lock = threading.Lock()
        self.queue: deque[Request] = deque()  # guarded-by: _lock
        self.pos = 0  # guarded-by: external — shared absolute decode cursor
        self.completed: list[Request] = []  # guarded-by: external

    # ------------------------------------------------------------------ api
    def submit(self, prompt: np.ndarray, max_new: int, rid: Optional[int] = None):
        """Enqueue a request; safe from any thread.  Auto-assigned rids are
        derived under the lock so concurrent submitters never collide."""
        prompt = np.asarray(prompt, np.int32)
        with self._lock:
            if rid is None:
                rid = len(self.completed) + len(self.queue)
            self.queue.append(Request(rid, prompt, max_new))

    def _admit(self) -> None:
        for slot in range(self.B):
            if self.slots[slot] is not None:
                continue
            # peek/decide/pop under the lock; the expensive prefill below
            # runs outside it so submitters are never blocked on it
            with self._lock:
                if not self.queue:
                    continue
                req = self.queue[0]
                P = len(req.prompt)
                if self.pos < P:
                    # The prompt must fit behind the shared cursor.  Moving
                    # the cursor would tear KV gaps into active slots, so:
                    if any(s is not None for s in self.slots):
                        break  # wait; cursor advances per step (FIFO kept)
                    self.pos = P  # batch idle: jump the cursor freely
                self.queue.popleft()
            offset = self.pos - P
            cache1 = self.model.init_cache(1, self.max_len, device=self.device)
            tokens = torch.from_numpy(req.prompt[None].astype(np.int64)).to(self.device)
            logits, cache1 = self.model.prefill(self.params, {"tokens": tokens}, cache1,
                                                pos_offset=offset)
            _write_slot(self.cache, cache1, slot)
            tok = int(logits[0].argmax())
            req.out.append(tok)
            self.slots[slot] = req
            self.start[slot] = offset
            self.tokens[slot] = tok

    def step(self) -> None:
        """One shared decode step across all occupied slots."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return
        logits, self.cache = self.model.decode(
            self.params,
            torch.from_numpy(self.tokens).to(self.device),
            self.cache,
            self.pos,
            torch.from_numpy(self.start).to(self.device),
        )
        next_tok = logits.argmax(dim=-1).cpu().numpy()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(next_tok[slot])
            req.out.append(tok)
            self.tokens[slot] = tok
            finished = (
                len(req.out) >= req.max_new
                or (self.eos_id is not None and tok == self.eos_id)
                or self.pos + 1 >= self.max_len - 1
            )
            if finished:
                req.done = True
                self.completed.append(req)
                self.slots[slot] = None
        self.pos += 1

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) and steps < max_steps:  # unlocked-ok: emptiness probe; a late submit is caught next loop
            self.step()
            steps += 1
        return sorted(self.completed, key=lambda r: r.rid)
