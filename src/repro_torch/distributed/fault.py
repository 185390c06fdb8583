"""Restart supervision and liveness: JAX-free copies of
``repro.distributed.fault.run_with_restarts`` and ``HeartbeatMonitor``.

:func:`run_with_restarts` catches a worker failure and runs the work again
with ``resume=True``; the training driver resumes from its latest
checkpoint, loader cursor included, so the restarted run continues the
uninterrupted one bitwise (``tests/test_torch_train.py``).  Unlike the
reference, which restarts on any ``BaseException``, it restarts on
``Exception`` only: an interrupt or a ``SystemExit`` ends the run.

:class:`LivenessMonitor` (the reference's ``HeartbeatMonitor``, renamed
because ``tools/analyze`` resolves classes by bare name) flags members whose
last beat is older than its timeout, on ``time.monotonic``; a
:class:`~repro_torch.core.prefetch.FetchPool` takes it as ``heartbeat=``.
The elastic re-mesh of the reference is not ported yet (ROADMAP.md queue A
#13).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Optional

__all__ = ["run_with_restarts", "LivenessMonitor"]


class LivenessMonitor:
    """Tracks the liveness of named members; flags those past their deadline."""

    def __init__(self, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self._last: dict[str, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def beat(self, member: str) -> None:
        with self._lock:
            self._last[member] = time.monotonic()

    def suspects(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [m for m, t in self._last.items() if now - t > self.timeout_s]

    def alive(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [m for m, t in self._last.items() if now - t <= self.timeout_s]


def run_with_restarts(
    work: Callable[[bool], Any],
    *,
    max_restarts: int = 3,
    backoff_s: float = 0.0,
    max_backoff_s: Optional[float] = None,
    jitter: float = 0.0,
    seed: int = 0,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    on_give_up: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run ``work(resume: bool)``; restart on failure up to ``max_restarts``.

    ``work`` must be checkpoint-resumable (the training driver is: state +
    loader cursor ride in the checkpoint).  Returns work's result.

    The backoff before restart ``k`` is ``min(backoff_s * 2**(k-1),
    max_backoff_s) * (1 + jitter * u_k)`` with ``u_k`` a seeded uniform draw
    in ``[0, 1)`` — exponential growth, capped (``max_backoff_s=None`` =
    uncapped), and desynchronized across supervisors restarting off one
    shared failure (jitter=0 keeps a deterministic schedule; the jittered
    schedule is deterministic in ``seed``).  ``on_give_up(restarts_used,
    last_exc)`` fires once when the budget is exhausted, before the final
    exception propagates — the hook for paging/cleanup.  ``sleep`` is
    injectable so tests assert the schedule without waiting it.
    """
    rng = random.Random(seed)
    attempt = 0
    while True:
        try:
            return work(attempt > 0)
        except Exception as e:  # supervisor boundary; an interrupt or exit propagates
            attempt += 1
            if attempt > max_restarts:
                if on_give_up:
                    on_give_up(attempt - 1, e)
                raise
            if on_restart:
                on_restart(attempt, e)
            if backoff_s:
                delay = backoff_s * (2.0 ** (attempt - 1))
                if max_backoff_s is not None:
                    delay = min(delay, max_backoff_s)
                if jitter:
                    delay *= 1.0 + jitter * rng.random()
                sleep(delay)
