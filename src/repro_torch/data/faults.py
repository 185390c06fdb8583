"""``fault://`` — deterministic fault injection, and the resilience
primitives the planner executes against it: the port of
``repro.data.faults``.

- :class:`FaultProfile` — a frozen, seeded fault regime: a per-attempt
  transient error rate, per-shard blackout windows (op-count ranges during
  which every read of the shard fails), latency spikes and a stuck read.
  Every decision is a pure function of ``(seed, lo, hi, attempt)`` through
  :func:`mix_u01`, so the port's decisions are the reference's, bit for
  bit, and two runs under one profile inject the same faults.
- :class:`FaultInjectingReader` — wraps any inner reader (the reference's
  ``FaultInjectingAdapter``) and composes under any URI:
  ``fault://cloud://sharded-h5ad:///data?error_rate=0.05&seed=3``.  A fault
  is raised before the inner read, so a failed attempt records nothing.
- :func:`is_transient`, :class:`RetryPolicy` (bounded retries, exponential
  backoff with decorrelated jitter, an optional per-read deadline),
  :class:`ShardCircuit` (the reference's ``ShardBreaker``: a per-shard
  circuit breaker with half-open probes and an injectable clock) and the
  terminal :class:`RetryBudgetExhausted`.

The two classes that lock are named apart from their counterparts because
``tools/analyze`` resolves classes by bare name across ``src/``.  This
module imports :mod:`repro_torch.data.backend` for the reader base and the
registry; the planner imports the primitives back inside its functions.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np

from .backend import StorageReader, open_adapter, register_backend
from .iostats import IOCounters

__all__ = [
    "TransientStorageError",
    "RetryBudgetExhausted",
    "is_transient",
    "mix_u01",
    "FaultProfile",
    "FaultInjectingReader",
    "RetryPolicy",
    "ShardCircuit",
]


class TransientStorageError(OSError):
    """An injected (or real) failure that a retry may outlive."""


class RetryBudgetExhausted(RuntimeError):
    """Terminal: retries/deadline spent and the read still fails.

    Deliberately NOT an ``OSError`` — :func:`is_transient` classifies it as
    permanent, so a waiter that re-issues a failed block and fails again
    does not retry forever.  ``__cause__`` carries the last storage error.
    """


def is_transient(exc: BaseException) -> bool:
    """Whether a read failure is worth retrying.

    OS-level errors (I/O errors, timeouts, connection resets — and the
    injected :class:`TransientStorageError`) are transient; everything else
    (index errors, corrupt-format ValueErrors, an exhausted retry budget)
    is permanent and must surface immediately.
    """
    return isinstance(exc, (OSError, TimeoutError))


_MASK64 = (1 << 64) - 1


def mix_u01(*ints: int) -> float:
    """Deterministic hash of integers -> uniform float in ``[0, 1)``.

    SplitMix64-style avalanche over the argument sequence; no process
    randomness, so fault decisions, jitter and tail draws replay exactly
    across runs, threads and platforms.
    """
    h = 0x9E3779B97F4A7C15
    for v in ints:
        h = (h ^ (int(v) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
    h ^= h >> 29
    return (h >> 11) / float(1 << 53)


# --------------------------------------------------------------------------
# fault profile
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Seeded, deterministic description of one storage fault regime.

    Every decision is a pure function of ``(seed, lo, hi, attempt)`` — the
    attempt index increments per physical read of the same range, so a
    retried (or hedged) read deterministically draws a FRESH fault decision
    while the run as a whole stays reproducible.

    ``blackouts`` are per-shard op-count windows ``(shard, first_op,
    last_op)``: reads number ``last_op - first_op`` ops of that shard
    (retries included) fail with :class:`TransientStorageError` — a bounded
    degraded-shard episode that retries/backoff can outlive.
    ``stuck_row`` targets a hang: any read covering that row sleeps
    ``stuck_s`` (first attempt only unless ``stuck_on_retries``), modeling
    a wedged request that a duplicate read sails past.
    """

    seed: int = 0
    error_rate: float = 0.0  # P(transient failure) per read attempt
    spike_rate: float = 0.0  # P(latency spike) per read attempt
    spike_s: float = 0.05  # spike duration scale (drawn in [0.5, 1.0] x this)
    spike_on_retries: bool = True  # False: only attempt 0 spikes
    blackouts: tuple = ()  # (shard, first_op, last_op) op-count windows
    stuck_row: int = -1  # reads covering this row hang; -1 = off
    stuck_s: float = 0.0
    stuck_on_retries: bool = False
    scale: float = 1.0  # multiplier on injected sleep durations

    def __post_init__(self):
        # rates are probabilities: a rate of 2.0 is a typo (0.2? 2%?) —
        # silently behaving as "always fail" would mask the misconfiguration
        for name in ("error_rate", "spike_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v!r}")
        for name in ("spike_s", "stuck_s", "scale"):
            v = getattr(self, name)
            if v < 0.0:
                raise ValueError(f"{name} must be >= 0, got {v!r}")
        for b in self.blackouts:
            shard, first, last = b
            if shard < 0 or first < 0 or last < first:
                raise ValueError(f"malformed blackout window {b!r}")

    def transient(self, lo: int, hi: int, attempt: int) -> bool:
        if self.error_rate <= 0.0:
            return False
        return mix_u01(self.seed, 1, lo, hi, attempt) < self.error_rate

    def spike(self, lo: int, hi: int, attempt: int) -> float:
        """Injected extra latency (seconds) for this attempt, 0 if none."""
        if self.spike_rate <= 0.0 or (attempt > 0 and not self.spike_on_retries):
            return 0.0
        if mix_u01(self.seed, 2, lo, hi, attempt) >= self.spike_rate:
            return 0.0
        draw = 0.5 + 0.5 * mix_u01(self.seed, 3, lo, hi, attempt)
        return self.spike_s * draw * self.scale

    def stuck(self, lo: int, hi: int, attempt: int) -> float:
        if self.stuck_row < 0 or not (lo <= self.stuck_row < hi):
            return 0.0
        if attempt > 0 and not self.stuck_on_retries:
            return 0.0
        return self.stuck_s * self.scale


# --------------------------------------------------------------------------
# fault-injecting wrapper adapter
# --------------------------------------------------------------------------
class FaultInjectingReader(StorageReader):
    """Inject a :class:`FaultProfile` under any inner adapter.

    Pure pass-through for batch algebra and metadata (like
    :class:`~repro_torch.data.cloud.CloudReader`) — delivered bytes are those of
    the inner adapter, only failures and timing are added.  Faults are
    decided and raised BEFORE delegating, so a failed attempt never touches
    the inner store and records no request counters (the counters' rollback
    for failed attempts is structural, not compensating).
    """

    def __init__(self, inner: StorageReader, profile: FaultProfile):
        self.inner = inner
        self.profile = profile
        self._edges = inner.boundaries()
        # per-range attempt indices + per-shard op ordinals: the mutable
        # half of determinism (decisions themselves are pure hashes)
        self._attempts: dict[tuple[int, int], int] = {}  # guarded-by: _lock
        self._shard_ops: dict[int, int] = {}  # guarded-by: _lock
        self.injected = {"reads": 0, "errors": 0, "spikes": 0, "stuck": 0}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _shard_of(self, row: int) -> int:
        edges = self._edges
        if edges is None or len(edges) <= 2:
            return 0
        return int(np.searchsorted(edges, row, side="right") - 1)

    # ----------------------------------------------------------- injection
    def read_range(self, start: int, stop: int) -> Any:
        p = self.profile
        shard = self._shard_of(start)
        with self._lock:
            att = self._attempts.get((start, stop), 0)
            self._attempts[(start, stop)] = att + 1
            op = self._shard_ops.get(shard, 0)
            self._shard_ops[shard] = op + 1
            self.injected["reads"] += 1
            fail = any(
                s == shard and a <= op < z for (s, a, z) in p.blackouts
            ) or p.transient(start, stop, att)
            sleep_s = 0.0
            if fail:
                self.injected["errors"] += 1
            else:
                sleep_s = p.stuck(start, stop, att)
                if sleep_s > 0.0:
                    self.injected["stuck"] += 1
                else:
                    sleep_s = p.spike(start, stop, att)
                    if sleep_s > 0.0:
                        self.injected["spikes"] += 1
        # raise/sleep OUTSIDE the lock: injected latency must overlap across
        # reader threads like real degraded storage would
        if fail:
            raise TransientStorageError(
                f"injected fault: shard {shard} range [{start}, {stop}) "
                f"attempt {att}"
            )
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        return self.inner.read_range(start, stop)

    def fault_snapshot(self) -> dict:
        """Injection counters (reads / errors / spikes / stuck) so far."""
        with self._lock:
            return dict(self.injected)

    # ------------------------------------------------------ delegation
    def __len__(self) -> int:
        return len(self.inner)

    def boundaries(self) -> Optional[np.ndarray]:
        return self.inner.boundaries()

    def take(self, piece: Any, rows: np.ndarray) -> Any:
        return self.inner.take(piece, rows)

    def concat(self, pieces: Sequence[Any]) -> Any:
        return self.inner.concat(pieces)

    def nbytes_of(self, rows: np.ndarray) -> int:
        return self.inner.nbytes_of(rows)

    @property
    def avg_row_bytes(self) -> float:
        return self.inner.avg_row_bytes

    @property
    def schema(self) -> dict:
        return {
            **self.inner.schema,
            "fault_seed": self.profile.seed,
            "fault_error_rate": self.profile.error_rate,
        }

    def obs_keys(self) -> list[str]:
        return self.inner.obs_keys()

    def obs_column(self, key: str) -> np.ndarray:
        return self.inner.obs_column(key)

    def bind_iostats(self, iostats: IOCounters) -> None:
        self.inner.bind_iostats(iostats)

    def close(self) -> None:
        self.inner.close()


def _as_bool(v) -> bool:
    """Query-string / kwarg boolean: 1/0, true/false, or an actual bool."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"cannot interpret {v!r} as a boolean")


def _parse_blackouts(spec) -> tuple:
    """``"shard:first:last[;shard:first:last...]"`` -> blackout tuples."""
    if not spec:
        return ()
    if isinstance(spec, (list, tuple)):
        return tuple(tuple(int(x) for x in window) for window in spec)
    out = []
    for part in str(spec).split(";"):
        try:
            shard, first, last = (int(x) for x in part.split(":"))
        except ValueError:
            raise ValueError(
                f"blackout window {part!r} is not 'shard:first:last'"
            ) from None
        out.append((shard, first, last))
    return tuple(out)


@register_backend("fault")
def _open_fault(
    inner_uri: str,
    *,
    seed=0,
    error_rate=0.0,
    spike_rate=0.0,
    spike_ms=50,
    spike_on_retries=True,
    blackout=None,
    stuck_row=-1,
    stuck_ms=0,
    stuck_on_retries=False,
    fault_scale=1.0,
    **inner_opts,
) -> FaultInjectingReader:
    """Opener: ``fault://<inner-uri>?error_rate=0.05&seed=3&...`` — fault
    knobs are consumed here, everything else forwards to the inner opener
    (so ``fault://cloud://...?profile=cross-region`` composes)."""
    profile = FaultProfile(
        seed=int(seed),
        error_rate=float(error_rate),
        spike_rate=float(spike_rate),
        spike_s=float(spike_ms) / 1e3,
        spike_on_retries=_as_bool(spike_on_retries),
        blackouts=_parse_blackouts(blackout),
        stuck_row=int(stuck_row),
        stuck_s=float(stuck_ms) / 1e3,
        stuck_on_retries=_as_bool(stuck_on_retries),
        scale=float(fault_scale),
    )
    return FaultInjectingReader(open_adapter(inner_uri, **inner_opts), profile)


# --------------------------------------------------------------------------
# retry policy
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + decorrelated jitter.

    ``retries`` is the budget of ADDITIONAL attempts after the first;
    backoff for attempt ``k`` is drawn uniformly (deterministically, via
    :func:`mix_u01` over ``(seed, range, k)``) from ``[backoff_s,
    max(3 * previous_delay, backoff_s)]`` and capped at ``max_backoff_s`` —
    the classic decorrelated-jitter schedule: grows exponentially in
    expectation, desynchronizes concurrent retriers, never exceeds the cap.
    ``deadline_s`` (when > 0) bounds one logical read's total retry wall
    time regardless of the attempt budget.
    """

    retries: int = 0
    backoff_s: float = 0.005
    max_backoff_s: float = 0.25
    deadline_s: float = 0.0  # 0 = no per-read deadline
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return self.retries > 0

    def backoff(self, lo: int, hi: int, attempt: int, prev_s: float) -> float:
        u = mix_u01(self.seed, 4, lo, hi, attempt)
        span = max(3.0 * prev_s, self.backoff_s)
        delay = self.backoff_s + u * (span - self.backoff_s)
        return min(self.max_backoff_s, delay)


# --------------------------------------------------------------------------
# per-shard circuit breaker
# --------------------------------------------------------------------------
class ShardCircuit:
    """Per-shard circuit breaker: closed -> open -> half-open probe.

    ``threshold`` consecutive failures of one shard open its breaker.
    While open, background prefetch skips the shard entirely
    (:meth:`is_open`) and demand fetches take the :meth:`admit` gate: after
    ``cooldown_s`` ONE caller is elected the half-open probe ("probe"), all
    others see "open" (the planner caps their retry budget).  A recorded
    success closes the breaker; a failure restarts the cooldown.

    State-transition methods RETURN whether a transition happened instead
    of firing callbacks, so the caller records the counters' transitions outside
    this lock — no lock-order edge from the circuit to the counters' lock.
    """

    def __init__(self, threshold: int, cooldown_s: float, *, clock=time.monotonic):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._fails: dict[int, int] = {}  # guarded-by: _lock — consecutive failures
        self._open_at: dict[int, float] = {}  # guarded-by: _lock — open shards
        self._probing: set[int] = set()  # guarded-by: _lock — half-open probes out
        self.opens = 0  # guarded-by: _lock
        self.closes = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def is_open(self, shard: int) -> bool:
        with self._lock:
            return shard in self._open_at

    def admit(self, shard: int) -> str:
        """Demand-read gate: ``"closed"`` | ``"probe"`` | ``"open"``."""
        with self._lock:
            if shard not in self._open_at:
                return "closed"
            cooled = self._clock() - self._open_at[shard] >= self.cooldown_s
            if cooled and shard not in self._probing:
                self._probing.add(shard)
                return "probe"
            return "open"

    def record_failure(self, shard: int) -> bool:
        """Account one read failure; True if this OPENED the breaker."""
        with self._lock:
            self._probing.discard(shard)
            if shard in self._open_at:
                # failed while open (probe or capped demand read): restart
                # the cooldown — the shard is still dark
                self._open_at[shard] = self._clock()
                return False
            n = self._fails.get(shard, 0) + 1
            self._fails[shard] = n
            if n >= self.threshold:
                self._open_at[shard] = self._clock()
                self._fails[shard] = 0
                self.opens += 1
                return True
            return False

    def record_success(self, shard: int) -> bool:
        """Account one read success; True if this CLOSED an open breaker."""
        with self._lock:
            self._probing.discard(shard)
            self._fails[shard] = 0
            if shard in self._open_at:
                del self._open_at[shard]
                self.closes += 1
                return True
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "open_shards": sorted(self._open_at),
                "opens": self.opens,
                "closes": self.closes,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
            }
