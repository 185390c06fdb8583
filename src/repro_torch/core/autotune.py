"""(b, f) autotuning (paper §5, "automated profiling"): the port of
``repro.core.autotune``, function for function.

A recommendation rests on three measurable quantities:

1. **I/O cost model**: ``t(fetch) ≈ c0 + c_seek * n_runs + c_byte * bytes``,
   fitted by least squares over timed reads.  :func:`probe_io_cost` times a
   raw ``read_rows`` callable; :func:`probe_collection` times fetches of a
   planned collection (:class:`~repro_torch.data.backend.PlannedRows`) and
   takes its design matrix from the runs and bytes the planner issued, so
   the model carries the probe's measured ``hit_rate``,
   ``runs_per_sample``, ``cache_bytes`` and request and admission rates.
2. **Memory budget**: the fetch buffer holds ``m * f`` rows; a cache that
   absorbs redraws has its bytes reserved out of the budget first.
3. **Diversity**: Corollary 3.3's deficit ``(K-1) / (2 s_eff ln 2)`` with
   ``s_eff = min(m, f m / b)`` must stay within ``entropy_slack_bits`` of
   the IID value, and above an ``entropy_floor`` when one is set.

:func:`recommend` maximizes modeled samples/s under (2) and (3);
:func:`model_drift` says how far live counters sit from a fitted model.
Numpy only: the port's own copies of ``epoch_rng`` and the entropy
functions, and ``time.perf_counter`` for the probe's clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

from .sampling import epoch_rng

__all__ = [
    "IOCostModel",
    "probe_io_cost",
    "probe_collection",
    "recommend",
    "recommend_concurrency",
    "recommend_from",
    "fit_and_recommend",
    "model_drift",
    "Recommendation",
]

_LN2 = float(np.log(2.0))


@dataclasses.dataclass
class IOCostModel:
    c0: float  # fixed per-fetch-call overhead (s)
    c_seek: float  # per-random-run cost (s) — per-REQUEST cost on cloud://
    c_byte: float  # per-byte streaming cost (s/B)
    row_bytes: float  # average materialized row size (B)
    # --- planner-level measurements (probe_collection); the defaults give the plain model
    hit_rate: float = 0.0  # measured block-cache hit rate of the probe
    runs_per_sample: Optional[float] = None  # physical runs per row, measured
    cache_bytes: float = 0.0  # LRU budget the probe ran with
    # --- request semantics (cloud://)
    n_rows: float = 0.0  # collection size (enables the coalescing term); 0=off
    requests_per_sample: float = 0.0  # per-request ops per row (cloud:// GETs)
    # --- admission-regime measurements (adaptive engine): decisions per
    # cache touch at probe time.  A flip of the admission regime (TinyLFU
    # starts rejecting, or the stream detector starts bypassing) reshapes
    # the hit rate the model was fitted against, so model_drift() watches
    # these rates too.
    adm_bypass_rate: float = 0.0  # bypassing-policy skips per cache touch
    adm_reject_rate: float = 0.0  # TinyLFU duel losses per cache touch

    def _coalesce_factor(self, k: float, b: int) -> float:
        """Expected fraction of ``k`` drawn blocks that start a new run.

        Drawing k of the N = n_rows/b blocks uniformly leaves
        ``k * (N - k + 1) / N`` maximal runs in expectation — the paper's
        plateau argument (once the fetch covers every block, the whole read
        is one contiguous run).  This is what makes a larger fetch factor
        pay on per-request storage: more blocks per fetch coalesce into
        fewer (request-charged) physical reads per sample.
        """
        if self.n_rows <= 0:
            return 1.0
        N = max(float(k), self.n_rows / max(1, b))
        return max(1.0 / k, (N - k + 1.0) / N)

    def fetch_seconds(self, m: int, f: int, b: int) -> float:
        rows = m * f
        miss = 1.0 - min(max(self.hit_rate, 0.0), 0.99)
        k = max(1, rows // max(1, b))
        coal = self._coalesce_factor(k, b)
        n_seeks = k * coal * miss
        if self.runs_per_sample is not None:
            # Measured floor: the planner+cache never issued fewer physical
            # runs per row than observed at the probe's scale; extrapolating
            # below it is only allowed through the modeled coalescing gain.
            n_seeks = max(n_seeks, self.runs_per_sample * rows * coal)
        return self.c0 + self.c_seek * n_seeks + self.c_byte * rows * self.row_bytes * miss

    def samples_per_sec(self, m: int, f: int, b: int) -> float:
        return (m * f) / max(1e-12, self.fetch_seconds(m, f, b))


def probe_io_cost(
    read_rows: Callable[[np.ndarray], Any],
    n: int,
    row_bytes: float,
    *,
    probes: int = 5,
    probe_rows: int = 512,
    seed: int = 0,
) -> IOCostModel:
    """Fit the 3-parameter cost model with timed random/contiguous probes.

    ``read_rows(sorted_indices)`` must perform one backend call, mirroring
    Algorithm 1 line 8.
    """
    rng = epoch_rng(seed, 0, 0xA070)
    # Design: vary (n_blocks, rows) across probes and least-squares the model.
    rows_grid = [probe_rows // 4, probe_rows, probe_rows, probe_rows * 2]
    blocks_grid = [rows_grid[0], 1, rows_grid[2], 8]  # fully-random, contiguous, random, blocky
    X, y = [], []
    for _ in range(probes):
        for rows, nb in zip(rows_grid, blocks_grid):
            rows = min(rows, n)
            nb = min(nb, rows)
            bsz = max(1, rows // nb)
            starts = np.sort(rng.integers(0, max(1, n - bsz), size=nb))
            idx = np.concatenate([np.arange(s, s + bsz) for s in starts])[:rows]
            idx = np.unique(idx)
            t0 = time.perf_counter()
            read_rows(idx)
            dt = time.perf_counter() - t0
            X.append([1.0, float(nb), float(len(idx) * row_bytes)])
            y.append(dt)
    X = np.asarray(X)
    y = np.asarray(y)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    c0, c_seek, c_byte = (max(0.0, float(c)) for c in coef)
    return IOCostModel(c0=c0, c_seek=c_seek, c_byte=c_byte, row_bytes=row_bytes)


def probe_collection(
    col: Any,
    *,
    probes: int = 3,
    probe_rows: int = 512,
    seed: int = 0,
) -> IOCostModel:
    """Fit the cost model THROUGH a ``PlannedRows``.

    Unlike :func:`probe_io_cost` (which models seeks from raw index counts),
    the design matrix here uses what the planner actually did: the counters'
    runs/bytes deltas of each timed ``fetch``.  Cache absorption is part of
    the measurement — probe patterns include *redraws* of earlier rows, so a
    collection with a live block cache shows its hit rate, and the returned
    model carries ``hit_rate``, ``runs_per_sample`` and ``cache_bytes`` for
    :func:`recommend` to fold into the (b, f) choice.
    """
    stats = col.iostats
    rng = epoch_rng(seed, 0, 0xA071)
    n = len(col)
    base = stats.snapshot()
    hits0, miss0 = stats.cache_hits, stats.cache_misses
    req0 = stats.requests
    X, y = [], []
    prev_idx = None
    for _ in range(probes):
        # four patterns per round: scattered, contiguous, blocky, and a
        # REDRAW of the previous probe's rows (exercises the cache exactly
        # like with-replacement block sampling does across fetches)
        pr = min(probe_rows, n)
        scattered = np.unique(rng.integers(0, n, size=pr))
        start = int(rng.integers(0, max(1, n - pr)))
        contiguous = np.arange(start, start + pr)
        nb = max(1, pr // 64)
        starts = np.sort(rng.integers(0, max(1, n - 64), size=nb))
        blocky = np.unique(
            np.concatenate([np.arange(s, s + 64) for s in starts])[:pr]
        )
        patterns = [scattered, contiguous, blocky]
        if prev_idx is not None:
            patterns.append(prev_idx)
        prev_idx = blocky
        for idx in patterns:
            runs0, bytes0 = stats.runs, stats.bytes_read
            t0 = time.perf_counter()
            col.fetch(idx)
            dt = time.perf_counter() - t0
            X.append([1.0, float(stats.runs - runs0), float(stats.bytes_read - bytes0)])
            y.append(dt)
    coef, *_ = np.linalg.lstsq(np.asarray(X), np.asarray(y), rcond=None)
    c0, c_seek, c_byte = (max(0.0, float(c)) for c in coef)
    d_hits = stats.cache_hits - hits0
    d_miss = stats.cache_misses - miss0
    d_runs = stats.runs - base["runs"]
    d_rows = stats.rows - base["rows"]
    d_touch = max(1, d_hits + d_miss)
    d_adm_b = stats.adm_bypassed - base["adm_bypassed"]
    d_adm_r = stats.adm_rejected - base["adm_rejected"]
    return IOCostModel(
        c0=c0,
        c_seek=c_seek,
        c_byte=c_byte,
        row_bytes=float(col.avg_row_bytes),
        hit_rate=d_hits / max(1, d_hits + d_miss),
        runs_per_sample=d_runs / max(1, d_rows),
        cache_bytes=float(col.cache.max_bytes),
        n_rows=float(n),
        requests_per_sample=(stats.requests - req0) / max(1, d_rows),
        adm_bypass_rate=d_adm_b / d_touch,
        adm_reject_rate=d_adm_r / d_touch,
    )


def model_drift(
    model: IOCostModel,
    stats: Any,
    *,
    base: Optional[dict] = None,
    ra_shifts: int = 0,
    expected_entropy: Optional[float] = None,
) -> float:
    """How far live :class:`~repro_torch.data.iostats.IOCounters` sit from ``model``.

    Two planner-level quantities the fitted model carries are re-measurable
    for free from the running collection's stats:

    - runs per sample — RELATIVE deviation from ``model.runs_per_sample``
      (the access-pattern shape: coalescing got better/worse);
    - cache hit rate — ABSOLUTE deviation from ``model.hit_rate`` (already
      a 0..1 rate; relative deviation would explode near zero);
    - admission rates — ABSOLUTE deviation of bypasses/rejections per
      cache touch from the probe-time ``adm_bypass_rate`` /
      ``adm_reject_rate``: an admission-regime flip (TinyLFU warming up,
      the stream detector toggling) reshapes hit rate with a lag, so the
      decision counters flag it earlier than the hit rate itself.

    ``ra_shifts`` — number of readahead depth changes (controller grows +
    shrinks) since the model was fitted; each contributes 0.5 drift
    (capped at 1.0), so an adaptive readahead that had to move twice
    forces a re-probe on its own (``ScIterableDataset.autotune`` passes the delta
    against its probe-time mark).

    ``expected_entropy`` — the E[H] prediction (bits) the current
    ``(b, f)`` pick was made under (:attr:`Recommendation.predicted_entropy`).
    When given and the stats carry live diversity observations
    (``div_batches`` from a ``diversity_obs`` loader), the SHORTFALL of the
    measured mean batch entropy below the prediction contributes directly
    in bits — the §3.4 model over-promising diversity (a drifted label
    distribution, a degenerate epoch order) is drift exactly like a
    mis-fitted seek cost, and at the shared 0.5 default threshold half a
    bit of lost diversity forces a re-probe on its own.  Delivering MORE
    entropy than predicted is not drift (the bounds are one-sided).

    ``base`` — a ``stats.snapshot()`` taken when the model was fitted.
    When given, drift is measured on the counter DELTAS since then, so a
    regime change late in a long run is not diluted by hours of
    accumulated history (``ScIterableDataset.autotune`` passes its probe-time
    snapshot).  Without it, lifetime totals are used.

    Returns the largest of these (0.0 when the stats are empty or the model
    carries no planner measurements).  ``ScIterableDataset.autotune`` and
    ``DataPipeline.check_drift`` re-probe when this exceeds their
    threshold.
    """
    snap = stats.snapshot()  # one consistent cut of every counter
    runs, rows = snap["runs"], snap["rows"]
    hits, misses = snap["cache_hits"], snap["cache_misses"]
    adm_b, adm_r = snap["adm_bypassed"], snap["adm_rejected"]
    div_b = snap.get("div_batches", 0)
    div_s = snap.get("div_entropy_sum", 0.0)
    if base is not None:
        runs -= base.get("runs", 0)
        rows -= base.get("rows", 0)
        hits -= base.get("cache_hits", 0)
        misses -= base.get("cache_misses", 0)
        adm_b -= base.get("adm_bypassed", 0)
        adm_r -= base.get("adm_rejected", 0)
        div_b -= base.get("div_batches", 0)
        div_s -= base.get("div_entropy_sum", 0.0)
    drifts = [0.0]
    if expected_entropy is not None and div_b > 0:
        drifts.append(max(0.0, float(expected_entropy) - div_s / div_b))
    if rows > 0 and model.runs_per_sample is not None:
        ref = max(float(model.runs_per_sample), 1e-9)
        drifts.append(abs(runs / rows - ref) / ref)
    touched = hits + misses
    if touched > 0:
        drifts.append(abs(hits / touched - model.hit_rate))
        drifts.append(abs(adm_b / touched - model.adm_bypass_rate))
        drifts.append(abs(adm_r / touched - model.adm_reject_rate))
    if ra_shifts > 0:
        drifts.append(min(1.0, 0.5 * float(ra_shifts)))
    return max(drifts)


@dataclasses.dataclass
class Recommendation:
    block_size: int
    fetch_factor: int
    modeled_samples_per_sec: float
    entropy_lower_bound: float
    buffer_bytes: float
    rationale: str
    cache_reserved_bytes: float = 0.0
    # --- concurrency picks: from the fitted per-request cost of the
    # chosen (b, f) cell.  io_workers is the smallest worker count whose
    # modeled fetch time sits within 10% of the best (overlapping the
    # per-run/request latency term); readahead is "auto" when that fetch is
    # latency-bound (the adaptive controller then finds the depth) and 0
    # when per-call overhead + streaming dominate (nothing to overlap).
    io_workers: int = 1
    readahead: Any = 0  # 0 | "auto"
    # predicted E[H] (bits) of the chosen cell under the §3.4 model:
    # H_ref - (K-1)/(2 s_eff ln2), where H_ref is the class distribution's
    # entropy (log2 K uniform fallback).  The runtime diversity monitor
    # cross-checks measured entropy against this through model_drift.
    predicted_entropy: Optional[float] = None
    # the fitted model this pick came from (drift checks re-measure against
    # it); filled by the Pipeline and ScIterableDataset autotune paths
    model: Optional[IOCostModel] = dataclasses.field(default=None, repr=False)


_IO_WORKER_GRID = (1, 2, 4, 8, 16)


def recommend_concurrency(
    cost: IOCostModel,
    *,
    batch_size: int,
    fetch_factor: int,
    block_size: int,
    worker_slack: float = 0.1,
) -> tuple[int, Any]:
    """``(io_workers, readahead)`` for one (m, f, b) cell from the fitted
    per-request cost model.

    The latency term of a fetch is ``c_seek`` per physical run/request;
    ``W`` workers overlap those, so the modeled fetch time is ``c0 +
    c_seek * ceil(n_seeks / W) + byte_term``.  The pick is the SMALLEST
    ``W`` within ``worker_slack`` of the best — threads a cheap store
    cannot repay are not spent, and on per-request storage (``cloud://``,
    where ``c_seek`` is the fitted per-GET cost) the recommended count
    grows with first-byte latency.  ``readahead`` is ``"auto"`` when the
    remaining latency term still dominates per-call overhead + streaming
    (double-buffering has real I/O to hide), else 0.
    """
    m, f, b = int(batch_size), int(fetch_factor), int(block_size)
    rows = m * f
    miss = 1.0 - min(max(cost.hit_rate, 0.0), 0.99)
    k = max(1, rows // max(1, b))
    coal = cost._coalesce_factor(k, b)
    n_seeks = k * coal * miss
    if cost.runs_per_sample is not None:
        n_seeks = max(n_seeks, cost.runs_per_sample * rows * coal)
    byte_s = cost.c_byte * rows * cost.row_bytes * miss

    def fetch_s(W: int) -> float:
        return cost.c0 + cost.c_seek * float(np.ceil(n_seeks / W)) + byte_s

    best = min(fetch_s(W) for W in _IO_WORKER_GRID)
    io_workers = next(
        W for W in _IO_WORKER_GRID if fetch_s(W) <= best * (1.0 + worker_slack)
    )
    latency_s = cost.c_seek * float(np.ceil(n_seeks / io_workers))
    readahead = "auto" if latency_s > 0.5 * (cost.c0 + byte_s) else 0
    return int(io_workers), readahead


def recommend(
    cost: IOCostModel,
    *,
    batch_size: int = 64,
    num_classes: int = 14,
    class_probs: Optional[Sequence[float]] = None,
    mem_budget_bytes: float = 2e9,
    entropy_slack_bits: float = 0.1,
    entropy_floor: Optional[float] = None,
    b_grid: Sequence[int] = (1, 4, 16, 64, 256, 1024),
    f_grid: Sequence[int] = (1, 4, 16, 64, 256, 1024),
    cache_hit_threshold: float = 0.05,
    throughput_slack: float = 0.0,
) -> Recommendation:
    """Pick (b, f) maximizing modeled throughput under memory + diversity limits.

    Diversity-SLO aware: ``entropy_floor`` (bits) turns the paper's
    quality/throughput trade-off into a one-knob target.  Each cell's
    predicted E[H] under the §3.4 model is ``H_ref - (K-1)/(2 s_eff ln2)``
    with ``s_eff = min(m, f*m/b)`` — ``H_ref`` is the entropy of
    ``class_probs`` when given, else the uniform ``log2 K`` — and cells
    whose prediction falls below the floor are infeasible.  Among the
    survivors the usual selection applies (max modeled samples/sec, or the
    leanest buffer within ``throughput_slack`` of it), so the pick is the
    leanest/fastest geometry that still CLEARS the floor.  A floor no cell
    can clear (it exceeds even the IID prediction for this m) raises with
    the best achievable value in the message.

    Planner-aware: when ``cost`` came from :func:`probe_collection` and shows
    the block cache absorbing redraws (``hit_rate >= cache_hit_threshold``),
    the cache's byte budget (capped at half the memory budget) is reserved
    before sizing the fetch buffer — evicting a cache that is already
    serving ``hit_rate`` of block touches to afford a bigger fetch buffer
    would re-pay those reads on disk.  The fetch-factor ceiling (and thus
    typically the recommended f) shrinks accordingly, and the seek/byte
    terms of every candidate are discounted by the measured hit rate inside
    ``cost.fetch_seconds``.

    Request-aware: ``throughput_slack > 0`` changes the selection rule from
    "argmax modeled samples/sec" to "the SMALLEST fetch buffer within
    ``throughput_slack`` of the best" — don't spend memory a cheap store
    cannot repay.  On per-request storage (``cloud://``) the per-run cost
    ``c_seek`` is the fitted per-request cost, so as first-byte latency
    grows, small fetch factors fall out of the slack window and the
    recommended f climbs toward the memory cap.
    """
    m = batch_size
    K = num_classes
    if class_probs is not None:
        from .theory import distribution_entropy

        K = int(np.count_nonzero(np.asarray(class_probs)))
        h_ref = distribution_entropy(class_probs)
    else:
        h_ref = float(np.log2(max(1, K)))
    reserve = 0.0
    if cost.hit_rate >= cache_hit_threshold and cost.cache_bytes > 0:
        reserve = min(float(cost.cache_bytes), 0.5 * mem_budget_bytes)
    buffer_budget = mem_budget_bytes - reserve
    # Thm 3.1 deficit at IID: (K-1)/(2 m ln2). We demand the *effective* deficit
    # (K-1)/(2 S_eff ln2) be within entropy_slack of it, where S_eff is the
    # effective sample size min(m, f*m/b) (blocks contributing to a batch).
    iid_deficit = (K - 1) / (2.0 * m * _LN2)
    feasible: list[tuple] = []  # (b, f, sps, buffer_bytes, deficit)
    for b in b_grid:
        for f in f_grid:
            buffer_bytes = m * f * cost.row_bytes
            if buffer_bytes > buffer_budget:
                continue
            s_eff = min(m, max(1, (f * m) // max(1, b)))
            deficit = (K - 1) / (2.0 * s_eff * _LN2)
            if deficit - iid_deficit > entropy_slack_bits:
                continue
            if entropy_floor is not None and h_ref - deficit < entropy_floor:
                continue  # predicted E[H] below the diversity SLO
            feasible.append((b, f, cost.samples_per_sec(m, f, b), buffer_bytes, deficit))
    if not feasible:
        if entropy_floor is not None and h_ref - iid_deficit < entropy_floor:
            raise ValueError(
                f"entropy_floor {entropy_floor:.3f} bits is unreachable at "
                f"m={m}: even IID sampling predicts only "
                f"{h_ref - iid_deficit:.3f} bits (H_ref {h_ref:.3f} minus the "
                f"Thm 3.1 deficit {iid_deficit:.3f}); lower the floor or "
                "raise batch_size"
            )
        raise ValueError("no (b, f) satisfies the memory/diversity constraints")
    best_sps = max(c[2] for c in feasible)
    if throughput_slack > 0:
        # leanest buffer that still lands within the slack of the best —
        # memory a cheap store can't repay in throughput is not spent
        window = [c for c in feasible if c[2] >= best_sps * (1.0 - throughput_slack)]
        b, f, sps, buffer_bytes, deficit = min(
            window, key=lambda c: (c[3], c[1], -c[2])
        )
    else:  # pure argmax (first strictly-greater in grid order, as before)
        b, f, sps, buffer_bytes, deficit = next(
            c for c in feasible if c[2] >= best_sps
        )
    planner = (
        f", cache reserve {reserve/1e6:.0f}MB "
        f"(hit rate {cost.hit_rate:.2f}, "
        f"{cost.runs_per_sample if cost.runs_per_sample is not None else 0:.4f} runs/sample)"
        if reserve > 0
        else ""
    )
    io_workers, readahead = recommend_concurrency(
        cost, batch_size=m, fetch_factor=f, block_size=b
    )
    floor_note = (
        f", predicted E[H] {h_ref - deficit:.3f} >= floor {entropy_floor:.3f}"
        if entropy_floor is not None
        else ""
    )
    return Recommendation(
        block_size=b,
        fetch_factor=f,
        modeled_samples_per_sec=sps,
        entropy_lower_bound=-deficit,
        buffer_bytes=buffer_bytes,
        cache_reserved_bytes=reserve,
        io_workers=io_workers,
        readahead=readahead,
        predicted_entropy=h_ref - deficit,
        rationale=(
            f"b={b},f={f}: buffer {buffer_bytes/1e6:.1f}MB <= "
            f"{buffer_budget/1e6:.0f}MB, entropy deficit "
            f"{deficit:.3f} bits (IID {iid_deficit:.3f}), modeled {sps:.0f} samp/s"
            f", io_workers={io_workers}, readahead={readahead!r}"
            f"{floor_note}{planner}"
        ),
    )


def recommend_from(
    model: IOCostModel,
    *,
    batch_size: int = 64,
    budget: float = 2e9,
    num_classes: int = 14,
    class_probs: Optional[Sequence[float]] = None,
    entropy_slack_bits: float = 0.1,
    entropy_floor: Optional[float] = None,
    throughput_slack: float = 0.0,
) -> Recommendation:
    """:func:`recommend` from an already-fitted model, with the fit attached
    to the result (``rec.model``) so drift checks can re-measure against it.
    The one place the model→recommendation hand-off is wired — both
    ``ScIterableDataset.autotune`` and the Pipeline builder go through here."""
    rec = recommend(
        model,
        batch_size=batch_size,
        num_classes=num_classes,
        class_probs=class_probs,
        mem_budget_bytes=budget,
        entropy_slack_bits=entropy_slack_bits,
        entropy_floor=entropy_floor,
        throughput_slack=throughput_slack,
    )
    rec.model = model
    return rec


def fit_and_recommend(
    col: Any,
    *,
    probes: int = 3,
    probe_rows: int = 512,
    batch_size: int = 64,
    budget: float = 2e9,
    num_classes: int = 14,
    class_probs: Optional[Sequence[float]] = None,
    entropy_slack_bits: float = 0.1,
    entropy_floor: Optional[float] = None,
    throughput_slack: float = 0.0,
) -> Recommendation:
    """Probe ``col`` through the planner and recommend in one call."""
    return recommend_from(
        probe_collection(col, probes=probes, probe_rows=probe_rows),
        batch_size=batch_size,
        budget=budget,
        num_classes=num_classes,
        class_probs=class_probs,
        entropy_slack_bits=entropy_slack_bits,
        entropy_floor=entropy_floor,
        throughput_slack=throughput_slack,
    )
