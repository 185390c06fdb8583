"""Minibatch-diversity theory (paper §3.4, Appendix C): the port's copy of
``repro.core.theory``.

The plug-in entropy, the bias expansions of Theorems 3.1/3.2, the sandwich
bound of Corollary 3.3, and a Monte-Carlo simulation of the sampling scheme
that checks the bounds empirically.  It is numpy float64 code, copied
function for function and not imported, so on the same inputs (and, for
:func:`simulate_expected_entropy`, the same generator state) every function
returns the reference's values bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "plugin_entropy",
    "distribution_entropy",
    "expected_entropy_large_f",
    "expected_entropy_f1",
    "entropy_bounds",
    "batch_entropy",
    "mean_batch_entropy",
    "simulate_expected_entropy",
    "tahoe_plate_distribution",
]

_LN2 = math.log(2.0)


def plugin_entropy(counts: np.ndarray) -> float:
    """H(C) = -sum (C_k/m) log2 (C_k/m)  — Eq. (1). Zero counts contribute 0.

    An all-zero (or empty) histogram has entropy 0 by convention; negative
    counts are rejected — they have no histogram meaning and would
    otherwise poison the normalization silently.
    """
    counts = np.asarray(counts, dtype=np.float64)
    if counts.size and float(counts.min()) < 0:
        raise ValueError("plugin_entropy: counts must be non-negative")
    m = counts.sum()
    if m <= 0:
        return 0.0
    p = counts[counts > 0] / m
    # max() also normalizes the single-class -0.0 (sum of -1*log2(1))
    return max(0.0, float(-(p * np.log2(p)).sum()))


def distribution_entropy(p: Sequence[float]) -> float:
    """H(p) in bits."""
    p = np.asarray(p, dtype=np.float64)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def expected_entropy_large_f(p: Sequence[float], m: int) -> float:
    """Theorem 3.1: E[H(C)] = H(p) - (K-1)/(2 m ln 2) + O(m^-2)."""
    if m <= 0:
        raise ValueError(f"batch size m must be positive, got {m}")
    p = np.asarray(p, dtype=np.float64)
    K = int((p > 0).sum())
    return distribution_entropy(p) - (K - 1) / (2.0 * m * _LN2)


def expected_entropy_f1(p: Sequence[float], m: int, b: int) -> float:
    """Theorem 3.2: with f=1 the effective sample size is B = m/b."""
    if m <= 0 or b <= 0:
        raise ValueError(f"m and b must be positive, got m={m}, b={b}")
    p = np.asarray(p, dtype=np.float64)
    K = int((p > 0).sum())
    B = m / b
    return distribution_entropy(p) - (K - 1) / (2.0 * B * _LN2)


def entropy_bounds(p: Sequence[float], m: int, b: int) -> tuple[float, float]:
    """Corollary 3.3 sandwich bound, any f >= 1.

    H(p) - (K-1) b / (2 m ln2)  <=  E[H(C)]  <=  H(p) - (K-1)/(2 m ln2)

    Both bounds are clamped at 0 (entropy cannot be negative): in the
    m < K regime even the UPPER expansion term goes negative, and clamping
    only the lower bound would invert the ordering.  Clamping both
    preserves ``lo <= hi`` because the raw expressions already satisfy it
    for every b >= 1.
    """
    if m <= 0 or b <= 0:
        raise ValueError(f"m and b must be positive, got m={m}, b={b}")
    p = np.asarray(p, dtype=np.float64)
    K = int((p > 0).sum())
    H = distribution_entropy(p)
    lo = H - (K - 1) * b / (2.0 * m * _LN2)
    hi = H - (K - 1) / (2.0 * m * _LN2)
    return max(0.0, lo), max(0.0, hi)


def batch_entropy(labels: np.ndarray, num_classes: Optional[int] = None) -> float:
    """Plug-in entropy of one minibatch's label histogram.

    ``labels`` are non-negative integer class codes (an integer-valued
    float array is accepted and cast).  An empty batch has entropy 0 —
    ``np.bincount`` would reject the default-float64 empty array outright.
    """
    labels = np.asarray(labels)
    if labels.size == 0:
        return 0.0
    if labels.dtype.kind not in "iu":
        labels = labels.astype(np.int64)
    counts = np.bincount(labels, minlength=num_classes or 0)
    return plugin_entropy(counts)


def mean_batch_entropy(batches_labels: Sequence[np.ndarray]) -> tuple[float, float]:
    """(mean, std) of entropy over minibatches — the Fig. 4 / Table 2 metric."""
    ents = np.array([batch_entropy(b) for b in batches_labels])
    return float(ents.mean()), float(ents.std())


def simulate_expected_entropy(
    p: Sequence[float],
    m: int,
    b: int,
    f: int,
    *,
    trials: int = 200,
    rng: Optional[np.random.Generator] = None,
) -> tuple[float, float]:
    """Monte-Carlo E[H(C)] under the paper's sampling model (§3.4).

    Model: the buffer holds f*B blocks (B = ceil(m/b)) drawn IID from
    Cat(p), each contributing b same-label cells; a minibatch is m cells
    drawn uniformly without replacement from the buffer.  B rounds UP so
    the buffer always holds at least m cells — with floor division a
    non-dividing (m, b) pair (e.g. m=10, b=3, f=1) left a buffer smaller
    than the batch and the without-replacement draw raised.
    """
    if m <= 0 or b <= 0 or f <= 0:
        raise ValueError(f"m, b, f must be positive, got m={m}, b={b}, f={f}")
    if trials <= 0:
        raise ValueError(f"trials must be positive, got {trials}")
    rng = rng or np.random.default_rng(0)
    p = np.asarray(p, dtype=np.float64)
    p = p / p.sum()
    K = len(p)
    B = max(1, -(-m // b))
    ents = np.empty(trials)
    for t in range(trials):
        block_labels = rng.choice(K, size=f * B, p=p)
        buffer_labels = np.repeat(block_labels, b)
        pick = rng.choice(len(buffer_labels), size=m, replace=False)
        ents[t] = batch_entropy(buffer_labels[pick], K)
    return float(ents.mean()), float(ents.std())


def tahoe_plate_distribution() -> np.ndarray:
    """The 14-plate size distribution used in the paper's §3.4 validation.

    Plate sizes range 4.7%–10.4% of cells with H(p) = 3.78 bits (paper gives
    these two facts; the vector below is a maximum-entropy-consistent
    reconstruction hitting both: 14 plates, min .047, max .104, H = 3.78).
    """
    p = np.array(
        [0.104, 0.096, 0.089, 0.083, 0.078, 0.074, 0.071, 0.068,
         0.066, 0.063, 0.058, 0.054, 0.049, 0.047]
    )
    return p / p.sum()
