"""``repro_torch.core.theory`` against ``repro.core.theory`` on the CPU, and
the JAX package's theory tests (``test_theory.py``,
``test_theory_properties.py``) run against the port.

Both modules are numpy float64 code, so each of the nine exported functions
is held to the reference bit for bit, ``simulate_expected_entropy``'s
Monte-Carlo included.  Every input is fixed: seeded numpy draws,
parametrised seeds, and hypothesis properties with ``derandomize=True``
(and no example database), so each run draws the same cases and a
Monte-Carlo property cannot fail by chance.  The sizes are the reference
tests' own; the file takes about 5 s on one CPU core.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.core import theory as ref_theory
from repro_torch.core import theory
from repro_torch.core.theory import (
    batch_entropy,
    distribution_entropy,
    entropy_bounds,
    expected_entropy_f1,
    expected_entropy_large_f,
    mean_batch_entropy,
    plugin_entropy,
    simulate_expected_entropy,
    tahoe_plate_distribution,
)

FIXED = dict(deadline=None, derandomize=True, database=None)


def _bits(x):
    """A result as bytes: equal bytes are equal bits, -0.0 and NaN included."""
    if isinstance(x, tuple):
        return tuple(_bits(v) for v in x)
    return np.asarray(x, dtype=np.float64).tobytes()


def _dirichlet(k: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).dirichlet(np.full(k, 5.0))


# --------------------------------------------------------- against repro

def test_exports_the_reference_names():
    assert theory.__all__ == ref_theory.__all__
    assert len(theory.__all__) == 9


def _cases(seed: int) -> list:
    """(function name, args, kwargs) for every exported function, drawn
    from ``seed``."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 15))
    p = rng.dirichlet(np.full(k, 2.0))
    p[rng.random(k) < 0.2] = 0.0  # zero classes
    m, b = int(rng.integers(1, 600)), int(rng.choice([1, 2, 4, 16, 64]))
    counts = rng.integers(0, 40, size=k)
    labels = rng.integers(0, k, size=int(rng.integers(0, 200)))
    batches = [rng.integers(0, k, size=int(rng.integers(1, 64))) for _ in range(5)]
    return [
        ("plugin_entropy", (counts,), {}),
        ("plugin_entropy", (counts.astype(np.float64) * 0.5,), {}),
        ("distribution_entropy", (p,), {}),
        ("expected_entropy_large_f", (p, m), {}),
        ("expected_entropy_f1", (p, m, b), {}),
        ("entropy_bounds", (p, m, b), {}),
        ("batch_entropy", (labels,), {}),
        ("batch_entropy", (labels.astype(np.float64), k + 3), {}),
        ("mean_batch_entropy", (batches,), {}),
        ("tahoe_plate_distribution", (), {}),
    ]


@pytest.mark.parametrize("seed", range(8))
def test_functions_bitwise_equal_to_the_reference(seed):
    for name, args, kwargs in _cases(seed):
        got = getattr(theory, name)(*args, **kwargs)
        want = getattr(ref_theory, name)(*args, **kwargs)
        assert type(got) is type(want), name
        assert _bits(got) == _bits(want), (name, got, want)


@pytest.mark.parametrize("m,b,f,trials", [(64, 16, 1, 200), (64, 16, 256, 50), (10, 3, 1, 20),
                                          (33, 1, 8, 100)])
def test_monte_carlo_bitwise_equal_to_the_reference(m, b, f, trials):
    p = tahoe_plate_distribution()
    got = simulate_expected_entropy(p, m, b, f, trials=trials, rng=np.random.default_rng(7))
    want = ref_theory.simulate_expected_entropy(p, m, b, f, trials=trials,
                                                rng=np.random.default_rng(7))
    assert _bits(got) == _bits(want)
    # the default generator (seed 0) too
    assert _bits(simulate_expected_entropy(p, m, b, f, trials=trials)) == _bits(
        ref_theory.simulate_expected_entropy(p, m, b, f, trials=trials))


@pytest.mark.parametrize("call", [
    lambda t: t.plugin_entropy(np.array([3, -1, 2])),
    lambda t: t.expected_entropy_large_f([0.5, 0.5], 0),
    lambda t: t.expected_entropy_f1([0.5, 0.5], 64, 0),
    lambda t: t.entropy_bounds([0.5, 0.5], -1, 4),
    lambda t: t.simulate_expected_entropy([0.5, 0.5], 64, 16, 0),
    lambda t: t.simulate_expected_entropy([0.5, 0.5], 64, 16, 1, trials=0),
])
def test_refuses_what_the_reference_refuses(call):
    with pytest.raises(ValueError) as ref_err:
        call(ref_theory)
    with pytest.raises(ValueError) as err:
        call(theory)
    assert str(err.value) == str(ref_err.value)


# ------------------------------------------- test_theory.py, on the port

def test_paper_eq5_numbers():
    """Paper Eq. (5): m=64, b=16 on the Tahoe plate distribution."""
    p = tahoe_plate_distribution()
    assert abs(distribution_entropy(p) - 3.78) < 0.02
    lo, hi = entropy_bounds(p, m=64, b=16)
    assert abs(lo - 1.43) < 0.05
    assert abs(hi - 3.63) < 0.05


def test_paper_section34_empirical_match():
    p = tahoe_plate_distribution()
    m1, _ = simulate_expected_entropy(p, 64, 16, 1, trials=400, rng=np.random.default_rng(0))
    assert abs(m1 - 1.76) < 0.15  # paper: 1.76 +/- 0.33
    m256, _ = simulate_expected_entropy(p, 64, 16, 256, trials=200, rng=np.random.default_rng(0))
    assert abs(m256 - 3.61) < 0.05  # paper: 3.61 +/- 0.08


@given(k=st.integers(2, 12), b=st.sampled_from([1, 2, 4, 8, 16]),
       f=st.sampled_from([1, 2, 8, 64]), seed=st.integers(0, 100))
@settings(max_examples=25, **FIXED)
def test_sandwich_bound_holds(k, b, f, seed):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(k, 5.0))
    mean, std = simulate_expected_entropy(p, 64, b, f, trials=150, rng=rng)
    lo, hi = entropy_bounds(p, 64, b)
    slack = 3 * std / np.sqrt(150) + 0.08  # MC error + O(B^-2) truncation
    assert lo - slack <= mean <= hi + slack, (lo, mean, hi)


@given(k=st.integers(2, 10), seed=st.integers(0, 50))
@settings(max_examples=20, **FIXED)
def test_monotone_in_f(k, seed):
    p = np.random.default_rng(seed).dirichlet(np.full(k, 5.0))
    means = [simulate_expected_entropy(p, 64, 16, f, trials=200,
                                       rng=np.random.default_rng(seed))[0] for f in (1, 8, 64)]
    assert means[0] <= means[1] + 0.1
    assert means[1] <= means[2] + 0.1


def test_theorem_limits_consistency():
    p = tahoe_plate_distribution()
    lo, hi = entropy_bounds(p, 64, 16)
    assert abs(expected_entropy_f1(p, 64, 16) - lo) < 1e-9
    assert abs(expected_entropy_large_f(p, 64) - hi) < 1e-9


def test_plugin_entropy_edges():
    assert plugin_entropy(np.array([0, 0, 64])) == 0.0
    assert abs(plugin_entropy(np.array([32, 32])) - 1.0) < 1e-12
    assert plugin_entropy(np.zeros(4)) == 0.0
    assert batch_entropy(np.array([1, 1, 1, 1])) == 0.0
    with pytest.raises(ValueError, match="non-negative"):
        plugin_entropy(np.array([3, -1, 2]))


def test_batch_entropy_edges():
    assert batch_entropy(np.array([])) == 0.0
    assert batch_entropy(np.array([]), num_classes=14) == 0.0
    assert abs(batch_entropy(np.array([0.0, 1.0, 0.0, 1.0])) - 1.0) < 1e-12
    h = batch_entropy(np.array([7, 7, 7]))
    assert h == 0.0 and not np.signbit(h)


def test_entropy_bounds_clamps_both_sides_when_m_below_k():
    lo, hi = entropy_bounds(np.full(32, 1 / 32), m=4, b=4)
    assert 0.0 <= lo <= hi


def test_simulate_handles_non_dividing_block_size():
    mean, _ = simulate_expected_entropy(np.full(4, 0.25), m=10, b=3, f=1, trials=20,
                                        rng=np.random.default_rng(0))
    assert 0.0 <= mean <= 2.0


# ------------------------------ test_theory_properties.py, on the port

@given(k=st.integers(2, 14), m=st.integers(1, 2048),
       b=st.sampled_from([1, 2, 4, 8, 16, 64, 256]), seed=st.integers(0, 10_000))
@settings(max_examples=120, **FIXED)
def test_bounds_ordered_and_below_hp(k, m, b, seed):
    p = _dirichlet(k, seed)
    lo, hi = entropy_bounds(p, m, b)
    assert 0.0 <= lo <= hi + 1e-12, (lo, hi)
    assert hi <= distribution_entropy(p) + 1e-12


@given(k=st.integers(2, 14), m1=st.integers(1, 5000), m2=st.integers(1, 5000),
       seed=st.integers(0, 10_000))
@settings(max_examples=100, **FIXED)
def test_large_f_monotone_in_m(k, m1, m2, seed):
    p = _dirichlet(k, seed)
    lo_m, hi_m = sorted((m1, m2))
    assert expected_entropy_large_f(p, lo_m) <= expected_entropy_large_f(p, hi_m) + 1e-12


@given(k=st.integers(2, 14), seed=st.integers(0, 10_000))
@settings(max_examples=80, **FIXED)
def test_plugin_converges_to_distribution_entropy(k, seed):
    p = _dirichlet(k, seed)
    H = distribution_entropy(p)
    err_coarse = abs(plugin_entropy(np.round(p * 100)) - H)
    err_fine = abs(plugin_entropy(np.round(p * 1_000_000)) - H)
    assert err_fine < 0.02, (err_fine, H)
    assert err_fine <= err_coarse + 1e-6


@given(k=st.integers(2, 12), m=st.sampled_from([32, 64, 128]),
       b=st.sampled_from([1, 2, 4, 8, 16]), f=st.sampled_from([1, 4, 16]),
       seed=st.integers(0, 10_000))
@settings(max_examples=40, **FIXED)
def test_simulation_lands_inside_bounds(k, m, b, f, seed):
    p = _dirichlet(k, seed)
    mean, std = simulate_expected_entropy(p, m, b, f, trials=150,
                                          rng=np.random.default_rng(seed + 1))
    lo, hi = entropy_bounds(p, m, b)
    slack = 3 * std / np.sqrt(150) + 0.1
    assert lo - slack <= mean <= hi + slack, (lo, mean, hi, slack)


@given(k=st.integers(1, 20), n=st.integers(1, 512), shift=st.integers(0, 7),
       seed=st.integers(0, 10_000))
@settings(max_examples=100, **FIXED)
def test_batch_entropy_bounded_and_invariant(k, n, shift, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, size=n)
    h = batch_entropy(labels)
    assert 0.0 <= h <= np.log2(max(1, k)) + 1e-9
    assert batch_entropy(rng.permutation(labels)) == h
    assert abs(batch_entropy(labels + shift) - h) < 1e-12
    assert abs(batch_entropy(labels, num_classes=k + 5) - h) < 1e-12


@given(k=st.integers(2, 10), n_batches=st.integers(1, 12), seed=st.integers(0, 10_000))
@settings(max_examples=60, **FIXED)
def test_mean_batch_entropy_is_per_batch_mean(k, n_batches, seed):
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, k, size=int(rng.integers(1, 128))) for _ in range(n_batches)]
    mean, std = mean_batch_entropy(batches)
    ents = np.array([batch_entropy(b) for b in batches])
    assert abs(mean - ents.mean()) < 1e-12
    assert abs(std - ents.std()) < 1e-12


@given(k=st.integers(2, 14), m=st.integers(1, 2048), b=st.sampled_from([1, 2, 4, 8, 16, 64]),
       seed=st.integers(0, 10_000))
@settings(max_examples=100, **FIXED)
def test_bounds_are_clamped_theorem_expansions(k, m, b, seed):
    p = _dirichlet(k, seed)
    f1 = expected_entropy_f1(p, m, b)
    large = expected_entropy_large_f(p, m)
    assert f1 <= large + 1e-12
    lo, hi = entropy_bounds(p, m, b)
    assert abs(lo - max(0.0, f1)) < 1e-12
    assert abs(hi - max(0.0, large)) < 1e-12


def test_tahoe_plate_distribution_shape():
    p = tahoe_plate_distribution()
    assert len(p) == 14
    assert abs(p.sum() - 1.0) < 1e-12
    assert 0.045 <= p.min() and p.max() <= 0.105
    assert abs(distribution_entropy(p) - 3.78) < 0.02
