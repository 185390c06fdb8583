"""The numpy int8 error-feedback quantizer against the JAX package's: its
numpy mirror and its JAX ``quantize_ef`` / ``dequantize`` give the same
codes, scales and residual, bit for bit, over odd shapes and float dtypes,
and the residual carry holds across steps.

Counterparts in ``tests/test_compression.py``: ``test_numpy_mirror_parity``
and ``test_numpy_mirror_residual_carry`` (here with the same names), and
``test_roundtrip_odd_shapes_dtypes`` and ``test_residual_carry_across_steps``
for the numpy half (``test_odd_shapes_dtypes_bitwise``,
``test_residual_carry_across_steps``).  ``test_quantize_bounded_error``,
``test_error_feedback_converges`` and ``test_tree_roundtrip`` test the JAX
half, which the port has not (it becomes a DDP communication hook, ROADMAP.md
queue A #13); the bound and the convergence are held here on the numpy half
(``test_quantize_bounded_error``, ``test_error_feedback_converges``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as ref
from repro_torch.distributed.compression import dequantize_np, quantize_ef_np

SHAPES = [(1,), (17,), (255,), (256,), (257,), (3, 5), (4, 7, 9), (1000,), (5000,)]
DTYPES = [np.float32, np.float16, np.float64, "bfloat16"]


def _input(shape, dtype, seed):
    g = np.random.default_rng(seed).normal(0, 3.0, shape).astype(np.float32)
    if dtype == "bfloat16":  # numpy has no bfloat16: round through torch, hand over float32
        return torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    return g.astype(dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_odd_shapes_dtypes_bitwise(shape, dtype):
    g = _input(shape, dtype, int(np.prod(shape)))
    q, s, r = quantize_ef_np(g)
    qr, sr, rr = ref.quantize_ef_np(g)
    qj, sj, rj = ref.quantize_ef(jnp.asarray(g, jnp.float32))
    n_blocks = -(-int(np.prod(shape)) // 256)
    assert q.shape == (n_blocks, 256) and q.dtype == np.int8
    assert s.shape == (n_blocks,) and s.dtype == np.float32
    assert r.shape == g.shape and r.dtype == np.float32
    for a, b in ((q, qr), (s, sr), (r, rr), (q, np.asarray(qj)), (s, np.asarray(sj)),
                 (r, np.asarray(rj))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    out_dtype = np.float32 if dtype == "bfloat16" else dtype
    d, dr = dequantize_np(q, s, shape, out_dtype), ref.dequantize_np(q, s, shape, out_dtype)
    assert d.shape == tuple(shape) and d.dtype == np.dtype(out_dtype)
    assert d.tobytes() == dr.tobytes()
    dj = ref.dequantize(jnp.asarray(q), jnp.asarray(s), shape, jnp.float32)
    assert dequantize_np(q, s, shape, np.float32).tobytes() == np.asarray(dj).tobytes()


@pytest.mark.parametrize("n", [1, 17, 256, 300, 5000])
def test_numpy_mirror_parity(n):
    """The port's codes decode as the JAX package's do, both ways."""
    g = np.random.default_rng(n).normal(0, 3.0, n).astype(np.float32)
    qj, sj, _ = ref.quantize_ef(jnp.asarray(g))
    qn, sn, _ = quantize_ef_np(g)
    np.testing.assert_array_equal(np.asarray(qj), qn)
    np.testing.assert_array_equal(np.asarray(sj), sn)
    np.testing.assert_array_equal(
        dequantize_np(np.asarray(qj), np.asarray(sj), g.shape, np.float32),
        np.asarray(ref.dequantize(jnp.asarray(qn), jnp.asarray(sn), g.shape, jnp.float32)),
    )


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_quantize_bounded_error(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2000))
    g = rng.normal(0, float(rng.uniform(1e-6, 1e3)), n).astype(np.float32)
    q, s, r = quantize_ef_np(g)
    deq = dequantize_np(q, s, g.shape, np.float32)
    assert np.all(np.abs(deq - g) <= np.repeat(s, 256)[:n] * (0.5 + 1e-3) + 1e-9)
    np.testing.assert_array_equal(r, (g - deq).astype(np.float32))


def test_residual_carry_across_steps():
    """Two steps: delivered plus outstanding residual is twice the input,
    the same in both packages, bit for bit at every step."""
    g = np.random.default_rng(7).normal(0, 1, 777).astype(np.float32)
    r_port = r_ref = None
    delivered = np.zeros_like(g)
    for _ in range(2):
        q, s, r_port = quantize_ef_np(g, r_port)
        qr, sr, r_ref = ref.quantize_ef_np(g, r_ref)
        assert q.tobytes() == qr.tobytes() and s.tobytes() == sr.tobytes()
        assert r_port.tobytes() == r_ref.tobytes()
        delivered += dequantize_np(q, s, g.shape, np.float32)
    np.testing.assert_allclose(delivered + r_port, 2.0 * g, atol=1e-5)


def test_numpy_mirror_residual_carry():
    g = np.random.default_rng(3).normal(0, 1, 513).astype(np.float32)
    resid = resid_ref = None
    applied = np.zeros_like(g)
    for _ in range(20):
        q, s, resid = quantize_ef_np(g, resid)
        qr, sr, resid_ref = ref.quantize_ef_np(g, resid_ref)
        assert q.tobytes() == qr.tobytes() and resid.tobytes() == resid_ref.tobytes()
        applied += dequantize_np(q, s, g.shape, np.float32)
    np.testing.assert_allclose(applied / 20, g, atol=2e-2)


def test_error_feedback_converges():
    g = np.random.default_rng(0).normal(0, 1, 512).astype(np.float32)
    resid, applied = None, np.zeros_like(g)
    for _ in range(50):
        q, s, resid = quantize_ef_np(g, resid)
        applied += dequantize_np(q, s, g.shape, np.float32)
    np.testing.assert_allclose(applied / 50, g, atol=2e-2)
