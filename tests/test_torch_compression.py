"""The numpy int8 error-feedback quantizer against the JAX package's: its
numpy mirror and its JAX ``quantize_ef`` / ``dequantize`` give the same
codes, scales and residual, bit for bit, over odd shapes and float dtypes,
and the residual carry holds across steps.

Counterparts in ``tests/test_compression.py``: ``test_numpy_mirror_parity``
and ``test_numpy_mirror_residual_carry`` (here with the same names), and
``test_roundtrip_odd_shapes_dtypes`` and ``test_residual_carry_across_steps``
for the numpy half (``test_odd_shapes_dtypes_bitwise``,
``test_residual_carry_across_steps``).  The bound and the convergence are held on the numpy half too
(``test_quantize_bounded_error``, ``test_error_feedback_converges``).

The JAX half (``tests/test_compression.py``'s ``test_quantize_bounded_error``,
``test_error_feedback_converges``, ``test_tree_roundtrip``,
``test_roundtrip_odd_shapes_dtypes`` and ``test_residual_carry_across_steps``)
is held on the port's tensor functions, bit for bit against the JAX
package's ``quantize_ef``, ``dequantize``, ``compress_tree`` and
``decompress_tree`` and the numpy mirror (the ``test_tensor_*`` cases); and
the DDP hook on 2 gloo ranks, two steps, against the mean of each rank's
``dequantize_np(quantize_ef_np(...))`` with the residual carried, bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gloo import run_ranks
from repro.distributed import compression as ref
from repro_torch.distributed import compression as port
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


# ------------------------------------------------------- the JAX half, on tensors
TORCH_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
                "float16": (torch.float16, jnp.float16)}


def _same(t: torch.Tensor, a) -> bool:
    """A tensor and a JAX or numpy array: equal dtype width and bytes."""
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes() == a.view(np.int16).tobytes()
    return t.numpy().dtype == a.dtype and t.numpy().tobytes() == a.tobytes()


def _pair(g32: np.ndarray, dtype: str):
    """The same values as a tensor and a JAX array of ``dtype``."""
    tdt, jdt = TORCH_DTYPES[dtype]
    t = torch.from_numpy(g32).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


@pytest.mark.parametrize("shape", [(1,), (255,), (256,), (257,), (3, 5), (4, 7, 9), (1000,)])
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_tensor_roundtrip_odd_shapes_dtypes_bitwise(shape, dtype):
    t, j = _pair(np.random.default_rng(int(np.prod(shape))).normal(0, 2.0, shape)
                 .astype(np.float32), dtype)
    q, s, r = port.quantize_ef(t)
    qj, sj, rj = ref.quantize_ef(j)
    qn, sn, rn = ref.quantize_ef_np(t.float().numpy())
    n_blocks = -(-int(np.prod(shape)) // 256)
    assert q.shape == (n_blocks, 256) and q.dtype == torch.int8
    assert s.shape == (n_blocks,) and r.shape == t.shape and r.dtype == torch.float32
    for a, b, c in ((q, qj, qn), (s, sj, sn), (r, rj, rn)):
        assert _same(a, b) and _same(a, c)
    d = port.dequantize(q, s, shape, t.dtype)
    assert d.shape == shape and d.dtype == t.dtype
    assert _same(d, ref.dequantize(qj, sj, shape, TORCH_DTYPES[dtype][1]))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_tensor_quantize_bounded_error(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2000))
    g = torch.from_numpy(rng.normal(0, float(rng.uniform(1e-6, 1e3)), n).astype(np.float32))
    q, s, r = port.quantize_ef(g)
    deq = port.dequantize(q, s, g.shape, g.dtype)
    assert torch.all((deq - g).abs() <= s.repeat_interleave(256)[:n] * (0.5 + 1e-3) + 1e-9)
    assert torch.equal(r, g - deq)


def test_tensor_error_feedback_converges():
    g = torch.from_numpy(np.random.default_rng(0).normal(0, 1, 512).astype(np.float32))
    resid, applied = torch.zeros_like(g), torch.zeros_like(g)
    jresid = jnp.zeros(512, jnp.float32)
    for _ in range(50):
        q, s, resid = port.quantize_ef(g, resid)
        qj, sj, jresid = ref.quantize_ef(jnp.asarray(g.numpy()), jresid)
        assert _same(q, qj) and _same(resid, jresid)
        applied += port.dequantize(q, s, g.shape, g.dtype)
    np.testing.assert_allclose((applied / 50).numpy(), g.numpy(), atol=2e-2)


def test_tensor_residual_carry_across_steps():
    g = torch.from_numpy(np.random.default_rng(7).normal(0, 1, 777).astype(np.float32))
    q1, s1, r1 = port.quantize_ef(g)
    d1 = port.dequantize(q1, s1, g.shape, g.dtype)
    assert torch.equal(r1, g - d1)
    q2, s2, r2 = port.quantize_ef(g, r1)
    _, _, rj = ref.quantize_ef(jnp.asarray(g.numpy()), jnp.asarray(r1.numpy()))
    assert _same(r2, rj)
    d2 = port.dequantize(q2, s2, g.shape, g.dtype)
    np.testing.assert_allclose((d1 + d2 + r2).numpy(), (2.0 * g).numpy(), atol=1e-5)
    assert float(((d1 + d2) / 2 - g).abs().mean()) <= float((d1 - g).abs().mean()) + 1e-7


def test_tree_roundtrip():
    rng = np.random.default_rng(1)
    a, b = rng.normal(0, 1, (33,)).astype(np.float32), rng.normal(0, 10, (4, 7)).astype(np.float32)
    tree = {"a": torch.from_numpy(a), "b": {"c": torch.from_numpy(b).to(torch.bfloat16)}}
    jtree = {"a": jnp.asarray(a), "b": {"c": jnp.asarray(tree["b"]["c"].float().numpy())
                                        .astype(jnp.bfloat16)}}
    codes, scales, resid = port.compress_tree(tree)
    jcodes, jscales, jresid = ref.compress_tree(jtree)
    for got, want in ((codes, jcodes), (scales, jscales), (resid, jresid)):
        assert _same(got["a"], want["a"]) and _same(got["b"]["c"], want["b"]["c"])
    out = port.decompress_tree(codes, scales, tree)
    jout = ref.decompress_tree(jcodes, jscales, jtree)
    assert _same(out["a"], jout["a"]) and _same(out["b"]["c"], jout["b"]["c"])
    np.testing.assert_allclose(out["a"].numpy(), a, atol=0.05)
    assert out["b"]["c"].dtype == torch.bfloat16 and codes["a"].dtype == torch.int8
    # the residuals fed back as a tree
    codes2, _, _ = port.compress_tree(tree, resid)
    jcodes2, _, _ = ref.compress_tree(jtree, jresid)
    assert _same(codes2["a"], jcodes2["a"]) and _same(codes2["b"]["c"], jcodes2["b"]["c"])


def test_ef_int8_hook_is_the_mean_of_the_ranks_dequantized_codes(tmp_path):
    """Two steps of DDP on 2 ranks with the hook: after each, every rank
    holds the mean (float32, in rank order) of the ranks' error-feedback
    codes of their local gradients, the residual carried from step 1."""
    rng = np.random.default_rng(5)
    grads = [[rng.normal(0, 1, (7, 300)).astype(np.float32) for _ in range(2)] for _ in range(2)]
    ranks = run_ranks("ef_hook", 2, tmp_path, [[torch.from_numpy(g) for g in step]
                                                for step in grads])
    resid = [None, None]
    for step, local in enumerate(grads):
        deqs = []
        for r, g in enumerate(local):
            q, s, resid[r] = quantize_ef_np(g.reshape(-1), resid[r])
            deqs.append(dequantize_np(q, s, (g.size,), np.float32))
        want = ((deqs[0] + deqs[1]) / np.float32(2)).reshape(7, 300)
        for rank in ranks:
            assert rank["grads"][step].numpy().tobytes() == want.tobytes(), step
    for r, rank in enumerate(ranks):
        assert rank["residuals"][0].numpy().tobytes() == resid[r].tobytes()
