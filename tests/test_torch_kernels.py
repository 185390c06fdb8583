"""The port's ELL densify against the JAX package's Pallas kernel (interpret
mode) and its oracle, on the CPU; the Hopper kernel against its plain
version on a card is in ``test_torch_cuda.py``, which imports no JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.csr_to_dense import ell_to_dense as pallas_ell_to_dense
from repro_torch.data.csr_store import CSRBatch, CSRStore, write_csr_shard
from repro_torch.kernels import csr_to_dense, ops, ref

# the JAX package's sweep (tests/test_kernels.py): ragged rows and column
# tiles, and columns drawn with repeats (duplicates add up)
SWEEP = [(16, 8, 64, 8, 64), (33, 5, 100, 8, 32), (8, 16, 512, 4, 128), (1, 1, 8, 8, 8)]
ATOL = 1e-6  # duplicate columns are summed in another order


def _ell(R, K, G, seed, hi=None):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 1, (R, K)).astype(np.float32)
    cols = rng.integers(-1, G if hi is None else hi, (R, K)).astype(np.int32)
    return vals, cols


@pytest.mark.parametrize("R,K,G,br,bc", SWEEP)
def test_ell_to_dense_matches_pallas_and_oracle(R, K, G, br, bc):
    vals, cols = _ell(R, K, G, seed=R * 1000 + K)
    got = ops.ell_to_dense(torch.from_numpy(vals), torch.from_numpy(cols), n_cols=G)
    assert got.dtype == torch.float32 and got.shape == (R, G)
    pallas = pallas_ell_to_dense(jnp.asarray(vals), jnp.asarray(cols), n_cols=G,
                                 block_rows=br, block_cols=bc, interpret=True)
    oracle = jax_ref.ell_to_dense_ref(jnp.asarray(vals), jnp.asarray(cols), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL, rtol=0)


# the JAX sweep's shapes, and an n_cols that is not a multiple of 4 (rows
# that do not start on a 16-byte boundary on the card)
LOG1P_CASES = [*(c[:3] for c in SWEEP), (7, 11, 101)]


# XLA's float32 log1p on the CPU is not correctly rounded: at 0.5062917 it
# gives 0.40965074, 1.8 ULP under the true 0.40965079 that PyTorch's and
# numpy's round to, so it stands 2 ULP from PyTorch's there (queue C #5)
XLA_LOG1P_ULP = 2


def _check_log1p(got, vals, cols, G):
    """``got`` within 1 ULP of numpy's ``log1p`` and XLA_LOG1P_ULP of
    ``jnp.log1p`` (the reference's features,
    ``benchmarks/bench_fig5_classification.py``) of the JAX package's
    Pallas densify in interpret mode."""
    dense = pallas_ell_to_dense(jnp.asarray(vals), jnp.asarray(cols), n_cols=G,
                                block_rows=8, block_cols=32, interpret=True)
    np.testing.assert_array_max_ulp(got.numpy(), np.log1p(np.asarray(dense)), maxulp=1)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(jnp.log1p(dense)),
                                    maxulp=XLA_LOG1P_ULP)


@pytest.mark.parametrize("R,K,G", LOG1P_CASES)
def test_fused_log1p_is_the_plain_version_then_log1p(R, K, G):
    """On the CPU the fused entry is the plain densify followed by
    ``log1p_``, bitwise; against XLA's ``log1p`` of the Pallas kernel's
    output it is held to :func:`_check_log1p`'s ULPs (queue C #5: no two
    float32 log1p agree bitwise).  Each row's columns are distinct, as in canonical CSR, so
    that both densified batches agree bitwise and the comparison isolates
    log1p (duplicates add up in another order: the tests above); values are
    non-negative, as counts are, so that every output lies in log1p's
    domain."""
    rng = np.random.default_rng(R * 1000 + K + 1)
    vals = np.abs(rng.normal(0, 1, (R, K))).astype(np.float32)
    cols = np.stack([rng.choice(G, K, replace=False) for _ in range(R)]).astype(np.int32)
    cols[rng.random((R, K)) < 0.25] = -1  # padding
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    got = ops.ell_to_dense(v, c, n_cols=G, log1p=True)
    assert got.dtype == torch.float32 and got.shape == (R, G)
    assert torch.equal(got, ref.ell_to_dense_ref(v, c, G).log1p_())
    _check_log1p(got, vals, cols, G)


def test_fused_log1p_on_a_csr_batch(tmp_path):
    b = _canonical_batch(tmp_path, seed=6)
    b.data = np.abs(b.data)  # counts: in log1p's domain
    vals, cols = b.to_ell()
    got = ops.ell_to_dense(torch.from_numpy(vals), torch.from_numpy(cols), n_cols=b.n_var,
                           log1p=True)
    assert torch.equal(got, torch.from_numpy(b.to_dense()).log1p_())
    _check_log1p(got, vals, cols, b.n_var)


def test_ell_duplicate_columns_accumulate():
    vals = torch.tensor([[1.0, 2.0, 3.0]])
    cols = torch.tensor([[4, 4, -1]], dtype=torch.int32)
    out = ops.ell_to_dense(vals, cols, n_cols=8)
    assert float(out[0, 4]) == 3.0 and float(out.abs().sum()) == 3.0


def test_out_of_range_columns_add_nothing_as_in_jax():
    vals, cols = _ell(6, 9, 20, seed=2, hi=24)  # some columns >= n_cols
    got = ref.ell_to_dense_ref(torch.from_numpy(vals), torch.from_numpy(cols), 20)
    want = jax_ref.ell_to_dense_ref(jnp.asarray(vals), jnp.asarray(cols), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _canonical_batch(tmp_path, n=64, g=96, seed=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    data = rng.normal(0, 1, int(indptr[-1])).astype(np.float32)
    indices = np.concatenate(
        [np.sort(rng.choice(g, size=int(l), replace=False)) for l in lens]
    ).astype(np.int32)
    p = str(tmp_path / "s")
    write_csr_shard(p, data, indices, indptr, g, {"plate": np.zeros(n, np.int32)})
    return CSRStore(p)[rng.permutation(n)]


def test_ell_matches_csr_batch(tmp_path):
    """CSRBatch -> ELL -> densify == the batch's dense form, on both sides."""
    from repro.data.csr_store import CSRBatch as RefCSRBatch

    b = _canonical_batch(tmp_path)
    vals, cols = b.to_ell()
    got = ops.ell_to_dense(torch.from_numpy(vals), torch.from_numpy(cols), n_cols=b.n_var)
    ref_batch = RefCSRBatch(b.data, b.indices, b.indptr, b.n_var, b.obs)
    assert np.array_equal(got.numpy(), ref_batch.to_dense())  # canonical: bitwise
    assert np.array_equal(got.numpy(), b.to_dense())
    pallas = pallas_ell_to_dense(jnp.asarray(vals), jnp.asarray(cols), n_cols=b.n_var,
                                 block_rows=8, block_cols=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL, rtol=0)
    # a wider ELL only adds padding
    v2, c2 = b.to_ell(k_max=vals.shape[1] + 3)
    assert np.array_equal(
        ops.ell_to_dense(torch.from_numpy(v2), torch.from_numpy(c2), n_cols=b.n_var), got
    )


def test_to_ell_refuses_to_truncate(tmp_path):
    b = _canonical_batch(tmp_path)
    longest = int(np.diff(b.indptr).max())
    with pytest.raises(ValueError, match="drop nonzeros"):
        b.to_ell(k_max=longest - 1)
    with pytest.raises(ValueError, match="drop nonzeros"):
        b.to_tensors(k_max=longest - 1)
    assert b.to_ell(k_max=longest)[0].shape == (len(b), longest)


def test_to_dense_adds_duplicate_columns():
    b = CSRBatch(data=np.array([1.0, 2.0, 5.0], np.float32),
                 indices=np.array([3, 3, 0], np.int32),
                 indptr=np.array([0, 2, 3]), n_var=4, obs={})
    assert np.array_equal(b.to_dense(), np.array([[0, 0, 0, 3], [5, 0, 0, 0]], np.float32))
    vals, cols = b.to_ell()
    assert np.array_equal(ref.ell_to_dense_ref(torch.from_numpy(vals), torch.from_numpy(cols), 4).numpy(),
                          b.to_dense())


@pytest.mark.parametrize("case", [
    "vals_float64", "cols_int64", "shape_mismatch", "one_dim", "not_contiguous",
    "n_cols_zero", "cpu_tensors", "log1p_not_bool",
    "out_wrong_shape", "out_float64", "out_not_contiguous",
])
def test_kernel_wrapper_rejects_bad_input(case):
    vals = torch.zeros((4, 3))
    cols = torch.zeros((4, 3), dtype=torch.int32)
    n_cols, log1p, err = 8, False, ValueError
    if case == "vals_float64":
        vals, err = vals.double(), TypeError
    elif case == "cols_int64":
        cols, err = cols.long(), TypeError
    elif case == "shape_mismatch":
        cols = cols[:, :2].contiguous()
    elif case == "one_dim":
        vals, cols = vals.reshape(-1), cols.reshape(-1)
    elif case == "not_contiguous":
        vals, cols = vals.t(), cols.t()
    elif case == "n_cols_zero":
        n_cols = 0
    elif case == "log1p_not_bool":
        log1p, err = 1, TypeError
    elif case.startswith("out_"):
        out = {"out_wrong_shape": torch.zeros((4, n_cols - 1)),
               "out_float64": torch.zeros((4, n_cols), dtype=torch.float64),
               "out_not_contiguous": torch.zeros((n_cols, 4)).t()}[case]
        with pytest.raises(ValueError, match="out must be"):
            csr_to_dense.launch(None, vals, cols, n_cols, log1p, out=out)
        return
    before = csr_to_dense.ell_to_dense.launches
    with pytest.raises(err):
        csr_to_dense.ell_to_dense(vals, cols, n_cols=n_cols, log1p=log1p)
    assert csr_to_dense.ell_to_dense.launches == before


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError):
        ops.ell_to_dense(torch.zeros((2, 2), device="meta"),
                         torch.zeros((2, 2), dtype=torch.int32, device="meta"), n_cols=4)


def test_dispatch_refuses_a_log1p_that_is_not_a_bool():
    vals, cols = torch.zeros((2, 2)), torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.ell_to_dense(vals, cols, n_cols=4, log1p="yes")
