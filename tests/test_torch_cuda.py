"""The port's Hopper kernels against their plain PyTorch versions on a card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false.  Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import csr_to_dense, ops, ref

# (rows, K, n_cols): the JAX package's ELL sweep, a batch at Tahoe's width
# and a row narrower than one 16-byte store
CASES = [(16, 8, 64), (33, 5, 100), (8, 16, 512), (1, 1, 8), (64, 1800, 62_710), (3, 7, 5)]
ATOL = 1e-6  # random columns repeat, and atomics add duplicates in any order


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,K,G", CASES)
def test_ell_to_dense_kernel_matches_plain_version(R, K, G):
    dev = _card()
    rng = np.random.default_rng(R * 7 + K)
    vals = torch.tensor(rng.normal(0, 1, (R, K)).astype(np.float32), device=dev)
    cols = torch.tensor(rng.integers(-1, G, (R, K)).astype(np.int32), device=dev)
    before = csr_to_dense.ell_to_dense.launches
    got = ops.ell_to_dense(vals, cols, n_cols=G)
    torch.cuda.synchronize()
    assert csr_to_dense.ell_to_dense.launches == before + 1
    torch.testing.assert_close(got, ref.ell_to_dense_ref(vals, cols, G), atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_ell_to_dense_kernel_bitwise_without_duplicates():
    dev = _card()
    rng = np.random.default_rng(0)
    R, K, G = 64, 1800, 62_710
    cols = np.stack([np.sort(rng.choice(G, K, replace=False)) for _ in range(R)]).astype(np.int32)
    cols[:, -100:] = -1  # ragged rows
    vals = rng.integers(1, 50, (R, K)).astype(np.float32)
    v, c = torch.tensor(vals, device=dev), torch.tensor(cols, device=dev)
    assert torch.equal(ops.ell_to_dense(v, c, n_cols=G), ref.ell_to_dense_ref(v, c, G))
