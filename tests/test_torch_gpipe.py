"""The GPipe pipeline (``repro_torch.distributed.pipeline``) on 4 gloo
ranks: ``tests/test_pipeline.py``'s case (S 4 stages, M 6 microbatches of
8 x 16, ``tanh(h @ w + b)``).  The reference's own test raises under jax
0.9.0 (ROADMAP.md queue C #1), so the port is held to the sequential stack
of the same stages: within 1e-5 of it computed by the JAX package's
``jnp`` ops, and bit for bit equal to it computed by the same torch ops in
the ranks' processes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gloo import run_ranks

S, M, MB, D = 4, 6, 8, 16


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
    b = rng.normal(0, 0.1, (S, D)).astype(np.float32)
    x = rng.normal(0, 1, (M, MB, D)).astype(np.float32)
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    ranks = run_ranks("gpipe", S, tmp_path_factory.mktemp("gpipe"), params, torch.from_numpy(x))
    return (w, b, x), ranks


def test_pipeline_matches_sequential(case):
    (w, b, x), ranks = case

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    ref = jnp.asarray(x)
    for s in range(S):
        ps = {"w": jnp.asarray(w[s]), "b": jnp.asarray(b[s])}
        ref = jax.vmap(lambda h: stage_fn(ps, h))(ref)
    for rank in ranks:  # every rank returns the last stage's outputs
        assert rank["got"].shape == (M, MB, D)
        err = float(np.max(np.abs(rank["got"].numpy() - np.asarray(ref))))
        assert err < 1e-5, err


def test_pipeline_is_the_ports_sequential_stack_bitwise(case):
    _, ranks = case
    for rank in ranks:
        assert torch.equal(rank["got"], ranks[0]["got"])
        assert torch.equal(rank["got"], rank["sequential"])


def test_a_stage_dim_other_than_the_group_size_raises(case):
    _, ranks = case
    assert all(r["refused"] == f"stage_params leading dim {S - 1} != pipeline size {S}"
               for r in ranks)
