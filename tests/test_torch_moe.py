"""The MoE FFN, port against the JAX package on the CPU: ``moe_apply`` on
the same inputs (numpy, seeded) and the same weights (drawn by ``repro``),
its group count, its routing and dispatch, capacity drops, ties, and the
router's aux losses; with and without ``REPRO_PAPER_BASELINE=1``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import moe as jmoe
from repro_torch.configs import smoke_config
from repro_torch.models import moe

# float32: the same products summed in another order (router logits over
# d, expert products over d and ff, the combine over k slots); the outputs
# are large (the experts' weights have the reference's 1/sqrt(E) scale),
# so the tolerance is relative to the output's largest value
F32_RTOL = 2e-5
# bf16 dispatch and products: both sides round every product's output to
# bf16 (one ulp is 2**-8 of a value), in another order of sums over d and
# ff; measured against the largest output
BF16_RTOL = 2**-6
# the aux losses are float32 means of float32 softmaxes: a few ulps apart
AUX_TOL = 1e-6
ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
# (B, S, target_group_tokens, group_mult): no target, a target above S,
# targets that split S into 2, 4 and 8 pieces, S odd or not a power of two
# (the split stops where S stops halving), and multipliers that do not
# divide B S (lowered until they do)
GROUP_GRID = [(1, 1, None, 1), (3, 6, None, 3), (2, 16, None, 1), (1, 7, None, 3),
              (2, 6, 32, 1), (2, 64, 8, 1), (3, 16, 4, 3), (2, 24, 4, 1), (1, 64, 32, 3),
              (3, 5, 1, 1), (2, 48, 8, 2)]


class _Einsums:
    """Stands in for ``jnp`` in ``repro.models.moe``: records the result of
    each einsum by its equation, so a test can read the reference's
    dispatch and combine tensors."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, eq, *operands, **kw):
        out = jnp.einsum(eq, *operands, **kw)
        self.seen[eq] = np.asarray(out.astype(jnp.float32))
        return out


def _cfg(arch, dtype, **moe_kw):
    kw = {"param_dtype": dtype, "compute_dtype": dtype}
    ref_cfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    if moe_kw:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    ref_cfg, cfg = dataclasses.replace(ref_cfg, **kw), dataclasses.replace(cfg, **kw)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    return ref_cfg, cfg


def _weights(ref_cfg, seed=0, router=None):
    """The reference's draw, as (jax tree, torch dict of the same values)."""
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(seed), ref_cfg)
    if router is not None:
        jp["router"] = jnp.asarray(router, jp["router"].dtype)
    tp = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(getattr(torch, ref_cfg.param_dtype))
          for k, v in jp.items()}
    return jp, tp


def _x(cfg, B, S, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    dt = getattr(torch, cfg.compute_dtype)
    return jnp.asarray(x, getattr(jnp, cfg.compute_dtype)), torch.from_numpy(x).to(dt)


def _run_ref(monkeypatch, jp, ref_cfg, jx, **kw):
    rec = _Einsums()
    monkeypatch.setattr(jmoe, "jnp", rec)
    y, aux = jmoe.moe_apply(jp, ref_cfg, jx, **kw)
    monkeypatch.setattr(jmoe, "jnp", jnp)
    return np.asarray(y.astype(jnp.float32)), aux, rec.seen


@pytest.mark.parametrize("baseline", [False, True], ids=["optimized", "paper_baseline"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(monkeypatch, arch, dtype, baseline):
    if baseline:
        monkeypatch.setenv("REPRO_PAPER_BASELINE", "1")
    ref_cfg, cfg = _cfg(arch, dtype, target_group_tokens=8)
    jp, tp = _weights(ref_cfg)
    jx, tx = _x(cfg, 2, 24)
    want, want_aux, seen = _run_ref(monkeypatch, jp, ref_cfg, jx)
    got, aux = moe.moe_apply(tp, cfg, tx)
    # under the baseline the combine is float32, so the output is too
    assert got.dtype == (torch.float32 if baseline else getattr(torch, dtype))
    assert got.shape == tx.shape
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]), rtol=AUX_TOL,
                                   atol=AUX_TOL, err_msg=name)
    # the dispatch tensor: 0 and 1 in either type, bitwise the reference's
    G = seen["gsd,de->gse"].shape[0]
    r = moe.moe_dispatch(tp, cfg, tx.reshape(G, -1, cfg.d_model))
    assert r.disp.dtype == (torch.float32 if baseline else getattr(torch, dtype))
    np.testing.assert_array_equal(r.disp.float().numpy(), seen["gske,gskc->gsec"])


@pytest.mark.parametrize("baseline", [False, True], ids=["optimized", "paper_baseline"])
def test_group_count_matches_reference(monkeypatch, baseline):
    """G for a grid of (B, S, target_group_tokens, group_mult): the number
    of groups the reference's router einsum runs over."""
    if baseline:
        monkeypatch.setenv("REPRO_PAPER_BASELINE", "1")
    jp, _ = _weights(_cfg("mixtral-8x7b", "float32")[0])
    for B, S, tgt, mult in GROUP_GRID:
        ref_cfg, cfg = _cfg("mixtral-8x7b", "float32", target_group_tokens=tgt, group_mult=mult)
        jx, _ = _x(cfg, B, S)
        _, _, seen = _run_ref(monkeypatch, jp, ref_cfg, jx)
        want = seen["gsd,de->gse"].shape[0]
        assert moe.group_count(cfg.moe, B, S) == want, (B, S, tgt, mult)
    assert moe.group_count(cfg.moe, 2, 6, groups=5) == 4  # lowered until it divides 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_drops_keep_and_dispatch_bitwise(monkeypatch, dtype):
    """Capacity factor 0.5 and a router that favours expert 0: most pairs
    overflow their expert's queue.  The kept pairs (read from the dispatch
    tensor) and the dispatch tensor itself are the reference's, bitwise;
    the combine tensor's gates within float32 rounding."""
    ref_cfg, cfg = _cfg("mixtral-8x7b", dtype, capacity_factor=0.5, target_group_tokens=16)
    rng = np.random.default_rng(7)
    router = rng.normal(0, 0.05, (cfg.d_model, cfg.moe.num_experts)).astype(np.float32)
    router[:, 0] += 0.5
    jp, tp = _weights(ref_cfg, router=router)
    jx, tx = _x(cfg, 2, 32, seed=3)
    want, _, seen = _run_ref(monkeypatch, jp, ref_cfg, jx)
    G = seen["gsd,de->gse"].shape[0]
    r = moe.moe_dispatch(tp, cfg, tx.reshape(G, -1, cfg.d_model))
    C = r.disp.shape[-1]
    assert C == int(np.ceil(r.disp.shape[1] * cfg.moe.top_k * 0.5 / cfg.moe.num_experts))
    assert not bool(r.keep.all()), "no pair was dropped: the case does not test drops"
    disp = r.disp.float().numpy()
    np.testing.assert_array_equal(disp, seen["gske,gskc->gsec"])
    kept = np.take_along_axis(disp.sum(-1), r.expert_ids.numpy(), axis=2) > 0  # (G, Sg, k)
    np.testing.assert_array_equal(kept, r.keep.numpy())
    np.testing.assert_allclose(r.comb.float().numpy(), seen["gsk,gske,gskc->gsec"],
                               rtol=0, atol=1e-6 if dtype == "float32" else 2**-8)
    got, _ = moe.moe_apply(tp, cfg, tx)
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("router_kind", ["zero", "two_equal_columns"])
def test_tied_router_probabilities_pick_the_lower_expert(monkeypatch, router_kind):
    """Exact ties in the router's probabilities: ``jax.lax.top_k`` takes
    the lower expert index first, and so does the port."""
    ref_cfg, cfg = _cfg("phi3.5-moe-42b-a6.6b", "float32", target_group_tokens=8)
    E = cfg.moe.num_experts
    if router_kind == "zero":  # every expert ties: experts 0 and 1 for every token
        router = np.zeros((cfg.d_model, E), np.float32)
    else:  # experts 1 and 3 tie, above the rest: 1 then 3
        router = np.zeros((cfg.d_model, E), np.float32)
        router[:, 1] = router[:, 3] = np.random.default_rng(2).normal(0, 1, cfg.d_model)
    jp, tp = _weights(ref_cfg, router=router)
    jx, tx = _x(cfg, 2, 16, seed=5)
    if router_kind == "two_equal_columns":  # the pair ranks first for every token
        tx = tx.abs()
        jx = jnp.abs(jx)
        tp["router"][:, 1].abs_()
        tp["router"][:, 3].abs_()
        jp["router"] = jnp.asarray(tp["router"].numpy())
    _, _, seen = _run_ref(monkeypatch, jp, ref_cfg, jx)
    G = seen["gsd,de->gse"].shape[0]
    r = moe.moe_dispatch(tp, cfg, tx.reshape(G, -1, cfg.d_model))
    want_ids = (0, 1) if router_kind == "zero" else (1, 3)
    assert bool((r.expert_ids == torch.tensor(want_ids)).all())
    np.testing.assert_array_equal(r.disp.numpy(), seen["gske,gskc->gsec"])


def test_a_decode_step_routes_each_slot_alone():
    """One token a slot: G = B, so each slot is routed in a group of its
    own.  A batch of B routes every slot as B batches of one do: the same
    experts, kept pairs and dispatch tensor, bitwise; the gates, the
    combine tensor and the outputs within float32 rounding (the router's
    and the experts' products run at another batch size, which sums in
    another order)."""
    ref_cfg, cfg = _cfg("mixtral-8x7b", "float32")
    _, tp = _weights(ref_cfg)
    _, tx = _x(cfg, 5, 1, seed=9)
    assert moe.group_count(cfg.moe, 5, 1) == 5
    batched = moe.moe_dispatch(tp, cfg, tx.reshape(5, 1, cfg.d_model))
    alone = [moe.moe_dispatch(tp, cfg, tx[i].reshape(1, 1, cfg.d_model)) for i in range(5)]
    for field in ("expert_ids", "keep", "disp"):
        assert torch.equal(getattr(batched, field), torch.cat([getattr(a, field) for a in alone])), field
    for field in ("gates", "comb"):
        torch.testing.assert_close(getattr(batched, field), torch.cat([getattr(a, field) for a in alone]),
                                   rtol=0, atol=1e-6)
    y, _ = moe.moe_apply(tp, cfg, tx)
    y1 = torch.cat([moe.moe_apply(tp, cfg, tx[i:i + 1])[0] for i in range(5)])
    np.testing.assert_allclose(y.numpy(), y1.numpy(), rtol=0, atol=1e-6 * y1.abs().max().item())
