"""The rule-sharded train step on a ("data", "model") mesh on gloo ranks on
the CPU: ``shard_lm`` places the parameters on "model" by ``RULES_TRAIN``
(tensor and expert parallelism) and shards them over "data" with FSDP2
(FSDP2 x TP); three steps of smollm's, mixtral's and jamba's smoke configs
in float32 on (1, 2) and (2, 2) meshes against the port's single-process
step on the same global batches (``test_torch_train.py``'s tolerances:
losses, gradient norms and the parameters after three steps), and on a
(1, 1) mesh bit for bit.  A mutant whose regions take the gradient of
their replicated inputs (the scan's B and C, a kv head several ranks read,
a column-parallel product's input) as replicated instead of as partial
sums (``grad_placements`` left out) must fail the same comparison."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_gloo import run_ranks
from repro.configs import smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.train import optimizer, step

# test_torch_train.py's tolerances (test_three_train_steps_match_reference)
METRIC_RTOL = 1e-4
PARAM_TOL, PARAM_SHARE, PARAM_MAX = 2e-6, 0.999, 1e-4
# ROADMAP.md queue C #22 (test_torch_moe_train.py's C22_NEAR_ZERO): an element
# whose first-step gradient lies this far below its tensor's rms gradient
# takes an Adam first step of about lr times its sign, which float32 noise
# in the gradient moves by more than PARAM_TOL (jamba's blocks.1.ssm.D,
# element 14, 2.1e-6 off); such an element is held to PARAM_MAX alone
C22_NEAR_ZERO = 1e-4
ARCHS = ("smollm-360m", "mixtral-8x7b", "jamba-1.5-large-398b")


def _opt():
    return optimizer.AdamWConfig(lr=optimizer.warmup_cosine(1e-3, warmup=1, total=3),
                                 weight_decay=0.01, clip_norm=1.0)


def _batches(cfg) -> list:
    """Three global batches of 4 x 32 (test_torch_moe_train.py's draws)."""
    out = []
    for micro in range(3):
        rng = np.random.default_rng(micro)
        seq = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(seq[:, :-1]),
                    "labels": torch.from_numpy(seq[:, 1:])})
    return out


def _case(arch):
    """The smoke config in float32 with the JAX package's weights (its
    ``init`` at key 0, as ``test_torch_moe_train.py`` draws them: on other
    draws a gradient element can lie within float32 noise of zero, where
    Adam's first step, about lr times its sign, is ill-conditioned and a
    sum in another order moves that weight by up to 2 lr)."""
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    jparams, _ = RefModel(dataclasses.replace(ref_smoke_config(arch), param_dtype="float32",
                                              compute_dtype="float32")).init(
        jax.random.PRNGKey(0))
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, {n: p.detach().clone() for n, p in lm.named_parameters()}, _batches(cfg)


@pytest.fixture(scope="module")
def cases():
    return {arch: _case(arch) for arch in (*ARCHS, "falcon-mamba-7b")}


@pytest.fixture(scope="module")
def plain(cases):
    """The single-process step on the global batches, and the elements
    whose first-step gradient lies near zero (C #22)."""
    from repro_torch.precision import full_float32_matmul

    out = {}
    for arch, (cfg, params, batches) in cases.items():
        model = Model(cfg)
        lm = model.init(device="cpu")
        with torch.no_grad():
            for name, p in lm.named_parameters():
                p.copy_(params[name])
        with torch.enable_grad(), full_float32_matmul():
            total, _, _ = step.make_loss_fn(model)(lm, batches[0])
            grads = torch.autograd.grad(total, list(lm.parameters()))
        near_zero = {n: g.abs() <= C22_NEAR_ZERO * g.square().mean().sqrt()
                     for (n, _), g in zip(lm.named_parameters(), grads)}
        state = step.make_train_state(model, _opt(), params=lm)
        fn = step.make_train_step(model, _opt())
        metrics = []
        for b in batches:
            state, m = fn(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = (metrics, {n: p.detach().clone() for n, p in lm.named_parameters()},
                     near_zero)
    return out


def _run(cases, shape, tmp, archs=ARCHS, mutant=False):
    ranks = run_ranks("tp_train", shape[0] * shape[1], tmp, shape,
                      [cases[a] for a in archs], mutant)
    return {a: [r[i] for r in ranks] for i, a in enumerate(archs)}


@pytest.fixture(scope="module")
def meshes(cases, tmp_path_factory):
    return {shape: _run(cases, shape, tmp_path_factory.mktemp(f"tp{shape[0]}{shape[1]}"))
            for shape in ((1, 1), (1, 2), (2, 2))}


def _close(got, want) -> list:
    """The failures of ``got`` (metrics, params) against ``want``."""
    bad = []
    for i, (m, w) in enumerate(zip(got[0], want[0])):
        for k in ("loss", "ce_loss", "z_loss", "grad_norm", "tokens"):
            if not np.isclose(m[k], w[k], rtol=METRIC_RTOL, atol=0):
                bad.append((k, i, m[k], w[k]))
    for name, p in got[1].items():
        err = (p - want[1][name]).abs()
        held = (err <= PARAM_TOL) | want[2][name]  # C #22's elements: PARAM_MAX alone
        if float(held.float().mean()) < PARAM_SHARE or float(err.max()) > PARAM_MAX:
            bad.append((name, float(err.max())))
    return bad


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_on_a_model_axis_match_the_plain_step(meshes, plain, arch, shape):
    for rank in meshes[shape][arch]:  # every rank reports the global batch's metrics
        assert _close(rank[:2], plain[arch]) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_the_plain_step_bitwise(meshes, plain, arch):
    (metrics, params, _), = meshes[(1, 1)][arch]
    want_m, want_p, _ = plain[arch]
    assert metrics == want_m
    assert all(torch.equal(params[n], t) for n, t in want_p.items())


def test_parameters_are_placed_on_both_dims(meshes):
    """FSDP2 over "data" on the embed dim, TP over "model" as the rules
    place it; the norms replicated on "model"."""
    from torch.distributed.tensor import Replicate, Shard

    placements = meshes[(2, 2)]["smollm-360m"][0][2]
    assert placements["embed"] == (Shard(1), Shard(0))  # (vocab, embed)
    assert placements["blocks.0.mlp.w_in"] == (Shard(0), Shard(1))  # (embed, mlp)
    assert placements["blocks.0.attn.wq"] == (Shard(0), Replicate())  # 3 heads on 2: whole
    assert placements["blocks.0.norm1.scale"] == (Shard(0), Replicate())
    jamba = meshes[(2, 2)]["jamba-1.5-large-398b"][0][2]
    assert jamba["blocks.1.moe.w_in"] == (Shard(1), Shard(0))  # (experts, embed, mlp): EP
    # the scan's D, sharded on its channels by "model" alone, stays outside FSDP2
    assert jamba["blocks.0.ssm.D"] == (Shard(0),)


def test_leaving_out_the_partial_gradient_placement_fails(cases, plain, tmp_path_factory):
    """The kv head smollm's two query-head ranks share and the scan's B and
    C are read whole by each rank: their gradient is a partial sum.  With
    ``grad_placements`` left out the steps drift past the tolerances."""
    got = _run(cases, (1, 2), tmp_path_factory.mktemp("mutant"),
               ("smollm-360m", "falcon-mamba-7b"), mutant=True)
    for arch in ("smollm-360m", "falcon-mamba-7b"):
        assert _close(got[arch][0][:2], plain[arch]) != [], arch
