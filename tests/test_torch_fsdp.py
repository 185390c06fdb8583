"""The rule-sharded train step (the reference's ``grad_shardings`` path)
on gloo ranks on the CPU: ``shard_lm`` wraps each block and the model in
FSDP2's ``fully_shard`` over the mesh's "data" dim, each parameter sharded
on the dim ``RULES_TRAIN`` puts on "data"; three steps of smollm's smoke
config on 2 ranks, each rank fed its half of every global batch (the third
batch masked, with unequal token counts on the two ranks), against the
JAX package's step from the same weights (``test_torch_train.py``'s
tolerances) and against the port's single-process step; ``remat="full"``
and ``"dots"`` under FSDP2 against ``"none"`` bitwise; the sharded
checkpoint (saved whole) restored into a fresh sharded state bitwise; on
one rank, the sharded step is the plain step bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from _torch_gloo import run_ranks
from repro.configs import smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.distributed.sharding import RULES_TRAIN, MeshView, spec_for_axes
from repro_torch.models import Model
from repro_torch.train import optimizer, step

# test_torch_train.py's tolerances (test_three_train_steps_match_reference)
METRIC_RTOL = 1e-4
PARAM_TOL, PARAM_SHARE, PARAM_MAX = 2e-6, 0.999, 1e-4
LR_RTOL = 2.4e-7
REMATS = ("none", "full", "dots")
# bf16 gradients summed in another order (2 ranks' halves rounded to bf16
# before their sum; the encoder output's share from each decoder block):
# the gradient norm moves by a few 1e-3, an Adam update where a gradient
# lies near zero may flip, and a weight may round to the neighbouring bf16
# value: each weight within 3 lr (3 steps, each moving a weight by at most
# about lr) plus one bf16 ulp (at most 2**-7 of it)
BF16_LOSS_RTOL, BF16_GNORM_RTOL, BF16_PARAM_MAX, BF16_ULP = 1e-4, 5e-3, 3e-3, 2.0**-7


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _batches(vocab: int) -> list:
    """Three global batches of 4 x 32; the third masked so that rank 0's
    half counts 55 tokens and rank 1's 14."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(3):
        seq = rng.integers(0, vocab, (4, 33)).astype(np.int32)
        b = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if i == 2:
            mask = np.zeros((4, 32), np.float32)
            for row, n in enumerate((30, 25, 5, 9)):
                mask[row, :n] = 1
            b["mask"] = mask
        out.append(b)
    return out


def _opt():
    return optimizer.AdamWConfig(lr=optimizer.warmup_cosine(1e-3, warmup=1, total=3),
                                 weight_decay=0.01, clip_norm=1.0)


@pytest.fixture(scope="module")
def setup():
    ref_cfg, cfg = _f32(ref_smoke_config("smollm-360m")), _f32(smoke_config("smollm-360m"))
    jmodel = RefModel(ref_cfg)
    jcfg = jopt.AdamWConfig(lr=jopt.warmup_cosine(1e-3, warmup=1, total=3), weight_decay=0.01,
                            clip_norm=1.0)
    jstate = jstep.make_train_state(jmodel, jax.random.PRNGKey(0), jcfg)
    lm = convert.lm_from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu")
    params = {n: p.detach().clone() for n, p in lm.named_parameters()}
    batches = _batches(cfg.vocab_size)
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg))
    jmetrics = []
    for b in batches:
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jmetrics.append({k: float(v) for k, v in jm.items()})
    want = {n: p.detach() for n, p in convert.lm_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu").named_parameters()}
    torch_batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    return cfg, params, torch_batches, jmetrics, want


def _bf16_case(arch: str, batches: list):
    cfg = dataclasses.replace(smoke_config(arch), remat="full")
    lm = Model(cfg).init(device="cpu", generator=torch.Generator().manual_seed(4))
    if cfg.family == "encdec":  # its own frames beside the tokens
        rng = np.random.default_rng(1)
        batches = [{**b, "frames": torch.from_numpy(
            rng.normal(0, 1, (4, 24, cfg.d_model)).astype(np.float32))} for b in batches]
    return cfg, {n: p.detach().clone() for n, p in lm.named_parameters()}, batches, ("full",)


@pytest.fixture(scope="module")
def bf16_cases(setup):
    batches = setup[2]
    return {arch: _bf16_case(arch, batches)
            for arch in ("smollm-360m", "jamba-1.5-large-398b", "whisper-large-v3")}


@pytest.fixture(scope="module")
def bf16_plain(bf16_cases):
    return {arch: _plain_run(cfg, params, batches, "full")
            for arch, (cfg, params, batches, _) in bf16_cases.items()}


@pytest.fixture(scope="module")
def two_ranks(setup, bf16_cases, tmp_path_factory):
    cfg, params, batches, _, _ = setup
    tmp = tmp_path_factory.mktemp("fsdp2")
    ranks = run_ranks("fsdp_cases", 2, tmp, [(cfg, params, batches, REMATS, str(tmp / "ck")),
                                              bf16_cases["smollm-360m"]])
    return [r[0] for r in ranks], [r[1] for r in ranks]


@pytest.fixture(scope="module")
def one_rank(setup, bf16_cases, tmp_path_factory):
    cfg, params, batches, _, _ = setup
    (got,) = run_ranks("fsdp_cases", 1, tmp_path_factory.mktemp("fsdp1"),
                       [(cfg, params, batches, ("none",)), *bf16_cases.values()])
    return got


def _plain_run(cfg, params: dict, batches: list, remat: str = "none"):
    """The port's single-process step on the global batches."""
    model = Model(dataclasses.replace(cfg, remat=remat))
    lm = model.init(device="cpu")
    with torch.no_grad():
        for name, p in lm.named_parameters():
            p.copy_(params[name])
    state = step.make_train_state(model, _opt(), params=lm)
    fn = step.make_train_step(model, _opt())
    metrics = []
    for b in batches:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {n: p.detach().clone() for n, p in lm.named_parameters()}


@pytest.fixture(scope="module")
def plain(setup):
    cfg, params, batches, _, _ = setup
    return _plain_run(cfg, params, batches)


def _close_params(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, p in got.items():
        err = (p - want[name]).abs()
        assert float((err <= PARAM_TOL).float().mean()) >= PARAM_SHARE, name
        assert float(err.max()) <= PARAM_MAX, (name, float(err.max()))


def _bf16_close(got: dict, want: dict) -> None:
    for name, p in got.items():
        w = want[name].float()
        assert bool(((p.float() - w).abs() <= BF16_PARAM_MAX + BF16_ULP * w.abs()).all()), name


def _close_metrics(got: list, want: list) -> None:
    for i, (m, jm) in enumerate(zip(got, want)):
        assert set(m) == set(jm) == {"loss", "ce_loss", "z_loss", "ppl_proxy", "tokens",
                                     "grad_norm", "lr"}
        for k in m:
            rtol = LR_RTOL if k == "lr" else METRIC_RTOL
            np.testing.assert_allclose(m[k], jm[k], rtol=rtol, err_msg=f"{k} step {i}")


def test_three_rule_sharded_steps_match_the_reference(setup, two_ranks):
    _, _, batches, jmetrics, want = setup
    for rank in two_ranks[0]:  # every rank reports the global batch's metrics
        metrics, full = rank["none"]
        _close_metrics(metrics, jmetrics)
        _close_params(full, want)
    assert jmetrics[2]["tokens"] == 69.0  # 55 + 14 under the mask


def test_rule_sharded_steps_match_the_single_process_step(two_ranks, plain):
    metrics, full = two_ranks[0][0]["none"]
    _close_metrics(metrics, plain[0])
    _close_params(full, plain[1])


def test_each_parameter_and_moment_is_sharded_on_its_fsdp_dim(setup, two_ranks):
    cfg = setup[0]
    axes = Model(cfg).param_axes()
    placements = two_ranks[0][0]["placements"]
    assert set(placements) == set(axes)
    for name, ax in axes.items():
        spec = spec_for_axes(ax, RULES_TRAIN, MeshView({"data": 2}), tuple(setup[1][name].shape))
        want = Shard(spec.index("data")) if "data" in spec else Shard(0)
        assert placements[name] == (want,), name
        assert two_ranks[0][0]["moments"][name] == (want,), name
    assert placements["blocks.0.attn.wo"] == (Shard(2),)  # (heads, head_dim, embed)
    assert placements["embed"] == (Shard(1),)  # (vocab, embed)


def test_remat_full_and_dots_under_fsdp_are_none_bitwise(two_ranks):
    for rank in two_ranks[0]:
        none = rank["none"]
        for remat in ("full", "dots"):
            assert rank[remat][0] == none[0], remat
            assert all(torch.equal(rank[remat][1][n], t) for n, t in none[1].items()), remat


def test_sharded_checkpoint_restores_into_shards_bitwise(two_ranks):
    for rank in two_ranks[0]:
        restored, last = rank["restored"], rank[REMATS[-1]][1]
        assert restored["step"] == restored["count"] == 3
        assert all(torch.equal(restored["params"][n], t) for n, t in last.items())
        assert set(restored["m"]) == set(restored["v"]) == set(last)


def test_a_model_dim_is_refused(two_ranks):
    """A mesh of a "model" dim alone is refused (the step shards its batch
    over "data"); a "model" dim beside "data" is the tensor-parallel
    route (``tests/test_torch_tp_train.py``)."""
    assert "needs a 'data' dim" in two_ranks[0][0]["model_dim_refused"]


def test_bf16_keeps_the_float32_parameters_whole_and_matches(bf16_cases, bf16_plain, two_ranks):
    params = bf16_cases["smollm-360m"][1]
    metrics, want = bf16_plain["smollm-360m"]
    for rank in two_ranks[1]:
        for name, placement in rank["placements"].items():
            if params[name].dtype == torch.float32:  # the norms
                assert placement is None and rank["moments"][name] is None, name
            else:
                assert placement is not None and placement[0].is_shard(), name
        got, full = rank["full"]
        for m, w in zip(got, metrics):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=BF16_LOSS_RTOL)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=BF16_GNORM_RTOL)
        _bf16_close(full, want)


def test_one_rank_sharded_step_is_the_plain_step_bitwise(plain, bf16_plain, one_rank):
    cases = [(plain, one_rank[0]["none"])]
    for got, (arch, want) in zip(one_rank[1:], bf16_plain.items()):
        if arch != "whisper-large-v3":
            cases.append((want, got["full"]))
    for (want_m, want_p), (metrics, full) in cases:
        assert metrics == want_m
        assert all(torch.equal(full[n], t) for n, t in want_p.items())


def test_one_rank_sharded_encdec_step_matches_the_plain_step(bf16_plain, one_rank):
    """Not bitwise: the encoder's output feeds every decoder block, and
    FSDP2's per-block autograd hooks change the order in which its bf16
    gradient adds up the blocks' shares (the loss is bitwise)."""
    want_m, want_p = bf16_plain["whisper-large-v3"]
    metrics, full = one_rank[3]["full"]
    for m, w in zip(metrics, want_m):
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=BF16_GNORM_RTOL)
    assert metrics[0]["loss"] == want_m[0]["loss"]
    _bf16_close(full, want_p)

