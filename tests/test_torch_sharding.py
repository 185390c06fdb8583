"""Sharding rules, DTensor placements and the sharding context, port
against the JAX package: ``test_sharding_rules.py``'s eight cases (here
with the same names) against ``repro_torch.distributed.sharding``; for
every registered config, every parameter and cache leaf, the four rule
sets and both fake meshes, the port's spec equal to the reference's entry
for entry (the reference's stacked parameter leaves lose their leading
``"stack"`` entry: the port keeps one block per layer; the caches keep
it on both sides); placements from specs; and, on one gloo rank, a
DTensor refused by every kernel dispatcher and redistributed by
``constrain_act`` inside a sharding context."""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from _torch_gloo import run_ranks
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as jsh
from repro.models import Model as RefModel
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.distributed.context import constrain_act, current_context, sharding_context
from repro_torch.distributed.sharding import (
    RULES_DECODE,
    RULES_DECODE_LONG,
    RULES_DECODE_WS,
    RULES_TRAIN,
    ShardingRules,
    mesh_view,
    placements_for_spec,
    spec_for_axes,
    tree_placements,
    tree_specs,
)
from repro_torch.models import Model


class FakeMesh:
    def __init__(self, shape: dict):
        self._shape = shape

    @property
    def shape(self):
        return self._shape

    @property
    def axis_names(self):
        return tuple(self._shape.keys())


MESH = FakeMesh({"data": 16, "model": 16})
MESH_POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
RULE_SETS = {"train": (RULES_TRAIN, jsh.RULES_TRAIN), "decode": (RULES_DECODE, jsh.RULES_DECODE),
             "decode_long": (RULES_DECODE_LONG, jsh.RULES_DECODE_LONG),
             "decode_ws": (RULES_DECODE_WS, jsh.RULES_DECODE_WS)}


def _p(*entries):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(P(*entries))


# ---------------------------------------- test_sharding_rules.py's eight cases
def test_basic_param_spec():
    spec = spec_for_axes(("vocab", "embed"), RULES_TRAIN, MESH, (32000, 4096))
    assert spec == _p("model", "data")


def test_strict_refuses_uneven():
    spec = spec_for_axes(("stack", "embed", "heads", "head_dim"),
                         RULES_TRAIN, MESH, (32, 960, 15, 64))
    assert spec == _p(None, "data")  # heads 15 % 16 != 0 -> replicated


def test_nonstrict_pads_mildly_uneven():
    spec = spec_for_axes(("batch", "seq", "act_heads", "head_dim"),
                         RULES_TRAIN, MESH, (256, 4096, 15, 64), strict=False)
    assert spec == _p("data", None, "model")  # 15 on 16: 6.7% pad, allowed


def test_fallthrough_expert_dim():
    # mixtral: 8 experts on a 16-way axis -> ff picks up "model" instead
    spec = spec_for_axes(("experts", "embed", "mlp"), RULES_TRAIN, MESH,
                         (8, 4096, 14336), strict=False)
    assert spec == _p(None, "data", "model")
    # phi3.5: 16 experts divide evenly -> EP on experts, ff replicated
    spec = spec_for_axes(("experts", "embed", "mlp"), RULES_TRAIN, MESH,
                         (16, 4096, 6400), strict=False)
    assert spec == _p("model", "data")


def test_axis_used_once():
    # both dims want "model": second falls back
    r = ShardingRules({"a": "model", "b": "model"})
    assert spec_for_axes(("a", "b"), r, MESH, (16, 16)) == _p("model")


def test_missing_mesh_axes_dropped():
    spec = spec_for_axes(("batch", "seq"), RULES_TRAIN, MESH, (256, 4096))
    assert spec == _p("data")  # ("pod","data") -> pod absent -> ("data",)
    spec = spec_for_axes(("batch", "seq"), RULES_TRAIN, MESH_POD, (256, 4096))
    assert spec == _p(("pod", "data"))


def test_decode_rules_cache_seq():
    ax = ("stack", "batch", "cache_seq", "kv_heads", "head_dim")
    spec = spec_for_axes(ax, RULES_DECODE, MESH, (32, 128, 32768, 8, 128))
    assert spec == _p(None, "data", "model")
    spec = spec_for_axes(ax, RULES_DECODE_LONG, MESH, (9, 1, 524288, 8, 128))
    assert spec == _p(None, None, ("data", "model"))


def test_override_is_nondestructive():
    r2 = RULES_TRAIN.override(vocab=None)
    assert r2.get("vocab") is None
    assert RULES_TRAIN.get("vocab") == "model"
    assert r2.get("mlp") == "model"


# ------------------------------------------------------------ parity
def test_the_rule_sets_are_the_references():
    for name, (mine, ref) in RULE_SETS.items():
        assert dict(mine.table) == dict(ref.table) and mine.name == ref.name == name


def _leaves(tree, prefix=()):
    """(path, leaf) of a tree of dicts whose leaves are axes tuples or
    shapes."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*prefix, k))
    else:
        yield prefix, tree


def _ref_path(cfg, name: str) -> tuple:
    """A port parameter's path in the reference's stacked tree: layer
    s P + i of ``blocks`` is entry s of ``blocks/sub_i`` (as
    ``convert.lm_from_jax`` maps it); each encdec stack holds one kind."""
    parts = name.split(".")
    if parts[0] == "blocks":
        P_ = cfg.attn_period if cfg.family == "hybrid" else 1
        return ("blocks", f"sub_{int(parts[1]) % P_}", *parts[2:])
    if parts[0] in ("enc_blocks", "dec_blocks"):
        return (parts[0], *parts[2:])
    return tuple(parts)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    ref_cfg, cfg = ref_get_config(name), get_config(name)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    jmodel = RefModel(ref_cfg)
    shapes, ref_axes = jmodel.shapes_and_axes()
    return cfg, _paired(ref_axes, shapes), _paired(
        jmodel.cache_axes(), jax.eval_shape(lambda: jmodel.init_cache(2, 64)))


def _paired(axes_tree, shapes_tree) -> dict:
    """path -> (axes, shape), matched by path."""
    shapes = {path: tuple(sh.shape) for path, sh in _leaves(shapes_tree)}
    axes = dict(_leaves(axes_tree))
    assert set(axes) == set(shapes)
    return {path: (ax, shapes[path]) for path, ax in axes.items()}


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("mesh", [MESH, MESH_POD], ids=["data16_model16", "pod2_data16_model16"])
def test_param_and_cache_specs_equal_the_references(arch, mesh, strict):
    cfg, ref_params, ref_cache = arch
    model = Model(cfg)
    axes = model.param_axes()
    assert {_ref_path(cfg, n) for n in axes} == set(ref_params)
    cache_axes = dict(_leaves(model.cache_axes()))
    assert set(cache_axes) == set(ref_cache)
    for rules, ref_rules in RULE_SETS.values():
        for name, ax in axes.items():
            ref_ax, ref_shape = ref_params[_ref_path(cfg, name)]
            want = tuple(jsh.spec_for_axes(ref_ax, ref_rules, mesh, ref_shape, strict=strict))
            if "blocks" in name.split(".")[0]:  # a layer: the stacked leaf without "stack"
                assert ref_ax[0] == "stack" and (not want or want[0] is None), name
                ref_ax, ref_shape, want = ref_ax[1:], ref_shape[1:], want[1:]
            assert ax == ref_ax, name
            got = spec_for_axes(ax, rules, mesh, ref_shape, strict=strict)
            assert got == want, (name, rules.name)
        for path, ax in cache_axes.items():
            ref_ax, ref_shape = ref_cache[path]
            assert ax == ref_ax, path
            want = tuple(jsh.spec_for_axes(ref_ax, ref_rules, mesh, ref_shape, strict=strict))
            assert spec_for_axes(ax, rules, mesh, ref_shape, strict=strict) == want, path


@pytest.mark.parametrize("name", ARCHS)
def test_param_axes_name_every_parameter_and_dim(name):
    """At the smoke size: one axes entry per parameter, one name per dim,
    and the cache's axes one per dim of every buffer."""
    cfg = smoke_config(name)
    model = Model(cfg)
    params = dict(model.init(device="cpu").named_parameters())
    axes = model.param_axes()
    assert set(axes) == set(params)
    assert all(len(axes[n]) == p.ndim for n, p in params.items())
    cache = dict(_leaves(model.init_cache(2, 16, device="meta")))
    cache_axes = dict(_leaves(model.cache_axes()))
    assert set(cache) == set(cache_axes)
    assert all(len(cache_axes[k]) == t.ndim for k, t in cache.items())
    specs = dict(_leaves(tree_specs(model.cache_axes(), RULES_DECODE, MESH, model.init_cache(
        2, 16, device="meta"))))
    assert set(specs) == set(cache)


# ------------------------------------------------------------ placements
class _Mesh:
    """What placements_for_spec reads of a DeviceMesh."""

    def __init__(self, names, shape):
        self.mesh_dim_names = names
        self.mesh = torch.empty(shape)


def test_placements_follow_the_spec_per_mesh_dim():
    mesh = _Mesh(("pod", "data", "model"), (2, 2, 2))
    assert placements_for_spec(_p("model", "data"), mesh) == (Replicate(), Shard(1), Shard(0))
    assert placements_for_spec(_p(None, ("pod", "data")), mesh) == (Shard(1), Shard(1),
                                                                     Replicate())
    assert placements_for_spec((), mesh) == (Replicate(),) * 3
    assert mesh_view(mesh).shape == {"pod": 2, "data": 2, "model": 2}
    with pytest.raises(ValueError, match="two dims"):
        placements_for_spec(("data", "data"), mesh)
    with pytest.raises(ValueError, match="names mesh axis"):
        placements_for_spec(("expert",), mesh)


def test_tree_placements_place_every_leaf_by_its_strict_spec():
    mesh = _Mesh(("data", "model"), (2, 4))
    axes = {"embed": ("vocab", "embed"), "blk": {"wq": ("embed", "heads", "head_dim")}}
    shapes = {"embed": (32, 64), "blk": {"wq": (64, 6, 16)}}  # 6 heads on 4: replicated
    assert tree_placements(axes, RULES_TRAIN, mesh, shapes) == {
        "embed": (Shard(1), Shard(0)), "blk": {"wq": (Shard(0), Replicate())}}
    assert tree_placements(axes, RULES_TRAIN, mesh)["blk"]["wq"] == (Shard(0), Shard(1))


def test_constrain_act_is_the_identity_without_a_context():
    x = torch.randn(2, 3)
    assert current_context() is None
    assert constrain_act(x, ("batch",)) is x  # no context: no rank check either
    with sharding_context(MESH, RULES_TRAIN):
        assert current_context() == (MESH, RULES_TRAIN)
        assert constrain_act(x, ("batch", "act_embed")) is x  # a plain tensor stays
        with pytest.raises(ValueError, match="rank-2"):
            constrain_act(x, ("batch",))
    assert current_context() is None


# ------------------------------------------------------------ DTensors
@pytest.fixture(scope="module")
def dtensor(tmp_path_factory):
    (out,) = run_ranks("dtensor_checks", 1, tmp_path_factory.mktemp("dtensor"))
    return out


@pytest.mark.parametrize("op", ["ell_to_dense", "flash_attention", "ssm_scan", "ssm_scan_vjp"])
def test_a_dtensor_reaching_a_kernel_dispatcher_raises(dtensor, op):
    assert dtensor[op].startswith(f"{op} takes plain tensors, got a DTensor")


def test_global_norm_refuses_a_mix_of_dtensors_and_tensors(dtensor):
    assert "a mix of DTensors and plain tensors" in dtensor["global_norm"]


def test_constrain_act_redistributes_a_dtensor_in_a_context(dtensor):
    assert dtensor["no_context"] == (Replicate(),)
    assert dtensor["in_context"] == (Shard(0),)  # "batch" -> ("pod", "data") -> "data"
    assert dtensor["in_context_equal"]
    assert "rank-3" in dtensor["rank_check"]
