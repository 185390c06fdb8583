"""The elastic re-mesh (``repro_torch.distributed.fault.reshard_for_mesh``)
against ``tests/test_elastic.py::test_elastic_remesh_subprocess``'s script,
on 8 gloo ranks: a (32, 64) ``("vocab", "embed")`` leaf saved from a
(2 data, 4 model) mesh restores bit for bit onto the transposed (4, 2)
mesh, placed by ``RULES_TRAIN`` there, with the loader state; a (6, 64)
leaf is refused on the (2, 4) mesh under ``strict`` with the reference's
message and replicated along "vocab" with ``strict=False``.  Across the
model axis at gloo size: a whole model's parameters (smollm's smoke
config) placed on a (1 data, 2 model) mesh, saved with a loader state and
restored onto (2, 1), bit for bit, each placed by ``RULES_TRAIN`` there."""
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from _torch_gloo import run_ranks
from repro_torch.configs import smoke_config
from repro_torch.distributed.sharding import RULES_TRAIN, MeshView, spec_for_axes
from repro_torch.models import Model

MESH_A = (2, 4)  # ("data", "model"); restored onto (4, 2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("remesh")
    return run_ranks("remesh", MESH_A[0] * MESH_A[1], tmp, MESH_A, str(tmp / "ck"))


def test_elastic_remesh_restores_on_the_transposed_mesh(ranks):
    want = torch.arange(32 * 64, dtype=torch.float32).reshape(32, 64)
    for rank in ranks:
        # vocab -> "model", embed -> "data": one placement per mesh dim
        assert rank["even_saved_placements"] == (Shard(1), Shard(0))
        got = rank["even"]
        assert got["mesh"] == (4, 2) and got["placements"] == (Shard(1), Shard(0))
        assert torch.equal(got["full"], want)
        assert got["local"].shape == (16, 16)  # 32 / 2 model x 64 / 4 data
        assert rank["manifest"]["loader_state"]["fetch_cursor"] == 3


def test_an_undivisible_mesh_is_refused_unless_not_strict(ranks):
    want = torch.arange(6 * 64, dtype=torch.float32).reshape(6, 64)
    for rank in ranks:
        msg = rank["refused"]
        assert "not divisible" in msg and "vocab" in msg, msg
        assert "strict=False" in msg, msg
        got = rank["odd"]
        assert got["placements"] == (Shard(1), Replicate())  # vocab 6 on 4: replicated
        assert torch.equal(got["full"], want)
        assert got["local"].shape == (6, 32)


def test_a_model_state_remeshes_across_the_model_axis(tmp_path):
    cfg = smoke_config("smollm-360m")
    model = Model(cfg)
    lm = model.init(device="cpu", generator=torch.Generator().manual_seed(2))
    params = {n: p.detach().clone() for n, p in lm.named_parameters()}
    ranks = run_ranks("remesh_model", 2, tmp_path, cfg, params, str(tmp_path / "ck"))
    axes = model.param_axes()
    for rank in ranks:
        assert rank["loader_state"]["fetch_cursor"] == 3
        for name, want in params.items():
            assert torch.equal(rank["full"][name], want), name
            for placements, shape in ((rank["saved"][name], {"data": 1, "model": 2}),
                                      (rank["placements"][name], {"data": 2, "model": 1})):
                spec = spec_for_axes(axes[name], RULES_TRAIN, MeshView(shape),
                                     tuple(want.shape))
                for i, dim in enumerate(("data", "model")):
                    hit = [j for j, e in enumerate(spec) if e == dim]
                    assert placements[i] == (Shard(hit[0]) if hit else Replicate()), name
        # the vocabulary on "model" when saved, the embed dim on "data" when restored
        assert rank["saved"]["embed"] == (Shard(1), Shard(0))
        assert rank["placements"]["embed"] == (Shard(1), Shard(0))
