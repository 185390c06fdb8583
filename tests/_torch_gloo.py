"""Multi-rank runs of the port on the CPU: ``run_ranks`` spawns ``world``
processes joined in a gloo group through a ``FileStore`` under the test's
``tmp_path`` (no network), runs one of the workers below in each and
returns what each rank's worker returned.  A run that does not end within
``timeout`` seconds (the reference's subprocess tests allow 300) is killed
and fails the test instead of stalling it.

The workers import the port only (torch, numpy and ``repro_torch``), so a
child starts without JAX; the tests compute the references in the parent.
"""
import faulthandler
import os
import pickle
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 300.0


def _child(rank: int, world: int, store_path: str, out_dir: str, worker: str, args: tuple,
           timeout: float):
    torch.set_num_threads(1)
    # a rank still running near the parent's deadline prints where it waits
    faulthandler.dump_traceback_later(max(1.0, timeout - 10.0), file=sys.stderr)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            result = globals()[worker](rank, world, *args)
        finally:
            dist.destroy_process_group()
        payload = ("ok", result)
    except BaseException:  # noqa: BLE001 - handed to the parent, which fails the test
        payload = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)


def run_ranks(worker: str, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT_S) -> list:
    """``worker(rank, world, *args)`` on ``world`` gloo ranks; the list of
    their results by rank.  Raises ``AssertionError`` with a rank's
    traceback if one failed, or if the run outlasted ``timeout``."""
    out_dir = os.path.join(str(tmp_path), f"ranks_{worker}_{world}_{time.monotonic_ns()}")
    os.makedirs(out_dir)
    store_path = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_child, args=(world, store_path, out_dir, worker, args, timeout),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{worker} on {world} ranks outlasted {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise AssertionError(f"rank {rank} of {worker}:\n{value}")
        results.append(value)
    return results


# ------------------------------------------------------------------ workers
def fsdp_train(rank: int, world: int, cfg, params: dict, batches: list, remats: tuple,
               ckpt_dir=None):
    """Three (len(batches)) rule-sharded steps of ``cfg`` from ``params``
    on a (world, 1) ("data", "model") mesh, once per ``remat``, each rank
    fed its slice of every global batch; -> {remat: (metrics per step,
    the full parameters after the steps)}.  With ``ckpt_dir``, the last
    run's state is saved there after its last step."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import Model
    from repro_torch.train import optimizer, step

    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    tcfg = optimizer.AdamWConfig(lr=optimizer.warmup_cosine(1e-3, warmup=1, total=3),
                                 weight_decay=0.01, clip_norm=1.0)
    out = {}
    for remat in remats:
        model = Model(dataclasses.replace(cfg, remat=remat))
        lm = model.init(device="cpu")
        with torch.no_grad():
            for name, p in lm.named_parameters():
                p.copy_(params[name])
        step.shard_lm(model, lm, mesh)
        state = step.make_train_state(model, tcfg, params=lm)
        fn = step.make_train_step(model, tcfg)
        metrics = []
        for batch in batches:
            n = batch["tokens"].shape[0] // world
            local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
            state, m = fn(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        full = {name: _whole(p) for name, p in lm.named_parameters()}
        out[remat] = (metrics, full)
        out["placements"] = {name: _placements(p) for name, p in lm.named_parameters()}
        out["moments"] = {name: _placements(t) for name, t in state["opt"].m.items()}
    if ckpt_dir is not None:  # the last run's state, saved whole and restored sharded
        tree = step.train_state_tree(state)  # a gather: every rank
        if rank == 0:
            CheckpointManager(ckpt_dir).save(state["step"], tree,
                                             loader_state={"seed": 0, "epoch": 0, "fetch_cursor": 3})
        dist.barrier()
        out["restored"] = _restore_into(model, tcfg, mesh, ckpt_dir)
    if world > 1:  # the tensor-parallel forward is not ported: a "model" dim is refused
        try:
            step.shard_lm(model, model.init(device="cpu"),
                          init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model")))
        except ValueError as e:
            out["model_dim_refused"] = str(e)
    return out


def fsdp_cases(rank: int, world: int, cases: list) -> list:
    """:func:`fsdp_train` of each ``(cfg, params, batches, remats)``."""
    return [fsdp_train(rank, world, *case) for case in cases]


def _placements(t):
    """A DTensor's placements; None for a plain tensor."""
    return tuple(t.placements) if hasattr(t, "placements") else None


def _restore_into(model, tcfg, mesh, ckpt_dir) -> dict:
    """The checkpoint loaded into a fresh sharded state: its full
    parameters and moments, and its step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import step

    lm = model.init(device="cpu", generator=torch.Generator().manual_seed(5))
    step.shard_lm(model, lm, mesh)
    state = step.make_train_state(model, tcfg, params=lm)
    tree, _ = CheckpointManager(ckpt_dir).restore(step.train_state_tree(state))
    step.load_train_state_tree(state, tree)
    return {"params": {n: _whole(p) for n, p in lm.named_parameters()},
            "m": {n: _whole(t) for n, t in state["opt"].m.items()},
            "v": {n: _whole(t) for n, t in state["opt"].v.items()},
            "step": state["step"], "count": state["opt"].count}


def _whole(t: torch.Tensor) -> torch.Tensor:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()




def dtensor_checks(rank: int, world: int) -> dict:
    """What a DTensor meets in the port on a (world,) "data" mesh: the
    error each kernel dispatcher and ``global_norm`` over a mix raise, and
    what ``constrain_act`` makes of a replicated activation inside and
    outside a sharding context."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.context import constrain_act, sharding_context
    from repro_torch.distributed.sharding import RULES_TRAIN
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import global_norm

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))

    def dt(t):
        return distribute_tensor(t, mesh, (Replicate(),))

    q = torch.randn(1, 2, 8, 4)
    x, Bc = torch.randn(1, 8, 4), torch.randn(1, 8, 4)
    dtt, A, D = torch.rand(1, 8, 4), -torch.rand(4, 4), torch.ones(4)
    calls = {
        "ell_to_dense": lambda: ops.ell_to_dense(dt(torch.ones(2, 3)),
                                                 torch.zeros(2, 3, dtype=torch.int32), n_cols=4),
        "flash_attention": lambda: ops.flash_attention(dt(q), q, q),
        "ssm_scan": lambda: ops.ssm_scan(dt(x), dtt, A, Bc, Bc, D),
        "ssm_scan_vjp": lambda: ops.ssm_scan_vjp(x, dt(dtt), A, Bc, Bc, D),
        "global_norm": lambda: global_norm({"a": dt(torch.ones(4)), "b": torch.ones(3)}),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "no error"
        except TypeError as e:
            out[name] = str(e)
    act = dt(torch.randn(2 * world, 3, 4))
    out["no_context"] = tuple(constrain_act(act, ("batch", "seq", "act_embed")).placements)
    with sharding_context(mesh, RULES_TRAIN):
        got = constrain_act(act, ("batch", "seq", "act_embed"))
        out["in_context"] = tuple(got.placements)
        out["in_context_equal"] = bool(torch.equal(got.full_tensor(), act.full_tensor()))
        try:
            constrain_act(act, ("batch", "seq"))
        except ValueError as e:
            out["rank_check"] = str(e)
    out["shard"] = Shard(0)
    return out


def gpipe(rank: int, world: int, params: dict, x: torch.Tensor) -> dict:
    """``pipeline_apply`` of ``tanh(h @ w + b)`` stages over the ranks, the
    same stages run one after another on each microbatch in this process,
    and the error a stage dim other than the group's size raises."""
    from repro_torch.distributed.pipeline import pipeline_apply

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    got = pipeline_apply(stage_fn, params, x)
    seq = []
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(world):
            h = stage_fn({"w": params["w"][s], "b": params["b"][s]}, h)
        seq.append(h)
    try:
        pipeline_apply(stage_fn, {k: v[:-1] for k, v in params.items()}, x)
        refused = "no error"
    except ValueError as e:
        refused = str(e)
    return {"got": got, "sequential": torch.stack(seq), "refused": refused}


def remesh(rank: int, world: int, shape_a: tuple, ckpt_dir: str) -> dict:
    """The reference's elastic script (``tests/test_elastic.py``): save a
    (32, 64) leaf placed on a ``shape_a`` ("data", "model") mesh, restore
    it on the transposed mesh; a (6, 64) leaf refused there under
    ``strict`` and replicated without it."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import reshard_for_mesh
    from repro_torch.distributed.sharding import RULES_TRAIN, distribute_tree

    axes = {"w": ("vocab", "embed")}
    mesh_a = init_device_mesh("cpu", shape_a, mesh_dim_names=("data", "model"))
    mesh_b = init_device_mesh("cpu", shape_a[::-1], mesh_dim_names=("data", "model"))
    out = {}
    for name, rows in (("even", 32), ("odd", 6)):
        full = torch.arange(rows * 64, dtype=torch.float32).reshape(rows, 64)
        state = distribute_tree({"w": full}, axes, RULES_TRAIN, mesh_a)
        tree = {"w": state["w"].full_tensor()}  # a gather: every rank
        mgr = CheckpointManager(f"{ckpt_dir}_{name}")
        if rank == 0:
            mgr.save(1, tree, loader_state={"seed": 0, "epoch": 0, "fetch_cursor": 3})
        dist.barrier()
        template = {"w": torch.zeros(rows, 64)}
        out[f"{name}_saved_placements"] = tuple(state["w"].placements)
        if name == "even":
            restored, manifest = reshard_for_mesh(mgr, template, axes, mesh_b, RULES_TRAIN)
            out["manifest"] = manifest
        else:
            try:
                reshard_for_mesh(mgr, template, axes, mesh_a, RULES_TRAIN)
                out["refused"] = "no error"
            except ValueError as e:
                out["refused"] = str(e)
            restored, _ = reshard_for_mesh(mgr, template, axes, mesh_a, RULES_TRAIN, strict=False)
        w = restored["w"]
        out[name] = {"full": w.full_tensor(), "local": w.to_local().clone(),
                     "placements": tuple(w.placements), "mesh": tuple(w.device_mesh.shape)}
    return out


def ef_hook(rank: int, world: int, grads: list) -> dict:
    """A one-weight ``Linear`` under DDP with ``ef_int8_hook``: its
    weight's local gradient made ``grads[step][rank]`` by the backward of
    ``(ddp(I) * g.T).sum()``, for each step; -> the gradient DDP leaves
    after each step, and the hook's residual after the last."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    from repro_torch.distributed.compression import EFInt8State, ef_int8_hook

    shape = grads[0][0].shape
    lin = torch.nn.Linear(shape[1], shape[0], bias=False)
    ddp = DDP(lin)
    state = EFInt8State()
    ddp.register_comm_hook(state, ef_int8_hook)
    seen = []
    for g in grads:
        ddp.zero_grad(set_to_none=True)
        (ddp(torch.eye(shape[1])) * g[rank].T).sum().backward()
        seen.append(ddp.module.weight.grad.detach().clone())
    return {"grads": seen, "residuals": {k: v.clone() for k, v in state.residuals.items()}}
