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
    on a (world,) ("data",) mesh (FSDP2 alone), once per ``remat``, each rank
    fed its slice of every global batch; -> {remat: (metrics per step,
    the full parameters after the steps)}.  With ``ckpt_dir``, the last
    run's state is saved there after its last step."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import Model
    from repro_torch.train import optimizer, step

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
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
    if world > 1:  # a mesh without a "data" dim is refused
        try:
            step.shard_lm(model, model.init(device="cpu"),
                          init_device_mesh("cpu", (world,), mesh_dim_names=("model",)))
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


# ------------------------------------------------------- tensor parallelism
def _mesh(shape: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))


def _kernel_spy():
    """Wrap the attention and scan dispatchers of ``repro_torch.kernels.ops``
    (which the models call) to record the (query heads, kv heads) and the
    channels each call of this rank sees; -> (log, undo)."""
    from repro_torch.kernels import ops

    log = []
    fa, scan = ops.flash_attention, ops.ssm_scan

    def flash_attention(q, k, v, **kw):
        log.append(("attention", q.shape[1], k.shape[1]))
        return fa(q, k, v, **kw)

    def ssm_scan(x, *args):
        log.append(("scan", x.shape[-1]))
        return scan(x, *args)

    ops.flash_attention, ops.ssm_scan = flash_attention, ssm_scan

    def undo():
        ops.flash_attention, ops.ssm_scan = fa, scan

    return log, undo


def tp_serve(rank: int, world: int, shape: tuple, cases: list) -> list:
    """Each case ``{cfg, params, batch, rules, max_len, pos0, tokens}`` on
    a ``shape`` ("data", "model") mesh: the parameters placed by
    ``distribute_params`` under ``rules`` (each shard a view of the
    parameter's storage), the cache by ``distribute_cache``; the forward,
    the prefill and a decode step at ``pos0 + i`` for each of ``tokens``
    run inside ``sharding_context`` -> their whole logits, the kernels'
    local shapes, and whether every shard shares its parameter's storage."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import sharding_context
    from repro_torch.models import Model

    mesh = _mesh(shape)
    out = []
    for case in cases:
        cfg = case["cfg"]
        model = Model(cfg)
        rules = getattr(sharding, case["rules"])
        lm = model.init(device="cpu")
        with torch.no_grad():
            for name, p in lm.named_parameters():
                p.copy_(case["params"][name])
        ptrs = {n: p.untyped_storage().data_ptr() for n, p in lm.named_parameters()}
        sharding.distribute_params(model, lm, rules, mesh)
        shared = all(p.to_local().untyped_storage().data_ptr() == ptrs[n]
                     for n, p in lm.named_parameters())
        cache = sharding.distribute_cache(
            model, model.init_cache(case["batch"]["tokens"].shape[0], case["max_len"],
                                    device="cpu"), rules, mesh)
        log, undo = _kernel_spy()
        try:
            with torch.no_grad(), sharding_context(mesh, rules):
                fwd = model.forward(lm, case["batch"]).full_tensor()
                logits, cache = model.prefill(lm, case["batch"], cache)
                steps = [logits.full_tensor()]
                for i, tok in enumerate(case["tokens"]):
                    logits, cache = model.decode(lm, tok, cache, case["pos0"] + i)
                    steps.append(logits.full_tensor())
        finally:
            undo()
        out.append({"forward": fwd, "steps": steps, "kernels": sorted(set(log)),
                    "shared": shared,
                    "cache": {k: tuple(t.placements) for k, t in _leaves(cache).items()}})
    return out


def _leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def tp_train(rank: int, world: int, shape: tuple, cases: list, mutant: bool = False) -> list:
    """Each case ``(cfg, params, batches)``: three rule-sharded steps
    (``shard_lm`` on a ``shape`` ("data", "model") mesh: FSDP2 x TP), each
    "data" rank fed its rows of every global batch -> (metrics per step,
    the whole parameters after).  ``mutant``: every region's replicated
    inputs take their gradient as replicated, not as the partial sums they
    are (``grad_placements`` left out)."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.models import Model
    from repro_torch.train import optimizer, step

    if mutant:
        tensor_parallel._grad_placements = lambda placements, names, split: tuple(placements)
    mesh = _mesh(shape)
    data = mesh.get_coordinate()[0]
    tcfg = optimizer.AdamWConfig(lr=optimizer.warmup_cosine(1e-3, warmup=1, total=3),
                                 weight_decay=0.01, clip_norm=1.0)
    out = []
    for cfg, params, batches in cases:
        model = Model(cfg)
        lm = model.init(device="cpu")
        with torch.no_grad():
            for name, p in lm.named_parameters():
                p.copy_(params[name])
        step.shard_lm(model, lm, mesh)
        state = step.make_train_state(model, tcfg, params=lm)
        fn = step.make_train_step(model, tcfg)
        metrics = []
        for batch in batches:
            n = batch["tokens"].shape[0] // shape[0]
            local = {k: v[data * n:(data + 1) * n] for k, v in batch.items()}
            state, m = fn(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        out.append((metrics, {n: _whole(p) for n, p in lm.named_parameters()},
                    {n: _placements(p) for n, p in lm.named_parameters()}))
    return out


def vocab_parallel_loss(rank: int, world: int, shape: tuple, logits: torch.Tensor,
                        labels: torch.Tensor, mask: torch.Tensor) -> dict:
    """``lm_loss`` of ``logits`` (B, S, V) placed on a ``shape`` ("data",
    "model") mesh as the logits of the train step are (batch over "data",
    vocabulary over "model"), its gradient; and ``global_norm`` of tensors
    placed on the mesh, on its "model" dim and replicated."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.train.loss import lm_loss
    from repro_torch.train.optimizer import global_norm

    mesh = _mesh(shape)
    x = distribute_tensor(logits.clone(), mesh, (Shard(0), Shard(2))).detach().requires_grad_()
    data = mesh.get_coordinate()[0]
    n = labels.shape[0] // shape[0]
    total, metrics = lm_loss(x, labels, mask[data * n:(data + 1) * n], z_loss_weight=1e-4,
                             count=mask.sum())
    total.backward()
    local = x.to_local()
    ce, lse = metrics["ce_loss"].detach().clone(), metrics["z_loss"].detach().clone()
    sums = torch.stack([total.detach(), ce, lse])
    dist.all_reduce(sums)  # each "data" rank's share; every "model" rank holds it
    sums /= shape[1]
    tensors = {
        "both": distribute_tensor(logits.clone(), mesh, (Shard(0), Shard(2))),
        "model": distribute_tensor(logits[0].clone(), mesh["model"], (Shard(1),)),
        "replicated": distribute_tensor(labels.float(), mesh, (Replicate(), Replicate())),
    }
    return {"sums": sums, "grad": x.grad.full_tensor(), "local_vocab": local.shape[-1],
            "norm": global_norm(tensors)}


def remesh_model(rank: int, world: int, cfg, params: dict, ckpt_dir: str) -> dict:
    """The reference's elastic re-mesh at gloo size, on a model's whole
    parameter tree: placed by ``RULES_TRAIN`` on a (1 data, 2 model) mesh,
    saved whole with a loader state, restored onto the transposed (2, 1)
    mesh by ``reshard_for_mesh``."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import reshard_for_mesh
    from repro_torch.distributed.sharding import RULES_TRAIN, distribute_tree
    from repro_torch.models import Model

    axes = Model(cfg).param_axes()
    state = distribute_tree(params, axes, RULES_TRAIN, _mesh((1, 2)))
    tree = {k: v.full_tensor() for k, v in state.items()}  # a gather: every rank
    mgr = CheckpointManager(ckpt_dir)
    if rank == 0:
        mgr.save(1, tree, loader_state={"seed": 0, "epoch": 0, "fetch_cursor": 3})
    dist.barrier()
    template = {k: torch.zeros_like(v) for k, v in params.items()}
    restored, manifest = reshard_for_mesh(mgr, template, axes, _mesh((2, 1)), RULES_TRAIN)
    return {"saved": {k: tuple(v.placements) for k, v in state.items()},
            "placements": {k: tuple(v.placements) for k, v in restored.items()},
            "full": {k: v.full_tensor() for k, v in restored.items()},
            "loader_state": manifest["loader_state"]}


def uneven_wrap(rank: int, world: int) -> dict:
    """A region's output on 15 heads sharded over ``world`` "model" ranks
    (8 / 7 at two), wrapped back by ``tensor_parallel.wrap`` and by torch's
    ``local_map`` -> each one's global shape on this rank, and the whole
    of ``wrap``'s (``local_map``'s is not gathered: its shards disagree
    with its shape, and gloo aborts the rank)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed import tensor_parallel

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    q = distribute_tensor(torch.arange(2 * 15 * 3, dtype=torch.float32).reshape(2, 15, 3),
                          mesh, [Shard(1)])
    ours = tensor_parallel.wrap(q.to_local() * 2, mesh, [Shard(1)], q.shape)
    theirs = local_map(lambda t: t * 2, out_placements=[Shard(1)], in_placements=([Shard(1)],),
                       device_mesh=mesh)(q)
    return {"local": tuple(q.to_local().shape), "wrap": tuple(ours.shape),
            "local_map": tuple(theirs.shape), "whole": ours.full_tensor()}
