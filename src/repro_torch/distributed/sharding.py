"""Logical-axis sharding rules -> partition specs and DTensor placements:
the port of ``repro.distributed.sharding``.

Models name every parameter and cache dim with a *logical* axis
(:func:`repro_torch.models.transformer.param_axes`, ``cache_axes``).  A
rule set maps logical names to mesh axes; :func:`spec_for_axes` resolves one
array's axes into a spec with the reference's guards: a mesh axis is used
once per spec, an axis the mesh does not have is dropped, and under
``strict`` a dim that the mesh axes do not divide is replicated (without
``strict`` it is sharded while padding wastes less than 2x).

A spec is the reference's ``PartitionSpec`` entries as a plain tuple: per
dim None, a mesh axis name, or a tuple of names, trailing Nones dropped.
The mesh is anything with ``.shape`` (axis name -> size) and
``.axis_names``, as the reference's tests fake it; a
``torch.distributed.device_mesh.DeviceMesh`` is read through
:func:`mesh_view`.

Rule sets (the reference's, unchanged):

- train:   batch->(pod,data), TP over heads/mlp/vocab/dinner, EP over
           experts, FSDP over the params' d_model ("embed") dim.
- decode:  KV-cache seq -> model, batch->(pod,data).
- decode_long: batch=1 -> cache seq over both data and model.
- decode_ws: weight-stationary decode: activations replicated, activation
           d_model over data, the cache over every device.

On a ``DeviceMesh``, :func:`placements_for_spec` gives one placement per
mesh dim: ``Shard(i)`` where entry i names that dim, else ``Replicate()``;
:func:`distribute_tree` places a tree of tensors so;
:func:`distribute_params` places a model's parameters by their
``param_axes()`` and :func:`distribute_cache` its caches by
``cache_axes()``, each over the storage each rank already holds (views,
no copy).  A mesh dim that
shards two tensor dims at once cannot be expressed by placements (one
per mesh dim) and raises; no rule set produces one, a spec using each mesh
axis once.  :func:`fsdp_placement_fn` is the rule-sharded train step's
``shard_placement_fn`` for FSDP2's ``fully_shard``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional, Sequence, Union

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

__all__ = [
    "ShardingRules",
    "RULES_TRAIN",
    "RULES_DECODE",
    "RULES_DECODE_LONG",
    "RULES_DECODE_WS",
    "MeshView",
    "mesh_view",
    "spec_for_axes",
    "tree_specs",
    "placements_for_spec",
    "tree_placements",
    "distribute_tree",
    "distribute_params",
    "distribute_cache",
    "fsdp_placement_fn",
    "tp_sharded_dims",
]

AxisAssignment = Union[None, str, tuple]  # mesh axis / tuple of axes / replicate


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None); the
    reference's ``Rules``."""

    table: Mapping[str, AxisAssignment]
    name: str = "custom"

    def get(self, logical: str) -> AxisAssignment:
        return self.table.get(logical)

    def override(self, name: str = None, **updates) -> "ShardingRules":
        t = dict(self.table)
        t.update(updates)
        return ShardingRules(table=t, name=name or self.name + "+")


# Shipped rule sets --------------------------------------------------------
_COMMON = {
    # params
    "vocab": "model",
    "embed": "data",  # FSDP: shard the d_model dim of weights over data
    "heads": "model",
    "kv_heads": None,  # replicated: kv_heads rarely divides tp (GQA)
    "head_dim": None,
    "mlp": "model",
    "experts": "model",  # EP (falls back to replicate when E % tp != 0)
    "experts_router": None,
    "dinner": "model",  # SSM inner dim
    "ssm_proj": None,
    "ssm_state": None,
    "conv_k": None,
    "stack": None,
    "norm": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_dinner": "model",  # SSM inner-dim activations
    "act_experts": "model",  # MoE expert-parallel activations
    "groups": ("pod", "data"),  # MoE dispatch groups
}

RULES_TRAIN = ShardingRules({**_COMMON}, name="train")

RULES_DECODE = ShardingRules(
    {**_COMMON, "cache_seq": "model", "cross_seq": None},
    name="decode",
)

# batch=1: spread the KV cache across every device
RULES_DECODE_LONG = ShardingRules(
    {**_COMMON, "batch": None, "cache_seq": ("data", "model"), "cross_seq": None},
    name="decode_long",
)

# weight-stationary decode: replicate the (tiny) activations, shard the
# activations' d_model over "data" and spread the KV cache over all devices
RULES_DECODE_WS = ShardingRules(
    {**_COMMON, "batch": None, "groups": None, "act_embed": "data",
     "cache_seq": ("data", "model"), "cross_seq": None},
    name="decode_ws",
)


# Meshes -------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshView:
    """A mesh's axis names and sizes, as the resolution reads them."""

    shape: Mapping[str, int]

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def mesh_view(mesh) -> Any:
    """``mesh`` as the resolution reads it: a ``DeviceMesh`` (its
    ``mesh_dim_names`` and ``mesh.shape``) becomes a :class:`MeshView`;
    anything else is taken as it is (``.shape`` and ``.axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None and hasattr(mesh, "axis_names"):
        return mesh
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to resolve sharding rules")
    return MeshView(dict(zip(names, (int(n) for n in mesh.mesh.shape))))


# Resolution ---------------------------------------------------------------
def _axis_size(mesh, assignment: AxisAssignment) -> int:
    if assignment is None:
        return 1
    if isinstance(assignment, str):
        return mesh.shape[assignment]
    n = 1
    for a in assignment:
        n *= mesh.shape[a]
    return n


def _pad_waste(dim: int, axis: int) -> float:
    """Padding waste factor of sharding ``dim`` ways over ``axis`` devices."""
    return math.ceil(dim / axis) * axis / max(1, dim)


def _present(mesh, assignment: AxisAssignment) -> Optional[AxisAssignment]:
    """Drop mesh axes the mesh does not have (e.g. "pod" on one pod); a
    tuple reduced to one axis collapses to the bare name."""
    names = set(mesh.axis_names)
    if assignment is None:
        return None
    if isinstance(assignment, str):
        return assignment if assignment in names else None
    kept = tuple(a for a in assignment if a in names)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def spec_for_axes(
    axes: Sequence[Optional[str]],
    rules: ShardingRules,
    mesh,
    shape: Optional[Sequence[int]] = None,
    *,
    strict: bool = True,
) -> tuple:
    """The spec of one array given its logical axes (entries as the
    reference's ``PartitionSpec``, trailing Nones dropped).

    ``strict=True`` (parameters, restores): a dim is sharded only if its
    mesh axes divide it.  ``strict=False`` (activations): a dim is sharded
    while padding wastes less than 2x; a smaller dim falls through so that a
    later dim can claim the axis (mixtral's 8 experts on a 16-way axis ->
    the per-expert ff takes "model").
    """
    mesh = mesh_view(mesh)
    entries = []
    used: set = set()
    for i, logical in enumerate(axes):
        a = _present(mesh, rules.get(logical)) if logical else None
        if a is not None:
            flat = (a,) if isinstance(a, str) else tuple(a)
            n = _axis_size(mesh, a)
            if any(x in used for x in flat):
                a = None  # a mesh axis may appear once per spec
            elif shape is not None and strict and shape[i] % n != 0:
                a = None
            elif shape is not None and not strict and _pad_waste(shape[i], n) >= 2.0:
                a = None
            else:
                used.update(flat)
        entries.append(a)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _shape_of(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def _tree_map(fn: Callable, axes_tree, *others):
    """``fn(axes, *other_leaves)`` over a tree of nested dicts whose leaves
    are axes tuples; ``others`` have the same dict structure."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *others)
    if not isinstance(axes_tree, Mapping):
        raise TypeError(f"an axes tree holds dicts and axes tuples, got {type(axes_tree).__name__}")
    return {k: _tree_map(fn, v, *(o[k] for o in others)) for k, v in axes_tree.items()}


def tree_specs(axes_tree, rules: ShardingRules, mesh, shapes_tree=None):
    """An axes tree (and optionally a tree of shapes or tensors of the same
    structure) -> a tree of specs."""
    if shapes_tree is None:
        return _tree_map(lambda ax: spec_for_axes(ax, rules, mesh), axes_tree)
    return _tree_map(lambda ax, sh: spec_for_axes(ax, rules, mesh, _shape_of(sh)),
                     axes_tree, shapes_tree)


def placements_for_spec(spec: Sequence[AxisAssignment], device_mesh) -> tuple:
    """One DTensor placement per dim of ``device_mesh``: ``Shard(i)`` where
    entry i of ``spec`` names that mesh dim (alone or in a tuple), else
    ``Replicate()``.  Raises ``ValueError`` if a spec names a mesh dim the
    mesh has not, or one mesh dim for two tensor dims."""
    names = device_mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to take a spec")
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in ((entry,) if isinstance(entry, str) else tuple(entry)):
            if axis not in names:
                raise ValueError(f"spec {tuple(spec)} names mesh axis {axis!r}; the mesh has {names}")
            d = names.index(axis)
            if out[d] != Replicate():
                raise ValueError(f"spec {tuple(spec)} shards two dims over mesh axis {axis!r}")
            out[d] = Shard(i)
    return tuple(out)


def tree_placements(axes_tree, rules: ShardingRules, device_mesh, shapes_tree=None):
    """The placements of every leaf of an axes tree on ``device_mesh``."""
    def place(axes, shaped=None):
        shape = None if shaped is None else _shape_of(shaped)
        return placements_for_spec(spec_for_axes(axes, rules, device_mesh, shape), device_mesh)

    if shapes_tree is None:
        return _tree_map(place, axes_tree)
    return _tree_map(place, axes_tree, shapes_tree)


def distribute_tree(params, axes_tree, rules: ShardingRules, device_mesh, *, strict: bool = True):
    """``params`` (a tree of nested dicts of tensors, shaped as
    ``axes_tree``) as DTensors on ``device_mesh``, each placed by its
    spec's placements; each rank keeps its own shards of the full tensors
    it passes (every rank must pass the same values)."""
    def place(axes, t):
        spec = spec_for_axes(axes, rules, device_mesh, tuple(t.shape), strict=strict)
        return distribute_tensor(t, device_mesh, placements_for_spec(spec, device_mesh))

    return _tree_map(place, axes_tree, params)


def tp_sharded_dims(p: torch.Tensor) -> set:
    """The dims a DTensor parameter's placements shard over mesh dims of
    more than one rank (the tensor-parallel dims FSDP2 must not shard
    again); empty for a plain tensor."""
    mesh = getattr(p, "device_mesh", None)
    if mesh is None:
        return set()
    return {pl.dim for m, pl in enumerate(p.placements)
            if isinstance(pl, Shard) and mesh.size(m) > 1}


def fsdp_placement_fn(axes: Mapping[str, tuple], rules: ShardingRules, device_mesh,
                      named: Mapping[str, torch.nn.Parameter]) -> Callable:
    """``shard_placement_fn`` for ``fully_shard`` on ``device_mesh`` (one
    dim): each parameter of ``named`` is sharded on the dim that ``rules``
    put on that mesh dim (under ``RULES_TRAIN`` and a "data" mesh, the
    FSDP dim "embed"), as its spec resolves strictly on the mesh; a
    parameter with no such dim on its first dim that tensor parallelism
    does not shard (:func:`tp_sharded_dims`; ``Shard(0)`` for a plain
    tensor).  ``axes`` is keyed like ``named`` (parameter name -> logical
    axes)."""
    (dim_name,) = device_mesh.mesh_dim_names
    by_id = {}
    for name, p in named.items():
        spec = spec_for_axes(axes[name], rules, device_mesh, tuple(p.shape))
        dims = [i for i, e in enumerate(spec)
                if e == dim_name or (isinstance(e, tuple) and dim_name in e)]
        taken = tp_sharded_dims(p)
        free = [i for i in range(p.ndim) if i not in taken]
        by_id[id(p)] = Shard(dims[0] if dims else free[0])

    def placement(p: torch.nn.Parameter):
        return by_id[id(p)]

    return placement


def _local_view(t: torch.Tensor, device_mesh, placements: tuple, contiguous: bool = False):
    """``t`` (whole on every rank) as a DTensor placed as ``placements``
    whose local shard is a view of ``t``'s storage (narrowed, not
    copied), or with ``contiguous`` a contiguous copy where the view is
    not."""
    from .tensor_parallel import local_range, wrap

    local = t
    for dim in sorted({p.dim for p in placements if isinstance(p, Shard)}):
        s, e = local_range(t.shape[dim], device_mesh, placements, dim)
        local = local.narrow(dim, s, e - s)
    if contiguous:
        local = local.contiguous()
    return wrap(local, device_mesh, placements, tuple(t.shape))


def distribute_params(model, params: torch.nn.Module, rules: ShardingRules,
                      device_mesh, *, contiguous: bool = False) -> torch.nn.Module:
    """``params`` (the model's module, whole on every rank) with every
    parameter replaced, in place, by a DTensor on ``device_mesh`` placed by
    its ``model.param_axes()`` under ``rules`` (strict: a dim the mesh
    axes do not divide stays whole).  Each rank's shard is a view of the
    parameter it held: nothing is copied, so a model that fills the
    device's memory once can be placed (its shard's
    ``untyped_storage().data_ptr()`` is the old parameter's).  With
    ``contiguous`` a shard that is not contiguous is copied (FSDP2 takes
    contiguous shards only)."""
    axes = model.param_axes()
    for name, p in list(params.named_parameters()):
        spec = spec_for_axes(axes[name], rules, device_mesh, tuple(p.shape))
        dt = _local_view(p.detach(), device_mesh, placements_for_spec(spec, device_mesh),
                         contiguous)
        owner_name, _, leaf = name.rpartition(".")
        owner = params.get_submodule(owner_name) if owner_name else params
        setattr(owner, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return params


def distribute_cache(model, cache: dict, rules: ShardingRules, device_mesh) -> dict:
    """``cache`` (``model.init_cache``'s tree, whole on every rank) as
    DTensors on ``device_mesh`` placed by ``model.cache_axes()`` under
    ``rules`` (strict), each rank's shard a view of its buffer; the
    model's serving entry points write the shards in place."""
    def place(axes, t):
        spec = spec_for_axes(axes, rules, device_mesh, tuple(t.shape))
        return _local_view(t, device_mesh, placements_for_spec(spec, device_mesh))

    return _tree_map(place, model.cache_axes(), cache)
