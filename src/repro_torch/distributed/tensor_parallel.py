"""Tensor- and expert-parallel regions over a ("data", "model") mesh: the
port's counterpart of what GSPMD derives from the reference's
``constrain_act`` annotations.

Between the annotated sites the model's activations are DTensors on the
mesh of the current :func:`~.context.sharding_context`, placed as the rule
set resolves their logical axes (``strict=False``: a dim is sharded
unevenly, in ``torch.chunk``'s pieces, while padding wastes under 2x).
Pointwise work on them (residual adds, activations, casts) is DTensor's
own.  Everything that reads a parameter or launches a kernel is a *local
region*: its inputs are redistributed to the placements the region needs
and taken with ``to_local()``, the region runs plain PyTorch (or the
Hopper kernels) on each rank's shards, and its outputs are wrapped back
with ``DTensor.from_local`` on the placements they have, ``Partial()``
where a rank holds a share of a sum.  No DTensor reaches a kernel
(:mod:`repro_torch.kernels.ops` still refuses one).

Gradients.  An input that is ``Replicate()`` on a mesh dim over which the
region's work is split (the batch over "data", heads, channels, experts or
the vocabulary over "model") gets a different gradient on each rank: its
``to_local()`` names ``grad_placements`` ``Partial()`` there, so the
backward sums the ranks' shares (an all-reduce or reduce-scatter).  The
kernels' inputs a rank reads whole are such inputs: the scan's B and C,
and the keys and values of a kv head that several ranks' query heads read.
Where the work is not split, the gradient is the same on every rank and
stays ``Replicate()``.

Parameters are DTensors too: on the whole mesh when serving
(:func:`~.sharding.distribute_params`), on the "model" submesh while
FSDP2 has gathered a block's weights over "data" (the rule-sharded train
step).  Mesh dims are matched by name.

Why not torch's ``local_map``.  ``torch.distributed.tensor.experimental
.local_map`` wraps a region's outputs with ``DTensor.from_local(out,
mesh, placements, run_check=False)`` and no global shape, so it reads
every shard as an even one: smollm's 15 query heads over two "model"
ranks (8 / 7) come back as 16 heads on rank 0 and 14 on rank 1, and
gathering them fails on gloo ("Received data size doesn't match expected
size"; torch 2.13, ``tests/test_torch_tp_serve.py::
test_wrap_keeps_uneven_shards_where_local_map_does_not``).  The
reference shards such dims (``strict=False``), so the regions wrap with
the global shape (:func:`wrap`).  What ``local_map`` would take as given
is what the regions decide: which inputs a rank reads whole (their
``grad_placements``), the GQA plan of :func:`attention_heads`, and, in
:func:`einsum_tp`, which operand keeps its shard and which is narrowed
or gathered, as the reference's annotations place the products (DTensor's
own einsum would choose its redistributions itself).

:func:`chunk_range` and :func:`local_range` are ``torch.chunk``'s pieces,
which are DTensor's shards; :func:`attention_heads` is the helper that
gives a rank's query heads their key and value heads (the GQA alignment),
used by the model and by the card's per-rank checks alike.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .context import current_context

__all__ = [
    "is_dtensor",
    "chunk_range",
    "local_range",
    "wrap",
    "take",
    "take_weight",
    "einsum_tp",
    "attention_heads",
    "attention_tp",
    "pointwise",
    "act_mesh",
    "settled",
    "replicate",
    "norm_tp",
    "embed_tp",
    "assign",
    "assign_row",
    "cached_attention_tp",
]


def is_dtensor(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def act_mesh():
    """The current sharding context's mesh; raises without one."""
    ctx = current_context()
    if ctx is None:
        raise RuntimeError("a DTensor activation needs a sharding_context(mesh, rules)")
    return ctx[0]


def chunk_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """Piece ``index`` of ``n`` cut in ``parts`` as ``torch.chunk`` cuts it
    (pieces of ceil(n / parts), the last ones shorter or empty): DTensor's
    ``Shard`` of an uneven dim."""
    size = -(-n // parts) if n else 0
    start = min(index * size, n)
    return start, min(start + size, n)


def local_range(n: int, mesh, placements: Sequence, dim: int) -> tuple[int, int]:
    """This rank's [start, stop) of a dim of size ``n`` that ``placements``
    on ``mesh`` shard, mesh dim by mesh dim in order (DTensor's order for
    a dim sharded over two mesh dims)."""
    coord = mesh.get_coordinate()
    start, stop = 0, n
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            a, b = chunk_range(stop - start, mesh.size(m), coord[m])
            start, stop = start + a, start + b
    return start, stop


def _stride(shape: Sequence[int]) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def wrap(local: torch.Tensor, mesh, placements: Sequence, shape: Sequence[int]) -> DTensor:
    """``local`` as this rank's shard of a DTensor of global ``shape``
    (uneven shards included) placed as ``placements`` on ``mesh``; no
    communication, no copy."""
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=_stride(shape))


def _grad_placements(placements: Sequence, names: Sequence[str], split: dict) -> tuple:
    return tuple(Partial() if isinstance(p, Replicate) and split.get(n, False) else p
                 for p, n in zip(placements, names))


def take(x: DTensor, placements: Sequence, split: dict) -> torch.Tensor:
    """``x`` redistributed to ``placements`` on its mesh, then its local
    shard; its gradient comes back ``Partial()`` on every mesh dim where
    ``placements`` replicate it and ``split[name]`` says the region's work
    is split there, else as placed."""
    placements = tuple(placements)
    if tuple(x.placements) != placements:
        x = x.redistribute(x.device_mesh, placements)
    return x.to_local(grad_placements=_grad_placements(placements, x.device_mesh.mesh_dim_names,
                                                       split))


def take_weight(w: DTensor, slices: dict, split: dict) -> torch.Tensor:
    """The local piece a region reads of ``w`` (a parameter, or the other
    operand of a product): for each dim in
    ``slices`` (dim -> (start, stop), global indices) that range, for every
    other dim the whole.  A shard that already is the range is taken as it
    is; otherwise the dim is gathered and narrowed.  Gradients as
    :func:`take`'s."""
    if not isinstance(w, DTensor):
        raise TypeError("a tensor-parallel region reads DTensor parameters "
                        "(distribute_params or shard_lm places them), got a plain tensor")
    mesh = w.device_mesh
    target, kept = [], set()
    for pl in w.placements:
        if (isinstance(pl, Shard) and pl.dim in slices and sum(
                isinstance(q, Shard) and q.dim == pl.dim for q in w.placements) == 1
                and local_range(w.shape[pl.dim], mesh, w.placements, pl.dim) == slices[pl.dim]):
            target.append(pl)
            kept.add(pl.dim)
        else:
            target.append(Replicate())
    local = take(w, target, split)
    for dim, (s, e) in slices.items():
        if dim not in kept and (s, e) != (0, w.shape[dim]):
            local = local.narrow(dim, s, e - s)
    return local


def _placement_on(x, name: str):
    """``x``'s placement on the mesh dim called ``name``; Replicate where its
    mesh has no such dim (a parameter on the "model" submesh is whole on
    every "data" rank)."""
    names = x.device_mesh.mesh_dim_names
    return x.placements[names.index(name)] if name in names else Replicate()


def _expand(sub: str, ndim: int) -> str:
    if "..." not in sub:
        return sub
    extra = ndim - (len(sub) - 3)
    return sub.replace("...", "ABCDEFGH"[:extra])


def einsum_tp(eq: str, a: DTensor, b: DTensor, *, saveable: bool = True) -> DTensor:
    """The two-operand product ``eq`` of DTensors, rank by rank.  On each
    mesh dim:

    - an operand sharded on an index keeps it; the other operand, if it has
      that index, is narrowed to the same range (a weight's own shard where
      it already is that range);
    - the output is sharded on that index, or ``Partial()`` where the index
      is summed over (a row-parallel product);
    - two operands sharded on different indices: the second is gathered.

    The local products are ``layers.einsum``'s, with its remat mark
    (``saveable``)."""
    from ..models.layers import einsum as plain_einsum

    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        raise TypeError(f"{eq}: a tensor-parallel product takes two DTensors")
    ins, out = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    ctx = current_context()
    mesh = ctx[0] if ctx is not None else a.device_mesh
    la, lb = _expand(sa, a.ndim), _expand(sb, b.ndim)
    lo = _expand(out, a.ndim - len(sa.replace("...", "")) + len(out.replace("...", "")))
    size = {c: n for c, n in zip(la, a.shape)}
    size.update({c: n for c, n in zip(lb, b.shape)})
    out_shape = [size[c] for c in lo]

    names = mesh.mesh_dim_names
    ta: dict = {}  # mesh dim name -> a's target placement
    narrow_a: dict = {}  # a's dim -> range (an index b is sharded on)
    narrow_b: dict = {}  # b's dim -> range (its own shard's, or a's)
    out_pl, split = [], {}
    for name in names:
        pa, pb = settled([_placement_on(a, name), _placement_on(b, name)])
        if isinstance(pa, Shard):
            c = la[pa.dim]
            rng = local_range(a.shape[pa.dim], a.device_mesh, a.placements, pa.dim)
            ta[name] = pa
            if c in lb:
                narrow_b[lb.index(c)] = rng
            out_pl.append(Shard(lo.index(c)) if c in lo else Partial())
            split[name] = True
        elif isinstance(pb, Shard):
            c = lb[pb.dim]
            rng = local_range(b.shape[pb.dim], b.device_mesh, b.placements, pb.dim)
            ta[name] = Replicate()
            if c in la:
                narrow_a[la.index(c)] = rng
            narrow_b[pb.dim] = rng
            out_pl.append(Shard(lo.index(c)) if c in lo else Partial())
            split[name] = True
        else:
            ta[name] = Replicate()
            out_pl.append(Replicate())
            split[name] = False

    a_loc = take(a, [ta.get(n, Replicate()) for n in a.device_mesh.mesh_dim_names], split)
    for dim, (s, e) in narrow_a.items():
        a_loc = a_loc.narrow(dim, s, e - s)
    y = plain_einsum(eq, a_loc, take_weight(b, narrow_b, split), saveable=saveable)
    return wrap(y, mesh, out_pl, out_shape)


def pointwise(fn: Callable, x: DTensor, *args) -> DTensor:
    """``fn(local, *args)`` on ``x``'s shard, wrapped back on ``x``'s
    placements: for functions that act on each element of the sharded
    dims alone (RoPE per head and position)."""
    if not isinstance(x, DTensor):
        return fn(x, *args)
    mesh = x.device_mesh
    pls = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
    loc = take(x, pls, {})
    return wrap(fn(loc, *args), mesh, pls, x.shape)


def attention_heads(h0: int, h1: int, num_heads: int, num_kv_heads: int):
    """The key and value heads that query heads [h0, h1) read, as the
    kernels map a local query head j to kv head j // (H_local / Hkv_local):
    ``("range", k0, k1)`` where the heads are whole groups of their own kv
    heads (pass kv heads [k0, k1)), else ``("index", idx)``: kv head
    ``idx[j]`` for local query head j, one kv head per query head (gather
    the kv heads, then ``index_select``, as ``layers._expand_kv`` does)."""
    G = num_heads // num_kv_heads
    if h0 % G == 0 and (h1 - h0) % G == 0:
        return ("range", h0 // G, h1 // G)
    return ("index", [h // G for h in range(h0, h1)])


def _kv_take(k: DTensor, heads_dim: int, plan, target: list, split: dict, model: str):
    """A rank's kv heads for its query heads: its own shard where that is
    ``plan``'s range, else the heads gathered (gradient ``Partial()`` on
    ``model``) and narrowed or selected."""
    names = k.device_mesh.mesh_dim_names
    pk = k.placements[names.index(model)] if model in names else Replicate()
    if plan[0] == "range" and isinstance(pk, Shard) and pk.dim == heads_dim:
        own = local_range(k.shape[heads_dim], k.device_mesh, k.placements, heads_dim)
        if own == (plan[1], plan[2]):
            return take(k, target, split)
    target = [Replicate() if n == model else p for n, p in zip(names, target)]
    loc = take(k, target, split)
    if plan[0] == "range":
        return loc.narrow(heads_dim, plan[1], plan[2] - plan[1])
    idx = torch.tensor(plan[1], dtype=torch.long, device=loc.device)
    return loc.index_select(heads_dim, idx)


def attention_tp(q: DTensor, k: DTensor, v: DTensor, fn: Callable, *,
                 heads_dim: int = 2) -> DTensor:
    """``fn(q_local, k_local, v_local)`` on each rank's query heads (the
    layout (B, S, H, D), heads at ``heads_dim``), with the kv heads they
    read (:func:`attention_heads`); the output placed as ``q``.  The
    batch of k and v follows q's."""
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    qpl = tuple(Replicate() if isinstance(p, Partial) else p for p in q.placements)
    for p in qpl:
        if isinstance(p, Shard) and p.dim not in (0, heads_dim):
            raise ValueError(f"attention shards the batch and the heads, got {q.placements}")
    split = {n: isinstance(p, Shard) for n, p in zip(names, qpl)}
    q_loc = take(q, qpl, split)
    H, Hkv = q.shape[heads_dim], k.shape[heads_dim]
    h0, h1 = local_range(H, mesh, qpl, heads_dim)
    plan = attention_heads(h0, h1, H, Hkv)
    kv_target = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in qpl]
    model = next((n for n, p in zip(names, qpl) if isinstance(p, Shard) and p.dim == heads_dim),
                 "model")
    if model in names and isinstance(_placement_on(k, model), Shard) and \
            _placement_on(k, model).dim == heads_dim:
        kv_target[names.index(model)] = Shard(heads_dim)
    k_loc = _kv_take(k, heads_dim, plan, kv_target, split, model)
    v_loc = _kv_take(v, heads_dim, plan, kv_target, split, model)
    return wrap(fn(q_loc, k_loc, v_loc), mesh, qpl, q.shape)


def settled(placements: Sequence) -> list:
    """``placements`` with each ``Partial()`` as ``Replicate()``: where a
    region needs the sum."""
    return [Replicate() if isinstance(p, Partial) else p for p in placements]


def norm_tp(norm: Callable, x: DTensor, p: dict) -> DTensor:
    """``norm(x, p)`` (over the last dim) on each rank's rows: the last dim
    gathered where it is sharded (the weight-stationary rules put d_model
    on "data"), the output placed back as ``x``."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    last = x.ndim - 1
    pls = [Replicate() if isinstance(q, Shard) and q.dim == last else q
           for q in settled(x.placements)]
    split = {n: isinstance(q, Shard) for n, q in zip(names, pls)}
    y = norm(take(x, pls, split), {k: take_weight(w, {}, split) for k, w in p.items()})
    out = wrap(y, mesh, pls, x.shape)
    if tuple(pls) != tuple(x.placements):
        out = out.redistribute(mesh, settled(x.placements))
    return out


def replicate(t: torch.Tensor, mesh=None) -> DTensor:
    """A plain tensor that every rank holds whole, as a replicated DTensor
    on ``mesh`` (default the context's); a DTensor as it is."""
    if isinstance(t, DTensor):
        return t
    mesh = act_mesh() if mesh is None else mesh
    return wrap(t, mesh, [Replicate()] * mesh.ndim, t.shape)


def embed_tp(table: DTensor, tokens: torch.Tensor, placements: Sequence,
             post: Optional[Callable] = None) -> DTensor:
    """Rows of ``table`` (vocab, d) for ``tokens``, placed as ``placements``
    (the (..., d) activation's): where the vocabulary is sharded over a
    mesh dim, each rank looks up the tokens its rows hold, zeros for the
    others, and the ranks' rows are summed (one rank's row plus zeros: the
    same bits as one lookup); where the output shards d_model, each rank
    its columns.  ``post`` (pointwise, zero at zero) runs on the local
    rows before the sum."""
    mesh = act_mesh()
    names = mesh.mesh_dim_names
    tokens = replicate(tokens)
    nd = tokens.ndim
    shape = (*tokens.shape, table.shape[1])
    tok_pl, out_pl, split, slices = [], [], {}, {}
    vocab_dims = []
    for name, want in zip(names, placements):
        pt = _placement_on(table, name)
        if isinstance(pt, Shard) and pt.dim == 0:
            tok_pl.append(Replicate())
            out_pl.append(Partial())
            vocab_dims.append(name)
            split[name] = True
        elif isinstance(want, Shard) and want.dim == nd:
            tok_pl.append(Replicate())
            out_pl.append(want)
            split[name] = True
        elif isinstance(want, Shard):
            tok_pl.append(Shard(want.dim))
            out_pl.append(want)
            split[name] = True
        else:
            tok_pl.append(Replicate())
            out_pl.append(Replicate())
            split[name] = False
    d0, d1 = local_range(table.shape[1], mesh, out_pl, nd)
    slices[1] = (d0, d1)
    tnames = table.device_mesh.mesh_dim_names
    v0, v1 = local_range(table.shape[0], table.device_mesh,
                         [table.placements[tnames.index(n)] if n in vocab_dims and n in tnames
                          else Replicate() for n in tnames], 0)
    slices[0] = (v0, v1)
    rows = take_weight(table, slices, split)
    idx = take(tokens, tok_pl, {}).long()
    if vocab_dims:
        inside = (idx >= v0) & (idx < v1)
        got = rows[(idx - v0).clamp(0, max(v1 - v0 - 1, 0))] if v1 > v0 else \
            rows.new_zeros((*idx.shape, rows.shape[1]))
        got = torch.where(inside[..., None], got, torch.zeros((), dtype=got.dtype,
                                                              device=got.device))
    else:
        got = rows[idx]
    if post is not None:
        got = post(got)
    out = wrap(got, mesh, out_pl, shape)
    return out.redistribute(mesh, placements) if tuple(out_pl) != tuple(placements) else out


def assign(dst: DTensor, src: DTensor) -> None:
    """Copy ``src`` into ``dst`` (same global shape) in place: ``src``
    redistributed to ``dst``'s placements, each rank writing its shard."""
    src = replicate(src)
    if src.device_mesh != dst.device_mesh:
        raise ValueError("assign needs one mesh")
    loc = src.redistribute(dst.device_mesh, settled(dst.placements)).to_local()
    dst.to_local().copy_(loc)


def assign_row(dst: DTensor, dim: int, index: int, src: DTensor) -> None:
    """``dst.select(dim, index).copy_(src)`` in place, made by the ranks whose
    shard of ``dst`` holds ``index`` on ``dim`` (a decode step's write at
    its position into a cache sharded over positions)."""
    mesh = dst.device_mesh
    pls = settled(dst.placements)
    tgt = []
    for q in pls:  # src lacks dim: dst's dims past it move down one
        if isinstance(q, Shard) and q.dim != dim:
            tgt.append(Shard(q.dim - (q.dim > dim)))
        else:
            tgt.append(Replicate())
    loc = replicate(src).redistribute(mesh, tgt).to_local()
    s0, s1 = local_range(dst.shape[dim], mesh, pls, dim)
    if s0 <= index < s1:
        dst.to_local().select(dim, index - s0).copy_(loc)


def cached_attention_tp(q: DTensor, k: DTensor, v: DTensor, valid: Optional[torch.Tensor],
                        plain: Callable) -> DTensor:
    """Decode's attention against a cache (B, T, Hkv, D) that is sharded
    over its positions (``cache_seq``) and batch: q (B, 1, H, D) is
    gathered over its heads (every rank attends with all heads at its own
    positions), the float32 scores (B, H, 1, T) are gathered over the
    ranks that hold the positions and the softmax taken whole on each
    rank, as the plain code takes it; each rank multiplies its positions'
    probabilities by its values, and the ranks' (B, 1, H, D) shares are
    summed.  What moves: q, the scores and the output, never the cache.
    ``plain`` is the plain :func:`~repro_torch.models.layers.cached_attention`
    (where no rank splits the positions, the whole call runs on each
    rank's batch)."""
    from ..models.layers import _expand_kv, _scores
    from ..models.layers import einsum as plain_einsum

    mesh = k.device_mesh
    names = mesh.mesh_dim_names
    kpl = settled(k.placements)
    qpl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in kpl]
    ql = take(replicate(q), qpl, {})
    kl, vl = k.to_local(), v.to_local()
    b0, b1 = local_range(k.shape[0], mesh, kpl, 0)
    t0, t1 = local_range(k.shape[1], mesh, kpl, 1)
    if valid is not None:
        valid = valid[:, t0:t1] if valid.shape[0] == 1 else valid[b0:b1, t0:t1]
    seq_split = [n for n, p in zip(names, kpl) if isinstance(p, Shard) and p.dim == 1]
    out_shape = (k.shape[0], q.shape[1], q.shape[2], q.shape[3])
    if not seq_split:
        return wrap(plain(ql, kl, vl, valid), mesh, qpl, out_shape)
    H = ql.shape[2]
    ke, ve = _expand_kv(kl, H), _expand_kv(vl, H)
    s = _scores(ql, ke, valid)
    s_pl = [Shard(3) if n in seq_split else p for n, p in zip(names, qpl)]
    whole = wrap(s, mesh, s_pl, (k.shape[0], H, q.shape[1], k.shape[1])).redistribute(
        mesh, qpl).to_local()
    pr = torch.softmax(whole, dim=-1).to(ql.dtype)[..., t0:t1]
    o = plain_einsum("bhst,bthd->bshd", pr, ve)
    o_pl = [Partial() if n in seq_split else p for n, p in zip(names, qpl)]
    return wrap(o, mesh, o_pl, out_shape).redistribute(mesh, qpl)
