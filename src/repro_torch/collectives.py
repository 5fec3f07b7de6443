"""Named mesh axes over process groups: the port's counterpart of the axis
names that ``shard_map`` binds in the JAX package.

A mesh here is either a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the JAX axis names (``"pod"``, ``"data"``,
``"model"``), or a device-free ``MeshShape`` (ordered axis name -> size,
the counterpart of JAX's ``AbstractMesh``) that plans layouts without any
process.  Where the JAX package reduces over a tuple of axes
(``psum(x, ("data", "model"))``), the port reduces over one process group
of their product: ``MeshGroups.group`` builds it with ``dist.new_group``
the first time it is asked, on every rank in the same order, and keeps it.
Importing this module touches no process group.

The collectives of a ``shard_map`` body (``all_gather`` tiled along a
dim, ``psum``, ``psum_scatter``, ``pmean``) run on local tensors over the
groups of named axes and are differentiable: each backward is the
transpose that JAX takes, so that a body's gradients are those of the
global function it computes.  ``to_placements`` turns a ``P`` into
DTensor placements (models read it in ``ModelCtx.constrain``), and
``replicate_like`` hands a constant to a ``DTensor``'s operator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

Axes = Union[str, Sequence[str]]


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    return None if not e else (e[0] if len(e) == 1 else e)


class P(tuple):
    """A PartitionSpec: per tensor dimension None (replicated), an axis name,
    or a tuple of names that split the dimension major to minor.  Entries
    are normalized as JAX's ``PartitionSpec`` normalizes them (a one-name
    tuple is the name, an empty one None), so two specs compare entry by
    entry with ``tuple(a) == tuple(b)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


class MeshShape:
    """Axis names and sizes, no devices: ``MeshShape((16, 16), ("data",
    "model"))``.  ``shape`` maps each name to its size in mesh order, as the
    JAX package's ``Mesh.shape`` and ``AbstractMesh.shape`` do."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} against axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"MeshShape({self.shape})"


def axis_names(mesh) -> tuple:
    """The mesh's axis names in mesh order."""
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no named axes")
    return tuple(names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size, in mesh order, for a ``MeshShape`` or a
    ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


def _as_tuple(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Optional[Axes]) -> int:
    """The product of the named axes' sizes (1 for None or no mesh)."""
    if mesh is None or axes is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _as_tuple(axes))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index along the named axes, major to minor in the order
    given (``jax.lax.axis_index`` combined as the JAX package's
    ``seq_shard_start`` combines it)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    idx = 0
    for a in _as_tuple(axes):
        idx = idx * sizes[a] + coord[names.index(a)]
    return idx


class MeshGroups:
    """The process groups of one ``DeviceMesh``'s named axes.

    ``group(axes)`` is the group of the ranks that share this rank's
    coordinates on every other axis, the ranks ordered by their index along
    ``axes``; ``members(axes)`` lists them in that order.  A single axis is
    the mesh's own group of that dimension; a tuple of several axes is
    built with ``dist.new_group`` once, the first time any rank asks for it,
    which every rank must then do at the same point of the program (as it
    does when every rank runs the same model code)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._built: dict = {}
        # the rank table as numpy: groups are planned with no tensor
        # operator (a traced program's fake mode would take it over)
        self._ranks = np.asarray(mesh.mesh.tolist())

    def _rows(self, axes: tuple):
        """Every group of ``axes`` as the rank lists, each ordered by the
        index along ``axes``, the groups in mesh order."""
        names = axis_names(self.mesh)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = self._ranks.transpose(*rest, *dims)
        return ranks.reshape(-1, math.prod(ranks.shape[len(rest):])).tolist()

    def members(self, axes: Axes) -> list:
        axes = _as_tuple(axes)
        me = dist.get_rank()
        for row in self._rows(axes):
            if me in row:
                return row
        raise RuntimeError("this rank is not in the mesh")

    def group(self, axes: Axes):
        axes = _as_tuple(axes)
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if axes not in self._built:
            me, mine = dist.get_rank(), None
            for row in self._rows(axes):
                g = dist.new_group(row)       # every rank, every row, in order
                if me in row:
                    mine = g
            self._built[axes] = mine
        return self._built[axes]


def all_gather_ordered(t: torch.Tensor, groups: MeshGroups, axes: Axes,
                       dim: int) -> torch.Tensor:
    """The shards of ``t`` over ``axes`` concatenated along ``dim`` in the
    order of the index along ``axes`` (a dimension sharded over those axes,
    made whole)."""
    axes = _as_tuple(axes)
    members = groups.members(axes)
    if len(members) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in members]
    dist.all_gather(parts, t, group=groups.group(axes))
    # all_gather fills the list in group-rank order, which is global-rank order
    by_rank = dict(zip(sorted(members), parts))
    return torch.cat([by_rank[r] for r in members], dim=dim)


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension the
    tensor dim it shards, or ``Replicate()``."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _as_tuple(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {entry} are not in mesh order "
                             f"{names}, which DTensor's Shard cannot express")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]} used twice")
            out[i] = Shard(dim)
    return out


def replicate_like(t: torch.Tensor, like) -> torch.Tensor:
    """A constant ``t`` (the same on every rank: positions, a mask, RoPE's
    angles) as a replicated ``DTensor`` on the mesh of ``like`` when
    ``like`` is a ``DTensor``, so the two meet in one operator; ``t`` as it
    is otherwise."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


class _GradAsForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.spec = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.spec)


def grad_as_forward(x):
    """A ``DTensor`` ``x`` as it is, its gradient moved to ``x``'s own
    placements before it flows on (a flat dim whose gradient comes split
    over an axis that does not divide its heads could not be cut into
    them); a plain tensor as it is."""
    return _GradAsForward.apply(x) if isinstance(x, DTensor) else x


# ------------------------------------------------- shard_map's collectives
def _rank_order(groups: MeshGroups, axes: tuple) -> list:
    """Each member's position in the group's own rank order (the order of
    ``all_gather_into_tensor``'s and ``reduce_scatter_tensor``'s chunks),
    listed by index along ``axes``."""
    members = groups.members(axes)
    by_rank = sorted(members)
    return [by_rank.index(r) for r in members]


def _gather(t, groups, axes, dim):
    order = _rank_order(groups, axes)
    n = len(order)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=groups.group(axes))
    parts = out.chunk(n)
    return torch.cat([parts[i] for i in order], dim=0).movedim(0, dim)


def _scatter_sum(t, groups, axes, dim):
    order = _rank_order(groups, axes)
    n = len(order)
    if n == 1:
        return t
    parts = t.movedim(dim, 0).chunk(n)
    by_pos = [None] * n
    for idx, pos in enumerate(order):
        by_pos[pos] = parts[idx]
    x = torch.cat(by_pos, dim=0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                               group=groups.group(axes))
    return out.movedim(0, dim)


def _my_slice(t, groups, axes, dim):
    n = len(groups.members(axes))
    w = t.shape[dim] // n
    return t.narrow(dim, axis_index(groups.mesh, axes) * w, w)


def _sum(t, groups, axes):
    if len(groups.members(axes)) == 1:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=groups.group(axes))
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes, dim, same):
        ctx.args = (groups, axes, dim, same)
        return _gather(t, groups, axes, dim)

    @staticmethod
    def backward(ctx, g):
        groups, axes, dim, same = ctx.args
        if same:
            return _my_slice(g, groups, axes, dim), None, None, None, None
        return _scatter_sum(g, groups, axes, dim), None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes):
        return _sum(t, groups, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes, dim):
        ctx.args = (groups, axes, dim)
        return _scatter_sum(t, groups, axes, dim)

    @staticmethod
    def backward(ctx, g):
        groups, axes, dim = ctx.args
        return _gather(g, groups, axes, dim), None, None, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes):
        ctx.n = len(groups.members(axes))
        return _sum(t, groups, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, axes):
        ctx.args = (groups, axes)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        groups, axes = ctx.args
        for a in axes:                      # one axis at a time: its own group
            g = _sum(g, groups, (a,))
        return g, None, None


def sum_grad(t: torch.Tensor, groups: MeshGroups, axes: Axes) -> torch.Tensor:
    """``t`` as it is; its gradient summed over ``axes`` (the dual of
    ``psum``: each rank of them holds a part of the gradient of the same
    value)."""
    return _SumGrad.apply(t, groups, _as_tuple(axes))


def local_map_summed(fn, out_placements, in_placements, in_grad_placements,
                     mesh, groups: MeshGroups):
    """``local_map`` of ``fn`` on ``mesh`` whose inputs' gradients may be
    partial sums over some mesh dims (``Partial()`` in
    ``in_grad_placements``): those are summed inside, over the dims'
    process groups (``sum_grad``), so that every gradient leaves the
    function whole and replicated on them, never as a partial DTensor."""
    names = axis_names(mesh)
    summed = [tuple(names[i] for i, p in enumerate(g) if isinstance(p, Partial))
              for g in in_grad_placements]
    grads = tuple([Replicate() if isinstance(p, Partial) else p for p in g]
                  for g in in_grad_placements)

    def wrapped(*args):
        return fn(*(sum_grad(a, groups, ax) if ax else a
                    for a, ax in zip(args, summed)))

    return local_map(wrapped, out_placements=out_placements,
                     in_placements=in_placements, in_grad_placements=grads,
                     device_mesh=mesh)


def all_gather(t: torch.Tensor, groups: MeshGroups, axes: Axes, dim: int,
               same_grad: bool = False) -> torch.Tensor:
    """``jax.lax.all_gather(t, axes, axis=dim, tiled=True)``: the shards of
    ``t`` over ``axes`` concatenated along ``dim`` in the order of the index
    along them.  The backward sums each rank's gradient of the whole over
    ``axes`` and keeps this rank's slice (a reduce-scatter), as JAX
    transposes it; ``same_grad`` says the ranks of ``axes`` compute the same
    thing from the whole, so the gradient is the same on every rank and is
    sliced, not summed."""
    return _AllGather.apply(t, groups, _as_tuple(axes), dim, same_grad)


def psum(t: torch.Tensor, groups: MeshGroups, axes: Axes) -> torch.Tensor:
    """``jax.lax.psum``: the sum over ``axes``, the same on every rank of
    them; its gradient reaches each rank's term unchanged."""
    return _Psum.apply(t, groups, _as_tuple(axes))


def psum_scatter(t: torch.Tensor, groups: MeshGroups, axes: Axes,
                 dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(t, axes, scatter_dimension=dim, tiled=True)``:
    the sum over ``axes``, this rank's slice of it along ``dim`` (by its
    index along ``axes``); the backward gathers the slices' gradients."""
    return _PsumScatter.apply(t, groups, _as_tuple(axes), dim)


def pmean(t: torch.Tensor, groups: MeshGroups, axes: Axes) -> torch.Tensor:
    """``jax.lax.pmean``: the mean over ``axes``; each rank's term gets
    ``1 / n`` of the gradient."""
    return _Pmean.apply(t, groups, _as_tuple(axes))
