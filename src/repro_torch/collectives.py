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
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

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

    def _rows(self, axes: tuple):
        """Every group of ``axes`` as the rank lists, each ordered by the
        index along ``axes``, the groups in mesh order."""
        names = axis_names(self.mesh)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = self.mesh.mesh.permute(*rest, *dims)
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
