"""Meshes: functions, not module-level constants (the port of
``repro.launch.mesh``).  Importing this module touches no process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, with the JAX package's axis names: ``data``
carries DP/FSDP, ``model`` TP/SP/EP, and ``pod`` (the multi-pod mesh) pure
DP.  ``MeshShape`` is the device-free mesh that a ``Policy`` plans on
(16x16 and 2x16x16 without 256 ranks).  ``init_world_of_one`` starts a
process group of one rank for a caller that has none (one card: NCCL; the
CPU: gloo).  ``init_fake_world`` starts a world of N ranks on PyTorch's
"fake" backend in one process, as its last rank, whose collectives return at
once: on it the meshes are built without a card (no ``resolve_device``)
and a program is traced on fake tensors (``launch.dryrun``), as the JAX
package's dry run fakes its fleet with host devices.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.collectives import MeshShape, axis_names
from repro_torch.device import resolve_device

__all__ = ["MeshShape", "make_production_mesh", "make_small_mesh",
           "device_mesh", "data_axes_of", "model_axis_of", "init_world_of_one",
           "init_fake_world", "fake_world"]


def device_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over ranks 0..prod(shape)-1 of the
    default process group, row-major (rank r at the coordinates of r in
    ``shape``, as ``jax.make_mesh`` places devices).  Every rank of the
    group calls it; ranks past the mesh get no coordinate.  On a fake world
    (``init_fake_world``) the device type is taken as it is: no card is
    asked for."""
    dev = torch.device(device_type) if fake_world() else resolve_device(device_type)
    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        raise RuntimeError("no default process group: start one "
                           "(init_world_of_one on one device)")
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {tuple(shape)} needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    Axes: ``data`` carries DP/FSDP, ``model`` carries TP/SP/EP; the ``pod``
    axis is pure DP (the gradient all-reduce crosses pods, never FSDP)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, axes, device_type)


def make_small_mesh(shape=(2, 4), axes=("data", "model"), device_type: str = "cuda"):
    """Reduced mesh for tests (a few ranks)."""
    return device_mesh(shape, axes, device_type)


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis_of(mesh) -> str:
    return "model"


def init_world_of_one(device="cuda") -> bool:
    """Start a default process group of world size 1 if there is none:
    NCCL for ``device="cuda"`` (the default), gloo for ``"cpu"``.  The
    rendezvous is an in-process ``HashStore``: no port, no file.  Returns
    True when it started the group (the caller ends it with
    ``dist.destroy_process_group()``), False when one was running, whose
    backend must then serve the device: the card is never handed a gloo
    group."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if backend not in str(dist.get_backend()):
            raise RuntimeError(f"the running process group's backend is "
                               f"{dist.get_backend()!r}; {dev.type} needs {backend}")
        return False
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        kw["device_id"] = torch.device("cuda", dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)
    return True


def fake_world() -> bool:
    """The default process group runs on the "fake" backend."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def init_fake_world(n: int) -> None:
    """Start a default process group of ``n`` ranks on the "fake" backend
    (``torch.testing._internal.distributed.fake_pg``), this process the
    last rank, ``n - 1``: every collective returns at once and moves
    nothing.  The last rank because the ranks' programs differ only where
    the data-parallel-only layout splits the sequence over the model axis,
    and there the causal attention of the last model rank's block sees
    every key, of the first only its own: the last rank's work sets the
    step's time.  Refuses when a group is running.  End it with
    ``dist.destroy_process_group()``."""
    if dist.is_initialized():
        raise RuntimeError(f"a process group is running ({dist.get_backend()}, "
                           f"{dist.get_world_size()} ranks); the fake world "
                           "needs the default group to itself")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=int(n) - 1,
                            world_size=int(n))
