"""Elastic re-deployment: move a training state between meshes (the port of
``repro.launch.elastic``).

This is the substrate under SpotTune's Algorithm-1 re-deployment (lines
38-44): a revoked trial's checkpoint is restored onto whatever slice the
Provisioner picks next, which generally has a different chip count and hence
a different mesh.  Three pieces:

  * ``slice_mesh(chips)`` — the mesh a slice of ``chips`` ranks exposes
    (model axis capped at the slice's efficient TP width, remainder to
    data); ``slice_shape`` is its device-free shape;
  * ``reshard_state(state, shardings)`` — every leaf placed to the sharding
    the target policy assigns it (from whole tensors or from ``DTensor``s
    of another mesh);
  * ``ElasticTrial`` — checkpoint-backed save / restore-onto-a-new-mesh.

A restored leaf is a ``DTensor`` on the target mesh: each rank holds its
own block, which it cut from the leaf it had just read.  On one card the
mesh is (1, 1) and every block is the whole leaf.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import restore_pytree, save_pytree
from repro_torch.collectives import MeshShape
from repro_torch.launch.mesh import device_mesh
from repro_torch.launch.sharding import Policy, full_state, place, restore_hook


def slice_shape(chips: int, max_model: int = 16) -> MeshShape:
    """The (data, model) shape of a slice of ``chips``: model = the largest
    power-of-two divisor of ``chips`` up to ``max_model``; the rest is
    data/FSDP — the layout the production 16x16 pod uses, shrunk."""
    model = 1
    while model * 2 <= min(max_model, chips) and chips % (model * 2) == 0:
        model *= 2
    return MeshShape((chips // model, model), ("data", "model"))


def slice_mesh(chips: Optional[int] = None, max_model: int = 16,
               device_type: str = "cuda"):
    """``DeviceMesh`` of ``slice_shape`` over the first ``chips`` ranks of
    the default process group (all of them by default)."""
    n_avail = dist.get_world_size() if dist.is_initialized() else 1
    chips = min(chips or n_avail, n_avail)
    shape = slice_shape(chips, max_model)
    return device_mesh(tuple(shape.shape.values()), shape.axis_names, device_type)


def state_shardings(cfg, mesh, state_shapes, kind: str = "train",
                    global_batch: Optional[int] = None):
    """``NamedSharding``s for a {params, opt} train state on ``mesh``."""
    return Policy(cfg, mesh, kind, global_batch=global_batch).state_shardings(
        state_shapes)


def reshard_state(state, shardings):
    """Every tensor leaf placed onto its target sharding (a ``DTensor`` of
    another mesh gathered whole first); int leaves as they are."""
    return place(state, shardings)


class ElasticTrial:
    """Checkpoint-backed migration: save on slice A, restore sharded on B.

    The restore path never holds more than one leaf whole on a rank: each
    leaf is read from the store and cut to this rank's block before the next
    is read (the store layout is one object per leaf)."""

    def __init__(self, cfg, store, prefix: str, kind: str = "train"):
        self.cfg = cfg
        self.store = store
        self.prefix = prefix
        self.kind = kind

    def save(self, step: int, state, blocking: bool = True):
        """Write ``state`` (whole tensors, or ``DTensor``s gathered whole
        leaf by leaf); on a process group of several ranks rank 0 writes and
        the others wait for it."""
        state = full_state(state)
        if dist.is_initialized() and dist.get_world_size() > 1:
            h = (save_pytree(self.store, self.prefix, step, state, blocking=True)
                 if dist.get_rank() == 0 else None)
            dist.barrier()
            return h
        return save_pytree(self.store, self.prefix, step, state,
                           blocking=blocking)

    def restore_onto(self, mesh, like, step: Optional[int] = None,
                     global_batch: Optional[int] = None):
        """(state, step): the checkpoint laid out by ``Policy(cfg, mesh,
        kind)``, every tensor leaf a ``DTensor`` on ``mesh``.  ``like`` is a
        state of the same structure, shapes and types (tensors on any
        device, ``meta`` included)."""
        shardings = state_shardings(self.cfg, mesh, like, self.kind, global_batch)
        return restore_pytree(self.store, self.prefix, like, step=step,
                              sharding_fn=restore_hook(shardings, like))

