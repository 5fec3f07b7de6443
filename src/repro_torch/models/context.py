"""ModelCtx: the mesh, the sharding rules and the lowering flags threaded
through the models.

The port of ``repro.models.context``.  Models never import
``repro_torch.launch``: the launcher builds a ModelCtx from its sharding
policy (``launch.sharding.Policy.ctx``) and passes it down.  With
``mesh=None`` (one device) every collective degrades to the identity, so
the same model code runs on one card.

``mesh`` is a ``DeviceMesh`` with the JAX axis names, or a device-free
``MeshShape`` for planning.  On a ``DeviceMesh``, ``groups`` holds the
process groups of its named axes (``collectives.MeshGroups``), built once
for the ctx.  ``decode_plan`` (``launch.sharding.DecodePlan``) lays out
the decode caches: under a plan on a ``DeviceMesh`` every decode step runs
the shard-aware path (``blocks._distributed_decode``,
``mla._distributed_mla_decode``), whose collectives are the JAX package's
``shard_map`` ones; ``decode_attn`` is the plan's mode, ``"distributed"``
when the cache sequence is sharded.

On a ``DeviceMesh`` the prefill and training forward run sharded, as the
JAX package's jitted program does under the same rules: parameters and
batches are ``DTensor``s placed by the policy (``launch.sharding``'s
``place_state`` / ``place_batch``), and ``constrain(x, role)`` moves an
activation to the placements of ``rules[role]``
(``x.redistribute``), where the JAX package puts a
``with_sharding_constraint``.  It is the identity with no mesh, on a
``MeshShape``, for a role without a rule, and for a plain tensor (the
decode's local tensors, which the shard-aware decode lays out itself).
The hand-written kernels run on each rank's local shard
(``torch.distributed.tensor.experimental.local_map``), and the MoE FFN
runs the JAX package's ``shard_map`` body on local tensors over
``groups`` when ``use_shard_map`` is set.  Constants made inside the
model (positions, masks, RoPE angles) meet DTensors as replicated
DTensors (``collectives.replicate_like``).  ``policy`` is the
``launch.sharding.Policy`` that built the ctx (None otherwise); the
``Trainer`` and ``Server`` place their state by it.

``remat`` is the JAX package's: ``"full"`` recomputes each layer body in
the backward (``torch.utils.checkpoint``, where the JAX package applies
``jax.checkpoint`` to its scan body), ``"none"`` keeps the activations.
``kernels`` is the port's own field: ``"ref"`` sends every ``kops`` call on
the model path to its plain PyTorch version (the model-level form of
``ops``'s ``force``; tests and ``chip_smoke.py`` set it to hold the kernels
against their plain versions), ``None`` lets the device decide.  The port
reads one more key of ``rules``, ``"mla_materialized"``
(``models.mla.mla_train``'s form).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch.distributed.tensor import DTensor

from repro_torch.collectives import (MeshGroups, MeshShape, P, axis_size,
                                     to_placements)

REMAT = ("none", "full")
DECODE_ATTN = ("local", "distributed")


@dataclasses.dataclass
class ModelCtx:
    mesh: object = None            # DeviceMesh | MeshShape | None
    # logical role -> PartitionSpec (launch/sharding.py's policy)
    rules: dict = dataclasses.field(default_factory=dict)
    data_axes: tuple = ("data",)   # ('pod', 'data') on the multi-pod mesh
    fsdp_axis: Optional[str] = "data"
    model_axis: Optional[str] = "model"
    # the JAX package's chunked attention (MLA's plain attention routes by
    # them as the reference does; the flash kernel's forward runs at every
    # length whatever their value, ``attn_chunk`` its backward's key chunk)
    use_chunked_attn: bool = True
    attn_chunk: int = 1024
    remat: str = "full"            # none | full (checkpoint each layer body)
    decode_attn: str = "local"     # local | distributed (LSE-combine over seq shards)
    decode_plan: object = None     # launch.sharding.DecodePlan under a policy
    use_shard_map: bool = True     # MoE on a mesh: the shard_map body
    kernels: Optional[str] = None  # None (by device) | "ref" | "cuda"
    # the mesh's process groups, built from ``mesh`` (not an argument)
    groups: Optional[MeshGroups] = dataclasses.field(default=None, init=False,
                                                     repr=False)
    policy: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.remat not in REMAT:
            raise ValueError(f"remat={self.remat!r}: one of {REMAT}")
        if self.decode_attn not in DECODE_ATTN:
            raise ValueError(f"decode_attn={self.decode_attn!r}: one of {DECODE_ATTN}")
        if self.mesh is not None and not isinstance(self.mesh, MeshShape):
            self.groups = MeshGroups(self.mesh)

    @property
    def sharded_decode(self) -> bool:
        """Decode runs the shard-aware path: a plan on a mesh of processes."""
        return self.decode_plan is not None and self.groups is not None

    @property
    def sharded(self) -> bool:
        """On a mesh of processes (the forward takes DTensors, the decode
        its local tensors)."""
        return self.groups is not None

    def constrain(self, x, role: str):
        """``x`` moved to the placements of ``rules[role]``."""
        if role not in self.rules:
            return x
        return self.place(x, self.rules[role])

    def place(self, x, spec):
        """A DTensor ``x`` moved to ``spec``, also a layout that the JAX
        program holds without a rule of its own (the flat projections
        before their heads are split, a kernel's inputs); plain tensors as
        they are."""
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, to_placements(spec, self.mesh))

    def gather_seq(self, x):
        """A residual-stream DTensor (B, S, D) with its sequence whole, the
        batch over the residual's batch axes: the sequence-parallel gather
        before a projection (a product over a sharded sequence dim would
        flatten it with the batch); plain tensors as they are."""
        if not isinstance(x, DTensor) or "residual" not in self.rules:
            return x
        return self.place(x, P(self.rules["residual"][0], None, None))

    def spec(self, role: str) -> P:
        return self.rules.get(role, P())

    @property
    def batch_axes(self):
        return self.data_axes

    def axis_size(self, name) -> int:
        return axis_size(self.mesh, name)


def null_ctx(**kw) -> ModelCtx:
    return ModelCtx(mesh=None, use_shard_map=False, **kw)
