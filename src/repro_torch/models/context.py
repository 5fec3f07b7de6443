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

``constrain`` is the identity: the port's prefill and training forward
run each rank's work replicated, not tensor- or sequence-parallel yet, so
the activation rules (``rules["residual"]`` and the like) are planned and
compared but not applied.  ``use_shard_map`` is kept for the JAX package's
constructor: the port's MoE runs its local math on every rank.

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

from repro_torch.collectives import MeshGroups, MeshShape, P, axis_size

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
    use_chunked_attn: bool = True  # kept for the JAX package's constructor
    # key chunk of the flash backward (the JAX package's flash chunk); the
    # forward runs the flash kernel at every length whatever its value
    attn_chunk: int = 1024
    remat: str = "full"            # none | full (checkpoint each layer body)
    decode_attn: str = "local"     # local | distributed (LSE-combine over seq shards)
    decode_plan: object = None     # launch.sharding.DecodePlan under a policy
    use_shard_map: bool = True     # kept for the JAX package's constructor
    kernels: Optional[str] = None  # None (by device) | "ref" | "cuda"
    # the mesh's process groups, built from ``mesh`` (not an argument)
    groups: Optional[MeshGroups] = dataclasses.field(default=None, init=False,
                                                     repr=False)

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

    def constrain(self, x, role: str):
        return x

    def spec(self, role: str) -> P:
        return self.rules.get(role, P())

    @property
    def batch_axes(self):
        return self.data_axes

    def axis_size(self, name) -> int:
        return axis_size(self.mesh, name)


def null_ctx(**kw) -> ModelCtx:
    return ModelCtx(mesh=None, use_shard_map=False, **kw)
