"""Launchers: ``serve`` (batched greedy decoding, on one device or on a
mesh), ``train`` (the train step and ``Trainer`` with checkpoint/restart),
the distribution layer — ``mesh`` (``DeviceMesh`` meshes with the JAX axis
names, the device-free ``MeshShape``, ``init_world_of_one``), ``sharding``
(the divisibility-aware ``Policy``, ``DecodePlan``, ``NamedSharding``) and
``elastic`` (``slice_mesh``, ``reshard_state``, ``ElasticTrial``: a
checkpoint restored onto another mesh) — ``roofline`` (the simulated
pool's rates, the H100's, and the three-term roofline of the dry run's
artifacts), ``cost`` (the per-device cost of a traced program, the
counterpart of the JAX package's HLO walk) and ``dryrun`` (one rank's
program of every cell traced on fake tensors of a fake world)."""

from repro_torch.launch.elastic import (ElasticTrial, reshard_state, slice_mesh,
                                        slice_shape, state_shardings)
from repro_torch.launch.mesh import (MeshShape, init_world_of_one,
                                     make_production_mesh, make_small_mesh)
from repro_torch.launch.sharding import DecodePlan, NamedSharding, Policy

__all__ = ["DecodePlan", "ElasticTrial", "MeshShape", "NamedSharding", "Policy",
           "init_world_of_one", "make_production_mesh", "make_small_mesh",
           "reshard_state", "slice_mesh", "slice_shape", "state_shardings"]
