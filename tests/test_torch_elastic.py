"""The port's elastic re-deployment (``repro_torch.launch.elastic``) against
the JAX package's ``repro.launch.elastic``.

* ``slice_shape(c)`` is the (data, model) shape of JAX's ``slice_mesh(c)``
  for c in 1..8, with the default and a smaller ``max_model``.
* The reduced qwen1.5-0.5b train state, saved by either package after two
  training steps, restores onto four spawned gloo ranks as a (2, 2) mesh
  (``slice_mesh(4, max_model=2)``), for the "train" policy (dp_only: every
  leaf replicated) and the "decode" one (TP and FSDP over the mesh).  Each
  rank's local block of every leaf is bit-equal (``torch.equal``, no
  tolerance) to the addressable shard of JAX's ``restore_onto`` on a (2, 2)
  mesh of four fake host devices at the same mesh coordinates.
* On a world of one (``init_world_of_one("cpu")``), ``slice_mesh()`` is
  (1, 1), the restore gives every leaf back whole, and a ``Server`` of the
  migrated parameters generates the tokens of one fed the saved ones.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import _torch_port  # noqa: F401  (one intra-op thread)

import jax
from _torch_dist import restore_worker, run_ranks
from repro.checkpoint import LocalObjectStore as JStore
from repro.configs.base import get_config as jget
from repro.launch.elastic import ElasticTrial as JTrial
from repro.launch.elastic import slice_mesh as jslice_mesh
from repro.launch.train import Trainer as JTrainer
from repro_torch.checkpoint import LocalObjectStore
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.elastic import (ElasticTrial, full_state, reshard_state,
                                        slice_mesh, slice_shape, state_shardings)
from repro_torch.launch.mesh import init_world_of_one
from repro_torch.launch.serve import Server
from repro_torch.launch.train import Trainer
from repro_torch.models.model import _to_tensor
from repro_torch.optim.optimizers import tree_leaves

ARCH = "qwen1.5-0.5b"
KINDS = ("train", "decode")


@pytest.mark.parametrize("max_model", [16, 2])
@pytest.mark.parametrize("chips", range(1, 9))
def test_slice_shape_equals_jax(chips, max_model):
    assert slice_shape(chips, max_model).shape == dict(
        jslice_mesh(chips, max_model).shape)


def _jax_blocks(jstate, jmesh):
    """keystr -> {rank: numpy block} of every leaf, the rank of a device
    being its row-major index in the mesh (as the port's mesh places
    ranks)."""
    devs = list(np.asarray(jmesh.devices).reshape(-1))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        out[jax.tree_util.keystr(path)] = {
            devs.index(s.device): np.asarray(s.data) for s in leaf.addressable_shards}
    return out


def _save(writer, tmp_path):
    """Two training steps of the reduced model in the ``writer``'s package,
    saved at step 2 -> (store dir, JAX state template)."""
    d = str(tmp_path / "store")
    jtr = JTrainer(jget(ARCH, reduced=True), batch=2, seq=16, seed=0)
    if writer == "jax":
        jtr.run_steps(2)
        JTrial(jget(ARCH, reduced=True), JStore(d), "trial").save(jtr.step, jtr.state)
    else:
        ttr = Trainer(tget(ARCH, reduced=True), batch=2, seq=16, seed=0, device="cpu")
        ttr.run_steps(2)
        ElasticTrial(tget(ARCH, reduced=True), LocalObjectStore(d), "trial").save(
            ttr.step, ttr.state)
    return d, jax.eval_shape(lambda: jtr.state)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_restore_onto_2x2_matches_jax_shards(writer, tmp_path):
    store_dir, jshapes = _save(writer, tmp_path)
    jmesh = jslice_mesh(4, max_model=2)
    assert dict(jmesh.shape) == {"data": 2, "model": 2}
    ranks = run_ranks(restore_worker, 4, tmp_path, ARCH, None, store_dir, "trial",
                      KINDS)
    sharded = 0
    for kind in KINDS:
        jstate, jstep = JTrial(jget(ARCH, reduced=True), JStore(store_dir), "trial",
                               kind=kind).restore_onto(jmesh, jshapes)
        want = _jax_blocks(jstate, jmesh)
        for rank, res in enumerate(ranks):
            assert res["mesh"] == (2, 2) and res["coord"] == divmod(rank, 2)
            got = res[kind]
            assert got["step"] == jstep == 2 and set(got["leaves"]) == set(want)
            for path, (local, placements) in got["leaves"].items():
                block = want[path][rank]
                if placements is None:                  # the optimizer's step
                    assert local == int(block), path
                    continue
                assert torch.equal(local, _to_tensor(block, "cpu")), (kind, path, rank)
                sharded += any(d is not None for d in placements)
    # "train" replicates the small model (dp_only); "decode" shards it
    assert sharded > 0


def test_world_of_one_restore_and_serve(tmp_path):
    """The card's migration on the CPU: train, save, restore onto
    ``slice_mesh()`` of a world of one, serve from the migrated weights."""
    cfg = tget(ARCH, reduced=True)
    tr = Trainer(cfg, batch=2, seq=16, seed=0, device="cpu")
    tr.run_steps(2)
    trial = ElasticTrial(cfg, LocalObjectStore(str(tmp_path / "s")), "t")
    trial.save(tr.step, tr.state)
    started = init_world_of_one("cpu")
    try:
        assert started and dist.get_world_size() == 1
        mesh = slice_mesh(device_type="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)
        state, step = trial.restore_onto(mesh, tr.state)
        assert step == 2
        for a, b in zip(tree_leaves(tr.state), tree_leaves(state)):
            if isinstance(a, torch.Tensor):
                assert b.placements and torch.equal(b.to_local(), a)
            else:
                assert a == b
        # reshard_state from DTensors of one mesh onto a policy of another
        again = reshard_state(state, state_shardings(cfg, mesh, tr.state, "decode"))
        assert all(torch.equal(x.full_tensor(), y.full_tensor())
                   for x, y in zip(tree_leaves(again["params"]),
                                   tree_leaves(state["params"])))
        prompts = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))}
        moved = Server(cfg, full_state(state["params"]), max_len=24, device="cpu")
        kept = Server(cfg, tr.state["params"], max_len=24, device="cpu")
        assert torch.equal(moved.generate(prompts, 8), kept.generate(prompts, 8))
    finally:
        if started:
            dist.destroy_process_group()
