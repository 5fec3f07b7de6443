"""The port's MoE on a mesh, the JAX package's ``shard_map`` route, against
the JAX package's sharded program (fault C7: the port used to run the local
math on every rank of a mesh).

The port runs ``_moe_shard_body`` on each (data, model) shard's local
tensors under ``local_map``, its collectives over ``ModelCtx.groups``; the
JAX package runs ``shard_map`` of the same body inside ``jax.jit`` with the
policy's ``in_shardings`` on fake host devices (``_jax_sharded``).  Both
take the same ``Policy`` arguments, float32 reduced configs, JAX-initialized
weights and the same ``sample_train_batch`` batch (B = 4, S = 16), spawned
once per mesh (``_torch_dist.sharded_worker``).

Cases: grok-1 (MoE "tp": every shard all 4 experts, a slice of their
hidden dim; attention "expand" on (2, 4)) and deepseek-v2 (MoE "ep": 8
experts over ``model``, ``e_start`` from the model index; MLA) with
``dp_only_threshold=0`` on (2, 4) and (2, 2); deepseek-v2 under the default
(DP-only) policy on (2, 4), where the experts are still split over
``model`` inside the body, the weights sliced from their replicated
copies.  All of them sequence-parallel (S % model == 0): the token shard
gathered over ``model`` and the output reduce-scattered back.

Limits, set before the first run: the loss within 1e-5 relative of JAX's
*sharded* loss, every gradient leaf within 1e-4 of its largest, whole and
as each rank's block against JAX's ``addressable_shards``, prefill's
last-position logits within 1e-4 of JAX's sharded prefill.  And C7 shown:
on (2, 4) the sharded loss of both MoE archs is *not* within 1e-5 of the
unsharded loss (capacity per shard, aux averaged over shards).
"""

import functools

import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

import _jax_sharded as J
from _torch_dist import _batch, run_ranks, sharded_worker
from repro_torch.configs.base import get_config as tget
from repro_torch.models.model import Model, params_from_numpy

LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-4
B, S = 4, 16
GROK, DEEPSEEK = "grok-1-314b", "deepseek-v2-236b"

# name -> (mesh, arch, dp_only_threshold)
GRAD = {
    "grok-tp": ((2, 4), GROK, 0),
    "deepseek-ep": ((2, 4), DEEPSEEK, 0),
    "deepseek-ep-dp-only": ((2, 4), DEEPSEEK, 1e9),
    "grok-tp-2x2": ((2, 2), GROK, 0),
    "deepseek-ep-2x2": ((2, 2), DEEPSEEK, 0),
}
PREFILL = {
    "grok-prefill": ((2, 4), GROK, 0),
    "deepseek-prefill": ((2, 4), DEEPSEEK, 0),
}


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    cfg = J.cfg_of(arch)
    return cfg, J.init_numpy(cfg), J.batch_numpy(cfg, B, S)


def _cases(mesh):
    out = []
    for kind, table in (("grad", GRAD), ("prefill", PREFILL)):
        for name, (m, arch, thr) in table.items():
            if m == mesh:
                _, p, b = _inputs(arch)
                out.append({"name": name, "kind": kind, "arch": arch, "thr": thr,
                            "params": p, "batch": b, "max_len": S})
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    runs = {}

    def get(mesh):
        if mesh not in runs:
            try:
                runs[mesh] = run_ranks(sharded_worker, mesh[0] * mesh[1],
                                       tmp_path_factory.mktemp("ranks"), mesh,
                                       _cases(mesh), deadline=600)
            except Exception as e:      # one spawn a mesh, failed or not
                runs[mesh] = e
        if isinstance(runs[mesh], Exception):
            raise runs[mesh]
        return runs[mesh]
    return get


@functools.lru_cache(maxsize=None)
def _jax_grad(name):
    mesh, arch, thr = GRAD[name]
    cfg, p, b = _inputs(arch)
    loss, grads, jmesh = J.sharded_loss_and_grads(cfg, p, b, mesh, thr)
    return loss, J.flat(grads), J.blocks(grads, jmesh)


def _close(got, want, scale):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) <= GRAD_TOL * max(scale, 1e-30)


@pytest.mark.parametrize("name", list(GRAD))
def test_sharded_moe_loss_matches_jax_sharded(name, port_runs):
    mesh = GRAD[name][0]
    got, want = port_runs(mesh)[0][name]["loss"], _jax_grad(name)[0]
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
    assert len({r[name]["loss"] for r in port_runs(mesh)}) == 1


@pytest.mark.parametrize("name", list(GRAD))
def test_sharded_moe_gradients_match_jax_sharded(name, port_runs):
    mesh = GRAD[name][0]
    got, want = port_runs(mesh)[0][name]["full"], _jax_grad(name)[1]
    assert set(got) == set(want)
    bad = [path for path in want
           if not _close(got[path], want[path], np.max(np.abs(want[path])))]
    assert not bad, bad


@pytest.mark.parametrize("name", list(GRAD))
def test_moe_local_gradient_blocks_match_jax_shards(name, port_runs):
    mesh = GRAD[name][0]
    _, full, blocks = _jax_grad(name)
    for rank, res in enumerate(port_runs(mesh)):
        for path, (local, _) in res[name]["local"].items():
            want = blocks[path][rank]
            assert tuple(local.shape) == want.shape, (path, rank)
            assert _close(local, want, np.max(np.abs(full[path]))), (path, rank)


@pytest.mark.parametrize("name", ["grok-tp", "deepseek-ep"])
def test_sharded_moe_loss_differs_from_unsharded(name, port_runs):
    """C7: the shard_map route computes another function than the local
    math (per-shard capacity, aux averaged over the shards), as the JAX
    package's does; the port's sharded loss is that one, not the
    unsharded one."""
    mesh, arch, _ = GRAD[name]
    cfg, p, b = _inputs(arch)
    tcfg = J.dataclasses.replace(tget(arch, reduced=True), dtype="float32")
    with torch.no_grad():
        unsharded = float(Model(tcfg).loss(params_from_numpy(tcfg, p, device="cpu"),
                                           _batch(b))[0])
    assert abs(unsharded - J.loss_and_grads(cfg, p, b)[0]) <= LOSS_TOL * abs(unsharded)
    sharded = port_runs(mesh)[0][name]["loss"]
    assert abs(sharded - unsharded) > LOSS_TOL * abs(unsharded), (sharded, unsharded)


@pytest.mark.parametrize("name", list(PREFILL))
def test_sharded_moe_prefill_matches_jax(name, port_runs):
    mesh, arch, thr = PREFILL[name]
    cfg, p, b = _inputs(arch)
    batch = {k: v for k, v in b.items() if k != "labels"}
    want = J.prefill_logits(cfg, p, batch, mesh, thr)
    got = port_runs(mesh)[0][name]["logits"].numpy()
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= LOGIT_TOL
