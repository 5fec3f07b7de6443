"""The port's sharded train step and ``Trainer`` on a mesh against the JAX
package's jitted step under ``in_shardings``.

The port places the {params, AdamW} state by its ``Policy``
(``launch.sharding.place_state``) and runs ``make_train_step``: the
sharded forward and backward, the gradients placed like their parameters,
the global norm reduced once over every shard, the update on each rank's
shards.  The JAX package jits its ``make_train_step`` with the policy's
state and batch shardings as ``in_shardings`` (the dry run's recipe,
``repro.launch.dryrun``) on a ``jax.sharding.Mesh`` of fake host devices.
Both start from the same JAX-initialized weights (float32 reduced
configs) and take the same two ``sample_train_batch`` batches (B = 4,
S = 16), ``dp_only_threshold=0`` (the TP and FSDP rules), on (2, 4):
qwen3-32b (attention "expand") and deepseek-v2 (MLA, MoE "ep").  One spawn
of 8 gloo ranks for both, one of 4 for the ``Trainer``.

Limits: after two steps every parameter leaf within 1e-4 of its largest;
every rank holds only its shards: each parameter, AdamW moment and master
leaf has the shape of JAX's addressable shard at the same mesh coordinates
and its values within 1e-4 of the leaf's largest.  The parameters (and
the master copy) are compared on the elements whose gradient, at each of
the two steps, is 0 or at least 100 eps: AdamW's first update is
g / (|g| + eps), so where |g| is near eps = 1e-8 it turns the float32
summation order of g into parameter differences of a fraction of lr
(seen: qwen3-32b's ``w_gate``, 4e-4 of its largest at an element whose
first gradient is 1.1e-8, 7 orders below the leaf's largest; the JAX
package's own sharded and unsharded steps differ there by 8.7e-5).  The
moments, smooth in g, are compared on every element, and the elements
left out are under 10 % of each leaf.  The ``Trainer`` on a (2, 2) mesh (qwen1.5-0.5b
under the TP rules): its losses within 1e-5 relative of the same
``Trainer`` with no mesh, its parameters sharded, and a restore of its
step-2 checkpoint replays step 3 to the same loss.
"""

import functools

import jax
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

import _jax_sharded as J
from _torch_dist import run_ranks, sharded_worker
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.train import Trainer

TOL = 1e-4
EPS = 1e-8            # adamw's eps
B, S = 4, 16
MESH = (2, 4)
ARCHS = ("qwen3-32b", "deepseek-v2-236b")


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    cfg = J.cfg_of(arch)
    return cfg, J.init_numpy(cfg), [J.batch_numpy(cfg, B, S, seed=s) for s in (0, 1)]


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    cases = []
    for arch in ARCHS:
        _, p, bs = _inputs(arch)
        cases.append({"name": arch, "kind": "steps", "arch": arch, "thr": 0,
                      "params": p, "batches": bs})
    return run_ranks(sharded_worker, MESH[0] * MESH[1], tmp_path_factory.mktemp("r"),
                     MESH, cases, deadline=600)


@functools.lru_cache(maxsize=None)
def _jax_steps(arch):
    """JAX's state after two steps: (whole leaves, rank blocks, and per
    state path of a parameter's value its well-conditioned elements, whole
    and as rank blocks)."""
    cfg, p, bs = _inputs(arch)
    state, mesh, grads = J.sharded_steps(cfg, p, bs, MESH, 0)
    # the elements whose gradient at both steps is 0 (rows of the tokens no
    # batch holds) or at least 100 AdamW eps
    well = {k: np.logical_and(*[(g[k] == 0) | (np.abs(g[k]) >= 100 * EPS)
                                for g in grads]) for k in grads[0]}
    leaves = {jax.tree_util.keystr(path): x
              for path, x in jax.tree_util.tree_flatten_with_path(state)[0]}
    devs = list(np.asarray(mesh.devices).reshape(-1))
    masks, mask_blocks = {}, {}
    for path, x in leaves.items():
        if _param_key(path) is not None:
            m = jax.device_put(well[_param_key(path)], x.sharding)
            masks[path] = np.asarray(m)
            mask_blocks[path] = {devs.index(sh.device): np.asarray(sh.data)
                                 for sh in m.addressable_shards}
    return J.flat(state), J.blocks(state, mesh), masks, mask_blocks


def _scale(x):
    return max(float(np.max(np.abs(x))), 1e-30)


def _param_key(path):
    """The gradient's key of a state path holding a parameter's value
    (``['params']...`` or ``['opt']['master']...``), else None."""
    for pre in ("['params']", "['opt']['master']"):
        if path.startswith(pre):
            return path[len(pre):]
    return None


def _within(got, want, scale, mask=None):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if mask is not None:
        assert mask.mean() > 0.9, mask.mean()
        d = d[mask]
    return float(d.max()) <= TOL * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_two_sharded_steps_match_the_jitted_jax_step(arch, port_steps):
    full, _, well, _ = _jax_steps(arch)
    got = port_steps[0][arch]["full"]
    want = {k[len("['params']"):]: v for k, v in full.items()
            if k.startswith("['params']")}
    assert set(got) == set(want)
    bad = [k for k in want if not _within(got[k].numpy(), want[k], _scale(want[k]),
                                          well["['params']" + k])]
    assert not bad, bad
    losses = [r[arch]["losses"] for r in port_steps]
    assert all(ls == losses[0] for ls in losses) and np.all(np.isfinite(losses[0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_only_its_shards(arch, port_steps):
    full, blocks, _, well = _jax_steps(arch)
    sharded = 0
    for rank, res in enumerate(port_steps):
        local = res[arch]["local"]
        assert set(local) == set(blocks) | {"['opt']['step']"}
        for path, (block, dims) in local.items():
            if dims is None:                       # the optimizer's step
                assert block == int(full[path]) == 2
                continue
            want = blocks[path][rank]
            assert tuple(block.shape) == want.shape, (path, rank)
            mask = well[path][rank] if path in well else None
            assert _within(block.numpy(), want, _scale(full[path]), mask), (path, rank)
            sharded += block.numel() < np.prod(full[path].shape)
    assert sharded > 0


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("store"))
    case = {"name": "trainer", "kind": "trainer", "arch": "qwen1.5-0.5b", "thr": 0,
            "params": None, "B": B, "S": S, "store": store}
    return run_ranks(sharded_worker, 4, tmp_path_factory.mktemp("t"), (2, 2), [case],
                     deadline=300)


def test_trainer_on_a_mesh_matches_the_unsharded_trainer(trainer_run):
    import dataclasses
    cfg = dataclasses.replace(tget("qwen1.5-0.5b", reduced=True), dtype="float32")
    ref = Trainer(cfg, B, S, seed=0, val_every=1, device="cpu")
    ref.run_steps(3)
    for res in trainer_run:
        got = res["trainer"]["losses"]
        assert len(got) == 3
        assert np.allclose(got, ref.metrics_vals, rtol=1e-5, atol=0), (got, ref.metrics_vals)
        shards = [(blk, dims) for blk, dims in res["trainer"]["local"].values()]
        assert any(any(d is not None for d in dims) for _, dims in shards)


def test_trainer_restore_on_a_mesh_replays_the_stream(trainer_run):
    for res in trainer_run:
        r = res["trainer"]
        assert r["restored_step"] == 2
        assert r["replayed"] == [r["losses"][2]]


def test_jax_mesh_is_auto():
    """The JAX side's meshes take ``constrain`` (Auto axes)."""
    mesh = J.mesh_of(MESH)
    assert dict(mesh.shape) == {"data": 2, "model": 4}
    assert all(t == jax.sharding.AxisType.Auto for t in mesh.axis_types)
