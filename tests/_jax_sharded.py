"""The JAX package's sharded programs on fake host devices, for the port's
sharded-forward tests (``tests/test_torch_tp_forward.py``,
``test_torch_moe_sharded.py``, ``test_torch_sharded_train.py``).

Meshes are ``jax.sharding.Mesh`` over the first devices of the 8 that
``tests/conftest.py`` makes, whose axes are Auto (``jax.make_mesh`` gives
Explicit axes, under which the JAX package's ``constrain`` raises).  A
device's rank is its row-major index in the mesh, as the port's
``DeviceMesh`` places ranks.  Configs are the reduced ones in float32,
with a case's overrides.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh

from repro.configs.base import get_config
from repro.launch.sharding import Policy
from repro.launch.train import make_train_step
from repro.models.context import null_ctx
from repro.models.inputs import sample_train_batch
from repro.models.model import Model
from repro.optim import adamw


def cfg_of(arch: str, **overrides):
    return dataclasses.replace(get_config(arch, reduced=True), dtype="float32",
                               **overrides)


def mesh_of(shape) -> Mesh:
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def init_numpy(cfg, seed: int = 0):
    """JAX-initialized parameters as numpy (``params_from_numpy`` carries
    them into the port)."""
    params = jax.jit(Model(cfg).init)(jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def batch_numpy(cfg, B: int, S: int, seed: int = 0) -> dict:
    batch = sample_train_batch(np.random.default_rng(seed), cfg, B, S)
    return {k: np.asarray(v) for k, v in batch.items()}


def blocks(tree, mesh) -> dict:
    """keystr -> {rank: numpy block} of every array leaf."""
    devs = list(np.asarray(mesh.devices).reshape(-1))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if not hasattr(leaf, "addressable_shards"):
            continue
        out[jax.tree_util.keystr(path)] = {
            devs.index(s.device): np.asarray(s.data) for s in leaf.addressable_shards}
    return out


def flat(tree) -> dict:
    """keystr -> numpy of every leaf."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def sharded_loss_and_grads(cfg, params_np, batch_np, mesh_shape, thr: float):
    """The loss and its gradients under ``Policy(cfg, mesh, "train",
    global_batch=B, dp_only_threshold=thr).ctx()``, jitted with the
    policy's in/out shardings -> (loss, grads (sharded jax arrays), mesh)."""
    mesh = mesh_of(mesh_shape)
    B = batch_np["tokens"].shape[0]
    policy = Policy(cfg, mesh, "train", global_batch=B, dp_only_threshold=thr)
    ctx = policy.ctx()
    model = Model(cfg)
    psh = policy.param_shardings(params_np)
    bsh = policy.batch_shardings(batch_np)
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b, ctx)[0]),
                 in_shardings=(psh, bsh), out_shardings=(None, psh))
    loss, grads = fn(params_np, batch_np)
    return float(loss), grads, mesh


def loss_and_grads(cfg, params_np, batch_np):
    """The loss and its gradients with no mesh."""
    model = Model(cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b, null_ctx(remat="none"))[0]))(params_np, batch_np)
    return float(loss), flat(grads)


def sharded_steps(cfg, params_np, batch_nps, mesh_shape, thr: float, lr=3e-3):
    """``make_train_step`` jitted with ``in_shardings`` of the policy's
    state and batch shardings (the dry run's recipe), run on each batch
    from the JAX-initialized state -> (state, mesh, the gradients each step
    took, as ``flat`` dicts)."""
    mesh = mesh_of(mesh_shape)
    B = batch_nps[0]["tokens"].shape[0]
    policy = Policy(cfg, mesh, "train", global_batch=B, dp_only_threshold=thr)
    model = Model(cfg)
    opt = adamw(lr, keep_master=(cfg.opt_precision == "fp32"))
    state = {"params": jax.tree.map(jax.numpy.asarray, params_np)}
    state["opt"] = opt.init(state["params"])
    psh = policy.param_shardings(state["params"])
    state_sh = {"params": psh, "opt": policy.opt_state_shardings(state["opt"], psh)}
    bsh = policy.batch_shardings(batch_nps[0])
    step = jax.jit(make_train_step(model, opt, policy.ctx()),
                   in_shardings=(state_sh, bsh), out_shardings=(state_sh, None))
    grads = []
    for b in batch_nps:
        params = jax.tree.map(np.asarray, state["params"])
        grads.append(flat(sharded_loss_and_grads(cfg, params, b, mesh_shape, thr)[1]))
        state, _ = step(state, b)
    return state, mesh, grads


def prefill_logits(cfg, params_np, batch_np, mesh_shape=None, thr: float = 1e9):
    """Last-position logits of ``Model.prefill``, under ``Policy(cfg, mesh,
    "prefill", dp_only_threshold=thr).ctx()`` on a mesh of ``mesh_shape``
    (jitted, the policy's shardings), or with no mesh."""
    model = Model(cfg)
    if mesh_shape is None:
        return np.asarray(jax.jit(lambda p, b: model.prefill(p, b)[0])(params_np,
                                                                       batch_np))
    return prefill(cfg, params_np, batch_np, mesh_shape, thr)[0]


def prefill(cfg, params_np, batch_np, mesh_shape, thr: float = 1e9):
    """``Model.prefill`` under ``Policy(cfg, mesh, "prefill",
    dp_only_threshold=thr).ctx()``, jitted as the JAX package's dry run
    lowers it (the policy's ``in_shardings``, the cache's ``out_shardings``
    from ``policy.cache_shardings`` of the decode plan for the batch) ->
    (the last-position logits, the cache as a ``flat`` dict)."""
    model = Model(cfg)
    mesh = mesh_of(mesh_shape)
    policy = Policy(cfg, mesh, "prefill", dp_only_threshold=thr)
    ctx = policy.ctx()
    plan = policy.decode_plan(batch_np["tokens"].shape[0])

    def step(p, b):
        return model.prefill(p, b, ctx)

    _, cache_shapes = jax.eval_shape(step, params_np, batch_np)
    fn = jax.jit(step, in_shardings=(policy.param_shardings(params_np),
                                     policy.batch_shardings(batch_np)),
                 out_shardings=(None, policy.cache_shardings(cache_shapes, plan)))
    logits, cache = fn(params_np, batch_np)
    return np.asarray(logits), flat(cache)
