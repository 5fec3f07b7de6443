"""AdamW and SGD with global-norm clipping over parameter trees, PyTorch.

The JAX package's ``repro.optim.optimizers`` (``adamw``, ``sgd``) as plain
functions over nested dicts and lists of tensors:

    init(params)                     -> opt_state
    update(grads, opt_state, params) -> (new_params, new_opt_state, metrics)

Not ``torch.optim.AdamW``: the reference clips by the global norm first,
divides by the bias corrections before the square root, adds eps after it
and decays as ``p - lr * (upd + wd * p)``, and the port keeps that order
so that a step agrees with the reference's to float32 rounding.  The
moments are float32; with ``keep_master`` a float32 master copy of the
parameters is kept and updated, and the parameters are cast from it.
``update`` is functional: it returns new tensors and changes none it was
given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of parameter trees (nested dicts and lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure and key order whose leaves, taken in
    ``tree_leaves`` order, are ``leaves``."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            filled = {k: fill(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [fill(x) for x in t]
        return next(it)

    return fill(tree)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state, metrics)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / |grads|), |grads|): the global
    norm over every leaf in float32, summed leaf by leaf in the reference's
    leaf order."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: Optional[float] = 1.0, keep_master: bool = True) -> Optimizer:
    """AdamW with an optional float32 master copy and global-norm clipping.
    ``lr`` is a constant or a schedule of the step (1 at the first update)."""
    sched = lr if callable(lr) else (lambda step: lr)

    def init(params):
        state = {
            "step": 0,
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
        }
        if keep_master:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        gn = None
        if grad_clip is not None:
            grads, gn = clip_by_global_norm(grads, grad_clip)
        lr_t = sched(step)
        # b ** step in float32, as the reference raises a weak-typed b to a
        # float32 step
        f32 = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** f32)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** f32)
        ref = state["master"] if keep_master else params

        def upd(g, m, v, p):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p32 = p.detach().float()
            return m, v, p32 - lr_t * (u + weight_decay * p32)

        out = tree_map(upd, grads, state["m"], state["v"], ref)
        new_m, new_v, new32 = (tree_map(lambda _, o: o[i], grads, out)
                               for i in range(3))
        new_params = tree_map(lambda p, n: n.to(p.dtype), params, new32)
        new_state = {"step": step, "m": new_m, "v": new_v}
        if keep_master:
            new_state["master"] = new32
        metrics = {"lr": lr_t}
        if gn is not None:
            metrics["grad_norm"] = gn
        return new_params, new_state, metrics

    return Optimizer(init=init, update=update)


def sgd(lr: Callable | float, momentum: float = 0.0,
        grad_clip: Optional[float] = None) -> Optimizer:
    """SGD, with float32 heavy-ball momentum ``mu = momentum * mu + g`` when
    ``momentum`` is not 0, and optional global-norm clipping; the update is
    float32 and the parameters are cast back to their type."""
    sched = lr if callable(lr) else (lambda step: lr)

    def init(params):
        state = {"step": 0}
        if momentum:
            state["mu"] = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        gn = None
        if grad_clip is not None:
            grads, gn = clip_by_global_norm(grads, grad_clip)
        lr_t = sched(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"], grads)
            new_params = tree_map(
                lambda p, m: (p.detach().float() - lr_t * m).to(p.dtype), params, mu)
            new_state = {"step": step, "mu": mu}
        else:
            new_params = tree_map(
                lambda p, g: (p.detach().float() - lr_t * g.float()).to(p.dtype),
                params, grads)
            new_state = {"step": step}
        metrics = {"lr": lr_t}
        if gn is not None:
            metrics["grad_norm"] = gn
        return new_params, new_state, metrics

    return Optimizer(init=init, update=update)
