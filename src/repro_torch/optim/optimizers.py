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
given.  ``adamw``'s ``update(..., donate=True)`` is the eager counterpart
of the JAX package's ``donate_argnums`` on its train step: the same
arithmetic, each given leaf of the gradients, the moments, the master
copy and the parameters released from its dict or list as the update
takes it, so that the step holds the old state and one leaf's
temporaries, not two states.  The trees given are left holding ``None``.
A leaf of more than ``SLICE_ELEMS`` elements is updated in slices
(``_slices``: ranges of its first axis, or of the first axis under short
leading ones, as a stacked layer axis of 1 is), each slice by the same
arithmetic (AdamW is elementwise, so the result is bit-equal to the whole
leaf's; the clip's norm sums such a leaf a slice at a time), so that its float32
temporaries are a slice's, not the leaf's; donated, each slice's new
moments, master copy and parameters are written into the old leaves' own
storage where nothing outside the update holds them (no other name, dict
or list refers to the tensor and no other tensor shares its storage), as
XLA writes a donated buffer in place.  A new whole leaf then never lives
beside the old one.

On a mesh the leaves are ``DTensor``s (``launch.sharding.place_state``):
the gradients placed like their parameters and the moments and master
copy like them too.  The update is elementwise, so it runs on each rank's
local shards and keeps their placements; the global norm is one
reduction over every shard, each replicated block counted once.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import sys
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate


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
    return _fill(tree, iter(leaves))


def _fill(t, it):
    # module-level, not a recursive closure: a closure that calls itself is
    # a reference cycle, which would keep ``it`` and so every leaf alive
    # until the garbage collector runs
    if isinstance(t, dict):
        filled = {k: _fill(t[k], it) for k in sorted(t)}
        return {k: filled[k] for k in t}
    if isinstance(t, (list, tuple)):
        return [_fill(x, it) for x in t]
    return next(it)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state, metrics)


def on_local(fn, *leaves):
    """``fn`` of the tensors' local shards, each result placed like the
    first ``DTensor`` among ``leaves`` (plain tensors: ``fn`` of them)."""
    like = next((t for t in leaves if isinstance(t, DTensor)), None)
    if like is None:
        return fn(*leaves)
    out = fn(*(t.to_local() if isinstance(t, DTensor) else t for t in leaves))
    wrap = lambda o: DTensor.from_local(  # noqa: E731
        o, like.device_mesh, like.placements, run_check=False,
        shape=like.shape, stride=like.stride())
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _counted_here(t) -> bool:
    """This rank's block of ``t`` counts in a sum over the mesh: it is the
    first copy (coordinate 0) on every mesh dim that replicates ``t``."""
    if any(isinstance(p, Partial) for p in t.placements):
        raise ValueError("a partial gradient: place it like its parameter first")
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, t.placements) if isinstance(p, Replicate))


def global_norm(grads):
    """|grads| in float32: the squares summed leaf by leaf in the
    reference's leaf order (a leaf over ``SLICE_ELEMS`` a slice at a time);
    on a mesh over each rank's own blocks, then reduced over the mesh
    once."""
    total, like = 0, None
    for g in tree_leaves(grads):
        if isinstance(g, DTensor):
            like = g
            if _counted_here(g):
                total = total + _squares(g.to_local())
        else:
            total = total + _squares(g)
    if like is not None:
        local = torch.as_tensor(total, dtype=torch.float32,
                                device=like.to_local().device).reshape(())
        total = DTensor.from_local(local, like.device_mesh,
                                   [Partial()] * like.device_mesh.ndim).full_tensor()
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / |grads|), |grads|)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: _scaled(g, scale), grads), gn


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _scaled(g, scale):
    return on_local(lambda x: (x.float() * scale).to(x.dtype), g)


#: a leaf of more elements than this is updated (and its squares summed for
#: the clip) in slices, a slice's float32 temporaries at most this many
#: elements (256 MiB)
SLICE_ELEMS = 1 << 26


def _held_only_in(leaves: list, i: int) -> bool:
    """Nothing but the list ``leaves`` (at each of its places there) refers
    to the plain tensor ``leaves[i]``, and no other tensor shares its
    storage: it can be written in place without changing a tensor that
    anyone else holds."""
    x = leaves[i]
    if not isinstance(x, torch.Tensor) or isinstance(x, DTensor):
        return False
    places = sum(y is x for y in leaves)
    # + this frame's ``x`` and getrefcount's argument; the storage's users:
    # x and the storage object untyped_storage() makes
    return (sys.getrefcount(x) == places + 2
            and torch._C._storage_Use_Count(x.untyped_storage()._cdata) == 2)


def _leaf_map(fn, *trees, release: bool = False):
    """``tree_map(fn, *trees)`` as ``fn(*leaves, owned)``, ``owned`` a bool
    a tree; with ``release`` each leaf is set to ``None`` in its dict or
    list once ``fn`` has taken it (a tuple's leaves are not released), and
    ``owned`` says which leaves nothing else then holds
    (``_held_only_in``); without it no leaf is owned."""
    t0 = trees[0]
    if not release or not isinstance(t0, (dict, list)):
        return tree_map(lambda *xs: fn(*xs, (False,) * len(xs)), *trees)
    keys = list(t0) if isinstance(t0, dict) else range(len(t0))
    out = {} if isinstance(t0, dict) else [None] * len(t0)
    for k in keys:
        sub = [t[k] for t in trees]
        if isinstance(sub[0], (dict, list, tuple)):
            out[k] = _leaf_map(fn, *sub, release=True)
            continue
        for t in trees:
            t[k] = None
        owned = tuple(_held_only_in(sub, i) for i in range(len(sub)))
        out[k] = fn(*sub, owned)
        del sub
    return out


def _slices(shape) -> list:
    """The index tuples that cut a leaf of ``shape`` into slices of at most
    ``SLICE_ELEMS`` elements, in order: ranges of the first axis whose
    trailing dims hold at most ``SLICE_ELEMS`` elements a step, under every
    index of the axes before it (a stacked layer axis of 1, a MoE layer's
    experts).  Each slice is a view, written in place through the leaf's
    own strides."""
    ax = 0      # the first axis one index of which holds at most the cut
    while ax < len(shape) - 1 and math.prod(shape[ax + 1:]) > SLICE_ELEMS:
        ax += 1
    row = math.prod(shape[ax + 1:])
    step = max(1, SLICE_ELEMS // max(row, 1))
    return [(*lead, slice(a, min(a + step, shape[ax])))
            for lead in itertools.product(*(range(n) for n in shape[:ax]))
            for a in range(0, shape[ax], step)]


def _squares(g):
    """sum(g ** 2) in float32; over ``_slices`` where ``g`` is over
    ``SLICE_ELEMS`` (no float32 copy of the whole leaf), the slices' sums
    added in order."""
    if g.numel() <= SLICE_ELEMS or g.dim() == 0:
        return torch.sum(torch.square(g.float()))
    total = 0
    for idx in _slices(tuple(g.shape)):
        total = total + torch.sum(torch.square(g[idx].float()))
    return total


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: Optional[float] = 1.0, keep_master: bool = True) -> Optimizer:
    """AdamW with an optional float32 master copy and global-norm clipping.
    ``lr`` is a constant or a schedule of the step (1 at the first update)."""
    sched = lr if callable(lr) else (lambda step: lr)

    def init(params):
        state = {
            "step": 0,
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        }
        if keep_master:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    @torch.no_grad()
    def update(grads, state, params, donate: bool = False):
        step = state["step"] + 1
        gn = scale = None
        if grad_clip is not None:
            gn = global_norm(grads)
            scale = _clip_scale(gn, grad_clip)
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

        def one(g, m, v, r, p, owned):
            if g.numel() > SLICE_ELEMS and g.dim() > 0:
                m, v, n32, p = on_local(lambda *xs: sliced(*xs, all(owned[1:])),
                                        g, m, v, r, p)
                return m, v, n32 if keep_master else None, p
            if scale is not None:
                g = _scaled(g, scale)
            m, v, n32 = on_local(upd, g, m, v, r)
            # no float32 copy of every parameter kept without a master
            return (m, v, n32 if keep_master else None,
                    on_local(lambda x: x.to(p.dtype), n32))

        def sliced(g, m, v, r, p, in_place: bool):
            """``one`` a slice (``_slices``) at a time -> (m, v, master, p):
            each slice's new moments, master and parameters written into the
            old leaves (``in_place``: nothing else holds them) or into new
            ones; without a master its place holds the parameters."""
            if in_place:
                out = (m, v, r, p)
            else:
                out = (torch.empty_like(m), torch.empty_like(v),
                       torch.empty_like(r) if keep_master else None, torch.empty_like(p))
            for idx in _slices(tuple(g.shape)):
                gs = g[idx]
                if scale is not None:
                    gs = (gs.float() * scale).to(gs.dtype)
                ms, vs, n32 = upd(gs, m[idx], v[idx], r[idx])
                out[0][idx] = ms
                out[1][idx] = vs
                if keep_master:
                    out[2][idx] = n32
                out[3][idx] = n32.to(p.dtype)
                del gs, ms, vs, n32
            return out if keep_master else (*out[:2], out[3], out[3])

        out = _leaf_map(one, grads, state["m"], state["v"], ref, params,
                        release=donate)
        # ``grads`` gives the structure (its leaves None where released)
        new_m, new_v, new32, new_params = (tree_map(lambda _, o: o[i], grads, out)
                                           for i in range(4))
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
