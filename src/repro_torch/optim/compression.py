"""int8 gradient compression with error feedback (the port of
``repro.optim.compression``).

* ``int8_allreduce(grads, axis, error)``: quantize each gradient leaf to
  int8 with a per-leaf scale, reduce the int8 payload, dequantize, and
  carry the quantization residual forward as *error feedback*, so the
  compression bias cancels over steps.  One card: ``axis=None`` is the
  only reduction the port has (the collective is the identity, the
  quantization and its residuals are real); a named axis needs a mesh of
  processes and raises (ROADMAP A12).
* ``compressed(optimizer)``: an optimizer wrapper that applies error
  feedback around any base optimizer (quantize-dequantize each step, the
  residual carried in the state).

The arithmetic is the JAX package's, in float32: ``round`` is half to
even in both.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim.optimizers import (Optimizer, tree_leaves, tree_map,
                                          tree_unflatten)


def quantize_int8(x, scale_floor: float = 1e-12):
    """x (any shape, float) -> (int8 payload, float32 scale).  Symmetric."""
    x32 = x.float()
    amax = torch.max(torch.abs(x32)) if x32.numel() else torch.zeros(
        (), dtype=torch.float32, device=x.device)
    scale = torch.clamp(amax, min=scale_floor) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_leaf(g, err):
    """Error-feedback compress one leaf: returns (decompressed, new_err)."""
    target = g.float() + err
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale)
    return deq.to(g.dtype), target - deq


def int8_allreduce(grads, axis: Optional[str], error):
    """Quantized mean-reduce over ``axis`` with error feedback.

    ``error`` is a tree like ``grads`` (float32 residuals); pass zeros on
    step 0.  Returns (mean_grads, new_error).  With ``axis=None`` the
    collective is the identity (one shard) but the quantization and its
    residuals are computed, so the numerics are the real ones.  A named
    axis raises NotImplementedError: it needs a mesh (ROADMAP A12)."""
    if axis is not None:
        raise NotImplementedError(
            f"int8_allreduce over axis {axis!r} needs a device mesh, which "
            "the port does not have yet (ROADMAP A12); axis=None is the "
            "one-shard path")

    @torch.no_grad()
    def one(g, e):
        target = g.float() + e
        q, scale = quantize_int8(target)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), target - deq

    outs = tree_map(one, grads, error)
    return (tree_map(lambda _, o: o[0], grads, outs),
            tree_map(lambda _, o: o[1], grads, outs))


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed(base: Optimizer) -> Optimizer:
    """Wrap an optimizer with int8 + error-feedback gradient compression
    (local form: quantize-dequantize each step, residual carried in state).
    """

    def init(params):
        return {"base": base.init(params), "err": init_error(params)}

    @torch.no_grad()
    def update(grads, state, params):
        pairs = [compress_leaf(g, e) for g, e in
                 zip(tree_leaves(grads), tree_leaves(state["err"]))]
        cgrads = tree_unflatten(grads, [p[0] for p in pairs])
        new_err = tree_unflatten(grads, [p[1] for p in pairs])
        new_params, new_base, metrics = base.update(cgrads, state["base"], params)
        return new_params, {"base": new_base, "err": new_err}, metrics

    return Optimizer(init=init, update=update)
