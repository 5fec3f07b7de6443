"""The shard-aware decode's products, split over the mesh.

XLA partitions the JAX package's jitted decode step around the policy's
shardings, so each device computes its share of every weight's product.
The port's decode on a mesh (``ctx.sharded_decode``) holds every weight
whole on every rank (``launch.serve.Server``) and splits the products
itself, as a Megatron decode does:

* ``cols(x, w, ctx, sl)``: ``x @ w[:, sl]``, the output columns of this
  rank's heads, channels or hidden units (column-parallel over the model
  axis; ``sl`` None: every column);
* ``rows(y, w, ctx, sl)``: ``y @ w[sl]`` for this rank's slice ``y`` of the
  input features, the partial sums reduced over the model axis
  (row-parallel);
* where the plan does not split the batch over the data axes (every data
  rank holds the same rows), each product's contraction is split over
  them as well and the partial sums reduced, so that no two ranks compute
  the same product.

``model_sum`` reduces a statistic of the rank's features over the model
axis.  ``split(n, ctx)`` is this rank's slice of ``n`` units over the model axis,
or None where they do not split (the caller then computes them whole).
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.collectives import axis_index


def split(n: int, ctx):
    """This rank's slice of ``n`` units over the model axis, or None."""
    m = ctx.axis_size(ctx.model_axis)
    if n % m:
        return None
    w = n // m
    i = axis_index(ctx.mesh, ctx.model_axis)
    return slice(i * w, (i + 1) * w)


def _replicated_axes(ctx) -> tuple:
    """The data axes over which the plan leaves the batch whole."""
    return () if ctx.decode_plan.b_axes else tuple(ctx.data_axes)


def _product(x, w, ctx, also=()):
    """``x @ w``, the contraction split over the replicated data axes and
    the partial sums reduced over them and over ``also``."""
    axes = _replicated_axes(ctx)
    n, K = ctx.axis_size(axes), x.shape[-1]
    if n > 1 and K % n == 0:
        i, k = axis_index(ctx.mesh, axes), K // n
        x, w = x[..., i * k:(i + 1) * k], w[i * k:(i + 1) * k]
    else:
        axes = ()
    return _sum(x @ w, ctx, axes + also)


def _sum(t, ctx, axes):
    """``t`` summed over ``axes`` (one all-reduce over their product)."""
    axes = tuple(a for a in ctx.groups.mesh.mesh_dim_names if a in axes)
    if ctx.axis_size(axes) > 1:
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ctx.groups.group(axes))
    return t


def model_sum(t, ctx):
    """``t`` summed over the model axis (a statistic of the rank's slice of
    features made whole, as the gated norm's mean square)."""
    return _sum(t, ctx, (ctx.model_axis,))


def cols(x, w, ctx, sl=None):
    """``x @ w[:, sl]``: this rank's output columns, whole."""
    return _product(x, w if sl is None else w[:, sl], ctx)


def rows(y, w, ctx, sl):
    """``y @ w[sl]`` summed over the model axis: ``y`` is this rank's
    slice ``sl`` of the input features."""
    return _product(y, w[sl], ctx, also=(ctx.model_axis,))
