"""The shard-aware decode's products, split over the mesh.

XLA partitions the JAX package's jitted decode step around the policy's
shardings (``in_shardings=(param_sh, cache_sh, ...)``), so each device
holds its block of every weight and computes its share of every product.
The port's decode on a mesh (``ctx.sharded_decode``) does the same by
hand, as a Megatron decode does.  Every weight is this rank's block under
the decode policy (``launch.sharding.Policy.param_shardings``;
``launch.serve.Server`` keeps only those blocks), and its layout is read
from the same policy: ``spec(ctx, name, shape)`` is the mesh axis (or
None) of each dim of the weight ``name`` of whole ``shape``, the
``Policy.param_spec`` that cut it.  A 2-D weight's spec is (rows, cols):

* ``cols(x, w, ctx, sp, sl)``: ``x @ W[:, sl]``, the output columns of
  this rank's heads, channels or hidden units (column-parallel over the
  model axis; ``w`` holds them where the policy splits the columns, else
  they are cut from its whole columns); with ``sl`` None every column:
  where they split over the model axis each rank computes its block and
  the blocks are gathered, where they do not the contraction is split
  over the model axis instead;
* ``rows(y, w, ctx, sp)``: ``y @ W[sl]`` for this rank's slice ``y`` of
  the input features, which the policy's rows split over the model axis,
  the partial sums reduced over it (row-parallel); ``rows_whole(x, w,
  ctx, sp)`` the same from the whole input;
* an FSDP-sharded dim (the policy's ``ctx.fsdp_axis``) is contracted in
  place where the plan leaves the batch whole over that axis (the partial
  sums, or the output blocks, then reduced or gathered over it) and
  all-gathered before its product otherwise (``whole``);
* where the plan does not split the batch over the data axes (every data
  rank holds the same rows), a whole contraction is split over them as
  well and the partial sums reduced, so that no two ranks compute the
  same product.

``model_sum`` reduces a statistic of the rank's features over the model
axis.  ``split(n, ctx)`` is this rank's slice of ``n`` units over the model
axis, or None where they do not split (the caller then computes them
whole); the policy splits a weight's dim over the model axis exactly
where ``split`` does.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.collectives import all_gather_ordered, axis_index


def split(n: int, ctx):
    """This rank's slice of ``n`` units over the model axis, or None."""
    m = ctx.axis_size(ctx.model_axis)
    if n % m:
        return None
    w = n // m
    i = axis_index(ctx.mesh, ctx.model_axis)
    return slice(i * w, (i + 1) * w)


def spec(ctx, name: str, shape) -> tuple:
    """The decode policy's layout of the weight ``name`` (its path inside a
    layer's parameters, as ``"wq"`` or ``"moe']['w_down"``) of whole
    ``shape``: a mesh axis or None for each dim."""
    return tuple(ctx.policy.param_spec(f"['{name}']", tuple(shape)))


def whole(w, dim: int, axis, ctx):
    """``w`` with its dim ``dim`` gathered whole over ``axis`` (None: as it
    is)."""
    if axis is None:
        return w
    return all_gather_ordered(w, ctx.groups, axis, dim)


def _replicated_axes(ctx) -> tuple:
    """The data axes over which the plan leaves the batch whole."""
    return () if ctx.decode_plan.b_axes else tuple(ctx.data_axes)


def _product(x, w, ctx, also=()):
    """``x @ w`` for a ``w`` whose rows are the whole contraction, the
    contraction split over the replicated data axes and the partial sums
    reduced over them and over ``also``."""
    axes = _replicated_axes(ctx)
    n, K = ctx.axis_size(axes), x.shape[-1]
    if n > 1 and K % n == 0:
        i, k = axis_index(ctx.mesh, axes), K // n
        x, w = x[..., i * k:(i + 1) * k], w[i * k:(i + 1) * k]
    else:
        axes = ()
    return _sum(x @ w, ctx, axes + also)


def _contract(x, w, ctx, rows_axis, also=()):
    """``x @ w`` where ``w``'s rows are split over ``rows_axis`` (the FSDP
    axis, or None): in place where the batch is whole over it, else
    gathered first."""
    if rows_axis in _replicated_axes(ctx):
        k = w.shape[0]
        i = axis_index(ctx.mesh, rows_axis)
        return _sum(x[..., i * k:(i + 1) * k] @ w, ctx, (rows_axis,) + tuple(also))
    return _product(x, whole(w, 0, rows_axis, ctx), ctx, also)


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


def cols(x, w, ctx, sp, sl=None):
    """``x @ W[:, sl]`` for the rank's block ``w`` of the weight W laid out
    as ``sp`` (rows, cols): the rank's output columns ``sl`` (its own block
    where the policy splits the columns), or with ``sl`` None all of them,
    each rank computing its block where they split over the model axis,
    or, where they do not, its slice of the contraction."""
    rows_axis, cols_axis = sp
    m = ctx.model_axis
    if cols_axis is not None:                 # w holds the rank's columns
        y = _contract(x, w, ctx, rows_axis)
        return y if sl is not None else all_gather_ordered(y, ctx.groups, m, y.dim() - 1)
    if sl is not None:
        return _contract(x, w[:, sl], ctx, rows_axis)
    msl = split(w.shape[1], ctx)
    if msl is not None:
        y = _contract(x, w[:, msl], ctx, rows_axis)
        return all_gather_ordered(y, ctx.groups, m, y.dim() - 1)
    ksl = split(x.shape[-1], ctx)
    if ksl is not None:
        # the columns do not split over the model axis: the contraction does
        return _product(x[..., ksl], whole(w, 0, rows_axis, ctx)[ksl], ctx, also=(m,))
    return _contract(x, w, ctx, rows_axis)


def rows(y, w, ctx, sp):
    """``y @ W[sl]`` summed over the model axis: ``y`` is this rank's
    slice ``sl`` of the input features, which W's rows split over the
    model axis as ``sp`` (rows, cols) lays it out (``w`` its block)."""
    cols_axis = sp[1]
    if cols_axis in _replicated_axes(ctx):
        out = _sum(y @ w, ctx, (ctx.model_axis,))
        return all_gather_ordered(out, ctx.groups, cols_axis, out.dim() - 1)
    return _product(y, whole(w, 1, cols_axis, ctx), ctx, also=(ctx.model_axis,))


def rows_whole(x, w, ctx, sp):
    """``x @ W`` for a row-parallel weight from the whole input ``x``: the
    rank's slice of the input features where W's rows split over the
    model axis (``rows``), else the whole contraction."""
    if sp[0] is not None:
        return rows(x[..., split(x.shape[-1], ctx)], w, ctx, sp)
    return _product(x, whole(w, 1, sp[1], ctx), ctx)
