"""Top-k routed mixture-of-experts with the JAX package's EP/TP sharding.

The port of ``repro.models.moe``.  Two routes, as in the JAX package:

* the local math (no mesh, or ``ctx.use_shard_map`` off): strategy ``tp``
  over all experts, ``e_start = 0``, no gather, no psum;
* on a mesh (the input a ``DTensor``), the ``shard_map`` body
  (``_moe_shard_body``) on each (data, model) shard's local tensors under
  ``local_map``, its collectives (``collectives.all_gather``, ``psum``,
  ``psum_scatter``, ``pmean``) on ``ctx.groups``:
    1. with the residual sequence-sharded over ``model`` (B % data and
       S % model divide: ``sp``), the token shard is gathered over
       ``model``, so that the tokens are replicated over it within a data
       shard, and flattened only then;
    2. FSDP: the expert weights, sharded over the fsdp axis, are gathered
       inside the shard (dim 1, or 2 for ``tp``'s ``w_down``);
    3. ``ep`` (the experts split over ``model``, n_experts % model == 0):
       each shard dispatches to its own experts, ``e_start`` = its model
       index times their count; ``tp``: every shard holds all experts and
       a slice of their hidden dim;
    4. the capacity comes from the shard's own token count;
    5. the partial outputs are combined by a ``psum_scatter`` over
       ``model`` (``sp``: back to sequence shards) or a ``psum``, and the
       aux loss is averaged over ``model`` and every data axis.
  The decode on a mesh (``moe_decode``: each rank's batch rows and its
  blocks of the weights, local tensors) runs the same body on them; with
  no mesh the decode takes the local math.

Every step that decides which tokens an expert keeps is the reference's:

* routing: float32 router logits, softmax, top-k in descending order,
  the weights renormalized;
* capacity: the reference's float arithmetic, copied verbatim
  (``capacity``);
* slots: an exclusive one-hot cumsum over the flattened (T·K) assignment
  order, first come first served (never a sort); assignments past an
  expert's capacity go to a drop-sink row;
* dispatch and combine: a loop over the K assignments (``index_add_`` into
  an ``(E*cap + 1, D)`` buffer; the combine adds ``flat_out[slot] * w`` in
  ``x.dtype``, j = 0..K-1 in order, each weight cast to ``x.dtype`` first).

The expert products are plain batched matrix products (``bmm``): the JAX
package computes them with ``einsum`` outside any Pallas kernel.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import collectives as C
from repro_torch.collectives import P, axis_index, to_placements
from repro_torch.models import layers


def init_moe(gen, cfg, device):
    dt = layers.dtype_of(cfg)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": layers.dense_init(gen, d, e, torch.float32, device),
        "w_gate": _expert_init(gen, e, d, f, dt, device),
        "w_up": _expert_init(gen, e, d, f, dt, device),
        "w_down": _expert_init(gen, e, f, d, dt, device),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = layers.init_mlp(gen, d, cfg.n_shared_experts * f, True, dt,
                                      device)
    return p


def _expert_init(gen, e, d_in, d_out, dt, device):
    """(e, d_in, d_out): each expert's ``dense_init``, drawn in one call."""
    std = float(1.0 / d_in ** 0.5)

    def fill(t, g):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        t.mul_(std)
    return layers._draw(gen, (e, d_in, d_out), device, dt, fill)


def moe_weight_specs(cfg, strategy: str, model_axis, fsdp_axis):
    """PartitionSpecs for the stacked (L-leading) expert weights: ``ep``
    shards the experts over ``model_axis``, ``tp`` their hidden dim."""
    m, f = model_axis, fsdp_axis
    if strategy == "ep":
        wg = wd = P(None, m, f, None)
    else:
        wg = P(None, None, f, m)
        wd = P(None, None, m, f)
    return {"w_gate": wg, "w_up": wg, "w_down": wd, "router": P(None, None, None)}


def _route(x, router_w, cfg):
    """x (T, D) -> (weights (T, K) float32, idx (T, K), aux load-balance
    loss)."""
    logits = x.to(torch.float32) @ router_w                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_tok, dim=-1, sorted=True)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    me = torch.mean(probs, dim=0)                                    # (E,)
    ce = torch.mean(F.one_hot(idx, cfg.n_experts).to(torch.float32).sum(1), dim=0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return w, idx, aux


def capacity(T: int, cfg) -> int:
    """Slots per expert: the capacity-factor-scaled mean load, floored at
    min(T, 4K) (decode steps carry few tokens), never above T (T slots per
    expert drop nothing).  The reference's float arithmetic, verbatim."""
    K = cfg.experts_per_tok
    cap_raw = -(-T * K * cfg.capacity_factor // max(cfg.n_experts, 1))
    return int(min(T, max(cap_raw, min(T, 4 * K))))


def _dispatch_indices(idx, e_start: int, e_count: int, capacity: int):
    """Sort-free capacity dispatch for the expert slice [e_start,
    e_start + e_count).  idx (T, K) global expert ids -> (slot (T, K), keep
    (T, K)); slot indexes an (e_count * capacity + 1) buffer whose last row
    is the drop sink.  An assignment's place in its expert is the exclusive
    one-hot cumsum over the flattened (T·K) order."""
    T, K = idx.shape
    flat = idx.reshape(-1)
    local = flat - e_start
    in_slice = (local >= 0) & (local < e_count)
    safe = torch.where(in_slice, local, torch.full_like(local, e_count))
    oh = F.one_hot(safe, e_count + 1)
    pos = torch.cumsum(oh, dim=0) - oh                               # exclusive
    pos = torch.gather(pos, 1, safe[:, None])[:, 0]
    keep = in_slice & (pos < capacity)
    slot = torch.where(keep, local * capacity + pos,
                       torch.full_like(local, e_count * capacity))
    return slot.reshape(T, K), keep.reshape(T, K)


def _dispatch(x, slot, keep, e_count: int, capacity: int):
    """x (T, D) -> the experts' buffers (e_count, capacity, D): each kept
    assignment's token in its slot, zeros in the free slots."""
    D = x.shape[-1]
    buf = torch.zeros((e_count * capacity + 1, D), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for j in range(slot.shape[1]):
        # the drop-sink row takes the assignments not kept (slot routes them)
        buf.index_add_(0, slot[:, j], torch.where(keep[:, j, None], x, zero))
    return buf[:-1].reshape(e_count, capacity, D)


def _expert_ffn(buf, w_gate, w_up, w_down):
    """buf (E, cap, D) -> (E, cap, D_out): each expert's gated SiLU FFN."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _combine(out_buf, slot, keep, w, dtype):
    """Each token's kept assignments' outputs, weighted, summed over
    j = 0..K-1 in order in ``dtype`` -> (T, D_out)."""
    E, cap, D_out = out_buf.shape
    flat_out = torch.cat([out_buf.reshape(E * cap, D_out),
                          torch.zeros((1, D_out), dtype=dtype, device=out_buf.device)])
    y = torch.zeros((slot.shape[0], D_out), dtype=dtype, device=out_buf.device)
    for j in range(slot.shape[1]):
        wj = torch.where(keep[:, j], w[:, j], torch.zeros_like(w[:, j])).to(dtype)
        y = y + flat_out[slot[:, j]] * wj[:, None]
    return y


def _moe_shard_body(x_shard, router_w, w_gate, w_up, w_down, *, cfg, groups,
                    model_axis, fsdp_axis, data_axes: tuple, strategy: str,
                    sp: bool, same_data: bool):
    """Per-(data, model)-shard computation on local tensors.  x_shard:
    (B_loc, S_loc, D) -> (y (B_loc, S_loc or S, D), aux).  The token
    flatten happens here, after the sequence-parallel gather.
    ``same_data``: the tokens are the same on every rank of the data axes
    (the batch did not split over them), so the data ranks compute the
    same thing: the weights' FSDP gather slices its gradient instead of
    summing it, and the aux loss needs no mean over them.  With no mesh
    (``model_axis`` None, strategy "tp", no fsdp axis) this is the local
    math: all experts, no collective."""
    if sp:
        x = C.all_gather(x_shard, groups, model_axis, 1)
    else:
        x = x_shard
    B_loc, S_full, D = x.shape
    T = B_loc * S_full
    x = x.reshape(T, D)
    if fsdp_axis is not None:
        w_gate = C.all_gather(w_gate, groups, fsdp_axis, 1, same_grad=same_data)
        w_up = C.all_gather(w_up, groups, fsdp_axis, 1, same_grad=same_data)
        w_down = C.all_gather(w_down, groups, fsdp_axis, 1 if strategy == "ep" else 2,
                              same_grad=same_data)

    w, idx, aux = _route(x, router_w, cfg)
    e_count = w_gate.shape[0]
    e_start = axis_index(groups.mesh, model_axis) * e_count if strategy == "ep" else 0
    cap = capacity(T, cfg)
    slot, keep = _dispatch_indices(idx, e_start, e_count, cap)
    buf = _dispatch(x, slot, keep, e_count, cap)
    out_buf = _expert_ffn(buf, w_gate, w_up, w_down)
    y = _combine(out_buf, slot, keep, w, x.dtype).reshape(B_loc, S_full, -1)

    # combine the partials (sp: the reduce-scatter back to sequence shards)
    if model_axis is not None:
        y = (C.psum_scatter(y, groups, model_axis, 1) if sp
             else C.psum(y, groups, model_axis))
        aux = C.pmean(aux, groups, model_axis)
    if not same_data:
        for ax in data_axes:
            aux = C.pmean(aux, groups, ax)
    return y, aux


def _strategy(cfg, ctx) -> str:
    strategy = cfg.moe_sharding
    if strategy in ("auto", "ep"):
        if ctx.mesh is None or cfg.n_experts % max(ctx.axis_size(ctx.model_axis), 1):
            return "tp"
        return "ep"
    return strategy


def _grad_placements(placements, x_pl, names, model_axis) -> list:
    """The placements of the gradient that ``_moe_shard_body`` leaves for
    an input of ``placements``: a sharded mesh dim keeps its shard (the
    body's collectives complete it); on a dim that does not shard the input
    the ranks' gradients are partial sums where they saw different tokens
    or experts (the model axis, a data axis that splits the batch), and the
    same where they saw the same (a data axis the batch did not split)."""
    out = []
    for name, pl, xp in zip(names, placements, x_pl):
        if isinstance(pl, Shard):
            out.append(pl)
        elif name == model_axis or isinstance(xp, Shard):
            out.append(Partial())
        else:
            out.append(Replicate())
    return out


def _moe_sharded(x, params, cfg, ctx, strategy: str):
    """``moe_ffn``'s mesh route: the specs of the JAX package's
    ``shard_map`` and ``_moe_shard_body`` under ``local_map``."""
    B, S, D = x.shape
    maxis, faxis = ctx.model_axis, ctx.fsdp_axis
    dsize, msize = ctx.axis_size(ctx.data_axes), ctx.axis_size(maxis)
    # keep the (B, S, D) layout at the boundary; flatten inside
    if B % dsize == 0 and S % msize == 0:
        x_spec, sp = P(tuple(ctx.data_axes), maxis, None), True
    elif B % dsize == 0:
        x_spec, sp = P(tuple(ctx.data_axes), None, None), False
    else:
        x_spec, sp = P(None, None, None), False
    wspecs = moe_weight_specs(cfg, strategy, maxis, faxis)
    specs = [x_spec] + [P(*wspecs[k][1:])
                        for k in ("router", "w_gate", "w_up", "w_down")]
    mesh = ctx.mesh
    pls = [to_placements(sp_, mesh) for sp_ in specs]
    names = C.axis_names(mesh)
    x_pl = pls[0]
    grads = [_grad_placements(pl, x_pl, names, maxis) for pl in pls]
    same_data = x_spec[0] is None
    args = [t.redistribute(mesh, pl) for t, pl in zip(
        (x, params["router"], params["w_gate"], params["w_up"], params["w_down"]), pls)]
    body = functools.partial(
        _moe_shard_body, cfg=cfg, groups=ctx.groups, model_axis=maxis,
        fsdp_axis=faxis, data_axes=tuple(ctx.data_axes), strategy=strategy, sp=sp,
        same_data=same_data)
    return C.local_map_summed(body, (x_pl, [Replicate()] * len(names)), tuple(pls),
                              tuple(grads), mesh, ctx.groups)(*args)


def moe_decode(x, params, cfg, ctx):
    """``moe_ffn`` of a decode step on a mesh (``ctx.sharded_decode``): x
    (B_loc, 1, D) is this rank's batch rows, the expert weights its blocks
    under the decode policy (``moe_weight_specs``).  ``_moe_shard_body``
    runs on them: under "ep" the rank's
    experts only (``e_start`` its model index times their count), under
    "tp" every expert on the rank's slice of their hidden units; the FSDP
    dims are gathered first, the capacity comes from the rank's tokens, and
    the partial outputs are summed over the model axis.  The shared
    experts run tensor-parallel (``blocks``' MLP decode).  -> y (B_loc, 1,
    D) (the aux loss is a training term)."""
    from repro_torch.models import tp
    from repro_torch.models.blocks import _mlp_decode

    strategy = _strategy(cfg, ctx)
    E, D, Fh = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    m = ctx.model_axis

    def gathered(name, shape):
        """The rank's block of an expert weight, its FSDP dim gathered
        whole (the experts, or hidden units, stay the rank's)."""
        w = params[name]
        for dim, ax in enumerate(tp.spec(ctx, f"moe']['{name}", shape)):
            if ax not in (None, m):
                w = tp.whole(w, dim, ax, ctx)
        return w
    wg, wu = (gathered(k, (E, D, Fh)) for k in ("w_gate", "w_up"))
    wd = gathered("w_down", (E, Fh, D))
    if strategy != "ep" and tp.split(Fh, ctx) is None:
        m = None           # the hidden units do not split: every rank all of them
    y, _ = _moe_shard_body(x, params["router"], wg, wu, wd, cfg=cfg, groups=ctx.groups,
                           model_axis=m, fsdp_axis=None, data_axes=(),
                           strategy=strategy, sp=False, same_data=True)
    if cfg.n_shared_experts > 0:
        y = y + _mlp_decode(x, params["shared"], True, ctx,
                            cfg.n_shared_experts * Fh)
    return y


def moe_ffn(x, params, cfg, ctx=None):
    """x (B, S, D), the normed residual -> (y (B, S, D), aux loss scalar
    times ``moe_aux_loss_coef``).  The shared experts, where the config has
    them, apply to the same x and add to y.  A ``DTensor`` x on a mesh
    takes the ``shard_map`` route (``ctx.use_shard_map``); otherwise the
    local math."""
    if isinstance(x, DTensor):
        if not ctx.use_shard_map:
            raise NotImplementedError(
                "MoE on DTensors runs the shard_map body: use_shard_map=True")
        y, aux = _moe_sharded(x, params, cfg, ctx, _strategy(cfg, ctx))
    else:
        y, aux = _moe_shard_body(
            x, params["router"], params["w_gate"], params["w_up"], params["w_down"],
            cfg=cfg, groups=None, model_axis=None, fsdp_axis=None, data_axes=(),
            strategy="tp", sp=False, same_data=True)
    if cfg.n_shared_experts > 0:
        shared = layers.mlp(x, params["shared"], gated=True)
        if isinstance(y, DTensor):      # the routed output's layout
            shared = shared.redistribute(y.device_mesh, y.placements)
        y = y + shared
    return y, aux * cfg.moe_aux_loss_coef
