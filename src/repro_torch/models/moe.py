"""Top-k routed mixture-of-experts, as direct local math.

The port of ``repro.models.moe`` for one card: the path the JAX package
takes with ``ctx.mesh is None`` (strategy ``tp`` over all experts,
``e_start = 0``, no sequence-parallel gather, no psum).  Of the mesh
pieces, ``moe_weight_specs`` (the sharding policy's expert specs) is
ported; the ``shard_map`` expert-parallel route is not, and every rank of
a mesh runs the local math.

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

import torch
import torch.nn.functional as F

from repro_torch.collectives import P
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


def moe_ffn(x, params, cfg, ctx=None):
    """x (B, S, D), the normed residual -> (y (B, S, D), aux loss scalar
    times ``moe_aux_loss_coef``).  The shared experts, where the config has
    them, apply to the same x and add to y."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    w, idx, aux = _route(xt, params["router"], cfg)
    e_count = params["w_gate"].shape[0]
    cap = capacity(T, cfg)
    slot, keep = _dispatch_indices(idx, 0, e_count, cap)
    buf = _dispatch(xt, slot, keep, e_count, cap)
    out_buf = _expert_ffn(buf, params["w_gate"], params["w_up"], params["w_down"])
    y = _combine(out_buf, slot, keep, w, x.dtype).reshape(B, S, -1)
    if cfg.n_shared_experts > 0:
        y = y + layers.mlp(x, params["shared"], gated=True)
    return y, aux * cfg.moe_aux_loss_coef
