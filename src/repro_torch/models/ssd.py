"""Mamba2: state-space duality (SSD) blocks.  [arXiv:2405.21060]

The port of ``repro.models.ssd``.  Chunked SSD (the train/prefill path) is a
host loop over sequence chunks, where the JAX package runs ``lax.scan``;
each chunk is one ``kops.ssd_chunk`` call (the hand-written kernel on the
card, its plain version on the CPU), which carries the (B, H, P, N) state
to the next.  Training takes the kernel's ``SsdChunk`` Function, which
keeps only a chunk's inputs and recomputes the plain chunk in the backward
(the JAX package's ``jax.checkpoint`` of the chunk body).  Decode is the
one-token state update in plain PyTorch.

Projections are split per segment (z / x / B / C / dt) and the depthwise
conv is per segment, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.collectives import (P, axis_index, grad_as_forward, local_map_summed,
                                     to_placements)
from repro_torch.kernels import ops as kops
from repro_torch.models import layers, tp


def init_ssd(gen, cfg, device):
    dt = layers.dtype_of(cfg)
    d = cfg.d_model
    din = cfg.ssm_d_inner
    h = cfg.ssm_nheads
    g, n = cfg.ssm_groups, cfg.ssm_state
    k = cfg.conv_kernel
    f32 = torch.float32
    # dt bias init: softplus^-1 of dt ~ U[1e-3, 1e-1] (mamba2 default)
    u = layers.uniform_init(gen, (h,), 1e-3, 1e-1, device)
    dt_bias = u + torch.log(-torch.expm1(-u))
    return {
        "wz": layers.dense_init(gen, d, din, dt, device),
        "wx": layers.dense_init(gen, d, din, dt, device),
        "wB": layers.dense_init(gen, d, g * n, dt, device),
        "wC": layers.dense_init(gen, d, g * n, dt, device),
        "wdt": layers.dense_init(gen, d, h, dt, device),
        "conv_x": _conv_init(gen, din, k, dt, device),
        "conv_B": _conv_init(gen, g * n, k, dt, device),
        "conv_C": _conv_init(gen, g * n, k, dt, device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device)),
        "dt_bias": dt_bias,
        "D_skip": torch.ones((h,), dtype=f32, device=device),
        "gate_norm": layers.init_rmsnorm(din, device),
        "wo": layers.dense_init(gen, din, d, dt, device),
    }


def _conv_init(gen, ch, k, dt, device):
    return {"w": layers.normal_init(gen, (ch, k), 1.0 / np.sqrt(k), dt, device),
            "b": torch.zeros((ch,), dtype=dt, device=device)}


def causal_conv(x, p):
    """Depthwise causal conv.  x (B, S, C); weight (C, K)."""
    k = p["w"].shape[-1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:S, :] * p["w"][:, 0]
    for i in range(1, k):
        out = out + xp[:, i:i + S, :] * p["w"][:, i]
    return out + p["b"]


def conv_decode(x_t, conv_state, p):
    """x_t (B, 1, C) with rolling window state (B, K-1, C) -> (y_t, new_state)."""
    window = torch.cat([conv_state, x_t], dim=1)                     # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, p["w"])[:, None] + p["b"]
    return y, window[:, 1:]


def _chunk_scan_step(carry, xs, A, kernels: Optional[str] = None):
    """One SSD chunk.  carry: state (B,H,P,N); xs: the chunk's
    (x (B,Q,H,P), dt (B,Q,H), B (B,Q,H,N), C (B,Q,H,N)).
    Returns (new_state, y)."""
    x_c, dt_c, B_c, C_c = xs
    y, state = kops.ssd_chunk(x_c, dt_c, A, B_c, C_c, carry, force=kernels)
    return state, y


def ssd_chunked(x, dt, A, B_in, C_in, chunk: int, state=None,
                kernels: Optional[str] = None):
    """Full-sequence SSD, chunk by chunk.

    x (B,S,H,P); dt (B,S,H) (already softplus'd); A (H,) negative;
    B_in/C_in (B,S,H,N) (group-broadcast done by the caller; a float32 view
    with head stride 0, as ``_broadcast_groups`` gives for one group, stays
    a view: each chunk's slice of it goes to the kernel as it lies).
    Returns (y (B,S,H,P) float32, final_state (B,H,P,N) float32)."""
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    f32 = torch.float32
    x, dt, B_in, C_in = (t.to(f32) for t in (x, dt, B_in, C_in))
    if pad:
        # dt = 0 padding is exact: decay exp(0) = 1 and zero state injection
        x, dt, B_in, C_in = (_pad_rows(t, pad) for t in (x, dt, B_in, C_in))
    state = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
             if state is None else state)
    A = A.to(f32)
    ys = []
    for c0 in range(0, S + pad, Q):
        sl = slice(c0, c0 + Q)
        state, y = _chunk_scan_step(
            state, (x[:, sl], dt[:, sl], B_in[:, sl], C_in[:, sl]), A, kernels)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, state


def _pad_rows(t, pad: int):
    """t padded with ``pad`` zero rows along dim 1.  A (B,S,H,N) view with
    head stride 0 is padded at one head and expanded again, so no per-head
    copy is made."""
    if t.dim() == 4 and t.stride(2) == 0:
        one = F.pad(t[:, :, :1], (0, 0, 0, 0, 0, pad))
        return one.expand(-1, -1, t.shape[2], -1)
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd_ref(x, dt, A, B_in, C_in, state=None):
    """Naive per-token recurrence, the oracle for tests."""
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    f32 = torch.float32
    s = torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) if state is None else state
    x, dt, B_in, C_in = (t.to(f32) for t in (x, dt, B_in, C_in))
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)                                  # (B,H)
        s = s * a[:, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None], B_in[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, C_in[:, t]))
    return torch.stack(ys, dim=1), s


def init_ssm_cache(cfg, batch, device, dtype=torch.float32):
    h, p, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    k = cfg.conv_kernel
    gn = cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, k - 1, cfg.ssm_d_inner), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, k - 1, gn), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, k - 1, gn), dtype=dtype, device=device),
    }


def _project(x, p, cfg):
    """Shared pre-SSD projections.  x (B, S, D)."""
    return (x @ p["wz"], x @ p["wx"], x @ p["wB"], x @ p["wC"], x @ p["wdt"])


def _finish(y, x4, z, p, cfg, out=None):
    """Skip + gate + norm + out-projection (``out``, by default the product
    with ``p["wo"]``).  y float32 (B,S,H,P)."""
    Bb, S = y.shape[:2]
    y = y + p["D_skip"][None, None, :, None] * x4.to(torch.float32)
    y = grad_as_forward(y.reshape(Bb, S, cfg.ssm_d_inner)).to(z.dtype)
    y = y * F.silu(z)
    y = layers.rms_norm(y, p["gate_norm"], cfg.norm_eps)
    return y @ p["wo"] if out is None else out(y)


def _broadcast_groups(t, cfg, heads=None):
    """(B,S,G*N) -> (B,S,H,N) float32.  The cast comes first, at (B,S,G*N):
    casting an expanded view would materialise it.  With one group the
    result is an ``expand``ed view of that tensor (head stride 0, its
    storage shared), so every head reads the one group's rows; with G > 1
    each group is copied to its H/G heads.  ``heads`` (start, count) keeps
    those heads only (a rank's local heads on a mesh)."""
    Bb, S = t.shape[:2]
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    start, count = heads if heads is not None else (0, h)
    t = t.to(torch.float32).reshape(Bb, S, g, n)
    if g == 1:
        return t.expand(Bb, S, count, n)
    return t.repeat_interleave(h // g, dim=2).narrow(2, start, count)


def _dt_A(dt_r, p):
    dt = F.softplus(dt_r.to(torch.float32) + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])


def mamba_prefill(x, p, cfg, ctx, seq=None):
    """The mixer over the prompt, and the decode cache: the final SSD state
    and conv windows holding the last K-1 *pre-activation* projected inputs.
    With ``seq`` (``blocks._Seq``) x (B, S_loc, D) is a rank's sequence
    block of the data-parallel-only layout (local tensors inside
    ``blocks``' ``local_map``): the projections, the gate, the norm and the
    out-projection run on the block, the projected conv inputs and dt are
    gathered whole over the model axis (their gradients reduce-scattered
    back) for the conv and the SSD scan, which run along the whole
    sequence; the cache is the whole sequence's."""
    Bb, S_loc, _ = x.shape
    h, pd = cfg.ssm_nheads, cfg.ssm_headdim
    k = cfg.conv_kernel
    z, xs_raw, B_raw, C_raw, dt_r = _project(x, p, cfg)
    if seq is not None:
        xs_raw, B_raw, C_raw, dt_r = map(seq.gather, (xs_raw, B_raw, C_raw, dt_r))
    S = xs_raw.shape[1]
    window = functools.partial(_window, k=k)
    sharded = isinstance(x, DTensor)
    if sharded:
        # the conv and the scan run along the whole sequence
        x_spec = _x_spec(ctx)
        heads = P(x_spec[0], None, ctx.model_axis if x_spec[2] else None)
        whole = P(x_spec[0], None, None)
        z, xs_raw, dt_r = (ctx.place(t, heads) for t in (z, xs_raw, dt_r))
        B_raw, C_raw = ctx.place(B_raw, whole), ctx.place(C_raw, whole)

    def conv(t, q):
        return _sharded_conv(t, q, ctx.groups) if sharded else causal_conv(t, q)

    xs = F.silu(conv(xs_raw, p["conv_x"]))
    B_r = F.silu(conv(B_raw, p["conv_B"]))
    C_r = F.silu(conv(C_raw, p["conv_C"]))
    dt, A = _dt_A(dt_r, p)
    if sharded:
        xs = ctx.place(xs, heads)        # channels split only where H splits
    x4 = ctx.constrain(xs.reshape(Bb, S, h, pd), "ssm_x")
    if sharded:
        y, state = _sharded_scan(x4, dt, A, B_r, C_r, cfg, ctx)
        if x_spec[3] is not None:
            # the head dim whole before (H, P) merges into d_inner
            whole_p = P(x_spec[0], None, x_spec[2], None)
            y, x4 = ctx.place(y, whole_p), ctx.place(x4, whole_p)
    else:
        y, state = ssd_chunked(x4, dt, A, _broadcast_groups(B_r, cfg),
                               _broadcast_groups(C_r, cfg), cfg.ssm_chunk,
                               kernels=ctx.kernels)
    cache = {"state": state, "conv_x": window(xs_raw),
             "conv_B": window(B_raw), "conv_C": window(C_raw)}
    if seq is not None:
        blk = slice(seq.offset, seq.offset + S_loc)
        y, x4 = y[:, blk], x4[:, blk]
    return _finish(y, x4, z, p, cfg), cache


def _window(t, k: int):
    """The conv window a decode step starts from: the last K-1 positions of
    ``t`` (B, S, C), zero-padded in front where S < K-1."""
    S = t.shape[1]
    w = t[:, max(S - (k - 1), 0):]
    return F.pad(w, (0, 0, max(k - 1 - S, 0), 0))


def _x_spec(ctx) -> P:
    """x4's (B, S, H, P) layout on a mesh: the ``ssm_x`` rule (H, or else
    P, over the model axis), or, without one, the batch over the
    residual's batch axes and the rest whole."""
    return ctx.rules.get("ssm_x", P(ctx.rules["residual"][0], None, None, None))


def _follow(placements, dims: dict, grad: bool = False) -> list:
    """The placements of a tensor whose dims are x4's ``dims`` (x4 dim ->
    its dim) when x4 has ``placements``: a mesh dim that shards one of
    those dims shards the tensor's, one that shards another dim of x4
    leaves it whole, or, for its gradient (``grad``), partial (each rank
    holds its slice's sum)."""
    out = []
    for pl in placements:
        if isinstance(pl, Shard) and pl.dim in dims:
            out.append(Shard(dims[pl.dim]))
        elif isinstance(pl, Shard) and grad:
            out.append(Partial())
        else:
            out.append(Replicate())
    return out


def _sharded_conv(x, p, groups):
    """``causal_conv`` on each rank's local channels under ``local_map``: x
    (B, S, C) with its sequence whole, the weights (C, K) and bias cut as
    its channels are, their gradients summed over the batch's shards."""
    pl, mesh = list(x.placements), x.device_mesh
    w_pl = _follow(pl, {2: 0})
    w_grad = _follow(pl, {2: 0}, grad=True)
    w, b = (t.redistribute(mesh, w_pl) for t in (p["w"], p["b"]))
    return local_map_summed(lambda x, w, b: causal_conv(x, {"w": w, "b": b}), pl,
                            (pl, w_pl, w_pl), (pl, w_grad, w_grad), mesh,
                            groups)(x, w, b)


def _sharded_scan(x4, dt, A, B_r, C_r, cfg, ctx):
    """``ssd_chunked`` on each rank's local heads (or head-dim slice),
    under ``local_map``: x4 (B,S,H,P) as ``ssm_x`` places it, dt (B,S,H)
    and A (H,) following its heads, B_r / C_r (B,S,G*N) whole over the
    model axis and broadcast to the local heads inside.  -> (y like x4,
    state (B,H,P,N)), DTensors."""
    pl = to_placements(_x_spec(ctx), ctx.mesh)
    # dims of dt, A, B_r, C_r that are x4's: (B, S, H), (H,), (B, S), (B, S)
    dims = [{0: 0, 1: 1, 2: 2}, {2: 0}, {0: 0, 1: 1}, {0: 0, 1: 1}]
    ins = [pl] + [_follow(pl, d) for d in dims]
    grads = [pl] + [_follow(pl, d, grad=True) for d in dims]
    x4, dt, A, B_r, C_r = (t.redistribute(ctx.mesh, q)
                           for t, q in zip((x4, dt, A, B_r, C_r), ins))
    h = cfg.ssm_nheads
    n_loc = h // math.prod(ctx.mesh.size(i) for i, q in enumerate(pl)
                           if isinstance(q, Shard) and q.dim == 2)
    start = axis_index(ctx.mesh, ctx.model_axis) * n_loc if n_loc < h else 0

    def local(x, dt, A, B_r, C_r):
        heads = (start, x.shape[2])
        return ssd_chunked(x, dt, A, _broadcast_groups(B_r, cfg, heads),
                           _broadcast_groups(C_r, cfg, heads), cfg.ssm_chunk,
                           kernels=ctx.kernels)

    return local_map_summed(local, (pl, _follow(pl, {0: 0, 2: 1, 3: 2})), tuple(ins),
                            tuple(grads), ctx.mesh, ctx.groups)(x4, dt, A, B_r, C_r)


def mamba_decode(x, p, cfg, cache, ctx):
    """One-token decode.  x (B,1,D); cache from init_ssm_cache.  Under a
    decode plan on a mesh (``ctx.sharded_decode``) x is this rank's batch
    rows and the cache its shard (``_sharded_decode``)."""
    if ctx is not None and ctx.sharded_decode:
        return _sharded_decode(x, p, cfg, cache, ctx)
    Bb = x.shape[0]
    h, pd = cfg.ssm_nheads, cfg.ssm_headdim
    f32 = torch.float32
    z, xs, B_r, C_r, dt_r = _project(x, p, cfg)
    xs, conv_x = conv_decode(xs, cache["conv_x"], p["conv_x"])
    B_r, conv_B = conv_decode(B_r, cache["conv_B"], p["conv_B"])
    C_r, conv_C = conv_decode(C_r, cache["conv_C"], p["conv_C"])
    xs, B_r, C_r = F.silu(xs), F.silu(B_r), F.silu(C_r)
    dt, A = _dt_A(dt_r, p)
    dt = dt[:, 0]                                                     # (B,H)
    x4 = xs.reshape(Bb, 1, h, pd)
    Bh = _broadcast_groups(B_r, cfg)[:, 0]                            # (B,H,N)
    Ch = _broadcast_groups(C_r, cfg)[:, 0]
    a = torch.exp(dt * A)                                             # (B,H)
    state = cache["state"] * a[:, :, None, None] + torch.einsum(
        "bhp,bhn->bhpn", (x4[:, 0] * dt[..., None]).to(f32), Bh.to(f32))
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.to(f32))[:, None]    # (B,1,H,P)
    out = _finish(y, x4, z, p, cfg)
    return out, {"state": state, "conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C}


def _sharded_decode(x, p, cfg, cache, ctx):
    """``mamba_decode`` on this rank's shard of the cache, as
    ``launch.sharding.Policy.cache_shardings`` lays it out over the model
    axis: the SSM state's heads where they split over it, else its head
    dim where that splits, else the whole state; each conv window's
    channels where they split.  (The batch is already this rank's rows.)

    Where the heads split, the mixer is tensor-parallel (``models.tp``): z,
    x and dt are projected for the rank's heads only, x's conv runs on
    their channels, the state update on their state, the gated norm's
    mean square is summed over the model axis and the out-projection's
    partial sums reduced; B and C, which every head reads, are projected
    whole.  Otherwise z, x, B, C and dt are projected whole (as
    ``blocks._distributed_decode`` computes q), each conv runs on the
    rank's channels of its window and is gathered, the state update on
    the rank's head-dim slice or the whole state, and y is gathered whole
    before ``_finish``.  -> (out, the new shard of each cache leaf)."""
    from repro_torch.collectives import all_gather_ordered

    Bb = x.shape[0]
    h, pd = cfg.ssm_nheads, cfg.ssm_headdim
    f32 = torch.float32
    m, groups = ctx.model_axis, ctx.groups
    i = axis_index(ctx.mesh, m)
    st = cache["state"]
    hs = tp.split(h, ctx) if st.shape[1] < h else None     # the rank's heads
    cs = slice(hs.start * pd, hs.stop * pd) if hs is not None else None

    def conv(t, window, q, local=False):
        """The conv on the rank's channels where the window is cut to them
        (its last dim shorter than the whole), gathered whole after unless
        ``local`` (t is already the rank's channels)."""
        c = window.shape[-1]
        if c == t.shape[-1] and not local:
            return conv_decode(t, window, q)
        # the policy splits the conv's channels as the cache's window: q is
        # the rank's block of them
        sl = slice(i * c, (i + 1) * c)
        y, new = conv_decode(t if local else t[..., sl], window, q)
        return (y if local else all_gather_ordered(y, groups, m, 2)), new

    di, gn, D = cfg.ssm_d_inner, cfg.ssm_groups * cfg.ssm_state, x.shape[-1]

    def proj(name, n, sl=None):
        return tp.cols(x, p[name], ctx, tp.spec(ctx, name, (D, n)), sl)
    z, xs = proj("wz", di, cs), proj("wx", di, cs)
    B_r, C_r = proj("wB", gn), proj("wC", gn)
    dt_r = proj("wdt", h, hs)
    wo = tp.spec(ctx, "wo", (di, D))
    xs, conv_x = conv(xs, cache["conv_x"], p["conv_x"], local=hs is not None)
    B_r, conv_B = conv(B_r, cache["conv_B"], p["conv_B"])
    C_r, conv_C = conv(C_r, cache["conv_C"], p["conv_C"])
    xs, B_r, C_r = F.silu(xs), F.silu(B_r), F.silu(C_r)
    q = {k: (p[k] if hs is None else p[k][hs]) for k in ("dt_bias", "A_log", "D_skip")}
    dt, A = _dt_A(dt_r, q)
    dt = dt[:, 0]                                                     # (B,Hl)
    hl = h if hs is None else hs.stop - hs.start
    x4 = xs.reshape(Bb, 1, hl, pd)
    heads = None if hs is None else (hs.start, hl)
    Bh = _broadcast_groups(B_r, cfg, heads)[:, 0].to(f32)             # (B,Hl,N)
    Ch = _broadcast_groups(C_r, cfg, heads)[:, 0].to(f32)
    xd = (x4[:, 0] * dt[..., None]).to(f32)                           # (B,Hl,P)
    a = torch.exp(dt * A)                                             # (B,Hl)
    split_p = hs is None and st.shape[2] < pd
    if split_p:
        w = st.shape[2]
        xd = xd[:, :, i * w:(i + 1) * w]
    state = st * a[:, :, None, None] + torch.einsum("bhp,bhn->bhpn", xd, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    new_cache = {"state": state, "conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C}
    if hs is None:
        if split_p:
            y = all_gather_ordered(y, groups, m, 2)
        out = _finish(y[:, None], x4, z, p, cfg,
                      out=lambda t: tp.rows_whole(t, p["wo"], ctx, wo))
        return out, new_cache
    # _finish on the rank's channels: the gated norm's mean square summed
    y = y[:, None] + q["D_skip"][None, None, :, None] * x4.to(f32)
    y = (y.reshape(Bb, 1, hl * pd).to(z.dtype) * F.silu(z)).to(f32)
    ss = torch.sum(torch.square(y), dim=-1, keepdim=True)
    ss = tp.model_sum(ss, ctx)
    y = y * torch.rsqrt(ss / cfg.ssm_d_inner + cfg.norm_eps)
    y = (y * p["gate_norm"]["scale"][cs].to(f32)).to(z.dtype)
    return tp.rows(y, p["wo"], ctx, wo), new_cache

