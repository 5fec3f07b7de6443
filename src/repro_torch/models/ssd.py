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

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers


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


def _finish(y, x4, z, p, cfg):
    """Skip + gate + norm + out-projection.  y float32 (B,S,H,P)."""
    Bb, S = y.shape[:2]
    y = y + p["D_skip"][None, None, :, None] * x4.to(torch.float32)
    y = y.reshape(Bb, S, cfg.ssm_d_inner).to(z.dtype)
    y = y * F.silu(z)
    y = layers.rms_norm(y, p["gate_norm"], cfg.norm_eps)
    return y @ p["wo"]


def _broadcast_groups(t, cfg):
    """(B,S,G*N) -> (B,S,H,N) float32.  The cast comes first, at (B,S,G*N):
    casting an expanded view would materialise it.  With one group the
    result is an ``expand``ed view of that tensor (head stride 0, its
    storage shared), so every head reads the one group's rows; with G > 1
    each group is copied to its H/G heads."""
    Bb, S = t.shape[:2]
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    t = t.to(torch.float32).reshape(Bb, S, g, n)
    if g == 1:
        return t.expand(Bb, S, h, n)
    return t.repeat_interleave(h // g, dim=2)


def _dt_A(dt_r, p):
    dt = F.softplus(dt_r.to(torch.float32) + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])


def mamba_block(x, p, cfg, ctx):
    """Full-sequence mamba2 mixer (train/prefill).  x (B,S,D) -> (B,S,D)."""
    return mamba_prefill(x, p, cfg, ctx)[0]


def mamba_prefill(x, p, cfg, ctx):
    """The mixer over the prompt, and the decode cache: the final SSD state
    and conv windows holding the last K-1 *pre-activation* projected inputs."""
    Bb, S, _ = x.shape
    h, pd = cfg.ssm_nheads, cfg.ssm_headdim
    k = cfg.conv_kernel
    z, xs_raw, B_raw, C_raw, dt_r = _project(x, p, cfg)

    def window(t):
        w = t[:, max(S - (k - 1), 0):]
        return F.pad(w, (0, 0, max(k - 1 - S, 0), 0))

    xs = F.silu(causal_conv(xs_raw, p["conv_x"]))
    B_r = F.silu(causal_conv(B_raw, p["conv_B"]))
    C_r = F.silu(causal_conv(C_raw, p["conv_C"]))
    dt, A = _dt_A(dt_r, p)
    x4 = ctx.constrain(xs.reshape(Bb, S, h, pd), "ssm_x")
    y, state = ssd_chunked(x4, dt, A, _broadcast_groups(B_r, cfg),
                           _broadcast_groups(C_r, cfg), cfg.ssm_chunk,
                           kernels=ctx.kernels)
    cache = {"state": state, "conv_x": window(xs_raw),
             "conv_B": window(B_raw), "conv_C": window(C_raw)}
    return _finish(y, x4, z, p, cfg), cache


def mamba_decode(x, p, cfg, cache, ctx):
    """One-token decode.  x (B,1,D); cache from init_ssm_cache."""
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
