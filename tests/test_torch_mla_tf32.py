"""The precision argument of MLA's float32 kernels (3xTF32).

``csrc/mla_attention_tf32.cuh`` runs MLA's float32 attention, forward and
backward, on the tensor cores in TF32.  Every float32 operand x is split as
the kernels form it: hi is x truncated to TF32 (a raw operand in shared
memory is its own hi, whose 13 low bits the tensor core drops; a register
operand is truncated by ``pack_a``) and lo = x - hi (truncated in turn by
the tensor core); every product is lo.hi + hi.lo + hi.hi summed in float32,
lo.lo dropped (``_tf32.py``'s "trunc").  ``_forward`` and ``_backward``
repeat the kernels' arithmetic in plain torch on the CPU: 64-key tiles, S
summed over 64-column chunks of Dk in 8-wide k steps (the forward's two
warpgroups' partials, over the even and the odd chunks, added last), the
scores scaled by scale * log2(e) and masked with -1e30, the online softmax
with exp2, P.V in 8-key steps; the backward's P = exp2(scale log2(e) S -
log2(e) lse), dP = dO.V^T, the port's D = rowsum(p dp) / rowsum(p), dS = P
(dP - D) scale, dQ = dS.K, dK = dS^T.Q and dV = P^T.dO over 8-row steps.
Both are held against the function in float64 at MLA's widths (Dk = 576,
Dv = 512, and the reduced 40 / 32): 3xTF32 within 1e-4 of each output's
largest, one TF32 product not.  The kernels themselves are held to the
plain versions on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)
from _tf32 import mm as _mm

TOL = 1e-4                # the float32 gate of MLA's kernels, of each output's largest
KT = 64                   # keys of a key tile
SCALE = 192 ** -0.5       # deepseek-v2's


def mm(eq, a, b, terms):
    """One product as the kernels take it: hi and lo truncated."""
    return _mm(eq, a, b, terms, "trunc")


def _steps(eq, a, b, terms, axis_a, axis_b, lo=0, hi=None):
    """``mm`` summed in float32 over 8-wide steps of the contracted axes
    (``axis_a`` of a, ``axis_b`` of b), from ``lo`` to ``hi``."""
    hi = a.shape[axis_a] if hi is None else hi
    out = 0
    for k0 in range(lo, hi, 8):
        out = out + mm(eq, a.narrow(axis_a, k0, 8), b.narrow(axis_b, k0, 8), terms)
    return out


def _scores(q, k, terms, split):
    """S (B, H, Sq, Sk') of q (B, Sq, H, Dk) and a key tile k (B, Sk', Dk):
    the sum over 64-column chunks, with ``split`` as the forward's two
    partials (even chunks, odd chunks) added last."""
    Dk = q.shape[-1]
    part = [0, 0]
    for c in range(0, Dk, 64):
        s = _steps("bqhd,bkd->bhqk", q, k, terms, 3, 2, c, min(c + 64, Dk))
        part[(c // 64) % 2 if split else 0] = part[(c // 64) % 2 if split else 0] + s
    return part[0] + part[1]


def _mask(Sq, Sk, k0, causal):
    keys = k0 + torch.arange(KT)[None, :]
    rows = torch.arange(Sq)[:, None]
    return (keys >= Sk) | ((keys > rows) if causal else torch.zeros_like(keys > rows))


def _pad(t, n):
    """t's second axis zero-padded to n (keys past Sk are zeros)."""
    return torch.cat([t, t.new_zeros(t.shape[0], n - t.shape[1], *t.shape[2:])], 1)


def _forward(q, k, v, causal, terms):
    """(o (B, Sq, H, Dv), lse (B, H, Sq)) as the forward kernel computes them."""
    B, Sq, H, Dk = q.shape
    Sk, Dv = k.shape[1], v.shape[2]
    c = SCALE * math.log2(math.e)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros(B, H, Sq)
    o = torch.zeros(B, H, Sq, Dv)
    for k0 in range(0, Sk, KT):
        kt, vt = _pad(k[:, k0:k0 + KT], KT), _pad(v[:, k0:k0 + KT], KT)
        s = _scores(q, kt, terms, split=True) * c
        s = torch.where(_mask(Sq, Sk, k0, causal), torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _steps("bhqk,bkd->bhqd", p, vt, terms, 3, 1)
        m = m_new
    lse = (m + torch.log2(l.clamp_min(1e-30))) * math.log(2)
    return (o / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3), lse


def _backward(q, k, v, lse, do, causal, terms):
    """(dq, dk, dv) as the backward kernels compute them, from the lse."""
    B, Sq, H, Dk = q.shape
    Sk = k.shape[1]
    kp = -(-Sk // KT) * KT
    kt, vt = _pad(k, kp), _pad(v, kp)
    s = torch.cat([_scores(q, kt[:, k0:k0 + KT], terms, split=False)
                   for k0 in range(0, kp, KT)], -1)
    masked = torch.cat([_mask(Sq, Sk, k0, causal) for k0 in range(0, kp, KT)], -1)
    p = torch.exp2(s * (SCALE * math.log2(math.e)) - lse[..., None] * math.log2(math.e))
    p = torch.where(masked, torch.tensor(0.0), p)
    dp = _steps("bqhd,bkd->bhqk", do, vt, terms, 3, 2)
    D = (p * dp).sum(-1) / p.sum(-1)
    ds = torch.where(masked, torch.tensor(0.0), p * (dp - D[..., None]) * SCALE)
    dq = _steps("bhqk,bkd->bqhd", ds, kt, terms, 3, 1)
    # the products over rows: (B, keys, rows) . (B, rows, D), rows as q
    # lies them, zero-padded to 64-row tiles
    rp = -(-Sq * H // 64) * 64
    rows = lambda t: _pad(t.permute(0, 2, 1, 3).reshape(B, Sq * H, kp), rp).transpose(1, 2)  # noqa: E731
    flat = lambda t: _pad(t.reshape(B, Sq * H, t.shape[-1]), rp)                             # noqa: E731
    dk = _steps("bkr,brd->bkd", rows(ds), flat(q), terms, 2, 1)
    dv = _steps("bkr,brd->bkd", rows(p), flat(do), terms, 2, 1)
    return dq, dk[:, :Sk], dv[:, :Sk]


def _exact(q, k, v, do, causal):
    """o, lse, dq, dk, dv in float64: what the float32 versions are rounded from."""
    q, k, v, do = (t.double().requires_grad_(True) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkd->bhqk", q, k) * SCALE
    if causal:
        keep = torch.arange(q.shape[1])[:, None] >= torch.arange(k.shape[1])[None, :]
        s = torch.where(keep, s, torch.tensor(-1e30, dtype=torch.float64))
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhqk,bkd->bqhd", torch.softmax(s, -1), v)
    grads = torch.autograd.grad(o, (q, k, v), do.detach())
    return o.detach(), lse.detach(), grads


def _inputs(seed, B, S, H, Dk, Dv):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, Dk), (B, S, Dk), (B, S, Dv), (B, S, H, Dv))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]


def _err(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


# deepseek-v2's widths (Dk = 576, Dv = 512) and the reduced config's (40 /
# 32), a few positions of many heads and many positions of few
@pytest.mark.parametrize("B,S,H,Dk,Dv", [
    (1, 70, 8, 576, 512),
    (1, 130, 2, 576, 512),
    (2, 24, 4, 40, 32),
    (1, 97, 6, 40, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_holds_1e4_and_1xtf32_does_not(B, S, H, Dk, Dv, causal):
    """The kernels' arithmetic with 3xTF32 products is within 1e-4 of each
    output's largest (o, lse, dq, dk, dv) against the function in float64;
    with one TF32 product per float32 product it is not, which is why the
    kernels split."""
    q, k, v, do = _inputs(S + Dk, B, S, H, Dk, Dv)
    o_x, lse_x, grads_x = _exact(q, k, v, do, causal)
    errs = {}
    for terms in (3, 1):
        o, lse = _forward(q, k, v, causal, terms)
        grads = _backward(q, k, v, lse, do, causal, terms)
        errs[terms] = [_err(o, o_x), _err(lse, lse_x)] + [
            _err(g, w) for g, w in zip(grads, grads_x)]
    assert max(errs[3]) <= TOL, errs[3]
    assert max(errs[1]) > TOL, errs[1]
