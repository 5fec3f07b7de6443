"""Plain PyTorch versions of the port's kernels.

They are the CPU path (``ops.py`` takes them for tensors on the CPU) and
the yardstick the CUDA kernels are held to on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, w_ih, w_hh, b):
    """One grouped LSTM step.  x (G,B,I); h, c (G,B,H); w_ih (G,I,4H);
    w_hh (G,H,4H); b (G,4H).  Gate order i, f, g, o.  The arithmetic is
    float32 whatever the input type, and (h', c') come back in the input
    type, as in the Pallas kernel ``lstm_cell_pallas``; G = 1 is that
    kernel, G > 1 its ``jax.vmap`` over a leading parameter axis."""
    f32 = torch.float32
    gates = (torch.bmm(x.to(f32), w_ih.to(f32))
             + torch.bmm(h.to(f32), w_hh.to(f32))
             + b.to(f32)[:, None, :])
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c.to(f32) + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2.to(h.dtype), c2.to(c.dtype)


def lstm_stack_ref(xs, layers):
    """A stack of grouped LSTM layers over a sequence: xs (G,B,T,I); layers
    a list of {w_ih (G,I_l,4H), w_hh (G,H,4H), b (G,4H)}, I_0 = I and
    I_l = H above -> the top layer's last h (G,B,H).  Each layer starts
    from h = c = 0 and feeds its output sequence to the next; every step is
    one ``lstm_cell_ref``, so h and c round to the input type at each step
    as the cell's outputs do (the JAX package's ``revpred._run_lstm_stack``,
    a ``lax.scan`` of the cell per layer)."""
    G, B = xs.shape[:2]
    seq = xs.permute(2, 0, 1, 3).contiguous()        # time-major (T, G, B, I)
    h = None
    for lp in layers:
        hdim = lp["w_hh"].shape[-2]
        h = torch.zeros(G, B, hdim, dtype=xs.dtype, device=xs.device)
        c = torch.zeros_like(h)
        hs = []
        for t in range(seq.shape[0]):
            h, c = lstm_cell_ref(seq[t], h, c, lp["w_ih"], lp["w_hh"], lp["b"])
            hs.append(h)
        seq = torch.stack(hs)
    return h


def lstm_stack_fwd_train_ref(xs, layers):
    """What the training forward ``lstm_stack_fwd_train`` computes, float32:
    the arguments of ``lstm_stack_ref`` -> (the top layer's last h (G,B,H),
    gates (L,G,B,T,4H) after their nonlinearities, c and h (L,G,B,T,H) of
    every layer and step), each step the arithmetic of ``lstm_cell_ref``."""
    G, B, T = xs.shape[:3]
    seq = xs
    gates, cs, hs = [], [], []
    for lp in layers:
        H = lp["w_hh"].shape[-2]
        h = torch.zeros(G, B, H, dtype=xs.dtype, device=xs.device)
        c = torch.zeros_like(h)
        g_l, c_l, h_l = [], [], []
        for t in range(T):
            pre = (torch.bmm(seq[:, :, t], lp["w_ih"]) + torch.bmm(h, lp["w_hh"])
                   + lp["b"][:, None, :])
            i, f, g, o = pre.chunk(4, dim=-1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
            c = f * c + i * g
            h = o * torch.tanh(c)
            g_l.append(torch.cat([i, f, g, o], dim=-1))
            c_l.append(c)
            h_l.append(h)
        seq = torch.stack(h_l, dim=2)
        gates.append(torch.stack(g_l, dim=2))
        cs.append(torch.stack(c_l, dim=2))
        hs.append(seq)
    return h, torch.stack(gates), torch.stack(cs), torch.stack(hs)


def lstm_stack_bwd_ref(dh_top, gates, c, layers):
    """What the backward kernel ``lstm_stack_bwd`` computes, float32: BPTT
    from the upstream gradient of the top layer's last h (G,B,H) and the
    training forward's gates and c -> dgates (L,G,B,T,4H), the gradient of
    every layer's pre-activation gates, layer by layer from the top and
    step by step from the last."""
    L, G, B, T, H4 = gates.shape
    H = H4 // 4
    dgates = torch.empty_like(gates)
    dx = None                           # (G, B, T, H) from the layer above
    for n in reversed(range(L)):
        dh_rec = torch.zeros(G, B, H, dtype=gates.dtype, device=gates.device)
        dc = torch.zeros_like(dh_rec)
        dx_below = torch.empty(G, B, T, H, dtype=gates.dtype,
                               device=gates.device) if n > 0 else None
        for t in reversed(range(T)):
            dh = dh_rec + (dx[:, :, t] if dx is not None
                           else dh_top if t == T - 1 else 0.0)
            i, f, g, o = gates[n, :, :, t].chunk(4, dim=-1)
            ct = c[n, :, :, t]
            cp = c[n, :, :, t - 1] if t > 0 else torch.zeros_like(ct)
            tc = torch.tanh(ct)
            dc = dc + dh * o * (1 - tc * tc)
            dg = torch.cat([dc * g * i * (1 - i), dc * cp * f * (1 - f),
                            dc * i * (1 - g * g), dh * tc * o * (1 - o)], dim=-1)
            dc = dc * f
            dgates[n, :, :, t] = dg
            dh_rec = torch.bmm(dg, layers[n]["w_hh"].transpose(1, 2))
            if n > 0:
                dx_below[:, :, t] = torch.bmm(dg, layers[n]["w_ih"].transpose(1, 2))
        dx = dx_below
    return dgates


# the sweep's "not running" boundary tick, the boundary min's identity
_BIG = 1 << 60


def ewma_fold_torch_ref(obs, lens, m0, first, ewma):
    """The SoA round's EWMA fold on float64 tensors, column by column in the
    order of the numpy ``soa_step.ewma_fold_ref``: obs (F,L), lens (F,)
    int64, m0 (F,), first (F,) bool, ewma (F,) -> m (F,).  Each product
    and the sum are separate operations, so every step rounds as numpy's
    ``b * m + a * col`` does."""
    m = torch.where(first, torch.zeros_like(m0), m0)
    fr = first.clone()
    b = 1.0 - ewma
    for j in range(obs.shape[1]):
        col = obs[:, j]
        valid = j < lens
        m = torch.where(valid & fr, col,
                        torch.where(valid, b * m + ewma * col, m))
        fr = fr & ~valid
    return m


def soa_step_fused_ref(obs, lens, m0, first, ewma, next_k, row_rep,
                       n_reps: int):
    """The fold and the per-replica boundary min: (m (F,) float64,
    seg (n_reps,) int64) where seg[r] is the min of ``next_k`` over the
    rows with ``row_rep == r``, and 2^60 for a replica with no row."""
    m = ewma_fold_torch_ref(obs, lens, m0, first, ewma)
    seg = torch.full((int(n_reps),), _BIG, dtype=torch.int64,
                     device=next_k.device)
    seg.scatter_reduce_(0, row_rep, next_k, "amin")
    return m, seg


def flash_attention_ref(q, k, v, causal: bool = True, scale=None, q_offset: int = 0):
    """Plain softmax attention, what ``flash_attention_pallas`` computes.
    q (B,Sq,H,D); k, v (B,Sk,H,D) with the same H.  Scores, softmax and the
    product are float32; the output comes back in q's type.  The causal
    mask is q_offset + qpos >= kpos (``q_offset`` the global position of
    q's first row; the Pallas kernel's is 0); masked scores are -1e30."""
    f32 = torch.float32
    D = q.shape[-1]
    Sq, Sk = q.shape[1], k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None] + q_offset
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full((), -1e30, dtype=f32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(f32))
    return o.to(q.dtype)


def _key_chunk(Sk: int, chunk) -> int:
    """The flash loops' key chunk: ``min(chunk, Sk)``, or all of Sk where
    that does not divide it (the JAX package then takes its naive path,
    the same function)."""
    c = Sk if chunk is None else min(int(chunk), Sk)
    return c if c > 0 and Sk % c == 0 else Sk


def _grouped(q, k, v):
    """q (B,Sq,H,D) with k, v (B,Sk,H,D) as the grouped layout, q
    (B,Sq,H,1,D); a grouped q (B,Sq,KV,G,D) as it is."""
    return q if q.dim() == 5 else q[:, :, :, None]


def flash_attention_fwd_lse(q, k, v, causal: bool = True, scale=None,
                            chunk=None, q_offset: int = 0):
    """Flash forward that also returns the log-sum-exp, the port of the JAX
    package's ``models.attention._chunked_fwd`` (the forward of its custom
    VJP): an online softmax over key chunks of ``chunk`` in float32.
    q (B,Sq,H,D); k (B,Sk,H,D), v (B,Sk,H,Dv) -> (o (B,Sq,H,Dv) in q's type,
    lse (B,H,Sq) float32), lse = m + log(max(l, 1e-30)) in natural units of
    s = scale * q.k.  Also the grouped layout: q (B,Sq,KV,G,D) against k
    (B,Sk,KV,D), v (B,Sk,KV,Dv), each K/V head read once for its G query
    heads -> (o (B,Sq,KV,G,Dv), lse (B,KV,G,Sq)).  ``q_offset``: the global
    position of q's first row under the causal mask (key positions start
    at 0)."""
    f32 = torch.float32
    q5 = _grouped(q, k, v)
    B, Sq, KV, G, D = q5.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    c = _key_chunk(Sk, chunk)
    q32 = q5.to(f32) * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    neg = torch.full((), -1e30, dtype=f32, device=q.device)
    m = torch.full((B, KV, G, Sq), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, Dv), dtype=f32, device=q.device)
    for start in range(0, Sk, c):
        s = torch.einsum("bqkgd,bckd->bkgqc", q32, k[:, start:start + c].to(f32))
        if causal:
            kpos = start + torch.arange(c, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p, v[:, start:start + c].to(f32))
        m = m_new
    o = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    if q.dim() == 4:
        o, lse = o[:, :, :, 0], lse[:, :, 0]
    return o.to(q.dtype), lse


def flash_attention_bwd(q, k, v, lse, do, causal: bool = True, scale=None,
                        chunk=None, q_offset: int = 0):
    """The flash backward, the port of the JAX package's
    ``models.attention._flash_bwd_rule``, in float32: per key chunk
    p = exp(s - lse), dv = p^T.do, dp = do.v^T, ds = p * (dp - D) * scale,
    then dq (summed over the chunks), dk = ds^T.q.  The reference takes
    D = sum(do * o) over the head dim; here D = sum(p * dp) / sum(p) over
    the keys, from the probabilities this backward recomputes (a first pass
    over the chunks where there are several).  The two are equal in exact
    arithmetic (o = p.v and sum(p) = 1), but the reference's D carries the
    forward's rounding of o and lse into every ds: where the attention is
    nearly uniform (whisper's cross-attention over 1500 frames) dq cancels
    to far below |o|, and sum(ds) must vanish for it to, which this D makes
    hold whatever the forward's rounding.  q, do (B,Sq,H,D); k, v
    (B,Sk,H,D); lse (B,H,Sq) float32 -> (dq, dk, dv), each in its input's
    type; or the grouped layout of ``flash_attention_fwd_lse`` (q, do
    (B,Sq,KV,G,.), k, v (B,Sk,KV,.), lse (B,KV,G,Sq)), v's width Dv free.
    Each pass holds one (Sq, chunk) tile of probabilities at a time."""
    f32 = torch.float32
    q5 = _grouped(q, k, v)
    B, Sq, KV, G, Dh = q5.shape
    Sk = k.shape[1]
    lse5 = lse if q.dim() == 5 else lse[:, :, None]
    scale = scale if scale is not None else Dh ** -0.5
    c = _key_chunk(Sk, chunk)
    q32 = q5.to(f32)
    do32 = _grouped(do, k, v).to(f32).permute(0, 2, 3, 1, 4)    # (B,KV,G,Sq,Dv)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    neg = torch.full((), -1e30, dtype=f32, device=q.device)

    def chunk_terms(start):
        """(k, p, dp) of the key chunk at ``start``."""
        k32 = k[:, start:start + c].to(f32)
        v32 = v[:, start:start + c].to(f32)
        s = torch.einsum("bqkgd,bckd->bkgqc", q32 * scale, k32)
        if causal:
            kpos = start + torch.arange(c, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, neg)
        p = torch.exp(s - lse5[..., None])                    # (B,KV,G,Sq,C)
        return k32, p, torch.einsum("bkgqd,bckd->bkgqc", do32, v32)

    starts = range(0, Sk, c)
    terms = [chunk_terms(0)] if c == Sk else map(chunk_terms, starts)
    pdp = psum = 0
    for _, p, dp in terms:
        pdp = pdp + torch.sum(p * dp, dim=-1)
        psum = psum + torch.sum(p, dim=-1)
    Dsum = pdp / psum
    dq = torch.zeros((B, Sq, KV, G, Dh), dtype=f32, device=q.device)
    dks, dvs = [], []
    for start in starts:
        k32, p, dp = terms[0] if c == Sk else chunk_terms(start)
        dvs.append(torch.einsum("bkgqc,bkgqd->bckd", p, do32))
        ds = p * (dp - Dsum[..., None]) * scale
        dq = dq + torch.einsum("bkgqc,bckd->bqkgd", ds, k32)
        dks.append(torch.einsum("bkgqc,bqkgd->bckd", ds, q32))
    dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
    if q.dim() == 4:
        dq = dq[:, :, :, 0]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_chunk_ref(x, dt, A, B_in, C_in, state):
    """One Mamba2 SSD chunk with its incoming state: the arithmetic of the
    JAX package's ``models.ssd._chunk_scan_step`` (what ``ssd_chunk_pallas``
    tiles), in float32.  x (B,Q,H,P); dt (B,Q,H); A (H,); B_in, C_in
    (B,Q,H,N); state (B,H,P,N) -> (y (B,Q,H,P), new_state (B,H,P,N)).
    ``seg`` is masked before the exp: above the diagonal it is positive and
    would overflow to inf."""
    f32 = torch.float32
    x, dt, A = x.to(f32), dt.to(f32), A.to(f32)
    B_in, C_in, state = B_in.to(f32), C_in.to(f32), state.to(f32)
    a = dt * A                                                  # (B,Q,H)
    cum = torch.cumsum(a, dim=1)
    seg = cum[:, :, None, :] - cum[:, None, :, :]               # (B,Qi,Qj,H)
    Q = x.shape[1]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    mask = mask[None, :, :, None]
    zero = torch.zeros((), dtype=f32, device=x.device)
    decay = torch.where(mask, torch.exp(torch.where(mask, seg, zero)), zero)
    scores = torch.einsum("bihn,bjhn->bijh", C_in, B_in) * decay
    xbar = x * dt[..., None]
    y = torch.einsum("bijh,bjhp->bihp", scores, xbar)
    y = y + torch.einsum("bhpn,bihn->bihp", state, C_in * torch.exp(cum)[..., None])
    chunk_decay = torch.exp(cum[:, -1])                         # (B,H)
    w = torch.exp(cum[:, -1:, :] - cum)                         # (B,Q,H)
    new_state = state * chunk_decay[:, :, None, None] + torch.einsum(
        "bjhp,bjhn->bhpn", xbar * w[..., None], B_in)
    return y, new_state


def ssd_chunk_bwd(x, dt, A, B_in, C_in, state, dy, dstate, needs=None):
    """The SSD chunk's backward: ``ssd_chunk_ref`` recomputed on detached
    inputs under ``torch.enable_grad()`` and differentiated by autograd,
    the port of the ``jax.checkpoint`` around the JAX package's
    ``_chunk_scan_step`` (nothing but the inputs is kept from the forward).
    dy (B,Q,H,P), dstate (B,H,P,N) -> the gradients of (x, dt, A, B_in,
    C_in, state), each of its input's shape (B_in and C_in with head stride
    0 get a full (B,Q,H,N) gradient, which autograd sums over the heads of
    the ``expand``); None where ``needs`` (one bool an input) is False."""
    inputs = (x, dt, A, B_in, C_in, state)
    needs = needs if needs is not None else (True,) * 6
    with torch.enable_grad():
        det = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        y, new_state = ssd_chunk_ref(*det)
        wrt = [t for t, n in zip(det, needs) if n]
        got = iter(torch.autograd.grad((y, new_state), wrt, (dy, dstate),
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in needs)
