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
