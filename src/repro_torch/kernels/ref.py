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
