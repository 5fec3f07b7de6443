"""Dispatch between the CUDA kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version (``ref.py``); a CUDA
tensor takes the kernel, which raises if it cannot run.  There is no
fallback from the kernel to the plain version.  ``force="ref"`` runs the
plain version on any device, for tests and ``chip_smoke.py``; it trains by
autograd of the plain version.  Otherwise inputs that need a gradient take
the kernel's autograd Function (``LstmStack``, ``FlashAttention``,
``MlaAttention``, ``SsdChunk``), whose forward and backward are kernels on
the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._grad import needs_grad
from repro_torch.kernels.flash_attention_cuda import (FlashAttention,
                                                      flash_attention_cuda)
from repro_torch.kernels.lstm_cell import (lstm_cell_cuda, lstm_stack_cuda,
                                           lstm_stack_train)
from repro_torch.kernels.mla_attention_cuda import (MlaAttention, mla_attention_cuda,
                                                    mla_fwd_lse_ref)
from repro_torch.kernels.soa_step_cuda import ewma_fold_cuda, soa_step_fused_cuda
from repro_torch.kernels.ssd_chunk_cuda import SsdChunk, ssd_chunk_cuda


def lstm_cell(x, h, c, w_ih, w_hh, b, force: str | None = None):
    """Grouped fused LSTM cell.  force: None (by device) | 'ref' | 'cuda'."""
    mode = force or ("cuda" if x.is_cuda else "ref")
    if mode == "ref":
        return ref.lstm_cell_ref(x, h, c, w_ih, w_hh, b)
    if mode == "cuda":
        return lstm_cell_cuda(x, h, c, w_ih, w_hh, b)
    raise ValueError(f"unknown lstm_cell mode {mode!r}")


def lstm_stack(xs, layers, force: str | None = None):
    """Grouped LSTM stack over a sequence -> the top layer's last h.
    force: None (by device) | 'ref' | 'cuda'.  On CUDA tensors, inputs that
    require grad (with grad mode on) take the training kernels
    (``LstmStack``: forward with its saved state, then the backward);
    others the inference kernel.  The plain version trains by autograd."""
    mode = force or ("cuda" if xs.is_cuda else "ref")
    if mode == "ref":
        return ref.lstm_stack_ref(xs, layers)
    if mode == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [xs] + [lp[k] for lp in layers
                                                 for k in ("w_ih", "w_hh", "b")]):
            return lstm_stack_train(xs, layers)
        return lstm_stack_cuda(xs, layers)
    raise ValueError(f"unknown lstm_stack mode {mode!r}")


def soa_step_fused(obs, lens, m0, first, ewma, next_k, row_rep, n_reps: int,
                   force: str | None = None):
    """SoA round step: EWMA fold + per-replica boundary min -> (m, seg).
    force: None (by device) | 'ref' | 'cuda'."""
    mode = force or ("cuda" if obs.is_cuda else "ref")
    if mode == "ref":
        return ref.soa_step_fused_ref(obs, lens, m0, first, ewma, next_k,
                                      row_rep, n_reps)
    if mode == "cuda":
        return soa_step_fused_cuda(obs, lens, m0, first, ewma, next_k,
                                   row_rep, n_reps)
    raise ValueError(f"unknown soa_step_fused mode {mode!r}")


def ewma_fold(obs, lens, m0, first, ewma, force: str | None = None):
    """The SoA round's EWMA fold alone -> m.  force: None | 'ref' | 'cuda'."""
    mode = force or ("cuda" if obs.is_cuda else "ref")
    if mode == "ref":
        return ref.ewma_fold_torch_ref(obs, lens, m0, first, ewma)
    if mode == "cuda":
        return ewma_fold_cuda(obs, lens, m0, first, ewma)
    raise ValueError(f"unknown ewma_fold mode {mode!r}")


def _mode(t, force):
    mode = force or ("cuda" if t.is_cuda else "ref")
    if mode not in ("ref", "cuda"):
        raise ValueError(f"unknown kernel mode {mode!r}")
    return mode


def flash_attention(q, k, v, causal: bool = True, scale=None, chunk=None,
                    force: str | None = None, q_offset: int = 0):
    """Attention over (B, S, H, D) with shared H -> (B, Sq, H, D) in q's
    type, the causal mask offset by ``q_offset`` (q's first row's global
    position).  force: None (by device) | 'ref' | 'cuda'.  Inputs that
    need a gradient take ``FlashAttention`` (unless ``force='ref'``), whose
    backward runs over key chunks of ``chunk`` (None: one chunk)."""
    mode = _mode(q, force)
    if force != "ref" and needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, scale, chunk, mode == "cuda",
                                    q_offset)
    if mode == "ref":
        return ref.flash_attention_ref(q, k, v, causal, scale, q_offset)
    return flash_attention_cuda(q, k, v, causal, scale, q_offset)


def mla_attention(q, k, v, causal: bool = True, scale=None, chunk=None,
                  force: str | None = None):
    """MLA's absorbed attention: q (B, Sq, H, Dk) against one shared key
    head k (B, Sk, Dk) and value head v (B, Sk, Dv) -> (B, Sq, H, Dv) in
    q's type.  force: None (by device) | 'ref' | 'cuda'.  Inputs that need
    a gradient take ``MlaAttention`` (unless ``force='ref'``), whose plain
    backward runs over key chunks of ``chunk`` (None: one chunk)."""
    mode = _mode(q, force)
    if force != "ref" and needs_grad(q, k, v):
        return MlaAttention.apply(q, k, v, causal, scale, chunk, mode == "cuda")
    if mode == "ref":
        return mla_fwd_lse_ref(q, k, v, causal, scale, chunk)[0]
    return mla_attention_cuda(q, k, v, causal, scale)


def ssd_chunk(x, dt, A, B_in, C_in, state, force: str | None = None):
    """One Mamba2 SSD chunk -> (y, new_state), float32.
    force: None (by device) | 'ref' | 'cuda'.  Inputs that need a gradient
    take ``SsdChunk`` (unless ``force='ref'``)."""
    mode = _mode(x, force)
    if force != "ref" and needs_grad(x, dt, A, B_in, C_in, state):
        return SsdChunk.apply(x, dt, A, B_in, C_in, state, mode == "cuda")
    if mode == "ref":
        return ref.ssd_chunk_ref(x, dt, A, B_in, C_in, state)
    return ssd_chunk_cuda(x, dt, A, B_in, C_in, state)
