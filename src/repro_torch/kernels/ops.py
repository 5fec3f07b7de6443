"""Dispatch between the CUDA kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version (``ref.py``); a CUDA
tensor takes the kernel, which raises if it cannot run.  There is no
fallback from the kernel to the plain version.  ``force="ref"`` runs the
plain version on any device, for tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.lstm_cell import lstm_cell_cuda
from repro_torch.kernels.soa_step_cuda import ewma_fold_cuda, soa_step_fused_cuda


def lstm_cell(x, h, c, w_ih, w_hh, b, force: str | None = None):
    """Grouped fused LSTM cell.  force: None (by device) | 'ref' | 'cuda'."""
    mode = force or ("cuda" if x.is_cuda else "ref")
    if mode == "ref":
        return ref.lstm_cell_ref(x, h, c, w_ih, w_hh, b)
    if mode == "cuda":
        return lstm_cell_cuda(x, h, c, w_ih, w_hh, b)
    raise ValueError(f"unknown lstm_cell mode {mode!r}")


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
