"""Dispatch between the CUDA kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version (``ref.py``); a CUDA
tensor takes the kernel, which raises if it cannot run.  There is no
fallback from the kernel to the plain version.  ``force="ref"`` runs the
plain version on any device, for tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.lstm_cell import lstm_cell_cuda


def lstm_cell(x, h, c, w_ih, w_hh, b, force: str | None = None):
    """Grouped fused LSTM cell.  force: None (by device) | 'ref' | 'cuda'."""
    mode = force or ("cuda" if x.is_cuda else "ref")
    if mode == "ref":
        return ref.lstm_cell_ref(x, h, c, w_ih, w_hh, b)
    if mode == "cuda":
        return lstm_cell_cuda(x, h, c, w_ih, w_hh, b)
    raise ValueError(f"unknown lstm_cell mode {mode!r}")
