"""SoA sweep inner-step kernels: batched EWMA fold + segmented boundary min.

The SoA stepper's per-round compute is (a) folding every touched row's
deterministic per-tick step-time observations into its perf-matrix EWMA
entry and (b) the segmented min over the per-row next-boundary ticks that
replaces the engines' heaps.  The numpy functions below carry over from the
JAX package unchanged: the columnwise masked fold is bit-exact to the
sequential per-observation ``PerfModel.update_many`` replay (same per-row op
order, elementwise float64), and the boundary scan is one
``np.minimum.reduceat``.

``soa_step_fused`` and ``ewma_fold`` take the sweep's numpy arrays and run on
``device``: on the card they are the hand-written CUDA kernel
(``csrc/soa_step.cu``, through ``ops``), which computes both halves in one
launch and is bit-exact for any alpha; on the CPU they are its plain
PyTorch versions (``ref.py``).  The device decides; nothing else does.
``segmented_min`` is always the numpy scan, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_BIG = np.int64(1) << np.int64(60)


# ---------------------------------------------------------------- reference
def ewma_fold_ref(obs: np.ndarray, lens: np.ndarray, m0: np.ndarray,
                  first: np.ndarray, ewma: np.ndarray) -> np.ndarray:
    """Fold ``obs[i, :lens[i]]`` into ``m0[i]`` per row, columnwise.

    Rows with ``first[i]`` start from their first observation instead of
    ``m0`` (the unobserved-prior special case of ``PerfModel.update_many``).
    Per row this replays ``m = (1-a)*m + a*o`` in observation order with the
    identical float64 ops, so the result is bit-exact to the sequential
    fold regardless of how rows are batched."""
    m = np.where(first, 0.0, m0)
    fr = first.copy()
    b = 1.0 - ewma
    for j in range(obs.shape[1]):
        col = obs[:, j]
        valid = j < lens
        m = np.where(valid & fr, col,
                     np.where(valid, b * m + ewma * col, m))
        fr = fr & ~valid
    return m


def ewma_fold_sorted(obs: np.ndarray, lens: np.ndarray, m0: np.ndarray,
                     first: np.ndarray, ewma: np.ndarray) -> np.ndarray:
    """Same fold, O(sum(lens)) instead of O(rows * max(lens)).

    Rows are independent, so sorting them by descending length and folding
    each column over the still-valid *prefix* does the identical per-row
    float64 op sequence with no masking — bit-exact to ``ewma_fold_ref``
    while skipping the padded tail entirely (the tick windows are heavily
    skewed: most rows see a handful of observations, a few see hundreds)."""
    order = np.argsort(-lens, kind="stable")
    ln = lens[order]
    ob = obs[order]
    a = ewma[order]
    b = 1.0 - a
    fr = first[order]
    m = np.where(fr, 0.0, m0[order])
    neg = -ln                         # ascending, for prefix-count searches
    n = int(np.searchsorted(neg, 0, side="left"))      # rows with >=1 obs
    if n:
        col = ob[:n, 0]
        m[:n] = np.where(fr[:n], col, b[:n] * m[:n] + a[:n] * col)
    for j in range(1, obs.shape[1]):
        n = int(np.searchsorted(neg, -j, side="left"))  # rows with len > j
        if not n:
            break
        m[:n] = b[:n] * m[:n] + a[:n] * ob[:n, j]
    out = np.empty_like(m)
    out[order] = m
    return out


def segmented_min_ref(next_k: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Per-segment min of ``next_k`` over contiguous ``starts`` segments —
    the "next boundary" scan (``_BIG`` rows are the not-running padding)."""
    return np.minimum.reduceat(next_k, starts)


# ----------------------------------------------------------------- dispatch
#: bytes copied to and from the card by ``soa_step_fused`` / ``ewma_fold``
#: since the counts were last set to 0
H2D_BYTES = 0
D2H_BYTES = 0


def _to_device(dev: torch.device, *arrays):
    global H2D_BYTES
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            H2D_BYTES += t.numel() * t.element_size()
            t = t.to(dev)
        out.append(t)
    return out


def _to_host(dev: torch.device, *tensors):
    global D2H_BYTES
    if dev.type == "cuda":
        D2H_BYTES += sum(t.numel() * t.element_size() for t in tensors)
    return [t.cpu().numpy() for t in tensors]


def soa_step_fused(obs, lens, m0, first, ewma, next_k, row_rep, n_reps: int,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Fused inner step: (EWMA fold, segmented boundary min) in one kernel
    launch on ``device`` -> numpy (m, seg).  ``row_rep`` gives each row's
    replica in [0, n_reps); seg[r] is 2^60 for a replica with no row."""
    dev = resolve_device(device)
    row_rep = np.asarray(row_rep)
    if len(row_rep) and (row_rep.min() < 0 or row_rep.max() >= n_reps):
        raise ValueError(f"soa_step_fused: row_rep outside [0, {n_reps})")
    args = _to_device(dev, obs, lens, m0, first, ewma, next_k, row_rep)
    m, seg = ops.soa_step_fused(*args, n_reps)
    return tuple(_to_host(dev, m, seg))


def ewma_fold(obs, lens, m0, first, ewma, device="cuda") -> np.ndarray:
    """The fold alone on ``device`` (the kernel's fold-only entry point on
    the card) -> numpy m, bit-exact to ``ewma_fold_ref``."""
    dev = resolve_device(device)
    m = ops.ewma_fold(*_to_device(dev, obs, lens, m0, first, ewma))
    return _to_host(dev, m)[0]


def segmented_min(next_k, starts) -> np.ndarray:
    """The boundary scan (numpy reduceat, on every device; the fused
    kernel's min half covers the deferred rounds)."""
    return segmented_min_ref(next_k, starts)
