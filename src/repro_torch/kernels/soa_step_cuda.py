"""Wrapper of the hand-written SoA-step CUDA kernel.

``csrc/soa_step.cu`` replaces the Pallas kernel
``src/repro/kernels/soa_step.py:soa_step_fused`` and the Pallas branch of
``ewma_fold`` there (see its header for the design).  It is compiled by
``build.py`` at first use and called through ``ctypes`` on PyTorch's
current stream.  The functions here take CUDA tensors; ``soa_step.py`` moves
the sweep's numpy arrays to the card and back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import _BIG

#: launches of the kernel (both entry points) since the count was last set
#: to 0, and of those the fold-only ones
LAUNCHES = 0
FOLD_LAUNCHES = 0

_FNS = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("soa_step"), name)
        n_ptr = 9 if name == "soa_step_fused" else 6
        n_size = 4 if name == "soa_step_fused" else 2
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * n_size
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(named):
    """The tensors' common CUDA device, after the type, shape, contiguity
    and device checks the kernel relies on."""
    dev = None
    for name, t, shape in named:
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
            raise ValueError(f"soa_step_cuda: {name} must be a CUDA tensor, "
                             f"got {where}")
        if t.dtype != _DTYPES[name]:
            raise TypeError(f"soa_step_cuda: {name} is {t.dtype}, expected "
                            f"{_DTYPES[name]}")
        if tuple(t.shape) != shape:
            raise ValueError(f"soa_step_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"soa_step_cuda: {name} is not contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"soa_step_cuda: {name} is on {t.device}, the "
                             f"others on {dev}")
    return dev


_DTYPES = {"obs": torch.float64, "lens": torch.int64, "m0": torch.float64,
           "first": torch.bool, "ewma": torch.float64, "next_k": torch.int64,
           "row_rep": torch.int64}


def _fold_args(obs, lens, m0, first, ewma):
    if not isinstance(obs, torch.Tensor) or obs.dim() != 2:
        raise ValueError("soa_step_cuda: obs must be a 2-D (F, L) tensor")
    F, L = obs.shape
    return F, L, [("obs", obs, (F, L)), ("lens", lens, (F,)), ("m0", m0, (F,)),
                  ("first", first, (F,)), ("ewma", ewma, (F,))]


def soa_step_fused_cuda(obs, lens, m0, first, ewma, next_k, row_rep,
                        n_reps: int):
    """The fused kernel on CUDA tensors -> (m (F,) float64, seg (n_reps,)
    int64); the arguments of ``ref.soa_step_fused_ref``.  ``row_rep`` must
    lie in [0, n_reps): the kernel skips a row outside it."""
    global LAUNCHES
    F, L, named = _fold_args(obs, lens, m0, first, ewma)
    if not isinstance(next_k, torch.Tensor) or next_k.dim() != 1:
        raise ValueError("soa_step_cuda: next_k must be a 1-D (N,) tensor")
    N = next_k.shape[0]
    named += [("next_k", next_k, (N,)), ("row_rep", row_rep, (N,))]
    dev = _check(named)
    n_reps = int(n_reps)
    if n_reps < 0:
        raise ValueError(f"soa_step_cuda: n_reps={n_reps} < 0")
    m = torch.empty(F, dtype=torch.float64, device=dev)
    seg = torch.full((n_reps,), _BIG, dtype=torch.int64, device=dev)
    if F == 0 and N == 0:
        return m, seg
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("soa_step_fused")(
        obs.data_ptr(), lens.data_ptr(), m0.data_ptr(), first.data_ptr(),
        ewma.data_ptr(), next_k.data_ptr(), row_rep.data_ptr(), m.data_ptr(),
        seg.data_ptr(), F, L, N, n_reps, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"soa_step kernel launch failed (CUDA error {err})")
    LAUNCHES += 1
    return m, seg


def ewma_fold_cuda(obs, lens, m0, first, ewma):
    """The fold-only entry point on CUDA tensors -> m (F,) float64."""
    global LAUNCHES, FOLD_LAUNCHES
    F, L, named = _fold_args(obs, lens, m0, first, ewma)
    dev = _check(named)
    m = torch.empty(F, dtype=torch.float64, device=dev)
    if F == 0:
        return m
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("soa_ewma_fold")(
        obs.data_ptr(), lens.data_ptr(), m0.data_ptr(), first.data_ptr(),
        ewma.data_ptr(), m.data_ptr(), F, L, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"soa_step fold launch failed (CUDA error {err})")
    LAUNCHES += 1
    FOLD_LAUNCHES += 1
    return m
