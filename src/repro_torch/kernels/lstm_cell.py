"""Wrapper of the hand-written grouped LSTM-cell CUDA kernel.

``csrc/lstm_cell.cu`` replaces the Pallas kernel
``src/repro/kernels/lstm_cell.py:lstm_cell_pallas`` (see its header for the
design).  It is compiled by ``build.py`` at first use and called through
``ctypes`` on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("lstm_cell").lstm_cell_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(x, h, c, w_ih, w_hh, b):
    if not x.is_cuda:
        raise ValueError(f"lstm_cell_cuda needs CUDA tensors, got {x.device}")
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"lstm_cell_cuda takes float32 or bfloat16, got {dtype}")
    if x.dim() != 3 or h.dim() != 3:
        raise ValueError("lstm_cell_cuda takes grouped x (G,B,I) and h (G,B,H)")
    G, B, I = x.shape
    H = h.shape[2]
    want = {"x": (G, B, I), "h": (G, B, H), "c": (G, B, H),
            "w_ih": (G, I, 4 * H), "w_hh": (G, H, 4 * H), "b": (G, 4 * H)}
    for name, t in zip(want, (x, h, c, w_ih, w_hh, b)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"lstm_cell_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"lstm_cell_cuda: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell_cuda: {name} is not contiguous")
    if min(G, B, I, H) == 0:
        raise ValueError(f"lstm_cell_cuda: empty shape G={G} B={B} I={I} H={H}")
    return G, B, I, H


def lstm_cell_cuda(x, h, c, w_ih, w_hh, b):
    """The kernel on CUDA tensors; the shapes of ``ref.lstm_cell_ref``."""
    global LAUNCHES
    G, B, I, H = _check(x, h, c, w_ih, w_hh, b)
    fn = _fn()
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), w_ih.data_ptr(),
             w_hh.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
             G, B, I, H, _DTYPES[x.dtype], x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed (CUDA error {err})")
    LAUNCHES += 1
    return h_out, c_out
