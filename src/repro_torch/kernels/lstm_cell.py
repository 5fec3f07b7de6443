"""Wrappers of the hand-written grouped LSTM CUDA kernels.

``csrc/lstm_cell.cu`` replaces the Pallas kernel
``src/repro/kernels/lstm_cell.py:lstm_cell_pallas`` (see its header for the
design) with two entries: ``lstm_cell_fwd``, one grouped cell step (the
direct counterpart of the Pallas kernel), and ``lstm_stack_fwd``, a whole
stack of layers over a sequence in one launch (RevPred's and Tributary's
forwards).  They are compiled by ``build.py`` at first use and called
through ``ctypes`` on PyTorch's current stream.
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


# --------------------------------------------------------------------------
# the whole LSTM stack in one launch (``lstm_stack_fwd``)
# --------------------------------------------------------------------------

#: launches of the stack kernel since the count was last set to 0
STACK_LAUNCHES = 0

#: shared memory one block may have on sm_90 (232,448 bytes)
SMEM_LIMIT = 232448
MAX_THREADS = 1024
MAX_LAYERS = 8
#: threads per hidden unit: two k lanes for each of its four gate columns
LANES = 8
_WPAD = 16
_STACK_FN = None


def _stack_fn():
    global _STACK_FN
    if _STACK_FN is None:
        fn = build.load("lstm_cell").lstm_stack_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _STACK_FN = fn
    return _STACK_FN


def lstm_stack_smem_bytes(I: int, H: int, T: int, rows: int, n_layers: int = 3,
                          wave: int = 1) -> int:
    """Shared memory of one stack block with ``wave`` layers resident:
    their weights (max(I, H) + H rows of 4H for the first, 2H rows for each
    other, every row padded by 16 floats), their biases, the (T, rows, I)
    input and the (T, rows, H) output buffers (one per layer of the wave,
    plus one between waves), all float32 (``stack_smem_floats`` in
    ``csrc/lstm_cell.cu``)."""
    H4 = 4 * H
    w_rows = max(I, H) + H + (wave - 1) * 2 * H
    n_buf = n_layers if wave >= n_layers else wave + 1
    return 4 * (w_rows * (H4 + _WPAD) + wave * H4 + T * rows * I
                + n_buf * T * rows * H)


def lstm_stack_plan(B: int, I: int, H: int, T: int, n_layers: int = 3):
    """-> (layers per wave, rows per block, shared-memory bytes).  All
    layers run as one wavefront where their weights fit in shared memory
    and their threads (8H a layer and row) in 1024, else one layer at a
    time; then as many batch rows per block as fit both limits.  Raises
    ValueError where one layer of one row does not fit (H = 128: one
    layer's weights alone are over 512 KiB, and it would need 1024
    threads)."""
    if H % 4:
        raise ValueError(f"lstm_stack_cuda: hidden size {H} is not a multiple "
                         "of 4")

    def fits(wave, rows):
        return (wave * rows * H * LANES <= MAX_THREADS and
                lstm_stack_smem_bytes(I, H, T, rows, n_layers, wave) <= SMEM_LIMIT)

    if not fits(1, 1):
        raise ValueError(
            f"lstm_stack_cuda: I={I} H={H} T={T} needs "
            f"{lstm_stack_smem_bytes(I, H, T, 1, n_layers, 1)} bytes of shared "
            f"memory and {H * LANES} threads a block for one layer of one batch "
            f"row; a block has {SMEM_LIMIT} bytes and {MAX_THREADS} threads")
    wave = n_layers if fits(n_layers, 1) else 1
    rows = 1
    while rows < B and fits(wave, rows + 1):
        rows += 1
    return wave, rows, lstm_stack_smem_bytes(I, H, T, rows, n_layers, wave)


def _check_stack(xs, layers):
    if not isinstance(xs, torch.Tensor) or not xs.is_cuda:
        raise ValueError("lstm_stack_cuda needs CUDA tensors, got "
                         f"{getattr(xs, 'device', type(xs))}")
    dtype = xs.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"lstm_stack_cuda takes float32 or bfloat16, got {dtype}")
    if xs.dim() != 4:
        raise ValueError("lstm_stack_cuda takes xs (G,B,T,I)")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"lstm_stack_cuda takes 1 to {MAX_LAYERS} layers, "
                         f"got {len(layers)}")
    G, B, T, I = xs.shape
    H = layers[0]["w_hh"].shape[-2]
    if min(G, B, T, I, H) == 0:
        raise ValueError(f"lstm_stack_cuda: empty shape G={G} B={B} T={T} "
                         f"I={I} H={H}")
    tensors = [("xs", xs, (G, B, T, I))]
    for n, lp in enumerate(layers):
        i_l = I if n == 0 else H
        tensors += [(f"layers[{n}].w_ih", lp["w_ih"], (G, i_l, 4 * H)),
                    (f"layers[{n}].w_hh", lp["w_hh"], (G, H, 4 * H)),
                    (f"layers[{n}].b", lp["b"], (G, 4 * H))]
    for name, t, want in tensors:
        if tuple(t.shape) != want:
            raise ValueError(f"lstm_stack_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
        if t.device != xs.device or t.dtype != dtype:
            raise ValueError(f"lstm_stack_cuda: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_stack_cuda: {name} is not contiguous")
    return G, B, T, I, H


def lstm_stack_cuda(xs, layers):
    """The stack kernel on CUDA tensors; the arguments of
    ``ref.lstm_stack_ref``.  Returns the top layer's last h (G,B,H)."""
    global STACK_LAUNCHES
    G, B, T, I, H = _check_stack(xs, layers)
    n = len(layers)
    wave, rows, _ = lstm_stack_plan(B, I, H, T, n)
    fn = _stack_fn()
    ptrs = [(ctypes.c_void_p * n)(*[lp[k].data_ptr() for lp in layers])
            for k in ("w_ih", "w_hh", "b")]
    h_out = torch.empty(G, B, H, dtype=xs.dtype, device=xs.device)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = fn(xs.data_ptr(), *ptrs, n, h_out.data_ptr(), G, B, T, I, H, rows,
             wave, _DTYPES[xs.dtype], xs.device.index, stream)
    if err != 0:
        raise RuntimeError(f"lstm_stack kernel launch failed (code {err})")
    STACK_LAUNCHES += 1
    return h_out
