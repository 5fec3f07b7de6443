"""Wrappers of the hand-written grouped LSTM CUDA kernels.

``csrc/lstm_cell.cu`` replaces the Pallas kernel
``src/repro/kernels/lstm_cell.py:lstm_cell_pallas`` (see its header for the
design) with two entries: ``lstm_cell_fwd``, one grouped cell step (the
direct counterpart of the Pallas kernel), and ``lstm_stack_fwd``, a whole
stack of layers over a sequence in one launch (RevPred's and Tributary's
forwards).  Training goes through ``LstmStack``, a ``torch.autograd.Function``
over two more entries: ``lstm_stack_fwd_train`` (what the stack computes,
also saving every step's gates, c and h) and ``lstm_stack_bwd`` (the
backward's recurrence, a reverse wavefront over the layers), kernels of
their own that tile 1, 2 or 4 batch rows a block so that the grid runs in
one wave over the SMs (``lstm_stack_train_plan``,
``lstm_stack_bwd_plan``); the weight gradients,
which have no recurrence, are one ``torch.bmm`` per weight over the
kernel's dgates.  They are compiled by ``build.py`` at first use and called
through ``ctypes`` on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._grad import check_no_grad

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
    check_no_grad("lstm_cell_cuda", x, h, c, w_ih, w_hh, b)
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
    """-> (layers per wave, rows per block, shared-memory bytes) of the
    stack kernel under a block's limits: 8H threads a layer and row (1024 a
    block) and ``lstm_stack_smem_bytes`` (``SMEM_LIMIT``).  Every layer at
    once where that fits, else one at a time; then as many batch rows per
    block as fit.  Raises ValueError where one layer of one row does not
    fit: H = 128, whose weights alone are over 512 KiB and which would need
    1024 threads."""
    what = f"lstm_stack_cuda: I={I} H={H} T={T}"
    if H % 4:
        raise ValueError(f"{what}: hidden size {H} is not a multiple of 4")

    def smem(rows, wave):
        return lstm_stack_smem_bytes(I, H, T, rows, n_layers, wave)

    def fits(wave, rows):
        return (wave * rows * H * LANES <= MAX_THREADS and
                smem(rows, wave) <= SMEM_LIMIT)

    if not fits(1, 1):
        raise ValueError(
            f"{what} needs {smem(1, 1)} bytes of shared memory and "
            f"{H * LANES} threads a block for one layer of one batch row; a "
            f"block has {SMEM_LIMIT} bytes and {MAX_THREADS} threads")
    wave = n_layers if fits(n_layers, 1) else 1
    rows = 1
    while rows < B and fits(wave, rows + 1):
        rows += 1
    return wave, rows, smem(rows, wave)


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


def _flat(layers):
    return [lp[k] for lp in layers for k in ("w_ih", "w_hh", "b")]


def _unflat(flat):
    return [dict(zip(("w_ih", "w_hh", "b"), flat[i:i + 3]))
            for i in range(0, len(flat), 3)]


def lstm_stack_cuda(xs, layers):
    """The stack kernel on CUDA tensors; the arguments of
    ``ref.lstm_stack_ref``.  Returns the top layer's last h (G,B,H).  It
    has no gradient: inputs that require one go through ``LstmStack``
    (``ops.lstm_stack`` sends them there)."""
    global STACK_LAUNCHES
    check_no_grad("lstm_stack_cuda (use ops.lstm_stack to train)", xs,
                  *_flat(layers))
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


# --------------------------------------------------------------------------
# training: the forward with its saved state, and the backward
# (``lstm_stack_fwd_train``, ``lstm_stack_bwd``)
# --------------------------------------------------------------------------

#: launches of the training forward and of the backward since set to 0
TRAIN_LAUNCHES = 0
BWD_LAUNCHES = 0

#: batch rows a training block may own (the kernels' template argument R)
TRAIN_ROWS = (1, 2, 4)
#: threads a training block may have, by the registers its threads give
#: weights (``train_max_threads``): the smallest of 16, 32, 64 that holds
#: max(I, H) (forward) or H (backward)
TRAIN_MAX_THREADS = {16: 512, 32: 384, 64: 256}
#: the backward's cp.async ring: steps in flight, floats per (row, unit)
_BWD_DEPTH, _BWD_PREF = 3, 5
_TRAIN_FN = None
_BWD_FN = None
_N_SMS = {}


def _train_fn():
    global _TRAIN_FN
    if _TRAIN_FN is None:
        fn = build.load("lstm_cell").lstm_stack_fwd_train
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _TRAIN_FN = fn
    return _TRAIN_FN


def _bwd_fn():
    global _BWD_FN
    if _BWD_FN is None:
        fn = build.load("lstm_cell").lstm_stack_bwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def n_sms(device) -> int:
    """The streaming multiprocessors of a CUDA device (132 on an H100)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _N_SMS:
        _N_SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _N_SMS[index]


def _train_cap(what: str, width: int) -> int:
    """The registers a training thread gives a weight column (``train_cap``):
    the smallest of 16, 32, 64 that holds ``width``."""
    cap = next((c for c in sorted(TRAIN_MAX_THREADS) if width <= c), None)
    if cap is None:
        raise ValueError(
            f"{what}: a thread holds weights for max(I, H) = {width} inputs "
            f"in registers, at most {max(TRAIN_MAX_THREADS)}")
    return cap


def lstm_stack_train_smem_bytes(I: int, H: int, T: int, rows: int,
                                n_layers: int = 3, wave: int = 1) -> int:
    """Shared memory of one training-forward block: the wave's input
    sequence (T, rows) and per layer of the wave a two-step ring of h (2,
    rows), each row split over 4 k-lanes in segments of C / 4 floats
    padded by 4 (C the register capacity for max(I, H)), float32
    (``train_smem_floats`` in ``csrc/lstm_cell.cu``).  The weights live in
    registers."""
    cap = _train_cap("lstm_stack_fwd_train", max(I, H))
    return 4 * (T + 2 * wave) * rows * 4 * (cap // 4 + 4)


def lstm_stack_bwd_smem_bytes(H: int, T: int, rows: int, n_layers: int = 3,
                              wave: int = 1) -> int:
    """Shared memory of one backward block with ``wave`` layers resident:
    per layer and row its dgates (4H over 8 k-lanes in segments of C / 2
    floats padded by 4) and recurrent dh (H); the dx handed down (a
    two-step ring per handing layer when the wave is the whole stack, else
    two (T, rows, H) sequences); and the cp.async ring of the saved gates
    and c (3 steps of 5 floats per (layer, row, unit)), all float32
    (``bwd_smem_floats`` in ``csrc/lstm_cell.cu``)."""
    cap = _train_cap("lstm_stack_bwd", H)
    pairs = wave * rows * H
    dx = (wave - 1) * 2 * rows * H if wave >= n_layers else 2 * T * rows * H
    return 4 * (wave * rows * 8 * (cap // 2 + 4) + pairs + dx
                + _BWD_DEPTH * _BWD_PREF * pairs)


def _train_plan(what: str, B: int, width: int, H: int, n_layers: int,
                n_sms: int, G: int, smem) -> tuple:
    """-> (layers per wave, rows per block, blocks, shared-memory bytes) of
    a training kernel: every layer at once where its 4H threads a layer fit
    the capacity's thread limit and ``smem(rows, wave)`` fits, else one at
    a time; then the fewest rows of ``TRAIN_ROWS`` that bring the G *
    ceil(B / rows) blocks within ``n_sms``, so that they run in one wave
    over the SMs (where none does, the most rows that fit).
    Raises ValueError for H not a multiple of 4, ``width`` over 64 or a
    block that does not fit."""
    if H % 4:
        raise ValueError(f"{what}: hidden size {H} is not a multiple of 4")
    cap = _train_cap(what, width)

    def threads(wave):
        return -(-wave * 4 * H // 32) * 32

    def fits(rows, wave):
        return (threads(wave) <= TRAIN_MAX_THREADS[cap]
                and smem(rows, wave) <= SMEM_LIMIT)

    if not fits(1, 1):
        raise ValueError(f"{what} needs {smem(1, 1)} bytes of shared memory "
                         f"for one layer of one batch row; a block has "
                         f"{SMEM_LIMIT}")
    wave = n_layers if fits(1, n_layers) else 1
    rows = 1
    while (rows < min(B, TRAIN_ROWS[-1]) and G * -(-B // rows) > n_sms
           and fits(2 * rows, wave)):
        rows *= 2
    return wave, rows, G * -(-B // rows), smem(rows, wave)


def lstm_stack_train_plan(B: int, I: int, H: int, T: int, n_layers: int,
                          n_sms: int, G: int = 1):
    """-> (layers per wave, rows per block, blocks, shared-memory bytes) of
    the training forward (``_train_plan``): at RevPred's training batch
    (B = 256, I = 6, H = 32, T = 59, 3 layers) on 132 SMs, 3 layers a
    wave, 2 rows a block, 128 blocks."""
    return _train_plan(f"lstm_stack_fwd_train: I={I} H={H} T={T}", B,
                       max(I, H), H, n_layers, n_sms, G,
                       lambda rows, wave: lstm_stack_train_smem_bytes(
                           I, H, T, rows, n_layers, wave))


def lstm_stack_bwd_plan(B: int, H: int, T: int, n_layers: int, n_sms: int,
                        G: int = 1):
    """-> (layers per wave, rows per block, blocks, shared-memory bytes) of
    the backward kernel (``_train_plan``)."""
    return _train_plan(f"lstm_stack_bwd: H={H} T={T}", B, H, H, n_layers,
                       n_sms, G,
                       lambda rows, wave: lstm_stack_bwd_smem_bytes(
                           H, T, rows, n_layers, wave))


def lstm_stack_fwd_train_cuda(xs, layers):
    """The training forward on float32 CUDA tensors: -> (h (G,B,H), gates
    (L,G,B,T,4H) after the nonlinearities, c (L,G,B,T,H), hs (L,G,B,T,H))."""
    global TRAIN_LAUNCHES
    G, B, T, I, H = _check_stack(xs, layers)
    if xs.dtype != torch.float32:
        raise TypeError(f"lstm_stack training takes float32, got {xs.dtype} "
                        "(the reference trains in float32)")
    n = len(layers)
    dev = xs.device
    wave, rows, _, _ = lstm_stack_train_plan(B, I, H, T, n, n_sms(dev), G)
    ptrs = [(ctypes.c_void_p * n)(*[lp[k].data_ptr() for lp in layers])
            for k in ("w_ih", "w_hh", "b")]
    h_out = torch.empty(G, B, H, dtype=torch.float32, device=dev)
    gates = torch.empty(n, G, B, T, 4 * H, dtype=torch.float32, device=dev)
    c = torch.empty(n, G, B, T, H, dtype=torch.float32, device=dev)
    hs = torch.empty(n, G, B, T, H, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _train_fn()(xs.data_ptr(), *ptrs, n, h_out.data_ptr(),
                      gates.data_ptr(), c.data_ptr(), hs.data_ptr(), G, B, T,
                      I, H, rows, wave, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"lstm_stack_fwd_train launch failed (code {err})")
    TRAIN_LAUNCHES += 1
    return h_out, gates, c, hs


def lstm_stack_bwd_cuda(dh_top, gates, c, layers):
    """The backward's recurrence on float32 CUDA tensors: the upstream
    gradient of the top layer's last h (G,B,H) and the training forward's
    gates and c -> dgates (L,G,B,T,4H), the gradient of every layer's
    pre-activation gates."""
    global BWD_LAUNCHES
    L, G, B, T, H4 = gates.shape
    H = H4 // 4
    if len(layers) != L or tuple(dh_top.shape) != (G, B, H) or \
            tuple(c.shape) != (L, G, B, T, H):
        raise ValueError(f"lstm_stack_bwd: dh {tuple(dh_top.shape)}, gates "
                         f"{tuple(gates.shape)} and c {tuple(c.shape)} do not "
                         f"match {len(layers)} layers")
    for t in (dh_top, gates, c, *_flat(layers)):
        if t.dtype != torch.float32 or t.device != gates.device or \
                not t.is_contiguous():
            raise ValueError("lstm_stack_bwd takes contiguous float32 tensors "
                             f"on one device, got {t.dtype} on {t.device}")
    dev = gates.device
    wave, rows, _, _ = lstm_stack_bwd_plan(B, H, T, L, n_sms(dev), G)
    ptrs = [(ctypes.c_void_p * L)(*[lp[k].data_ptr() for lp in layers])
            for k in ("w_ih", "w_hh")]
    dgates = torch.empty_like(gates)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_fn()(dh_top.data_ptr(), gates.data_ptr(), c.data_ptr(), *ptrs,
                    L, dgates.data_ptr(), G, B, T, H, rows, wave, dev.index,
                    stream)
    if err != 0:
        raise RuntimeError(f"lstm_stack_bwd launch failed (code {err})")
    BWD_LAUNCHES += 1
    return dgates


def stack_weight_grads(xs, hs, dgates, layers, want):
    """The gradients the recurrence leaves to plain products: per layer
    dW_ih = sum_t x_t^T dgates_t (x = xs below, the layer below's h above),
    dW_hh = sum_t h_{t-1}^T dgates_t (h_{-1} = 0) and db = sum dgates, over
    the batch and the steps, one ``torch.bmm`` (or sum) each; and dxs =
    dgates_0 . W_ih0^T.  ``want`` flags (xs, then w_ih, w_hh, b per layer);
    an unwanted gradient is None."""
    L, G, B, T, H4 = dgates.shape
    H = H4 // 4
    out = []
    for n, lp in enumerate(layers):
        dg = dgates[n]                                   # (G, B, T, 4H)
        x = xs if n == 0 else hs[n - 1]                  # (G, B, T, I_l)
        dw_ih = dw_hh = db = None
        if want[1 + 3 * n]:
            dw_ih = torch.bmm(x.reshape(G, B * T, -1).transpose(1, 2),
                              dg.reshape(G, B * T, H4))
        if want[2 + 3 * n]:
            dw_hh = torch.bmm(
                hs[n][:, :, :-1].reshape(G, B * (T - 1), H).transpose(1, 2),
                dg[:, :, 1:].reshape(G, B * (T - 1), H4))
        if want[3 + 3 * n]:
            db = dg.sum(dim=(1, 2))
        out += [dw_ih, dw_hh, db]
    dxs = None
    if want[0]:
        dxs = torch.bmm(dgates[0].reshape(G, B * T, H4),
                        layers[0]["w_ih"].transpose(1, 2)).reshape(xs.shape)
    return [dxs] + out


class LstmStack(torch.autograd.Function):
    """``lstm_stack`` with a gradient, on float32 CUDA tensors: the forward
    is ``lstm_stack_fwd_train``, the backward ``lstm_stack_bwd`` and the
    products of ``stack_weight_grads``.  No fallback to the plain version:
    a build or launch failure raises."""

    @staticmethod
    def forward(ctx, xs, *flat):
        h, gates, c, hs = lstm_stack_fwd_train_cuda(xs, _unflat(flat))
        ctx.save_for_backward(xs, gates, c, hs, *flat)
        return h

    @staticmethod
    def backward(ctx, dh):
        xs, gates, c, hs, *flat = ctx.saved_tensors
        layers = _unflat(flat)
        dgates = lstm_stack_bwd_cuda(dh.contiguous(), gates, c, layers)
        return tuple(stack_weight_grads(xs, hs, dgates, layers,
                                        ctx.needs_input_grad))


def lstm_stack_train(xs, layers):
    """The stack with a gradient (``LstmStack``) -> the top layer's last h.
    bfloat16 inputs raise TypeError: the reference trains in float32."""
    if xs.dtype != torch.float32 or any(t.dtype != torch.float32
                                        for t in _flat(layers)):
        raise TypeError("lstm_stack with a gradient takes float32 (the "
                        f"reference trains in float32), got {xs.dtype}")
    return LstmStack.apply(xs, *_flat(layers))
