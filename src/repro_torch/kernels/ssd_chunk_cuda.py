"""Wrapper of the hand-written Mamba2 SSD-chunk CUDA kernel.

``csrc/ssd_chunk.cu`` replaces the Pallas kernel
``src/repro/kernels/ssd_scan.py:ssd_chunk_pallas`` (see its header for the
design: 3xTF32 products on the tensor cores by ``wgmma``).  It is
compiled by ``build.py`` at first use and called through ``ctypes`` on
PyTorch's current stream.  x, dt, B and C are read through their strides,
so a chunk's slice of a whole-sequence tensor is passed as it is; a tensor
whose last dimension is not contiguous is copied first.  B and C may have
head stride 0: ``models/ssd.py`` hands one group's (B,S,N) tensor to all of
its heads as an ``expand``ed view, and the kernel reads it as it lies.
The launch is an operator, ``torch.ops.repro_torch.ssd_chunk``, with a
shape function for fake and ``meta`` tensors (the dry run's trace);
``ssd_chunk_cost`` and ``ssd_bound_ms`` count one chunk's work.

Training goes through ``SsdChunk``, a ``torch.autograd.Function`` whose
forward is the kernel on the card and ``ref.ssd_chunk_ref`` on the CPU and
whose backward recomputes the chunk from the saved inputs: on the card
``csrc/ssd_chunk_bwd.cuh`` (built as ``ssd_chunk_bwd.cu`` for N <= 64 and
``ssd_chunk_bwd_n128.cu`` above; ``ssd_chunk_bwd_cuda``, the operator
``torch.ops.repro_torch.ssd_chunk_bwd``: a block per 64-row tile, head and
batch, then a launch per head and batch that sums the tiles' partials from
a scratch of ``ssd_chunk_bwd_scratch_floats``; see its header), on the CPU
``ref.ssd_chunk_bwd``, the plain chunk differentiated by autograd (the JAX
package trains through ``jax.checkpoint`` of its ``_chunk_scan_step``, not
through the Pallas kernel).  ``ops.ssd_chunk`` takes the Function when a
gradient is needed; the raw forward wrapper refuses inputs that require
one.  ``ssd_chunk_bwd_cost`` and ``ssd_bwd_bound_ms`` count the backward.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, hopper, ref
from repro_torch.kernels._grad import check_no_grad, traced

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0
#: calls of the backward kernels (one call: the tile launch and the finishing one)
BWD_LAUNCHES = 0

MAX_P, MAX_N = 64, 128
SMEM_LIMIT = 232448          # bytes of shared memory a block may have (H100)
_FN = None
_BWD_LIBS = {}


def ssd_chunk_smem_bytes(Q: int, N: int) -> int:
    """Shared memory of one kernel block at chunk length Q and state width
    N (``smem_bytes`` in ``csrc/ssd_chunk.cu``): with N padded to 64 or
    128, C_i's tf32 hi and lo tiles and, per ring stage, the B-slot and
    xbar-slot hi and lo tiles, two C buffers and two stages at N <= 64, one
    of each at N = 128; 1 KiB of alignment slack; cum (Q floats, rounded
    up to 4) and the 12 warps' scan sums."""
    nt = 64 if N <= 64 else 128
    tile, xt = 64 * nt * 4, 64 * 64 * 4
    bufs = 2 if nt == 64 else 1
    return (1024 + bufs * 2 * tile + bufs * (2 * tile + 2 * xt)
            + 4 * ((Q + 3) // 4 * 4 + 12))


def ssd_chunk_bwd_smem_bytes(Q: int, N: int) -> int:
    """Shared memory of one backward tile block at chunk length Q and state
    width N, as the kernel's library computes it (``smem_bytes`` in
    ``csrc/ssd_chunk_bwd.cuh``, exported by the library; built on first
    use, so a card's machine only)."""
    return int(_bwd_lib(N).ssd_chunk_bwd_smem_bytes(Q))


def ssd_chunk_bwd_scratch_floats(Q: int, P: int, N: int) -> int:
    """Scratch floats of one (batch, head) that the backward's tile blocks
    write and its finishing launch reads, as the kernel's library computes
    them (``scratch_floats`` in ``csrc/ssd_chunk_bwd.cuh``)."""
    return int(_bwd_lib(N).ssd_chunk_bwd_scratch_floats(Q, P, N))


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("ssd_chunk").ssd_chunk_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 17
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_lib(N: int):
    """The backward's library for state width N: one for N <= 64, one for
    64 < N <= 128 (compiled in parallel), its entry and sizes typed."""
    stem = "ssd_chunk_bwd" if N <= 64 else "ssd_chunk_bwd_n128"
    lib = _BWD_LIBS.get(stem)
    if lib is None:
        lib = build.load(stem)
        lib.ssd_chunk_bwd.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int64] * 21
                                      + [ctypes.c_int, ctypes.c_void_p])
        lib.ssd_chunk_bwd.restype = ctypes.c_int
        lib.ssd_chunk_bwd_smem_bytes.argtypes = [ctypes.c_int64]
        lib.ssd_chunk_bwd_smem_bytes.restype = ctypes.c_int64
        lib.ssd_chunk_bwd_scratch_floats.argtypes = [ctypes.c_int64] * 3
        lib.ssd_chunk_bwd_scratch_floats.restype = ctypes.c_int64
        _BWD_LIBS[stem] = lib
    return lib


_NAMES = ("x", "dt", "A", "B_in", "C_in", "state")


def _check_device(x, dt, A, B_in, C_in, state, *more):
    for name, t in (*zip(_NAMES, (x, dt, A, B_in, C_in, state)), *more):
        if not isinstance(t, torch.Tensor) or not (t.is_cuda or traced(t)):
            raise ValueError(f"ssd_chunk_cuda: {name} must be a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"ssd_chunk_cuda: {name} is on {t.device}, x on "
                             f"{x.device}")


def _check(x, dt, A, B_in, C_in, state):
    """Type and shape checks -> (B, Q, H, P, N).  Strides are not
    checked: the kernel reads x, dt, B and C through theirs, and B_in and
    C_in may have head stride 0 (one group's rows for every head)."""
    named = tuple(zip(_NAMES, (x, dt, A, B_in, C_in, state)))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk_cuda: {name} is {t.dtype}, expected "
                            "float32")
    if x.dim() != 4:
        raise ValueError("ssd_chunk_cuda: x must be (B, Q, H, P)")
    Bb, Q, H, P = x.shape
    N = B_in.shape[-1] if B_in.dim() == 4 else -1
    want = {"dt": (Bb, Q, H), "A": (H,), "B_in": (Bb, Q, H, N),
            "C_in": (Bb, Q, H, N), "state": (Bb, H, P, N)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_chunk_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_chunk_cuda: P={P}, N={N}; the kernel takes "
                         f"P <= {MAX_P} and N <= {MAX_N}")
    if ssd_chunk_smem_bytes(Q, N) > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_cuda: Q={Q} needs "
                         f"{ssd_chunk_smem_bytes(Q, N)} bytes of shared memory, "
                         f"over the {SMEM_LIMIT} a block may have")
    return Bb, Q, H, P, N


def _launch(x, dt, A, B_in, C_in, state):
    global LAUNCHES
    _check_device(x, dt, A, B_in, C_in, state)
    Bb, Q, H, P, N = _check(x, dt, A, B_in, C_in, state)
    x, dt, B_in, C_in = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in (x, dt, B_in, C_in))
    A, state = A.contiguous(), state.contiguous()
    y = torch.empty((Bb, Q, H, P), dtype=torch.float32, device=x.device)
    new_state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    if min(Bb, Q, H, P, N) == 0:
        return y, new_state
    strides = [s for t in (x, dt, B_in, C_in) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                C_in.data_ptr(), state.data_ptr(), y.data_ptr(),
                new_state.data_ptr(), Bb, Q, H, P, N, *strides,
                x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed (code {err})")
    LAUNCHES += 1
    return y, new_state


# The launch as an operator of the ``repro_torch`` namespace: a CUDA tensor
# takes the kernel, a traced one (fake or ``meta``) the shape function
# (see ``flash_attention_cuda``).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_chunk(Tensor x, Tensor dt, Tensor A, Tensor B_in, Tensor C_in, "
            "Tensor state) -> (Tensor, Tensor)")
_LIB.impl("ssd_chunk", _launch, "CUDA")


@torch.library.register_fake("repro_torch::ssd_chunk", lib=_LIB)
def _ssd_chunk_shape(x, dt, A, B_in, C_in, state):
    Bb, Q, H, P, N = _check(x, dt, A, B_in, C_in, state)
    return (torch.empty((Bb, Q, H, P), dtype=torch.float32, device=x.device),
            torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device))


def _check_bwd(x, dt, A, B_in, C_in, state, dy, dstate):
    """The forward's checks, dy (B,Q,H,P) and dstate (B,H,P,N) float32 ->
    (B, Q, H, P, N).  The backward's shared memory is checked at the launch
    (``ssd_chunk_bwd_smem_bytes``, from the kernel's library)."""
    Bb, Q, H, P, N = _check(x, dt, A, B_in, C_in, state)
    for name, t, want in (("dy", dy, (Bb, Q, H, P)), ("dstate", dstate, (Bb, H, P, N))):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"ssd_chunk_bwd_cuda: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {want} float32")
    return Bb, Q, H, P, N


def _launch_bwd(x, dt, A, B_in, C_in, state, dy, dstate):
    """One backward call (a tile launch and a finishing launch, with a
    scratch of ``ssd_chunk_bwd_scratch_floats`` a (batch, head)) -> (dx,
    ddt, dA, dB, dC, dstate_in): dB and dC per head (B,Q,H,N), dA the
    per-(batch, head) partials summed over the batch after the launches."""
    global BWD_LAUNCHES
    _check_device(x, dt, A, B_in, C_in, state, ("dy", dy), ("dstate", dstate))
    Bb, Q, H, P, N = _check_bwd(x, dt, A, B_in, C_in, state, dy, dstate)
    if min(P, N) > 0 and ssd_chunk_bwd_smem_bytes(Q, N) > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_bwd_cuda: Q={Q} needs "
                         f"{ssd_chunk_bwd_smem_bytes(Q, N)} bytes of shared memory, "
                         f"over the {SMEM_LIMIT} a block may have")
    x, dt, B_in, C_in, dy = (t if t.stride(-1) == 1 else t.contiguous()
                             for t in (x, dt, B_in, C_in, dy))
    A, state, dstate = A.contiguous(), state.contiguous(), dstate.contiguous()
    dev = x.device
    empty = min(Bb, Q, H, P, N) == 0          # nothing to launch: zero gradients
    dx, ddt, dB, dC, dst, dA_part = (
        (torch.zeros if empty else torch.empty)(shape, dtype=torch.float32, device=dev)
        for shape in ((Bb, Q, H, P), (Bb, Q, H), (Bb, Q, H, N), (Bb, Q, H, N),
                      (Bb, H, P, N), (Bb, H)))
    if empty:
        return dx, ddt, dA_part.sum(0), dB, dC, dst
    strides = [s for t in (x, dt, B_in, C_in, dy) for s in t.stride()[:3]]
    scratch = torch.empty(Bb * H * ssd_chunk_bwd_scratch_floats(Q, P, N), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_lib(N).ssd_chunk_bwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                    C_in.data_ptr(), state.data_ptr(), dy.data_ptr(), dstate.data_ptr(),
                    dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                    dst.data_ptr(), dA_part.data_ptr(), scratch.data_ptr(), scratch.numel(),
                    Bb, Q, H, P, N, *strides, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel launch failed (code {err})")
    BWD_LAUNCHES += 1
    return dx, ddt, dA_part.sum(0), dB, dC, dst


_LIB.define("ssd_chunk_bwd(Tensor x, Tensor dt, Tensor A, Tensor B_in, Tensor C_in, "
            "Tensor state, Tensor dy, Tensor dstate) -> (Tensor, Tensor, Tensor, Tensor, "
            "Tensor, Tensor)")
_LIB.impl("ssd_chunk_bwd", _launch_bwd, "CUDA")


@torch.library.register_fake("repro_torch::ssd_chunk_bwd", lib=_LIB)
def _ssd_chunk_bwd_shape(x, dt, A, B_in, C_in, state, dy, dstate):
    Bb, Q, H, P, N = _check_bwd(x, dt, A, B_in, C_in, state, dy, dstate)
    return tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                 for shape in ((Bb, Q, H, P), (Bb, Q, H), (H,), (Bb, Q, H, N),
                               (Bb, Q, H, N), (Bb, H, P, N)))


def ssd_chunk_bwd_cuda(x, dt, A, B_in, C_in, state, dy, dstate):
    """The backward kernel on float32 CUDA tensors; the arguments of
    ``ref.ssd_chunk_bwd`` without ``needs`` (the kernel computes every
    gradient) -> (dx, ddt, dA, dB, dC, dstate_in), each of its input's
    shape, contiguous; dB and dC per head even where B_in and C_in have head
    stride 0 (the expand's autograd sums them)."""
    _check_device(x, dt, A, B_in, C_in, state, ("dy", dy), ("dstate", dstate))
    return torch.ops.repro_torch.ssd_chunk_bwd(x, dt, A, B_in, C_in, state, dy, dstate)


def ssd_chunk_cuda(x, dt, A, B_in, C_in, state):
    """The kernel on float32 CUDA tensors; the arguments of
    ``ref.ssd_chunk_ref``.  Returns (y (B,Q,H,P), new_state (B,H,P,N)),
    float32 and contiguous.  Any (batch, row, head) strides are taken,
    head stride 0 for B_in and C_in included.  It has no gradient: inputs
    that require one go through ``SsdChunk`` (``ops.ssd_chunk`` sends them
    there)."""
    check_no_grad("ssd_chunk_cuda", x, dt, A, B_in, C_in, state,
                  route="ops.ssd_chunk")
    _check_device(x, dt, A, B_in, C_in, state)
    return torch.ops.repro_torch.ssd_chunk(x, dt, A, B_in, C_in, state)


def ssd_chunk_cost(B, Q, H, P, N, groups=None):
    """(FLOPs, bytes) of one chunk (float32): x, dt, A and the state read
    once, y and the new state written once, and B and C read once per head
    (``groups=None``) or once per group; the lower-triangle score products
    (once per head, or once per (batch, group)), the output products, the
    state term and the state update."""
    bc_heads = H if groups is None else groups
    n_bytes = 4 * (B * Q * H * (2 * P + 1) + 2 * B * Q * bc_heads * N + H
                   + 2 * B * H * P * N)
    tri = Q * (Q + 1) // 2
    flops = 2.0 * B * (bc_heads * tri * N + H * tri * P + 2 * H * Q * P * N)
    return flops, n_bytes


def ssd_bound_ms(B, Q, H, P, N, groups=None):
    """Least time for one chunk on the card (``hopper.bound_ms`` of
    ``ssd_chunk_cost``).  With ``groups=None`` (B and C read once per head,
    what the FFMA kernel of the first port was given) the operations run
    at the float32 peak outside the tensor cores (that kernel's bound);
    with groups at the 3xTF32 rate, three TF32 products per float32
    product on the tensor cores (495 / 3 TFLOP/s)."""
    flops, n_bytes = ssd_chunk_cost(B, Q, H, P, N, groups)
    peak = hopper.F32_FLOPS if groups is None else hopper.TF32_FLOPS / 3
    return hopper.bound_ms(flops, n_bytes, peak)


def ssd_chunk_bwd_cost(B, Q, H, P, N, groups=None):
    """(FLOPs, bytes) of one backward chunk (float32): the chunk's inputs
    (B and C once per head, ``groups=None``, or once per group) and the
    outputs' gradients read once, the inputs' gradients written once;
    the forward's products (``ssd_chunk_cost``) recomputed and two gradient
    products for each.  The kernel computes the score products per head and
    both orientations of M and L: the bound counts what the function needs."""
    bc = H if groups is None else groups
    ins = B * Q * H * (P + 1) + H + 2 * B * Q * bc * N + B * H * P * N
    outs = B * Q * H * P + B * H * P * N
    return 3 * ssd_chunk_cost(B, Q, H, P, N, groups)[0], 4 * (2 * ins + outs)


def ssd_bwd_bound_ms(B, Q, H, P, N, groups=None):
    """Least time for one backward chunk on the card (``hopper.bound_ms`` of
    ``ssd_chunk_bwd_cost``) at the 3xTF32 rate."""
    flops, n_bytes = ssd_chunk_bwd_cost(B, Q, H, P, N, groups)
    return hopper.bound_ms(flops, n_bytes, hopper.TF32_FLOPS / 3)


class SsdChunk(torch.autograd.Function):
    """One SSD chunk with a gradient: the forward by device (with
    ``use_kernel`` the kernel, else ``ref.ssd_chunk_ref``), saving only its
    inputs (B_in and C_in as the views they are, head stride 0 kept); the
    backward the same way (``ssd_chunk_bwd_cuda``, else
    ``ref.ssd_chunk_bwd``), None for an input that needs no gradient.  No
    fallback: a kernel that cannot run raises."""

    @staticmethod
    def forward(ctx, x, dt, A, B_in, C_in, state, use_kernel):
        fwd = ssd_chunk_cuda if use_kernel else ref.ssd_chunk_ref
        y, new_state = fwd(x, dt, A, B_in, C_in, state)
        ctx.save_for_backward(x, dt, A, B_in, C_in, state)
        ctx.use_kernel = use_kernel
        return y, new_state

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dstate):
        needs = ctx.needs_input_grad[:6]
        if ctx.use_kernel:
            grads = ssd_chunk_bwd_cuda(*ctx.saved_tensors, dy, dstate)
            grads = tuple(g if n else None for g, n in zip(grads, needs))
        else:
            grads = ref.ssd_chunk_bwd(*ctx.saved_tensors, dy, dstate, needs=needs)
        return (*grads, None)
