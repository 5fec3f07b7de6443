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
whose backward, ``ref.ssd_chunk_bwd``, recomputes the plain chunk from the
saved inputs and differentiates it (the JAX package trains through
``jax.checkpoint`` of its ``_chunk_scan_step``, not through the Pallas
kernel).  ``ops.ssd_chunk`` takes it when a gradient is needed; the raw
wrapper refuses inputs that require one.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, hopper, ref
from repro_torch.kernels._grad import check_no_grad, traced

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0

MAX_P, MAX_N = 64, 128
SMEM_LIMIT = 232448          # bytes of shared memory a block may have (H100)
_FN = None


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


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("ssd_chunk").ssd_chunk_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 17
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


_NAMES = ("x", "dt", "A", "B_in", "C_in", "state")


def _check_device(x, dt, A, B_in, C_in, state):
    for name, t in zip(_NAMES, (x, dt, A, B_in, C_in, state)):
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


class SsdChunk(torch.autograd.Function):
    """One SSD chunk with a gradient: the forward by device (with
    ``use_kernel`` the kernel, else ``ref.ssd_chunk_ref``), saving only its
    inputs (B_in and C_in as the views they are, head stride 0 kept); the
    backward ``ref.ssd_chunk_bwd``.  No fallback: a kernel that cannot run
    raises."""

    @staticmethod
    def forward(ctx, x, dt, A, B_in, C_in, state, use_kernel):
        fwd = ssd_chunk_cuda if use_kernel else ref.ssd_chunk_ref
        y, new_state = fwd(x, dt, A, B_in, C_in, state)
        ctx.save_for_backward(x, dt, A, B_in, C_in, state)
        return y, new_state

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = ref.ssd_chunk_bwd(*ctx.saved_tensors, dy, dstate,
                                  needs=ctx.needs_input_grad[:6])
        return (*grads, None)
