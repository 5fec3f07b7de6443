"""Wrapper of the hand-written flash-attention CUDA kernels.

``csrc/flash_attention.cu`` replaces the Pallas kernel
``src/repro/kernels/flash_attention.py:flash_attention_pallas`` (see its
header for the design).  Both routes run on the tensor cores by ``wgmma``:
bfloat16 inputs the TMA-fed bf16 kernel, float32 inputs the 3xTF32 kernel
(each float32 operand split into two TF32 halves, three products summed in
float32, fed by 16-byte loads that split on the way).  It is compiled by
``build.py`` at first use and called through ``ctypes`` on PyTorch's
current stream.  q, k and v are read through their strides; a tensor whose
last dimension is not contiguous is copied first (``.contiguous()``), and
a tensor whose base is not 16-byte aligned or whose batch, sequence or
head stride is not a multiple of 16 bytes (what a TMA tensor map and a
16-byte load take) is copied into a new contiguous tensor.  A copy, not a
change of route.

Training goes through ``FlashAttention``, a ``torch.autograd.Function``
whose forward is the kernel with its log-sum-exp (``flash_attention_lse_cuda``)
on the card and ``ref.flash_attention_fwd_lse`` on the CPU, and whose
backward is the plain ``ref.flash_attention_bwd`` (the JAX package's
backward is XLA code, ``models.attention._flash_bwd_rule``, not a Pallas
kernel).  ``ops.flash_attention`` takes it when a gradient is needed; the
raw wrappers refuse inputs that require one.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._grad import check_no_grad

#: launches of the kernels since the count was last set to 0 (both routes)
LAUNCHES = 0
#: of those, launches of the bfloat16 kernel (bf16 ``wgmma``)
WGMMA_LAUNCHES = 0
#: of those, launches of the float32 kernel (3xTF32 ``wgmma``)
TF32_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels are built for (96: phi3-mini's 3072 / 32)
HEAD_DIMS = (16, 32, 64, 96, 128)
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 17
                       + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} must be a CUDA tensor")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_cuda: {name} is {t.dtype}; q, k and "
                            "v must all be float32 or all bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be (B, S, H, D)")
        if t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, q "
                             f"on {q.device}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if tuple(k.shape) != (B, Sk, H, D) or tuple(v.shape) != (B, Sk, H, D):
        raise ValueError(f"flash_attention_cuda: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Sk, H, D) with q's "
                         f"B, H, D = {B}, {H}, {D}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} is not one of "
                         f"the supported {HEAD_DIMS}")
    if Sk == 0:
        raise ValueError("flash_attention_cuda: no keys (Sk = 0)")
    return B, Sq, Sk, H, D


def tma_strides(t):
    """(batch, sequence, head) element strides of a (B, S, H, D) tensor as
    the kernels read it (a bfloat16 TMA map, float32 16-byte loads), or
    None where they cannot take the tensor as it is (a base not 16-byte
    aligned, a stride of a dimension longer than 1 not a multiple of 16
    bytes).  A dimension of length 1 is never stepped, so its stride is
    replaced by a valid one."""
    if t.data_ptr() % 16:
        return None
    shape, stride, size = t.shape, t.stride(), t.element_size()
    out = []
    for i in range(3):
        st = stride[i]
        if shape[i] == 1:
            st = shape[3]
        elif st <= 0 or (st * size) % 16:
            return None
        out.append(st)
    return out


def _readable(t):
    """(t, its strides as ``tma_strides`` gives them), or a new contiguous
    copy of t and its strides where the kernels cannot read t as it is.  A
    fresh copy is aligned; ``.contiguous()`` would keep a contiguous view at
    an odd offset as it is."""
    st = tma_strides(t)
    if st is None:
        t = t.clone(memory_format=torch.contiguous_format)
        st = tma_strides(t)
    return t, st


def _launch(q, k, v, causal, scale, with_lse: bool):
    """One launch -> (o, lse or None); lse (B,H,Sq) float32 when asked."""
    global LAUNCHES, WGMMA_LAUNCHES, TF32_LAUNCHES
    B, Sq, Sk, H, D = _check(q, k, v)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or Sq == 0 or H == 0:
        return o, lse
    scale = float(scale if scale is not None else D ** -0.5)
    (q, sq), (k, sk), (v, sv) = (_readable(t) for t in (q, k, v))
    strides = [*sq, *sk, *sv, *tma_strides(o)]      # o is new and contiguous
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if with_lse else None,
                B, Sq, Sk, H, D, *strides, scale, int(bool(causal)),
                _DTYPES[q.dtype], q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {err})")
    LAUNCHES += 1
    if q.dtype == torch.bfloat16:
        WGMMA_LAUNCHES += 1
    else:
        TF32_LAUNCHES += 1
    return o, lse


def flash_attention_cuda(q, k, v, causal: bool = True, scale=None):
    """The kernel on CUDA tensors; the arguments of
    ``ref.flash_attention_ref``.  Returns o (B, Sq, H, D) in q's type.  It
    has no gradient: inputs that require one go through ``FlashAttention``
    (``ops.flash_attention`` sends them there)."""
    check_no_grad("flash_attention_cuda", q, k, v, route="ops.flash_attention")
    return _launch(q, k, v, causal, scale, False)[0]


def flash_attention_lse_cuda(q, k, v, causal: bool = True, scale=None):
    """The kernel writing its log-sum-exp too: (o (B,Sq,H,D) in q's type,
    lse (B,H,Sq) float32), what ``ref.flash_attention_fwd_lse`` returns.
    The kernel keeps its row max m2 in log2 units of the scaled score and
    stores (m2 + log2(max(l, 1e-30))) * ln 2."""
    check_no_grad("flash_attention_lse_cuda", q, k, v,
                  route="ops.flash_attention")
    return _launch(q, k, v, causal, scale, True)


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward by device (with
    ``use_kernel`` the kernel and its lse, else
    ``ref.flash_attention_fwd_lse``), saving (q, k, v, o, lse); the
    backward ``ref.flash_attention_bwd`` over key chunks of ``chunk`` (None:
    one chunk).  No fallback: a kernel that cannot run raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, chunk, use_kernel):
        if use_kernel:
            o, lse = flash_attention_lse_cuda(q, k, v, causal, scale)
        else:
            o, lse = ref.flash_attention_fwd_lse(q, k, v, causal, scale, chunk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.chunk = causal, scale, chunk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                             ctx.scale, ctx.chunk)
        return dq, dk, dv, None, None, None, None
