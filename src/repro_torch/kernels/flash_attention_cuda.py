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
change of route.  v may be narrower than q and k: the kernels are built
for the (D, Dv) pairs of ``HEAD_DIMS``, the five of one width and (192,
128), MLA's materialized head at deepseek-v2's width; ``kernel_pair`` says
which pair a call runs on (a narrower pair of two widths zero-padded to a
built one, anything else refused).

Each launch is an operator, ``torch.ops.repro_torch.flash_attention`` (and
``flash_attention_lse``): its CUDA implementation is the launch, its shape
function answers for fake and ``meta`` tensors, so the dry run traces
through it with no card.  ``flash_cost`` counts one call's FLOPs and
bytes, and ``flash_bound_ms`` turns them into its least time on the card.

Training goes through ``FlashAttention``, a ``torch.autograd.Function``
whose forward is the kernel with its log-sum-exp (``flash_attention_lse_cuda``)
on the card and ``ref.flash_attention_fwd_lse`` on the CPU, and whose
backward is ``csrc/flash_attention_bwd.cuh`` on the card (built as
``flash_attention_bwd.cu`` for float32 and ``flash_attention_bwd_bf16.cu``
for bfloat16; ``flash_attention_bwd_cuda``, the operator
``torch.ops.repro_torch.flash_attention_bwd``: a dq pass and a dk/dv pass,
bf16 on bf16 ``wgmma`` fed by TMA, float32 on 3xTF32 ``wgmma`` fed by TMA
(raw float32 tiles whose lo halves its producers write); see its header)
and ``ref.flash_attention_bwd`` on the CPU.  The JAX package's backward is
XLA code (``models.attention._flash_bwd_rule``), not a Pallas kernel.
``ops.flash_attention`` takes the Function when a gradient is needed; the
raw forward wrappers refuse inputs that require one.  ``flash_bwd_cost``
and ``flash_bwd_bound_ms`` count the backward's work.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, hopper, ref
from repro_torch.kernels._grad import check_no_grad, traced

#: launches of the kernels since the count was last set to 0 (both routes)
LAUNCHES = 0
#: of those, launches of the bfloat16 kernel (bf16 ``wgmma``)
WGMMA_LAUNCHES = 0
#: of those, launches of the float32 kernel (3xTF32 ``wgmma``)
TF32_LAUNCHES = 0
#: calls of the backward kernels (one call: the dq pass and the dk/dv pass)
BWD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the (D, Dv) pairs the kernels are built for, q and k D wide and v Dv
#: wide: one width for the GQA families (96: phi3-mini's 3072 / 32), and
#: (192, 128), deepseek-v2's materialized MLA head (qk_nope + qk_rope, and
#: v_head_dim)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (96, 96), (128, 128), (192, 128))
_FN = None
#: the backward's libraries, one a type (compiled in parallel)
_BWD_STEMS = {torch.float32: "flash_attention_bwd", torch.bfloat16: "flash_attention_bwd_bf16"}
_BWD_FNS = {}


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 18
                       + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_fn(dtype):
    fn = _BWD_FNS.get(dtype)
    if fn is None:
        fn = build.load(_BWD_STEMS[dtype]).flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 18
                       + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BWD_FNS[dtype] = fn
    return fn


def _check_device(name, q, k, v, *more):
    for arg, t in (("q", q), ("k", k), ("v", v), *more):
        if not isinstance(t, torch.Tensor) or not (t.is_cuda or traced(t)):
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, q on {q.device}")


def kernel_pair(D: int, Dv: int):
    """The built pair (``HEAD_DIMS``) a call with q and k D wide and v Dv
    wide runs on: (D, Dv) itself where it is built.  A pair of two widths
    that is not built (the reduced deepseek-v2's materialized head, (24,
    16)) runs on the narrowest built pair at least as wide in both, q and k
    padded with zero columns to its first width and v to its second, and o,
    dq, dk and dv cut back (exact: a zero column adds nothing to a score,
    and o's and dv's padded columns are not returned).  A pair of one
    width that is not built (no family has such a head dim), or a pair no
    built pair covers (MLA's absorbed (576, 512)), raises: there is no
    route to the plain version by shape."""
    if (D, Dv) in HEAD_DIMS:
        return D, Dv
    wider = [p for p in HEAD_DIMS if p[0] >= D and p[1] >= Dv]
    if D != Dv and wider:
        return min(wider, key=sum)
    raise ValueError(
        f"flash_attention_cuda: head dim {D} is not one of the built {HEAD_DIMS}"
        if D == Dv else
        f"flash_attention_cuda: head dims {D} (q, k) and {Dv} (v): no built pair of "
        f"{HEAD_DIMS} is as wide")


def _check(q, k, v, q_offset: int = 0):
    """Type and shape checks -> (B, Sq, Sk, H, D, Dv): q (B, Sq, H, D), k
    (B, Sk, H, D), v (B, Sk, H, Dv), (D, Dv) a pair ``kernel_pair`` takes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_cuda: {name} is {t.dtype}; q, k and "
                            "v must all be float32 or all bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be (B, S, H, D)")
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    if tuple(k.shape) != (B, Sk, H, D) or tuple(v.shape) != (B, Sk, H, Dv):
        raise ValueError(f"flash_attention_cuda: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Sk, H, D) and (B, Sk, H, Dv) "
                         f"with q's B, H, D = {B}, {H}, {D}")
    kernel_pair(D, Dv)
    if Sk == 0:
        raise ValueError("flash_attention_cuda: no keys (Sk = 0)")
    if not 0 <= q_offset <= 1 << 30:
        raise ValueError(f"flash_attention_cuda: q_offset {q_offset} outside [0, 2^30]")
    return B, Sq, Sk, H, D, Dv


def _pad(t, width):
    """t with zero columns to ``width`` (t itself where it is as wide)."""
    return t if t.shape[-1] == width else torch.nn.functional.pad(
        t, (0, width - t.shape[-1]))


def tma_strides(t):
    """(batch, sequence, head) element strides of a (B, S, H, D) tensor as
    the kernels read it (TMA tensor maps; the float32 forward's 16-byte
    loads), or None where they cannot take the tensor as it is (a base not
    16-byte aligned, a stride of a dimension longer than 1 not a multiple
    of 16 bytes).  A dimension of length 1 is never stepped, so its stride
    is replaced by a valid one."""
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


def _launch(q, k, v, causal, scale, with_lse: bool, q_offset: int = 0):
    """One launch -> (o (B,Sq,H,Dv), lse or None); lse (B,H,Sq) float32
    when asked."""
    global LAUNCHES, WGMMA_LAUNCHES, TF32_LAUNCHES
    _check_device("flash_attention_cuda", q, k, v)
    B, Sq, Sk, H, D, Dv = _check(q, k, v, q_offset)
    Dk_, Dv_ = kernel_pair(D, Dv)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or Sq == 0 or H == 0:
        return torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device), lse
    scale = float(scale if scale is not None else D ** -0.5)
    q, k, v = _pad(q, Dk_), _pad(k, Dk_), _pad(v, Dv_)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, Sq, H, Dv_), dtype=q.dtype, device=q.device)
    (q, sq), (k, sk), (v, sv) = (_readable(t) for t in (q, k, v))
    strides = [*sq, *sk, *sv, *tma_strides(o)]      # o is new and contiguous
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if with_lse else None,
                B, Sq, Sk, H, Dk_, Dv_, *strides, scale, int(bool(causal)), int(q_offset),
                _DTYPES[q.dtype], q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {err})")
    LAUNCHES += 1
    if q.dtype == torch.bfloat16:
        WGMMA_LAUNCHES += 1
    else:
        TF32_LAUNCHES += 1
    return (o if Dv_ == Dv else o[..., :Dv].contiguous()), lse


# The launches as operators of the ``repro_torch`` namespace: a CUDA tensor
# takes the kernel (``_launch``), a traced one (a fake or ``meta`` tensor)
# the shape function, so a program that reaches the kernel can be traced
# with no card (``launch.dryrun``) and a dispatch mode sees each launch as
# one operator (``launch.cost``).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "float? scale, int q_offset=0) -> Tensor")
_LIB.define("flash_attention_lse(Tensor q, Tensor k, Tensor v, bool causal, "
            "float? scale, int q_offset=0) -> (Tensor, Tensor)")
_LIB.impl("flash_attention",
          lambda q, k, v, causal, scale, q_offset=0:
          _launch(q, k, v, causal, scale, False, q_offset)[0], "CUDA")
_LIB.impl("flash_attention_lse",
          lambda q, k, v, causal, scale, q_offset=0:
          _launch(q, k, v, causal, scale, True, q_offset), "CUDA")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _flash_shape(q, k, v, causal, scale, q_offset=0):
    B, Sq, _, H, _, Dv = _check(q, k, v, q_offset)
    return torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)


@torch.library.register_fake("repro_torch::flash_attention_lse", lib=_LIB)
def _flash_lse_shape(q, k, v, causal, scale, q_offset=0):
    B, Sq, _, H, _, Dv = _check(q, k, v, q_offset)
    return (torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device),
            torch.empty((B, H, Sq), dtype=torch.float32, device=q.device))


def flash_attention_cuda(q, k, v, causal: bool = True, scale=None, q_offset: int = 0):
    """The kernel on CUDA tensors; the arguments of
    ``ref.flash_attention_ref``.  Returns o (B, Sq, H, Dv) in q's type.  It
    has no gradient: inputs that require one go through ``FlashAttention``
    (``ops.flash_attention`` sends them there)."""
    check_no_grad("flash_attention_cuda", q, k, v, route="ops.flash_attention")
    _check_device("flash_attention_cuda", q, k, v)
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), _scale(scale),
                                                 int(q_offset))


def flash_attention_lse_cuda(q, k, v, causal: bool = True, scale=None,
                             q_offset: int = 0):
    """The kernel writing its log-sum-exp too: (o (B,Sq,H,Dv) in q's type,
    lse (B,H,Sq) float32), what ``ref.flash_attention_fwd_lse`` returns.
    The kernel keeps its row max m2 in log2 units of the scaled score and
    stores (m2 + log2(max(l, 1e-30))) * ln 2."""
    check_no_grad("flash_attention_lse_cuda", q, k, v,
                  route="ops.flash_attention")
    _check_device("flash_attention_lse_cuda", q, k, v)
    return torch.ops.repro_torch.flash_attention_lse(q, k, v, bool(causal),
                                                     _scale(scale), int(q_offset))


def _check_bwd(q, k, v, lse, dout, q_offset):
    """The forward's checks, and do (B, Sq, H, Dv) of q's type, lse (B, H,
    Sq) float32 -> (B, Sq, Sk, H, D, Dv)."""
    B, Sq, Sk, H, D, Dv = _check(q, k, v, q_offset)
    if tuple(dout.shape) != (B, Sq, H, Dv) or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd_cuda: do is {tuple(dout.shape)} "
                         f"{dout.dtype}, expected {(B, Sq, H, Dv)} {q.dtype}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_cuda: lse is {tuple(lse.shape)} "
                         f"{lse.dtype}, expected {(B, H, Sq)} float32")
    return B, Sq, Sk, H, D, Dv


def _launch_bwd(q, k, v, lse, dout, causal, scale, q_offset: int = 0):
    """One call of the backward kernels -> (dq, dk, dv), new contiguous
    tensors of q's type (q's, k's and v's shapes)."""
    global BWD_LAUNCHES
    _check_device("flash_attention_bwd_cuda", q, k, v, ("lse", lse), ("do", dout))
    B, Sq, Sk, H, D, Dv = _check_bwd(q, k, v, lse, dout, q_offset)
    Dk_, Dv_ = kernel_pair(D, Dv)
    if B == 0 or Sq == 0 or H == 0:
        return tuple(torch.zeros(t.shape, dtype=q.dtype, device=q.device) for t in (q, k, v))
    scale = float(scale if scale is not None else D ** -0.5)
    q, k, v, dout = _pad(q, Dk_), _pad(k, Dk_), _pad(v, Dv_), _pad(dout, Dv_)
    q, k, v, dout = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, dout))
    lse = lse.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    (q, sq), (k, sk), (v, sv), (dout, sd) = (_readable(t) for t in (q, k, v, dout))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B, Sq, Sk, H, Dk_, Dv_, *sq, *sk, *sv, *sd, scale,
                    int(bool(causal)), int(q_offset), _DTYPES[q.dtype], q.device.index,
                    stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed (code {err})")
    BWD_LAUNCHES += 1
    if (Dk_, Dv_) != (D, Dv):
        dq, dk, dv = (g[..., :w].contiguous() for g, w in ((dq, D), (dk, D), (dv, Dv)))
    return dq, dk, dv


_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor lse, Tensor dout, "
            "bool causal, float? scale, int q_offset=0) -> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_attention_bwd", _launch_bwd, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_bwd", lib=_LIB)
def _flash_bwd_shape(q, k, v, lse, dout, causal, scale, q_offset=0):
    _check_bwd(q, k, v, lse, dout, q_offset)
    return tuple(torch.empty(t.shape, dtype=q.dtype, device=q.device) for t in (q, k, v))


def flash_attention_bwd_cuda(q, k, v, lse, do, causal: bool = True, scale=None,
                             q_offset: int = 0):
    """The backward kernels on CUDA tensors; the arguments of
    ``ref.flash_attention_bwd`` without its ``chunk`` (which only the plain
    version's loop reads) -> (dq, dk, dv), contiguous, in q's type.  q, k
    (B, S, H, D), v and do (B, S, H, Dv) share H (GQA callers expand K/V,
    and the expand's autograd sums dk and dv over the group); lse (B, H,
    Sq) float32 as the forward stores it."""
    _check_device("flash_attention_bwd_cuda", q, k, v, ("lse", lse), ("do", do))
    return torch.ops.repro_torch.flash_attention_bwd(q, k, v, lse, do, bool(causal),
                                                     _scale(scale), int(q_offset))


def _scale(scale):
    return None if scale is None else float(scale)


def causal_pairs(Sq: int, Sk: int, q_offset: int = 0) -> int:
    """The (query, key) pairs a causal mask keeps, query i seeing keys
    0..q_offset + i: the sum over i < Sq of min(q_offset + i + 1, Sk)."""
    def tri(n):                      # sum of 1..n
        return n * (n + 1) // 2
    # rows whose diagonal falls inside the keys, then rows that see them all
    inside = max(0, min(Sq, Sk - q_offset))
    return tri(q_offset + inside) - tri(q_offset) + (Sq - inside) * Sk


def flash_cost(B, Sq, Sk, H, D, causal, elem_bytes, q_offset: int = 0, Dv=None):
    """(FLOPs, bytes) of one call, q and k D wide and v Dv wide (None: D):
    the two products' multiply-adds over the (query, key) pairs the mask
    keeps, 2 (D + Dv) FLOPs a pair, and q, k, v read once and o written
    once (the log-sum-exp, B*H*Sq float32, left out)."""
    Dv = D if Dv is None else Dv
    pairs = causal_pairs(Sq, Sk, q_offset) if causal else Sq * Sk
    return (2.0 * B * H * pairs * (D + Dv),
            elem_bytes * B * H * (Sq * (D + Dv) + Sk * (D + Dv)))


def flash_bound_ms(B, Sq, Sk, H, D, causal, elem_bytes, ffma=False, q_offset: int = 0,
                   Dv=None):
    """Least time for one call on the card (``hopper.bound_ms`` of
    ``flash_cost``): bf16 at the tensor cores' bf16 peak, float32 at the
    3xTF32 rate (three TF32 products per float32 product, 495 / 3
    TFLOP/s), or with ``ffma`` at the float32 rate outside the tensor
    cores, the bound of the float32 FFMA kernel the 3xTF32 one replaced."""
    flops, n_bytes = flash_cost(B, Sq, Sk, H, D, causal, elem_bytes, q_offset, Dv)
    peak = (hopper.BF16_FLOPS if elem_bytes == 2 else hopper.F32_FLOPS if ffma
            else hopper.TF32_FLOPS / 3)
    return hopper.bound_ms(flops, n_bytes, peak)


def flash_bwd_cost(B, Sq, Sk, H, D, causal, elem_bytes, q_offset: int = 0, Dv=None):
    """(FLOPs, bytes) of one backward call, q and k D wide and v Dv wide
    (None: D): five products over the (query, key) pairs the mask keeps (S
    = Q.K^T recomputed, dQ = dS.K and dK = dS^T.Q over D; dV = P^T.dO and dP
    = dO.V^T over Dv: 2 (3 D + 2 Dv) FLOPs a pair), and q, k, v, do and lse
    read once, dq, dk and dv written once.  The kernels' own work is more (S
    and dP also in the D pass): the bound counts what the function needs,
    not what the design does."""
    Dv = D if Dv is None else Dv
    pairs = causal_pairs(Sq, Sk, q_offset) if causal else Sq * Sk
    return (2.0 * B * H * pairs * (3 * D + 2 * Dv),
            elem_bytes * B * H * (Sq * (2 * D + Dv) + Sk * (2 * D + 2 * Dv)) + 4 * B * H * Sq)


def flash_bwd_bound_ms(B, Sq, Sk, H, D, causal, elem_bytes, q_offset: int = 0, Dv=None):
    """Least time for one backward call on the card (``hopper.bound_ms`` of
    ``flash_bwd_cost``): bf16 at the tensor cores' bf16 peak, float32 at
    the 3xTF32 rate."""
    flops, n_bytes = flash_bwd_cost(B, Sq, Sk, H, D, causal, elem_bytes, q_offset, Dv)
    peak = hopper.BF16_FLOPS if elem_bytes == 2 else hopper.TF32_FLOPS / 3
    return hopper.bound_ms(flops, n_bytes, peak)


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward by device (with
    ``use_kernel`` the kernel and its lse, else
    ``ref.flash_attention_fwd_lse``), saving (q, k, v, lse); the backward
    the same way (the backward kernels, ``flash_attention_bwd_cuda``, or
    ``ref.flash_attention_bwd`` over key chunks of ``chunk``, None: one
    chunk), the causal mask offset by ``q_offset`` in both.  No fallback: a
    kernel that cannot run raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, chunk, use_kernel, q_offset=0):
        if use_kernel:
            o, lse = flash_attention_lse_cuda(q, k, v, causal, scale, q_offset)
        else:
            o, lse = ref.flash_attention_fwd_lse(q, k, v, causal, scale, chunk, q_offset)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (causal, scale, chunk, q_offset)
        ctx.use_kernel = use_kernel
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        causal, scale, chunk, q_offset = ctx.args
        if ctx.use_kernel:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, lse, do, causal, scale, q_offset)
        else:
            dq, dk, dv = ref.flash_attention_bwd(q, k, v, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None
