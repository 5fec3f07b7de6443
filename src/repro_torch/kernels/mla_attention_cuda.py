"""Wrapper of the hand-written kernels of MLA's absorbed attention.

``csrc/mla_attention.cu`` replaces no Pallas kernel: the JAX package
computes this attention with XLA code (``attention.attention`` as
``src/repro/models/mla.py:130`` calls it), and the flash kernels cannot
take it (one key head Dk wide and one value head Dv wide shared by all H
query heads, Dk != Dv, up to 576 and 512).  Two routes, by the input type
(the source's header has the design):

* bfloat16: ``wgmma`` fed by TMA (``csrc/mla_attention_wgmma.cuh``).  The
  forward is a block per 64-row tile of the (B, Sq * H, Dk) rows that reads
  its Q tile once and streams 32-key stages of K and V through a two-stage
  ring (one consumer warpgroup per 256 output columns); the backward is a
  rows launch (Q and dO kept, K and V streamed twice: the port's D, then P
  and dS to a scratch and dQ), a keys launch (dK and dV over chunks of row
  tiles into float32 partials) and a finishing launch.
* float32: tf32 ``wgmma`` fed by TMA at float32 accuracy (3xTF32,
  ``csrc/mla_attention_tf32.cuh``).  Every operand a product reads from
  shared memory is a 64 x 64 unit (hi and lo): K and V rows split in place
  by the warpgroup that reads them, V^T and K^T built once a call into a
  scratch (``units``, allocated here) and copied whole, Q and dO read raw
  into registers.  The forward is a block per row tile whose two
  warpgroups each compute half of S's chunks, exchange their partials and
  accumulate 256 columns of O each; the backward's rows launch computes S
  and dP once (P and dP to a key-major scratch, then dS over dP, then dQ
  = dS.K a chunk at a time), its keys launch reads dS^T and P^T from that
  scratch into registers, and the same finishing launch sums the
  partials.

It is compiled by ``build.py`` at first use and called through ``ctypes``
on PyTorch's current stream.

    q (B, Sq, H, Dk), k (B, Sk, Dk), v (B, Sk, Dv)
      -> o (B, Sq, H, Dv) in q's type, lse (B, H, Sq) float32

with Dk <= 576 and Dv <= 512, multiples of 8, any H >= 1 and any lengths;
a shape outside that raises, with the shape in the message.  Every shape
the contract takes runs the kernels (a narrower head loads fewer 64-column
boxes); ``mla_smem_bytes`` and ``mla_bwd_smem_bytes`` mirror their shared
memory.  The tensors are read contiguous from 16-byte aligned bases (TMA
tensor maps in both types: a view, or a tensor at an odd offset, is copied
first: a copy, not a change of route).  The plain
version is the flash functions of ``ref`` in their grouped layout at one
K/V head (KV = 1, G = H): ``mla_fwd_lse_ref`` and ``mla_bwd_ref`` below
call ``ref.flash_attention_fwd_lse`` and ``ref.flash_attention_bwd`` so.

Each launch is an operator of the ``repro_torch`` namespace
(``mla_attention``, ``mla_attention_lse``, ``mla_attention_bwd``) with a
shape function for fake and ``meta`` tensors, so the dry run traces and
counts it.  Training goes through ``MlaAttention``, a
``torch.autograd.Function`` whose forward and backward are the kernels on
the card and the plain versions on the CPU; ``ops.mla_attention`` routes
by device.  ``mla_cost`` / ``mla_bwd_cost`` count a call's work and
``mla_bound_ms`` / ``mla_bwd_bound_ms`` its least time on the card.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, hopper, ref
from repro_torch.kernels._grad import check_no_grad
from repro_torch.kernels.flash_attention_cuda import _check_device, _scale, causal_pairs

#: forward launches since the count was last set to 0 (both types)
LAUNCHES = 0
#: backward calls (one call: the rows, keys and finishing launches)
BWD_LAUNCHES = 0

#: the widest shared key and value heads the kernels take (deepseek-v2's
#: kv_lora_rank + qk_rope_head_dim and kv_lora_rank)
MAX_DK, MAX_DV = 576, 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("mla_attention")
        lib.mla_attention_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7
                                          + [ctypes.c_float] + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
        lib.mla_attention_fwd.restype = ctypes.c_int
        lib.mla_attention_bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int64] * 9
                                          + [ctypes.c_float] + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
        lib.mla_attention_bwd.restype = ctypes.c_int
        lib.mla_attention_bwd_sizes.argtypes = [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        lib.mla_attention_bwd_sizes.restype = None
        lib.mla_attention_smem_bytes.argtypes = [ctypes.c_int64] + [ctypes.c_int] * 2
        lib.mla_attention_smem_bytes.restype = ctypes.c_int64
        lib.mla_attention_units_floats.argtypes = [ctypes.c_int64] * 3
        lib.mla_attention_units_floats.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


#: a TMA box: 64 rows (32 for the key and value stages) x 128 bytes; a
#: float32 unit: 64 x 64, hi and lo
_BOX, _KBOX, _UNIT = 64 * 128, 32 * 128, 2 * 64 * 64 * 4


def _boxes(d):
    return -(-d // 64)


def mla_smem_bytes(Dk, Dv, dtype):
    """Dynamic shared memory of the forward launch, as the kernel plans it.
    bf16: the Q tile (9 boxes of 64 rows: the products run over the widest
    Dk, the boxes a narrower head leaves unloaded hold zeros) and two 32-key
    stages of K (9 boxes) and of V (4 boxes a consumer warpgroup, one per
    256 columns of Dv), or the O tile it stages its output in if larger, + 1
    KiB of alignment.  float32: a ring of six 64 x 64 units (hi and lo, 32
    KiB each) and the two warpgroups' S partials (16 KiB each), + 1 KiB, at
    every width."""
    if dtype == torch.bfloat16:
        nwg = 2 if _boxes(Dv) > 4 else 1
        main = 9 * _BOX + 2 * (9 + 4 * nwg) * _KBOX
        return 1024 + max(main, 4 * nwg * _BOX)
    return 1024 + 6 * _UNIT + 2 * 64 * 64 * 4


def mla_bwd_smem_bytes(Dk, Dv, dtype):
    """Shared memory of the backward's largest launch, as the kernels plan
    it.  bf16, the rows launch: Q and dO tiles (9 and 8 boxes), a 32-key
    stage of K and of V, P (float32) and dS (bf16) of a stage, + 1 KiB; the
    keys launch: four stages of two 64 x 64 dS tiles and a 4-box slab, + 1
    KiB.  float32, at every width: the rows launch's ring of six units and
    P's 16 KiB hand-over; the keys launch's ring of seven units, + 1 KiB."""
    if dtype == torch.bfloat16:
        rows = 1024 + (9 + 8) * (_BOX + _KBOX) + 64 * 32 * (4 + 2)
        keys = 1024 + 4 * (2 + 4) * _BOX
        return max(rows, keys)
    return 1024 + max(6 * _UNIT + 64 * 64 * 4, 7 * _UNIT)


def _check(q, k, v):
    """Type and shape checks -> (B, Sq, Sk, H, Dk, Dv)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"mla_attention_cuda: {name} is {t.dtype}; q, k and v "
                            "must all be float32 or all bfloat16")
    shapes = f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"mla_attention_cuda: {shapes}; want q (B, Sq, H, Dk), "
                         "k (B, Sk, Dk), v (B, Sk, Dv)")
    B, Sq, H, Dk = q.shape
    Sk, Dv = k.shape[1], v.shape[2]
    if tuple(k.shape) != (B, Sk, Dk) or tuple(v.shape[:2]) != (B, Sk):
        raise ValueError(f"mla_attention_cuda: {shapes}; k must be (B, Sk, Dk) and "
                         "v (B, Sk, Dv) with q's B and Dk")
    if not (0 < Dk <= MAX_DK and 0 < Dv <= MAX_DV and Dk % 8 == 0 and Dv % 8 == 0):
        raise ValueError(f"mla_attention_cuda: {shapes}; the kernels take Dk <= "
                         f"{MAX_DK} and Dv <= {MAX_DV}, multiples of 8")
    if Sk == 0:
        raise ValueError(f"mla_attention_cuda: {shapes}; no keys (Sk = 0)")
    if Sq * H > 1 << 30 or Sk > 1 << 30 or B > 65535:
        raise ValueError(f"mla_attention_cuda: {shapes}; more than 2^30 query rows "
                         "(Sq x H) or keys, or a batch over 65535")
    return B, Sq, Sk, H, Dk, Dv


def _readable(t):
    """t contiguous with a 16-byte aligned base (the kernels' TMA tensor
    maps): t itself, or a new copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _units(lib, q, B, Sk, D):
    """The float32 route's scratch of transposed units (V's for the
    forward, D = Dv; K's for the backward, D = Dk); none for bf16."""
    n = lib.mla_attention_units_floats(B, Sk, D) if q.dtype == torch.float32 else 0
    return torch.empty(n, dtype=torch.float32, device=q.device)


def _scale_of(scale, Dk):
    return float(scale if scale is not None else Dk ** -0.5)


def _launch(q, k, v, causal, scale, with_lse: bool):
    """One forward launch -> (o, lse or None)."""
    global LAUNCHES
    _check_device("mla_attention_cuda", q, k, v)
    B, Sq, Sk, H, Dk, Dv = _check(q, k, v)
    q, k, v = (_readable(t) for t in (q, k, v))
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or Sq == 0 or H == 0:
        return o, lse
    lib = _lib()
    units = _units(lib, q, B, Sk, Dv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mla_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                lse.data_ptr() if with_lse else None, units.data_ptr(),
                                units.numel(), B, Sq, Sk, H, Dk, Dv, _scale_of(scale, Dk),
                                int(bool(causal)), _DTYPES[q.dtype], q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"mla_attention kernel launch failed (code {err}) at "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    LAUNCHES += 1
    return o, lse


def _check_bwd(q, k, v, lse, dout):
    B, Sq, Sk, H, Dk, Dv = _check(q, k, v)
    if tuple(dout.shape) != (B, Sq, H, Dv) or dout.dtype != q.dtype:
        raise ValueError(f"mla_attention_bwd_cuda: do is {tuple(dout.shape)} "
                         f"{dout.dtype}, want {(B, Sq, H, Dv)} {q.dtype}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"mla_attention_bwd_cuda: lse is {tuple(lse.shape)} "
                         f"{lse.dtype}, want {(B, H, Sq)} float32")
    return B, Sq, Sk, H, Dk, Dv


def _launch_bwd(q, k, v, lse, dout, causal, scale):
    """One backward call (three launches) -> (dq, dk, dv) of q's type."""
    global BWD_LAUNCHES
    _check_device("mla_attention_bwd_cuda", q, k, v, ("lse", lse), ("do", dout))
    B, Sq, Sk, H, Dk, Dv = _check_bwd(q, k, v, lse, dout)
    q, k, v, dout = (_readable(t) for t in (q, k, v, dout))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=q.dtype, device=q.device) for t in (q, k, v))
    if B == 0 or Sq == 0 or H == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = _lib()
    sizes = (ctypes.c_int64 * 2)()
    lib.mla_attention_bwd_sizes(B, Sq, Sk, H, Dk, Dv, sizes)
    p_scr = torch.empty(sizes[0], dtype=q.dtype, device=q.device)
    ds_scr = torch.empty(sizes[0], dtype=q.dtype, device=q.device)
    part = torch.empty(sizes[1], dtype=torch.float32, device=q.device)
    units = _units(lib, q, B, Sk, Dk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mla_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                                dout.data_ptr(), p_scr.data_ptr(), ds_scr.data_ptr(),
                                part.data_ptr(), units.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), sizes[0], sizes[1], units.numel(), B, Sq, Sk, H,
                                Dk, Dv, _scale_of(scale, Dk), int(bool(causal)),
                                _DTYPES[q.dtype], q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"mla_attention_bwd kernel launch failed (code {err}) at "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    BWD_LAUNCHES += 1
    return dq, dk, dv


# The launches as operators of the ``repro_torch`` namespace (the library
# fragment ``flash_attention_cuda`` opened): a CUDA tensor takes the kernel,
# a traced one the shape function.
_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("mla_attention(Tensor q, Tensor k, Tensor v, bool causal, float? scale) "
            "-> Tensor")
_OPS.define("mla_attention_lse(Tensor q, Tensor k, Tensor v, bool causal, float? scale) "
            "-> (Tensor, Tensor)")
_OPS.define("mla_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor lse, Tensor dout, "
            "bool causal, float? scale) -> (Tensor, Tensor, Tensor)")
_OPS.impl("mla_attention",
          lambda q, k, v, causal, scale: _launch(q, k, v, causal, scale, False)[0], "CUDA")
_OPS.impl("mla_attention_lse",
          lambda q, k, v, causal, scale: _launch(q, k, v, causal, scale, True), "CUDA")
_OPS.impl("mla_attention_bwd", _launch_bwd, "CUDA")


def _out_shape(q, v):
    return (q.shape[0], q.shape[1], q.shape[2], v.shape[2])


@torch.library.register_fake("repro_torch::mla_attention", lib=_OPS)
def _mla_shape(q, k, v, causal, scale):
    _check(q, k, v)
    return q.new_empty(_out_shape(q, v))


@torch.library.register_fake("repro_torch::mla_attention_lse", lib=_OPS)
def _mla_lse_shape(q, k, v, causal, scale):
    B, Sq, _, H, _, _ = _check(q, k, v)
    return (q.new_empty(_out_shape(q, v)),
            q.new_empty((B, H, Sq), dtype=torch.float32))


@torch.library.register_fake("repro_torch::mla_attention_bwd", lib=_OPS)
def _mla_bwd_shape(q, k, v, lse, dout, causal, scale):
    _check_bwd(q, k, v, lse, dout)
    return tuple(t.new_empty(t.shape, dtype=q.dtype) for t in (q, k, v))


def mla_attention_cuda(q, k, v, causal: bool = True, scale=None):
    """The forward kernel on CUDA tensors -> o (B, Sq, H, Dv) in q's type.
    It has no gradient: inputs that require one go through ``MlaAttention``
    (``ops.mla_attention`` sends them there)."""
    check_no_grad("mla_attention_cuda", q, k, v, route="ops.mla_attention")
    _check_device("mla_attention_cuda", q, k, v)
    return torch.ops.repro_torch.mla_attention(q, k, v, bool(causal), _scale(scale))


def mla_attention_lse_cuda(q, k, v, causal: bool = True, scale=None):
    """The forward kernel writing its log-sum-exp too: (o (B,Sq,H,Dv),
    lse (B,H,Sq) float32), what ``mla_fwd_lse_ref`` returns."""
    check_no_grad("mla_attention_lse_cuda", q, k, v, route="ops.mla_attention")
    _check_device("mla_attention_lse_cuda", q, k, v)
    return torch.ops.repro_torch.mla_attention_lse(q, k, v, bool(causal), _scale(scale))


def mla_attention_bwd_cuda(q, k, v, lse, do, causal: bool = True, scale=None):
    """The backward kernels on CUDA tensors -> (dq, dk, dv) in q's type,
    from lse (B, H, Sq) as the forward stores it and do (B, Sq, H, Dv)."""
    _check_device("mla_attention_bwd_cuda", q, k, v, ("lse", lse), ("do", do))
    return torch.ops.repro_torch.mla_attention_bwd(q, k, v, lse, do, bool(causal),
                                                   _scale(scale))


def mla_fwd_lse_ref(q, k, v, causal: bool = True, scale=None, chunk=None):
    """The plain forward: ``ref.flash_attention_fwd_lse`` in the grouped
    layout at one K/V head (KV = 1, G = H), over key chunks of ``chunk``
    -> (o (B,Sq,H,Dv) in q's type, lse (B,H,Sq) float32)."""
    o, lse = ref.flash_attention_fwd_lse(q[:, :, None], k[:, :, None], v[:, :, None],
                                         causal, scale, chunk)
    return o[:, :, 0], lse[:, 0]


def mla_bwd_ref(q, k, v, lse, do, causal: bool = True, scale=None, chunk=None):
    """The plain backward: ``ref.flash_attention_bwd`` in the grouped
    layout at KV = 1, G = H -> (dq, dk, dv), each in its input's type."""
    dq, dk, dv = ref.flash_attention_bwd(q[:, :, None], k[:, :, None], v[:, :, None],
                                         lse[:, None], do[:, :, None], causal, scale, chunk)
    return dq[:, :, 0], dk[:, :, 0], dv[:, :, 0]


def mla_cost(B, Sq, Sk, H, Dk, Dv, causal, elem_bytes):
    """(FLOPs, bytes) of one forward call: the two products' multiply-adds
    over the (query, key) pairs the mask keeps, and q, the shared k and v
    read once and o written once (the log-sum-exp left out)."""
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    return (2.0 * B * H * pairs * (Dk + Dv),
            elem_bytes * B * (Sq * H * Dk + Sk * Dk + Sk * Dv + Sq * H * Dv))


def mla_bwd_cost(B, Sq, Sk, H, Dk, Dv, causal, elem_bytes):
    """(FLOPs, bytes) of one backward call: five products over the kept
    pairs (S = Q.K^T and dQ = dS.K, dK = dS^T.Q over Dk; dP = dO.V^T and
    dV = P^T.dO over Dv), and q, k, v, do and lse read once, dq, dk and dv
    written once.  The kernels' own work is more (S and dP twice in the
    rows launch, the scratch of P and dS): the bound counts what the
    function needs."""
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    return (2.0 * B * H * pairs * (3 * Dk + 2 * Dv),
            elem_bytes * B * (2 * Sq * H * Dk + 2 * Sk * Dk + 2 * Sk * Dv + Sq * H * Dv)
            + 4 * B * H * Sq)


def _bound(flops, n_bytes, elem_bytes):
    peak = hopper.BF16_FLOPS if elem_bytes == 2 else hopper.TF32_FLOPS / 3
    return hopper.bound_ms(flops, n_bytes, peak)


def mla_bound_ms(B, Sq, Sk, H, Dk, Dv, causal, elem_bytes):
    """Least time for one forward call on the card (``hopper.bound_ms``):
    bf16 at the tensor cores' bf16 peak, float32 at the 3xTF32 rate."""
    return _bound(*mla_cost(B, Sq, Sk, H, Dk, Dv, causal, elem_bytes), elem_bytes)


def mla_bwd_bound_ms(B, Sq, Sk, H, Dk, Dv, causal, elem_bytes):
    """Least time for one backward call on the card, as ``mla_bound_ms``."""
    return _bound(*mla_bwd_cost(B, Sq, Sk, H, Dk, Dv, causal, elem_bytes), elem_bytes)


class MlaAttention(torch.autograd.Function):
    """MLA's absorbed attention with a gradient: q (B,Sq,H,Dk), k (B,Sk,Dk),
    v (B,Sk,Dv) -> (B,Sq,H,Dv).  With ``use_kernel`` the forward kernel and
    its lse, and the backward kernels; else ``mla_fwd_lse_ref`` and
    ``mla_bwd_ref`` over key chunks of ``chunk`` (None: one chunk).  No
    fallback: a kernel that cannot run raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, chunk, use_kernel):
        if use_kernel:
            o, lse = mla_attention_lse_cuda(q, k, v, causal, scale)
        else:
            o, lse = mla_fwd_lse_ref(q, k, v, causal, scale, chunk)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (causal, scale, chunk)
        ctx.use_kernel = use_kernel
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        causal, scale, chunk = ctx.args
        if ctx.use_kernel:
            dq, dk, dv = mla_attention_bwd_cuda(q, k, v, lse, do, causal, scale)
        else:
            dq, dk, dv = mla_bwd_ref(q, k, v, lse, do, causal, scale, chunk)
        return dq, dk, dv, None, None, None, None
