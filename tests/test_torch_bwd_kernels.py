"""The backward kernels of flash attention and the SSD chunk
(``csrc/flash_attention_bwd.cuh``, ``csrc/ssd_chunk_bwd.cuh``) on the CPU.

* Routing: on the CPU ``FlashAttention``'s and ``SsdChunk``'s backwards are
  the plain versions, bit for bit; on fake tensors of a ``cuda`` device the
  backward records exactly one ``repro_torch::flash_attention_bwd`` or
  ``ssd_chunk_bwd`` operator and nothing else, with outputs of the
  gradients' shapes, types and strides; on fake CPU tensors with the kernel
  route (the dry run's trace) autograd reaches the same operators.
* Precision: ``_flash_bwd_tf32``, ``_flash_bwd_bf16`` and ``_ssd_bwd_tf32``
  repeat each kernel's arithmetic in plain torch (``_tf32.py``): the tile
  order, the flash kernels' D pass, the float32 route's TF32 splits (three
  terms; both kernels truncate, ``Round::trunc``; its dk/dv pass computes
  P^T once and hands it from one warpgroup to the other, which changes no
  sum: dK and dV still add one q tile's product at a time, in order), the
  bf16 route's exact bf16 products with p and dS split into bf16 hi and lo
  (two terms; one term does measurably worse), the SSD kernel's tile
  partition (a block
  per 64-row tile: its j tile's and i tile's pairs in order, E's column
  sums per warp), its cross-tile sums in
  their fixed order, dcum (the diagonal of E left out of both its sums),
  the reverse scan and the per-(batch, head) dA partials.  They hold the
  tolerances the kernels are held to on the card (1e-4 of each gradient's
  largest magnitude; bf16 flash 1e-2; the SSD chunk at dt |A| ~ 100 1e-2);
  one TF32 product does not hold 1e-4.
* Cost: ``flash_bwd_cost`` and ``ssd_chunk_bwd_cost`` against the
  ``CostCounter`` count of the plain backwards at two shapes each; the
  differences are stated in the tests.

The plain backwards themselves are held to the JAX package by
``tests/test_torch_attention_grad.py``; the kernels to the plain versions
on the card by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import math
import types

import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)
from _tf32 import mm as _mm
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import flash_attention_cuda as kfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk_cuda as kss
from repro_torch.launch.cost import CostCounter

T = 64                       # rows of the kernels' tiles


def mm(eq, a, b, terms):
    """The backward kernels' tf32 products: operands split by truncation."""
    return _mm(eq, a, b, terms, "trunc")


def _rel(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _flash_inputs(seed, B, Sq, Sk, H, D, dtype=torch.float32, q_offset=0, causal=True):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, D)).astype(np.float32)).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, H, D)).astype(np.float32)).to(dtype)
            for _ in range(2))
    _, lse = ref.flash_attention_fwd_lse(q, k, v, causal, None, None, q_offset)
    return q, k, v, lse, do


def _ssd_inputs(seed, B, Q, H, P, N, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, Q, H, P)), rng.uniform(0.001, 0.1, (B, Q, H)) * dt_scale,
            -rng.uniform(0.5, 2.0, (H,)), rng.standard_normal((B, Q, H, N)),
            rng.standard_normal((B, Q, H, N)), rng.standard_normal((B, H, P, N)),
            rng.standard_normal((B, Q, H, P)), rng.standard_normal((B, H, P, N))]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("causal,q_offset,chunk", [(True, 0, None), (False, 0, 16),
                                                   (True, 24, None)])
def test_flash_function_backward_on_the_cpu_is_the_plain_one(causal, q_offset, chunk):
    q, k, v, _, do = _flash_inputs(0, 2, 40, 64, 3, 16, q_offset=q_offset, causal=causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ops.flash_attention(*leaves, causal, chunk=chunk, q_offset=q_offset)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(o, leaves, do)
    _, lse = ref.flash_attention_fwd_lse(q, k, v, causal, None, chunk, q_offset)
    want = ref.flash_attention_bwd(q, k, v, lse, do, causal, None, chunk, q_offset)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("needs", [(True,) * 6, (True, False, True, False, True, False)])
def test_ssd_function_backward_on_the_cpu_is_the_plain_one(needs):
    t = _ssd_inputs(1, 2, 32, 3, 8, 4)
    leaves = [a.clone().requires_grad_(n) for a, n in zip(t[:6], needs)]
    y, st = ops.ssd_chunk(*leaves)
    assert type(y.grad_fn).__name__ == "SsdChunkBackward"
    wrt = [a for a, n in zip(leaves, needs) if n]
    got = torch.autograd.grad((y, st), wrt, (t[6], t[7]))
    want = [g for g in ref.ssd_chunk_bwd(*t, needs=needs) if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _kernel_ops(counter):
    return {op.overloadpacket.__name__: n for op, n in counter.ops.items()
            if op.namespace == "repro_torch"}


def _matmuls(counter):
    names = {"mm", "bmm", "addmm", "baddbmm"}
    return sum(n for op, n in counter.ops.items() if op.overloadpacket.__name__ in names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_on_fake_cuda_tensors_records_one_operator(dtype):
    with FakeTensorMode():
        q = torch.empty(2, 40, 3, 16, dtype=dtype, device="cuda")
        k, v = (torch.empty(2, 70, 3, 16, dtype=dtype, device="cuda") for _ in range(2))
        do = torch.empty_like(q)
        lse = torch.empty(2, 3, 40, device="cuda")
        ctx = types.SimpleNamespace(saved_tensors=(q, k, v, lse), use_kernel=True,
                                    args=(True, None, None, 0))
        with CostCounter() as c:
            grads = kfa.FlashAttention.backward(ctx, do)
    assert _kernel_ops(c) == {"flash_attention_bwd": 1} and _matmuls(c) == 0
    for g, like in zip(grads[:3], (q, k, v)):
        assert (g.shape, g.dtype, g.stride(), g.device.type) == (
            like.shape, dtype, like.stride(), "cuda")
    assert grads[3:] == (None,) * 5


def test_ssd_backward_on_fake_cuda_tensors_records_one_operator():
    B, Q, H, P, N = 2, 32, 4, 16, 8
    with FakeTensorMode():
        x, dy = (torch.empty(B, Q, H, P, device="cuda") for _ in range(2))
        dt, A = torch.empty(B, Q, H, device="cuda"), torch.empty(H, device="cuda")
        Bm = torch.empty(B, Q, 1, N, device="cuda").expand(B, Q, H, N)   # head stride 0
        st, dst = (torch.empty(B, H, P, N, device="cuda") for _ in range(2))
        ctx = types.SimpleNamespace(saved_tensors=(x, dt, A, Bm, Bm, st), use_kernel=True,
                                    needs_input_grad=(True, True, False, True, True, True,
                                                      False))
        with CostCounter() as c:
            grads = kss.SsdChunk.backward(ctx, dy, dst)
    assert _kernel_ops(c) == {"ssd_chunk_bwd": 1} and _matmuls(c) == 0
    want = [(B, Q, H, P), (B, Q, H), None, (B, Q, H, N), (B, Q, H, N), (B, H, P, N)]
    for g, shape in zip(grads, want):
        if shape is None:
            assert g is None
        else:
            assert (tuple(g.shape), g.dtype, g.is_contiguous(), g.device.type) == (
                shape, torch.float32, True, "cuda")
    assert grads[6] is None


def test_the_dry_runs_autograd_reaches_the_backward_operators():
    """Fake CPU tensors with the kernel route, as ``launch.dryrun`` traces:
    a loss through both Functions records one forward and one backward
    operator of each."""
    with FakeTensorMode(), CostCounter() as c:
        q = torch.empty(2, 64, 4, 32, requires_grad=True)
        o = kfa.FlashAttention.apply(q, q, q, True, None, None, True, 0)
        x = torch.empty(2, 32, 4, 16, requires_grad=True)
        y, st = kss.SsdChunk.apply(x, torch.empty(2, 32, 4), torch.empty(4),
                                   torch.empty(2, 32, 4, 8), torch.empty(2, 32, 4, 8),
                                   torch.empty(2, 4, 16, 8), True)
        gq, gx = torch.autograd.grad(o.sum() + y.sum() + st.sum(), (q, x))
    assert _kernel_ops(c) == {"flash_attention_lse": 1, "flash_attention_bwd": 1,
                              "ssd_chunk": 1, "ssd_chunk_bwd": 1}
    assert gq.shape == q.shape and gx.shape == x.shape


def test_the_backward_operators_refuse_what_the_kernels_do_not_take():
    with FakeTensorMode():
        q = torch.empty(1, 8, 2, 24, device="cuda")                    # D = 24
        lse = torch.empty(1, 2, 8, device="cuda")
        with pytest.raises(ValueError, match="head dim"):
            kfa.flash_attention_bwd_cuda(q, q, q, lse, q)
        q = torch.empty(1, 8, 2, 16, device="cuda")
        with pytest.raises(ValueError, match="lse"):
            kfa.flash_attention_bwd_cuda(q, q, q, torch.empty(1, 1, 8, device="cuda"), q)
        x = torch.empty(1, 16, 2, 8, device="cuda")
        Bm = torch.empty(1, 16, 2, 4, device="cuda")
        st = torch.empty(1, 2, 8, 4, device="cuda")
        with pytest.raises(ValueError, match="dstate"):
            kss.ssd_chunk_bwd_cuda(x, torch.empty(1, 16, 2, device="cuda"),
                                   torch.empty(2, device="cuda"), Bm, Bm, st, x,
                                   torch.empty(1, 1, 8, 4, device="cuda"))
    with pytest.raises(ValueError, match="CUDA"):
        q = torch.zeros(1, 8, 2, 16)
        kfa.flash_attention_bwd_cuda(q, q, q, torch.zeros(1, 2, 8), q)


@pytest.mark.parametrize("which", ["flash", "ssd"])
def test_the_plain_backwards_keep_a_nan_of_dy(which):
    """A NaN in dy (a diverged step) reaches the gradients of the plain
    backwards, the CPU's route; tests/test_torch_kernels_cuda.py holds the
    kernels to the same on the card."""
    if which == "flash":
        q, k, v, lse, do = _flash_inputs(3, 1, 80, 80, 2, 16)
        do[0, 37, 1, 5] = float("nan")
        got = ref.flash_attention_bwd(q, k, v, lse, do, True)
        assert torch.isnan(got[0][0, 37, 1]).all()           # the query's dq row
    else:
        t = _ssd_inputs(4, 1, 70, 2, 8, 4)
        t[6][0, 50, 1, 3] = float("nan")                     # dy
        got = ref.ssd_chunk_bwd(*t)
    assert all(torch.isnan(g).any() for g in got)


# ---------------------------------------------- the flash kernels' arithmetic

def _flash_bwd_tf32(q, k, v, lse, do, causal, terms, scale=None, q_offset=0):
    """``ref.flash_attention_bwd`` as the two kernels compute it: S and dP
    as tf32 products (``terms``), p = exp2(scale log2(e) s - lse log2(e))
    masked to 0, the D pass (the row sums of p dp and p over every key),
    dS = p (dP - D) scale; dq accumulated over 64-key tiles (the dq pass),
    dk and dv over 64-row q tiles (the dk/dv pass); outputs rounded to the
    input type."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    sc = scale if scale is not None else D ** -0.5
    l2 = math.log2(math.e)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    s = mm("bqhd,bkhd->bhqk", q32, k32, terms)
    dp = mm("bqhd,bkhd->bhqk", do32, v32, terms)
    p = torch.exp2(s * (sc * l2) - lse[..., None] * l2)
    if causal:
        masked = torch.arange(Sk)[None, :] > torch.arange(Sq)[:, None] + q_offset
        p = torch.where(masked, 0.0, p)
    dr = (p * dp).sum(-1) / p.sum(-1)
    ds = p * (dp - dr[..., None]) * sc
    dq = torch.zeros(B, Sq, H, D)
    for k0 in range(0, Sk, T):
        dq = dq + mm("bhqk,bkhd->bqhd", ds[..., k0:k0 + T], k32[:, k0:k0 + T], terms)
    dk, dv = torch.zeros(B, Sk, H, D), torch.zeros(B, Sk, H, D)
    for i0 in range(0, Sq, T):
        dk = dk + mm("bhqk,bqhd->bkhd", ds[:, :, i0:i0 + T], q32[:, i0:i0 + T], terms)
        dv = dv + mm("bhqk,bqhd->bkhd", p[:, :, i0:i0 + T], do32[:, i0:i0 + T], terms)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


FLASH_CASES = [(1, 192, 192, 2, 64, True, 0),       # zamba2's head dim, causal
               (1, 64, 300, 2, 64, False, 0),       # whisper's cross-attention, Sk != Sq
               (1, 70, 200, 2, 32, True, 100)]      # a sequence block at q_offset


# the float32 route's two chunks of D (NC = 2): its dk/dv pass walks another
# ring there, with the A fragments split a half at a time
FLASH_F32_CASES = FLASH_CASES + [(1, 130, 130, 2, 128, True, 0),   # pixtral's head dim
                                 (1, 100, 150, 2, 96, False, 0)]   # phi3's, Sq != Sk


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal,q_offset", FLASH_F32_CASES)
def test_flash_3xtf32_holds_1e4_and_1xtf32_does_not(B, Sq, Sk, H, D, causal, q_offset):
    q, k, v, lse, do = _flash_inputs(Sq + Sk, B, Sq, Sk, H, D, q_offset=q_offset,
                                     causal=causal)
    want = ref.flash_attention_bwd(q, k, v, lse, do, causal, None, None, q_offset)
    got3 = _flash_bwd_tf32(q, k, v, lse, do, causal, 3, q_offset=q_offset)
    got1 = _flash_bwd_tf32(q, k, v, lse, do, causal, 1, q_offset=q_offset)
    assert max(_rel(g, w) for g, w in zip(got3, want)) <= 1e-4
    assert max(_rel(g, w) for g, w in zip(got1, want)) > 1e-4


def _bf16_parts(t, terms):
    """t (float32) as the bf16 route's A fragments, in float32: hi = bf16(t)
    and lo = bf16(t - hi) (``terms`` 2, lo first as the kernel issues them),
    or hi alone (1)."""
    hi = t.to(torch.bfloat16).float()
    return [hi] if terms == 1 else [(t - hi).to(torch.bfloat16).float(), hi]


def _flash_bwd_bf16(q, k, v, lse, do, causal, terms, scale=None, q_offset=0, out=None):
    """``ref.flash_attention_bwd`` as the bf16 route computes it: S = q.k^T
    and dP = do.v^T of the bf16 inputs in float32 (bf16 wgmma: exact
    products), p = exp2(scale log2(e) s - lse log2(e)) masked to 0, the D
    pass, dS = p (dP - D) scale; dq = dS.k over 64-key tiles, dk = dS^T.q and
    dv = p^T.do over 64-row q tiles, p and dS each the sum of its bf16 parts
    (``_bf16_parts``: ``terms`` 2, hi and lo, or 1), a product a part; the
    outputs rounded to bf16, or to ``out``.  ``terms`` 0: the same function
    in float64 with nothing rounded, the yardstick of the split."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    sc = scale if scale is not None else D ** -0.5
    f = torch.float64 if terms == 0 else torch.float32
    q32, k32, v32, do32 = (t.to(f) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    l2 = math.log2(math.e)
    p = torch.exp2(s * (sc * l2) - lse.to(f)[..., None] * l2)
    if causal:
        masked = torch.arange(Sk)[None, :] > torch.arange(Sq)[:, None] + q_offset
        p = torch.where(masked, 0.0, p)
    dr = (p * dp).sum(-1) / p.sum(-1)
    ds = p * (dp - dr[..., None]) * sc
    parts = (lambda t: [t]) if terms == 0 else (lambda t: _bf16_parts(t, terms))
    dq = torch.zeros(B, Sq, H, D, dtype=f)
    for k0 in range(0, Sk, T):
        for part in parts(ds[..., k0:k0 + T]):
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", part, k32[:, k0:k0 + T])
    dk, dv = torch.zeros(B, Sk, H, D, dtype=f), torch.zeros(B, Sk, H, D, dtype=f)
    for i0 in range(0, Sq, T):
        for part in parts(ds[:, :, i0:i0 + T]):
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", part, q32[:, i0:i0 + T])
        for part in parts(p[:, :, i0:i0 + T]):
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", part, do32[:, i0:i0 + T])
    return tuple(t.to(out or q.dtype) for t in (dq, dk, dv))


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal,q_offset", FLASH_CASES)
def test_flash_bf16_splits_only_the_float32_operand_and_holds_1e2(B, Sq, Sk, H, D, causal,
                                                                   q_offset):
    """bf16 inputs, the bf16 route: q, k, v and do enter bf16 wgmma as they
    are, so S and dP are one exact-product sum; p and dS, float32, are split
    into bf16 hi and lo, two products each; the bf16 outputs hold 1e-2."""
    q, k, v, lse, do = _flash_inputs(Sq + 7, B, Sq, Sk, H, D, torch.bfloat16,
                                     q_offset=q_offset, causal=causal)
    want = ref.flash_attention_bwd(q, k, v, lse, do, causal, None, None, q_offset)
    got = _flash_bwd_bf16(q, k, v, lse, do, causal, 2, q_offset=q_offset)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g, w) <= 1e-2


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal,q_offset", FLASH_CASES)
def test_flash_bf16_one_term_for_p_and_ds_is_worse_than_two(B, Sq, Sk, H, D, causal, q_offset):
    """Before the outputs' bf16 rounding, against the same function in
    float64: p and dS as bf16 hi + lo stay within 2e-5 of each gradient's
    largest; rounded to one bf16 each they miss by more than 20 times that
    (the split is what keeps them float32-class, as the plain version keeps
    them in float32)."""
    q, k, v, lse, do = _flash_inputs(Sq + 11, B, Sq, Sk, H, D, torch.bfloat16,
                                     q_offset=q_offset, causal=causal)
    exact = _flash_bwd_bf16(q, k, v, lse, do, causal, 0, q_offset=q_offset, out=torch.float64)
    two = _flash_bwd_bf16(q, k, v, lse, do, causal, 2, q_offset=q_offset, out=torch.float32)
    one = _flash_bwd_bf16(q, k, v, lse, do, causal, 1, q_offset=q_offset, out=torch.float32)
    err2 = max(_rel(g, w) for g, w in zip(two, exact))
    err1 = max(_rel(g, w) for g, w in zip(one, exact))
    assert err2 <= 2e-5 and err1 > 20 * err2


# ------------------------------------------------- the SSD kernel's arithmetic

def _ssd_bwd_tf32(x, dt, A, B_in, C_in, state, dy, dstate, terms, dcum_by_dots=False):
    """``ref.ssd_chunk_bwd`` as ``ssd_chunk_bwd.cuh`` computes it: G = C.B^T
    and M = dy.xbar^T as tf32 products, L masked before the exp; then one
    block per 64-row tile t: for j tile t, dxbar and dB from their state
    terms, then the pairs i >= j in order, E's column sums per warp of 16
    j rows and its row sums; for i tile t, dC from its state term, then the
    pairs j <= i in order; the tile's part of dstate_in.  The finishing
    launch: dstate_in from exp(cum_L) dstate and the tiles' parts in tile
    order; dcum from E's column partials in tile and warp order (E off the
    diagonal), the row sums, the state parts and the new state's terms; da
    by the reverse scan; the dA partials per (batch, head), summed over the
    batch."""
    Bb, Q, H, P = x.shape
    cum = torch.cumsum(dt * A, 1)
    cL = cum[:, -1]
    i = torch.arange(Q)
    tri = (i[:, None] >= i[None, :])[None, :, :, None]
    seg = cum[:, :, None, :] - cum[:, None, :, :]                     # (B, Qi, Qj, H)
    L = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    xbar = x * dt[..., None]
    w = torch.exp(cL[:, None] - cum)
    G = mm("bihn,bjhn->bijh", C_in, B_in, terms)
    M = mm("bihp,bjhp->bijh", dy, xbar, terms)
    E = torch.where((i[:, None] > i[None, :])[None, :, :, None], L * G * M, 0.0)
    tiles = [slice(t0, min(Q, t0 + T)) for t0 in range(0, Q, T)]
    dxbar, dB, dC = torch.zeros_like(x), torch.zeros_like(B_in), torch.zeros_like(C_in)
    col_e = torch.zeros(len(tiles), 4, Bb, Q, H)       # E's column sums a tile and warp
    parts = []
    for t, tt in enumerate(tiles):
        # phase 1, j tile t
        dxb = w[:, tt, :, None] * mm("bjhn,bhpn->bjhp", B_in[:, tt], dstate, terms)
        dbj = w[:, tt, :, None] * mm("bjhp,bhpn->bjhn", xbar[:, tt], dstate, terms)
        for ti in tiles[t:]:
            dxb = dxb + mm("bijh,bihp->bjhp", (L * G)[:, ti, tt], dy[:, ti], terms)
            dbj = dbj + mm("bijh,bihn->bjhn", (L * M)[:, ti, tt], C_in[:, ti], terms)
            for wp in range(4):
                rows = slice(tt.start + 16 * wp, min(tt.stop, tt.start + 16 * wp + 16))
                col_e[t, wp, :, ti] = E[:, ti, rows].sum(2)
        dxbar[:, tt], dB[:, tt] = dxb, dbj
        # phase 2, i tile t
        dci = torch.exp(cum[:, tt])[..., None] * mm("bihp,bhpn->bihn", dy[:, tt], state, terms)
        for tj in tiles[:t + 1]:
            dci = dci + mm("bijh,bjhn->bihn", (L * M)[:, tt, tj], B_in[:, tj], terms)
        dC[:, tt] = dci
        # phase 3
        parts.append(mm("bihp,bihn->bhpn", dy[:, tt],
                        C_in[:, tt] * torch.exp(cum[:, tt])[..., None], terms))
    dst = torch.exp(cL)[..., None, None] * dstate
    for part in parts:
        dst = dst + part
    dC2 = torch.exp(cum)[..., None] * mm("bihp,bhpn->bihn", dy, state, terms)
    wdot = (xbar * w[..., None] * mm("bjhn,bhpn->bjhp", B_in, dstate, terms)).sum(-1)
    xdx = (dxbar * x).sum(-1)
    if dcum_by_dots:
        dcum = (C_in * dC).sum(-1) - dt * xdx
    else:
        row_e = torch.zeros(Bb, Q, H)
        for t in range(len(tiles)):
            row_e = row_e + ((col_e[t, 0] + col_e[t, 1]) + col_e[t, 2]) + col_e[t, 3]
        dcum = row_e - E.sum(1) + (C_in * dC2).sum(-1) - wdot
    extra = wdot.sum(1) + torch.exp(cL) * (dstate * state).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1]) + extra[:, None]
    dA = (da * dt).sum(1).sum(0)                   # (B, H) partials, then over b
    return dxbar * dt[..., None], da * A + xdx, dA, dB, dC, dst


@pytest.mark.parametrize("B,Q,H,P,N", [(1, 256, 2, 64, 64),    # zamba2's chunk widths
                                       (2, 32, 4, 16, 16),     # the mamba2 trial's
                                       (1, 130, 2, 32, 16),    # N = 16, a ragged tile
                                       (1, 100, 2, 64, 128)])  # N = 128, a ragged tile
def test_ssd_3xtf32_holds_1e4_and_1xtf32_does_not(B, Q, H, P, N):
    t = _ssd_inputs(Q + N, B, Q, H, P, N)
    want = ref.ssd_chunk_bwd(*t)
    got3 = _ssd_bwd_tf32(*t, terms=3)
    got1 = _ssd_bwd_tf32(*t, terms=1)
    assert max(_rel(g, w) for g, w in zip(got3, want)) <= 1e-4
    assert max(_rel(g, w) for g, w in zip(got1, want)) > 1e-4


def test_ssd_large_decay_holds_1e2_with_the_diagonal_left_out():
    """dt |A| up to ~200 (dt x 1000): E's diagonal terms are ~100x the rest
    and cancel between its two sums.  Left out of both, the emulation holds
    1e-2 of the plain backward; the same arithmetic with dcum taken as
    C.dC - xbar.dxbar (equal in exact arithmetic, the diagonal's terms
    inside both dots) does not hold dA."""
    t = _ssd_inputs(5, 2, 64, 3, 16, 8, dt_scale=1000.0)
    want = ref.ssd_chunk_bwd(*t)
    got = _ssd_bwd_tf32(*t, terms=3)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _rel(g, w) <= 1e-2
    by_dots = _ssd_bwd_tf32(*t, terms=3, dcum_by_dots=True)
    assert _rel(by_dots[2], want[2]) > 1e-2


# ---------------------------------------------------------------- the cost

def _plain_flops(fn, *args):
    mode = FakeTensorMode()
    fakes = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
    with mode, CostCounter() as c:
        fn(*fakes)
    return c.cost.flops


@pytest.mark.parametrize("B,Sq,Sk,H,D", [(2, 64, 96, 3, 16), (1, 128, 128, 4, 64)])
def test_flash_bwd_cost_against_the_counter_of_the_plain_backward(B, Sq, Sk, H, D):
    """Not causal, one key chunk: the plain backward's five products are
    ``flash_bwd_cost``'s.  Causal: the plain version computes every pair and
    the cost counts the kept ones.  Over key chunks the plain version's D
    pass computes S and dP once more (seven products); the kernels' D pass
    does too, and the cost leaves it out."""
    q, k, v, lse, do = _flash_inputs(3, B, Sq, Sk, H, D, causal=False)
    plain = _plain_flops(ref.flash_attention_bwd, q, k, v, lse, do, False, None, None)
    assert plain == kfa.flash_bwd_cost(B, Sq, Sk, H, D, False, 4)[0] == 10.0 * B * H * Sq * Sk * D
    causal = _plain_flops(ref.flash_attention_bwd, q, k, v, lse, do, True, None, None)
    cost = kfa.flash_bwd_cost(B, Sq, Sk, H, D, True, 4)[0]
    assert causal == plain and cost == 10.0 * B * H * kfa.causal_pairs(Sq, Sk) * D < plain
    chunked = _plain_flops(ref.flash_attention_bwd, q, k, v, lse, do, False, None, 32)
    assert chunked == 14.0 * B * H * Sq * Sk * D


@pytest.mark.parametrize("B,Q,H,P,N", [(2, 32, 4, 16, 8), (1, 64, 2, 32, 16)])
def test_ssd_bwd_cost_against_the_counter_of_the_plain_backward(B, Q, H, P, N):
    """The plain backward (autograd of the recomputed chunk) counts the
    forward's four products and two gradient products for each over the
    whole Q x Q square per head; ``ssd_chunk_bwd_cost`` with B and C per
    head counts the lower triangle, Q (Q + 1) / 2 pairs, for the two score
    products: the difference is exactly 3 x 2 B H (Q^2 - tri)(N + P)."""
    t = _ssd_inputs(4, B, Q, H, P, N)
    plain = _plain_flops(ref.ssd_chunk_bwd, *t)
    cost = kss.ssd_chunk_bwd_cost(B, Q, H, P, N)[0]
    tri = Q * (Q + 1) // 2
    assert plain == 6.0 * B * H * (Q * Q * (N + P) + 2 * Q * P * N)
    assert plain - cost == 6.0 * B * H * (Q * Q - tri) * (N + P)
    assert kss.ssd_chunk_bwd_cost(B, Q, H, P, N, groups=1)[0] < cost


def test_the_counter_counts_the_backward_operators_at_their_cost():
    B, Sq, H, D = 2, 96, 4, 32
    with FakeTensorMode(), CostCounter() as c:
        q = torch.empty(B, Sq, H, D, dtype=torch.bfloat16, device="cuda")
        kfa.flash_attention_bwd_cuda(q, q, q, torch.empty(B, H, Sq, device="cuda"), q,
                                     True, None, 5)
    assert c.cost.flops == kfa.flash_bwd_cost(B, Sq, Sq, H, D, True, 2, 5)[0]
    with FakeTensorMode(), CostCounter() as c:
        x = torch.empty(2, 32, 4, 16, device="cuda")
        Bm = torch.empty(2, 32, 1, 8, device="cuda").expand(2, 32, 4, 8)
        st = torch.empty(2, 4, 16, 8, device="cuda")
        kss.ssd_chunk_bwd_cuda(x, torch.empty(2, 32, 4, device="cuda"),
                               torch.empty(4, device="cuda"), Bm, Bm, st, x, st)
    assert c.cost.flops == kss.ssd_chunk_bwd_cost(2, 32, 4, 16, 8, groups=1)[0]
