"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card, since a CUDA kernel has
no CPU mode.  The file imports only ``torch`` and ``repro_torch``, so it
runs where JAX is not installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import revpred as rp
from repro_torch.kernels import lstm_cell as klc
from repro_torch.kernels import flash_attention_cuda as kfa
from repro_torch.kernels import ops, ref, soa_step
from repro_torch.kernels import soa_step_cuda as ksc
from repro_torch.kernels import ssd_chunk_cuda as kss

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(gen, G, B, I, H, dtype, device):
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device, dtype)
    return (rnd(G, B, I), rnd(G, B, H), rnd(G, B, H),
            rnd(G, I, 4 * H, scale=0.3), rnd(G, H, 4 * H, scale=0.3),
            rnd(G, 4 * H, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,B,I,H", [(1, 1, 6, 32), (6, 1, 32, 32),
                                     (6, 1, 7, 32), (3, 256, 64, 128)])
def test_lstm_cell_kernel_matches_ref(G, B, I, H, dtype, card):
    args = _inputs(torch.Generator().manual_seed(0), G, B, I, H, dtype, card)
    before = klc.LAUNCHES
    h, c = ops.lstm_cell(*args)
    assert klc.LAUNCHES == before + 1
    h2, c2 = ref.lstm_cell_ref(*args)
    torch.cuda.synchronize()
    assert h.dtype == dtype and h.shape == (G, B, H)
    tol = TOL[dtype]
    torch.testing.assert_close(h.float(), h2.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(c.float(), c2.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_lstm_cell_kernel_rejects_what_it_does_not_take(card):
    args = list(_inputs(torch.Generator().manual_seed(0), 2, 1, 6, 32,
                        torch.float32, card))
    bad_shape = args.copy()
    bad_shape[3] = bad_shape[3][:, :, :64]
    with pytest.raises(ValueError, match="shape"):
        klc.lstm_cell_cuda(*bad_shape)
    strided = args.copy()
    strided[4] = strided[4].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        klc.lstm_cell_cuda(*strided)
    with pytest.raises(TypeError):
        klc.lstm_cell_cuda(*[a.double() for a in args])


@pytest.mark.cuda
def test_revpred_forward_through_kernel_matches_plain(card):
    gen = torch.Generator().manual_seed(0)
    G = 6
    params = rp.tree_map(lambda *xs: torch.stack(xs),
                         *[rp.init_revpred(gen, 32, device=card) for _ in range(G)])
    hist = torch.rand(G, 1, rp.HISTORY, rp.N_FEAT, generator=gen).to(card)
    present = torch.rand(G, 1, rp.N_FEAT + 1, generator=gen).to(card)
    before = klc.STACK_LAUNCHES, klc.LAUNCHES
    with torch.inference_mode():
        lg = rp.revpred_logits(params, hist, present)
        lg_ref = rp.revpred_logits(params, hist, present, force="ref")
    # the whole LSTM stack is one launch; no per-step cell launch remains
    assert (klc.STACK_LAUNCHES, klc.LAUNCHES) == (before[0] + 1, before[1])
    torch.testing.assert_close(lg, lg_ref, rtol=1e-4, atol=1e-4)


def _stack_inputs(gen, G, B, T, I, H, dtype, device, n_layers=3):
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device, dtype)
    layers = [{"w_ih": rnd(G, I if n == 0 else H, 4 * H, scale=0.3),
               "w_hh": rnd(G, H, 4 * H, scale=0.3), "b": rnd(G, 4 * H, scale=0.1)}
              for n in range(n_layers)]
    return rnd(G, B, T, I), layers


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("I,T,H,G,B", [(6, 59, 32, 6, 1), (7, 60, 16, 1, 4),
                                       (6, 59, 32, 40, 1), (7, 60, 32, 3, 4),
                                       (6, 59, 64, 2, 3)])
def test_lstm_stack_kernel_matches_ref(I, T, H, G, B, dtype, card):
    xs, layers = _stack_inputs(torch.Generator().manual_seed(0), G, B, T, I, H,
                               dtype, card)
    before = klc.STACK_LAUNCHES
    h = ops.lstm_stack(xs, layers)
    assert klc.STACK_LAUNCHES == before + 1
    want = ref.lstm_stack_ref(xs, layers)
    torch.cuda.synchronize()
    assert h.dtype == dtype and h.shape == (G, B, H)
    tol = TOL[dtype]
    torch.testing.assert_close(h.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_lstm_stack_kernel_rejects_what_it_does_not_take(card):
    gen = torch.Generator().manual_seed(0)
    xs, layers = _stack_inputs(gen, 2, 1, 10, 6, 16, torch.float32, card)
    bad = [dict(lp) for lp in layers]
    bad[1]["w_ih"] = bad[1]["w_ih"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        klc.lstm_stack_cuda(xs, bad)
    with pytest.raises(ValueError, match="contiguous"):
        klc.lstm_stack_cuda(torch.cat([xs, xs], dim=-1)[..., :6], layers)
    with pytest.raises(TypeError):
        klc.lstm_stack_cuda(xs.double(), [{k: v.double() for k, v in lp.items()}
                                          for lp in layers])
    big_x, big = _stack_inputs(gen, 1, 1, 4, 6, 128, torch.float32, card)
    with pytest.raises(ValueError, match="shared memory"):
        klc.lstm_stack_cuda(big_x, big)


def _soa_inputs(F, L, N, R, alpha, seed=8):
    """Seeded SoA-round inputs as numpy: lens 0 and ``first`` rows included."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.5, 2.0, size=(F, L))
    lens = rng.integers(0, L + 1, size=F).astype(np.int64)
    m0 = rng.uniform(0.5, 2.0, size=F)
    first = rng.random(F) < 0.3
    if F >= 2:
        lens[0], first[0] = 0, True
        lens[1], first[1] = L, True
    ewma = np.full(F, alpha)
    next_k = rng.integers(0, 10_000, size=N).astype(np.int64)
    next_k[rng.random(N) < 0.2] = soa_step._BIG
    row_rep = np.sort(rng.integers(0, R, size=N)).astype(np.int64)
    if N >= R:
        row_rep[:R] = np.arange(R)
        row_rep = np.sort(row_rep)
    return obs, lens, m0, first, ewma, next_k, row_rep, R


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.1])
@pytest.mark.parametrize("F,L,N,R", [(32, 8, 128, 8), (128, 16, 512, 16),
                                     (128, 16, 32000, 1000), (0, 4, 64, 4),
                                     (16, 4, 0, 3)])
def test_soa_step_kernel_bit_exact(F, L, N, R, alpha, card):
    obs, lens, m0, first, ewma, next_k, row_rep, R = _soa_inputs(F, L, N, R, alpha)
    before = ksc.LAUNCHES
    m, seg = soa_step.soa_step_fused(obs, lens, m0, first, ewma, next_k,
                                     row_rep, R, device=card)
    assert ksc.LAUNCHES == before + 1
    want_m = soa_step.ewma_fold_ref(obs, lens, m0, first, ewma)
    assert np.array_equal(m, want_m)
    assert np.array_equal(m, soa_step.ewma_fold_sorted(obs, lens, m0, first, ewma))
    want_seg = np.full(R, soa_step._BIG, np.int64)
    np.minimum.at(want_seg, row_rep, next_k)
    assert np.array_equal(seg, want_seg)
    if N >= R:
        starts = np.searchsorted(row_rep, np.arange(R))
        assert np.array_equal(seg, soa_step.segmented_min_ref(next_k, starts))
    fold = soa_step.ewma_fold(obs, lens, m0, first, ewma, device=card)
    assert np.array_equal(fold, want_m)


@pytest.mark.cuda
def test_soa_step_kernel_rejects_what_it_does_not_take(card):
    obs, lens, m0, first, ewma, next_k, row_rep, R = _soa_inputs(8, 4, 32, 4, 0.3)
    T = [torch.from_numpy(a).to(card)
         for a in (obs, lens, m0, first, ewma, next_k, row_rep)]
    with pytest.raises(TypeError, match="obs"):
        ksc.soa_step_fused_cuda(T[0].float(), *T[1:], R)
    with pytest.raises(TypeError, match="lens"):
        ksc.ewma_fold_cuda(T[0], T[1].int(), *T[2:5])
    with pytest.raises(ValueError, match="shape"):
        ksc.soa_step_fused_cuda(T[0], T[1][:4], *T[2:], R)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ksc.soa_step_fused_cuda(*T[:5], T[5].cpu(), T[6], R)
    with pytest.raises(ValueError, match="contiguous"):
        ksc.ewma_fold_cuda(T[0].t().contiguous().t(), *T[1:5])


FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 4e-2}
SSD_TOL = 1e-4


def _randn(gen, *shape, dtype=torch.float32, device="cuda", scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,D,dtype", [
    (4, 512, 32, 64, torch.bfloat16),          # zamba2-1.2b's prefill
    (2, 1, 4, 128, torch.float32), (2, 200, 4, 128, torch.float32),
    (2, 333, 4, 128, torch.float32), (2, 1, 4, 128, torch.bfloat16),
    (2, 200, 4, 128, torch.bfloat16), (2, 333, 4, 128, torch.bfloat16),
    (2, 37, 4, 16, torch.float32), (1, 70, 2, 32, torch.bfloat16),
])
def test_flash_attention_kernel_matches_ref(B, S, H, D, dtype, causal, card):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (_randn(gen, B, S, H, D, dtype=dtype, device=card) for _ in range(3))
    before = kfa.LAUNCHES, kfa.WGMMA_LAUNCHES, kfa.TF32_LAUNCHES
    o = ops.flash_attention(q, k, v, causal)
    # both routes are on the tensor cores: bfloat16 the bf16 wgmma kernel,
    # float32 the 3xTF32 wgmma kernel
    bf16 = int(dtype == torch.bfloat16)
    assert (kfa.LAUNCHES, kfa.WGMMA_LAUNCHES, kfa.TF32_LAUNCHES) == (
        before[0] + 1, before[1] + bf16, before[2] + 1 - bf16)
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == (B, S, H, D)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (37, 37), (200, 200), (333, 333),
                                   (1, 38), (200, 237), (237, 200), (333, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_kernel_head_dims_and_sq_ne_sk(D, Sq, Sk, causal, card):
    """The 3xTF32 route at every head dim, ragged lengths and Sq != Sk both
    ways, within the float32 contract of the plain version."""
    gen = torch.Generator().manual_seed(D + Sq + Sk)
    q = _randn(gen, 2, Sq, 4, D, device=card)
    k, v = (_randn(gen, 2, Sk, 4, D, device=card) for _ in range(2))
    before = kfa.TF32_LAUNCHES
    o = kfa.flash_attention_cuda(q, k, v, causal)
    assert kfa.TF32_LAUNCHES == before + 1
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(o, want, rtol=3e-5, atol=3e-5)


def _attention_f64(q, k, v, causal):
    """``ref.flash_attention_ref``'s formula in float64."""
    q, k, v = q.double(), k.double(), v.double()
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full((), -1e30, dtype=s.dtype, device=s.device))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_kernel_large_scores(D, causal, card):
    """q scaled by 8: scores of order 8, the running max moving from tile to
    tile by tens and the rescale factors far below 1.  Large scores carry
    float32 rounding into the output (tests/test_torch_flash_tf32.py), so the
    kernel is held to the exact result, the plain formula in float64, at the
    float32 contract's 3e-5.  At q x 30 no float32 computation holds it, the
    float32 plain version included (``tools/flash_f32_timing.py --scores``)."""
    gen = torch.Generator().manual_seed(30 + D)
    q = _randn(gen, 2, 333, 4, D, device=card, scale=8.0)
    k, v = (_randn(gen, 2, 333, 4, D, device=card) for _ in range(2))
    o = kfa.flash_attention_cuda(q, k, v, causal)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o.double(), _attention_f64(q, k, v, causal),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
def test_flash_attention_f32_kernel_copies_what_it_cannot_read(card):
    """Views the 16-byte loads take as they are (a slice of a wider tensor
    in S and H, a (B, H, S, D) tensor transposed) and views they cannot (a
    base off 16 bytes, a row stride off 16 bytes): the latter are copied
    and every call runs the 3xTF32 kernel, within 3e-5 of the plain
    version."""
    gen = torch.Generator().manual_seed(5)
    wide = _randn(gen, 2, 96, 8, 64, device=card)
    sliced = wide[:, 10:50, :4]
    bhsd = _randn(gen, 2, 4, 40, 64, device=card).transpose(1, 2)
    flat = _randn(gen, 1 + 2 * 40 * 4 * 64, device=card)
    offset = flat[1:].view(2, 40, 4, 64)                 # contiguous, base off 16 bytes
    odd = _randn(gen, 2, 40, 4, 65, device=card)[..., 1:]  # strides of 65 floats
    assert kfa.tma_strides(sliced) is not None and kfa.tma_strides(bhsd) is not None
    assert kfa.tma_strides(offset) is None and kfa.tma_strides(odd) is None
    for q, k, v in ((sliced, bhsd, bhsd), (offset, odd, sliced), (odd, offset, offset)):
        for causal in (True, False):
            before = kfa.TF32_LAUNCHES
            o = kfa.flash_attention_cuda(q, k, v, causal, scale=0.2)
            assert kfa.TF32_LAUNCHES == before + 1
            want = ref.flash_attention_ref(q, k, v, causal, scale=0.2)
            torch.testing.assert_close(o, want, rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_strides_and_sq_ne_sk(card):
    gen = torch.Generator().manual_seed(1)
    wide = _randn(gen, 2, 96, 8, 64, device=card)
    q = wide[:, 10:50, :4]                       # strided in S and H
    k = _randn(gen, 2, 70, 4, 64, device=card)
    v = _randn(gen, 2, 4, 70, 64, device=card).transpose(1, 2)
    for causal in (True, False):
        o = kfa.flash_attention_cuda(q, k, v, causal, scale=0.2)
        want = ref.flash_attention_ref(q, k, v, causal, scale=0.2)
        torch.testing.assert_close(o, want, rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("Sq,Sk", [(1, 38), (200, 237), (333, 333), (512, 549)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_kernel_head_dims_and_sq_ne_sk(D, Sq, Sk, causal, card):
    gen = torch.Generator().manual_seed(D + Sq)
    q = _randn(gen, 2, Sq, 4, D, dtype=torch.bfloat16, device=card)
    k, v = (_randn(gen, 2, Sk, 4, D, dtype=torch.bfloat16, device=card)
            for _ in range(2))
    before = kfa.WGMMA_LAUNCHES
    o = kfa.flash_attention_cuda(q, k, v, causal)
    assert kfa.WGMMA_LAUNCHES == before + 1
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(o.float(), want.float(), rtol=4e-2, atol=4e-2)


@pytest.mark.cuda
def test_flash_attention_bf16_kernel_reads_strided_views(card):
    """Strided views go to the tensor maps as they are; a view whose
    strides a map cannot take is copied first.  Both agree with the plain
    version."""
    gen = torch.Generator().manual_seed(2)
    wide = _randn(gen, 2, 96, 8, 64, dtype=torch.bfloat16, device=card)
    q = wide[:, 10:50, :4]
    k = _randn(gen, 2, 70, 4, 64, dtype=torch.bfloat16, device=card)
    v = _randn(gen, 2, 4, 70, 64, dtype=torch.bfloat16, device=card).transpose(1, 2)
    odd = _randn(gen, 2, 70, 4, 72, dtype=torch.bfloat16, device=card)[..., 1:65]
    assert kfa.tma_strides(q) is not None and kfa.tma_strides(odd) is None
    for kk in (k, odd):
        for causal in (True, False):
            o = kfa.flash_attention_cuda(q, kk, v, causal, scale=0.2)
            want = ref.flash_attention_ref(q, kk, v, causal, scale=0.2)
            torch.testing.assert_close(o.float(), want.float(), rtol=4e-2,
                                       atol=4e-2)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros(1, 8, 2, 64, device=card)
    with pytest.raises(ValueError, match="head dim"):
        kfa.flash_attention_cuda(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(TypeError):
        kfa.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="CUDA tensor"):
        kfa.flash_attention_cuda(q, q.cpu(), q)
    with pytest.raises(ValueError, match="shape|must be"):
        kfa.flash_attention_cuda(q, q[:, :, :1], q)


def _ssd_inputs(gen, B, Q, H, P, N, device, dt_scale=1.0):
    x = _randn(gen, B, Q, H, P, device=device)
    dt = (torch.rand(B, Q, H, generator=gen) * 0.099 + 0.001) * dt_scale
    A = -(torch.rand(H, generator=gen) * 1.5 + 0.5)
    return (x, dt.to(device), A.to(device), _randn(gen, B, Q, H, N, device=device),
            _randn(gen, B, Q, H, N, device=device), _randn(gen, B, H, P, N, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,H,P,N", [
    (4, 256, 64, 64, 64),                      # zamba2-1.2b's chunk
    (2, 32, 3, 8, 4), (1, 64, 2, 16, 8), (3, 16, 1, 4, 4),
    (1, 256, 4, 64, 128),                      # mamba2-130m's state width
    (2, 200, 3, 16, 16), (1, 1, 2, 64, 64),
])
def test_ssd_chunk_kernel_matches_ref(B, Q, H, P, N, card):
    args = _ssd_inputs(torch.Generator().manual_seed(0), B, Q, H, P, N, card)
    before = kss.LAUNCHES
    y, s = ops.ssd_chunk(*args)
    assert kss.LAUNCHES == before + 1
    y2, s2 = ref.ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y2, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(s, s2, rtol=SSD_TOL, atol=SSD_TOL)


# With dt·|A| near 100 the cumulative log-decay reaches |cum| ~ 6e3, where a
# float32 prefix sum carries ~4e-4 of rounding that depends on the order of
# the adds (the kernel's warp scan against torch.cumsum), and exp turns that
# into the same relative error: 2.4e-3 seen on an H100.
LARGE_DECAY_TOL = 1e-2


@pytest.mark.cuda
def test_ssd_chunk_kernel_large_decay_is_finite(card):
    """dt·|A| near 100 (dt scaled by 1000): the upper triangle's
    cum_i - cum_j is large and positive, masked before the exp."""
    args = _ssd_inputs(torch.Generator().manual_seed(2), 2, 64, 3, 16, 8, card,
                       dt_scale=1000.0)
    y, s = kss.ssd_chunk_cuda(*args)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y2, s2 = ref.ssd_chunk_ref(*args)
    tol = LARGE_DECAY_TOL
    torch.testing.assert_close(y, y2, rtol=tol, atol=tol)
    torch.testing.assert_close(s, s2, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssd_chunk_kernel_reads_chunk_slices_in_place(card):
    x, dt, A, Bm, Cm, st = _ssd_inputs(torch.Generator().manual_seed(3),
                                       2, 128, 4, 32, 16, card)
    sl = slice(64, 128)
    got = kss.ssd_chunk_cuda(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], st)
    want = kss.ssd_chunk_cuda(*(t[:, sl].contiguous() for t in (x, dt)), A,
                              *(t[:, sl].contiguous() for t in (Bm, Cm)), st)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_ssd_chunk_kernel_rejects_what_it_does_not_take(card):
    args = list(_ssd_inputs(torch.Generator().manual_seed(4), 1, 16, 2, 8, 4, card))
    with pytest.raises(TypeError, match="float32"):
        kss.ssd_chunk_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        kss.ssd_chunk_cuda(*args[:5], args[5][:, :, :4])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kss.ssd_chunk_cuda(*args[:2], args[2].cpu(), *args[3:])
    big = _ssd_inputs(torch.Generator().manual_seed(5), 1, 16, 1, 72, 4, card)
    with pytest.raises(ValueError, match="P <="):
        kss.ssd_chunk_cuda(*big)


def _stride0(gen, B, Q, H, N, device):
    """B and C as the model hands them over for one group: a (B,Q,N) tensor
    expanded to (B,Q,H,N) with head stride 0."""
    return [_randn(gen, B, Q, 1, N, device=device).expand(B, Q, H, N)
            for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,H,P,N", [
    (4, 256, 64, 64, 64),                      # zamba2-1.2b's chunk
    (1, 256, 4, 64, 128),                      # N = 128
    (2, 200, 3, 64, 64),                       # a ragged last tile
    (2, 37, 5, 16, 8),
])
def test_ssd_chunk_kernel_on_head_stride0_b_and_c(B, Q, H, P, N, card):
    gen = torch.Generator().manual_seed(6)
    x, dt, A, _, _, st = _ssd_inputs(gen, B, Q, H, P, N, card)
    Bm, Cm = _stride0(gen, B, Q, H, N, card)
    assert Bm.stride(2) == 0
    before = kss.LAUNCHES
    y, s = ops.ssd_chunk(x, dt, A, Bm, Cm, st)
    assert kss.LAUNCHES == before + 1
    y2, s2 = ref.ssd_chunk_ref(x, dt, A, Bm, Cm, st)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y2, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(s, s2, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
def test_ssd_chunk_kernel_reads_a_chunk_slice_of_the_stride0_view(card):
    gen = torch.Generator().manual_seed(7)
    x, dt, A, _, _, st = _ssd_inputs(gen, 2, 512, 8, 64, 64, card)
    Bm, Cm = _stride0(gen, 2, 512, 8, 64, card)
    sl = slice(256, 512)
    y, s = kss.ssd_chunk_cuda(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], st)
    y2, s2 = ref.ssd_chunk_ref(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], st)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y2, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(s, s2, rtol=SSD_TOL, atol=SSD_TOL)
    # the same bits as from contiguous copies of the slices
    want = kss.ssd_chunk_cuda(*(t[:, sl].contiguous() for t in (x, dt)), A,
                              *(t[:, sl].contiguous() for t in (Bm, Cm)), st)
    for a, b in zip((y, s), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_ssd_chunk_kernel_shared_memory_stays_in_a_block(card):
    """The kernel's own count of its shared memory equals the wrapper's
    and stays under the 227 KB a block may have at the configs' chunk."""
    import ctypes
    from repro_torch.kernels import build
    fn = build.load("ssd_chunk").ssd_chunk_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int64, ctypes.c_int64], ctypes.c_int64
    for Q, N in ((256, 64), (256, 128), (200, 16), (1, 4), (4096, 128)):
        assert fn(Q, N) == kss.ssd_chunk_smem_bytes(Q, N)
    assert kss.ssd_chunk_smem_bytes(256, 128) <= kss.SMEM_LIMIT
    props = torch.cuda.get_device_properties(card)
    limit = getattr(props, "shared_memory_per_block_optin", kss.SMEM_LIMIT)
    assert kss.ssd_chunk_smem_bytes(256, 128) <= limit


def _soa_edge(kind, L=354, F=48, N=4096, R=97, alpha=0.3, seed=11):
    """SoA inputs with long rows (every lens = L), all-first rows, lens = 0
    rows, or unsorted row_rep."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.5, 2.0, size=(F, L))
    lens = np.full(F, L, np.int64)
    m0 = rng.uniform(0.5, 2.0, size=F)
    first = rng.random(F) < 0.3
    if kind == "all_first":
        first[:] = True
        lens = rng.integers(0, L + 1, size=F).astype(np.int64)
    if kind == "lens0":
        lens[::2] = 0
    ewma = np.full(F, alpha)
    next_k = rng.integers(0, 10_000, size=N).astype(np.int64)
    next_k[rng.random(N) < 0.2] = soa_step._BIG
    row_rep = np.sort(rng.integers(0, R, size=N)).astype(np.int64)
    if kind == "unsorted":
        row_rep = rng.permutation(row_rep)
    return obs, lens, m0, first, ewma, next_k, row_rep, R


@pytest.mark.cuda
@pytest.mark.parametrize("kind,L", [("long", 354), ("long", 1024),
                                    ("all_first", 354), ("lens0", 354),
                                    ("unsorted", 64)])
def test_soa_step_kernel_bit_exact_on_edge_rows(kind, L, card):
    obs, lens, m0, first, ewma, next_k, row_rep, R = _soa_edge(kind, L)
    T = [torch.from_numpy(a).to(card)
         for a in (obs, lens, m0, first, ewma, next_k, row_rep)]
    m, seg = ksc.soa_step_fused_cuda(*T, R)
    pm, pseg = ref.soa_step_fused_ref(*T, R)
    fold = ksc.ewma_fold_cuda(*T[:5])
    torch.cuda.synchronize()
    assert torch.equal(m, pm) and torch.equal(seg, pseg) and torch.equal(fold, pm)
    assert np.array_equal(m.cpu().numpy(),
                          soa_step.ewma_fold_ref(obs, lens, m0, first, ewma))


@pytest.mark.cuda
def test_reduced_zamba2_serves_the_same_tokens_on_card_and_cpu(card):
    """The port's server at float32 on the card (both kernels) and on the
    CPU (plain versions) from the same weights: equal greedy tokens."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models.model import Model, tree_map
    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                              dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    fa, ss = kfa.LAUNCHES, kss.LAUNCHES
    got = Server(cfg, tree_map(lambda t: t.to(card), params), max_len=64,
                 device=card).generate({"tokens": toks}, 12)
    model = Model(cfg)
    assert kfa.LAUNCHES - fa == model.n_shared_invocations
    assert kss.LAUNCHES - ss == cfg.n_layers * -(-40 // cfg.ssm_chunk)
    want = Server(cfg, params, max_len=64, device="cpu").generate({"tokens": toks}, 12)
    assert torch.equal(got.cpu(), want)


# --------------------------------------------------------------------------
# the LSTM stack's backward (training) and the wrappers without a backward
# --------------------------------------------------------------------------

GRAD_TOL = 1e-5   # of each gradient leaf's largest magnitude


def _grad_case(gen, G, B, T, I, H, L, device):
    """Seeded float32 inputs that require grad (xs too) and an upstream dh."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)
    xs = rnd(G, B, T, I).requires_grad_(True)
    layers = [{"w_ih": rnd(G, I if n == 0 else H, 4 * H,
                           scale=(I if n == 0 else H) ** -0.5).requires_grad_(True),
               "w_hh": rnd(G, H, 4 * H, scale=H ** -0.5).requires_grad_(True),
               "b": rnd(G, 4 * H, scale=0.1).requires_grad_(True)}
              for n in range(L)]
    return xs, layers, rnd(G, B, H)


# (G, B, T, I, H, layers) of the training kernels' card cases: B not a
# multiple of the plan's rows a block (255, 257: 2 rows, a last block of
# one), two groups at the training batch (4 rows a block), H = 64 (one
# layer a wave)
TRAIN_CASES = [
    (1, 256, 59, 6, 32, 3),          # RevPred's training batch
    (1, 256, 60, 7, 32, 3),          # Tributary's
    (1, 255, 59, 6, 32, 3), (1, 257, 60, 7, 32, 3), (2, 256, 59, 6, 32, 3),
    (1, 1, 59, 6, 32, 3), (1, 7, 60, 7, 32, 3), (2, 7, 59, 6, 16, 3),
    (1, 7, 59, 6, 32, 1), (1, 7, 59, 6, 32, 2), (1, 5, 20, 6, 64, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,T,I,H,L", TRAIN_CASES)
def test_lstm_stack_backward_kernel_matches_autograd_of_ref(G, B, T, I, H, L, card):
    xs, layers, dh = _grad_case(torch.Generator().manual_seed(B + H + L), G, B,
                                T, I, H, L, card)
    flat = [xs] + [lp[k] for lp in layers for k in ("w_ih", "w_hh", "b")]
    before = klc.TRAIN_LAUNCHES, klc.BWD_LAUNCHES, klc.STACK_LAUNCHES
    h = ops.lstm_stack(xs, layers)
    got = torch.autograd.grad(h, flat, dh)
    assert (klc.TRAIN_LAUNCHES, klc.BWD_LAUNCHES, klc.STACK_LAUNCHES) == \
        (before[0] + 1, before[1] + 1, before[2])
    h_ref = ref.lstm_stack_ref(xs, layers)
    want = torch.autograd.grad(h_ref, flat, dh)
    torch.cuda.synchronize()
    torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= GRAD_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,T,I,H,L", [(1, 9, 59, 6, 32, 3), (1, 255, 59, 6, 32, 3),
                                         (1, 257, 60, 7, 32, 3), (2, 256, 59, 6, 32, 3)])
def test_lstm_stack_training_kernels_match_their_plain_versions(G, B, T, I, H, L, card):
    xs, layers, dh = _grad_case(torch.Generator().manual_seed(3), G, B, T, I,
                                H, L, card)
    with torch.no_grad():
        saved = klc.lstm_stack_fwd_train_cuda(xs, layers)
        want = ref.lstm_stack_fwd_train_ref(xs, layers)
        for a, b in zip(saved, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        dg = klc.lstm_stack_bwd_cuda(dh, want[1], want[2], layers)
        dg_ref = ref.lstm_stack_bwd_ref(dh, want[1], want[2], layers)
    torch.testing.assert_close(dg, dg_ref, rtol=1e-5, atol=1e-5 * dg_ref.abs().max().item())


@pytest.mark.cuda
def test_lstm_stack_training_batch_runs_in_one_wave(card):
    """At RevPred's training batch both training kernels' grids fit the
    card's SMs at once (2 rows a block on an H100's 132)."""
    sms = klc.n_sms(card)
    for plan in (klc.lstm_stack_train_plan(256, 6, 32, 59, 3, sms),
                 klc.lstm_stack_bwd_plan(256, 32, 59, 3, sms)):
        wave, rows, blocks, _ = plan
        assert wave == 3 and blocks == -(-256 // rows) <= sms


@pytest.mark.cuda
def test_lstm_stack_bf16_with_grad_raises(card):
    xs, layers, _ = _grad_case(torch.Generator().manual_seed(0), 1, 2, 10, 6,
                               16, 3, card)
    layers = [{k: v.detach().bfloat16().requires_grad_(True) for k, v in lp.items()}
              for lp in layers]
    with pytest.raises(TypeError, match="float32"):
        ops.lstm_stack(xs.detach().bfloat16(), layers)


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_inputs_that_require_grad(card):
    gen = torch.Generator().manual_seed(0)
    x = _inputs(gen, 1, 2, 6, 32, torch.float32, card)
    xs, layers, _ = _grad_case(gen, 1, 2, 10, 6, 16, 3, card)
    q = _randn(gen, 1, 8, 2, 64, device=card).requires_grad_(True)
    ssd = [t.requires_grad_(True) if t.is_floating_point() else t
           for t in _ssd_inputs(gen, 1, 16, 1, 4, 4, card)]
    obs = torch.rand(4, 3, dtype=torch.float64, device=card, requires_grad=True)
    fold = (obs, torch.full((4,), 3, device=card), torch.rand(
        4, dtype=torch.float64, device=card), torch.zeros(4, dtype=torch.bool,
                                                         device=card),
        torch.full((4,), 0.5, dtype=torch.float64, device=card))
    calls = [lambda: klc.lstm_cell_cuda(x[0].requires_grad_(True), *x[1:]),
             lambda: klc.lstm_stack_cuda(xs, layers),
             lambda: ksc.ewma_fold_cuda(*fold),
             lambda: ksc.soa_step_fused_cuda(*fold, torch.zeros(
                 4, dtype=torch.int64, device=card), torch.zeros(
                 4, dtype=torch.int64, device=card), 1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward yet .ROADMAP A10"):
            call()
    # flash attention and the SSD chunk train through their autograd
    # Functions: the raw wrappers name that route
    routed = [(lambda: kfa.flash_attention_cuda(q, q, q), "ops.flash_attention"),
              (lambda: kfa.flash_attention_lse_cuda(q, q, q), "ops.flash_attention"),
              (lambda: kss.ssd_chunk_cuda(*ssd), "ops.ssd_chunk")]
    for call, route in routed:
        with pytest.raises(RuntimeError, match=f"no gradient; train through {route}"):
            call()
    with torch.no_grad():
        kfa.flash_attention_cuda(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H", [(2, 256, 256, 32), (1, 200, 237, 4),
                                       (2, 1, 38, 4), (1, 333, 333, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_head_dim_96(B, Sq, Sk, H, dtype, causal, card):
    """phi3-mini's head dim (3072 / 32): both routes, at its own scale."""
    gen = torch.Generator().manual_seed(Sq + H)
    q = _randn(gen, B, Sq, H, 96, dtype=dtype, device=card)
    k, v = (_randn(gen, B, Sk, H, 96, dtype=dtype, device=card) for _ in range(2))
    before = kfa.LAUNCHES
    o = ops.flash_attention(q, k, v, causal)
    assert kfa.LAUNCHES == before + 1
    want = ref.flash_attention_ref(q, k, v, causal, scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert o.shape == (B, Sq, H, 96) and o.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_train_model_on_the_card_matches_the_cpu(card):
    """One market's revpred, a few steps: per-step losses and the final
    parameters of the card run (the kernels) against the CPU run (autograd
    of the plain versions), from the same initialisation."""
    from repro_torch.core.market import SpotMarket
    m = SpotMarket(days=3, seed=3)
    inst = m.pool[1]
    data = rp.build_dataset(m.traces[inst.name], inst.od_price, 0, 2 * 1440,
                            "algo2", np.random.default_rng(0), stride=4)
    init = rp.init_revpred(torch.Generator().manual_seed(5), device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        losses = []
        params, pf = rp.train_model(rp.revpred_logits, init, data, epochs=2,
                                    seed=1, device=dev,
                                    on_step=lambda l: losses.append(l.item()))
        runs[dev] = (rp.params_to_numpy(params), losses)
    (pc, lc), (pp, lp) = runs["cuda"], runs["cpu"]
    assert len(lc) == len(lp) >= 2
    np.testing.assert_allclose(lc, lp, rtol=1e-4)
    for a, b in zip(rp.tree_leaves(pc), rp.tree_leaves(pp)):
        np.testing.assert_allclose(a, b, atol=1e-3)


# ------------------------------------------------ the model's training path

LSE_TOL = 1e-4      # the kernel's log-sum-exp against the plain one, absolute
FN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}  # of each leaf's largest


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
    (2, 512, 512, 32, 64, True),                # zamba2-1.2b's training shape
    (1, 200, 237, 4, 96, False), (2, 1, 38, 4, 16, True),
    (1, 333, 333, 2, 128, True), (2, 70, 70, 3, 32, False)])
def test_flash_attention_kernel_writes_the_plain_lse(B, Sq, Sk, H, D, causal, dtype, card):
    gen = torch.Generator().manual_seed(Sq + D)
    q = _randn(gen, B, Sq, H, D, dtype=dtype, device=card)
    k, v = (_randn(gen, B, Sk, H, D, dtype=dtype, device=card) for _ in range(2))
    before = kfa.LAUNCHES
    o, lse = kfa.flash_attention_lse_cuda(q, k, v, causal)
    assert kfa.LAUNCHES == before + 1
    o2, lse2 = ref.flash_attention_fwd_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, lse2, rtol=0, atol=LSE_TOL)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), o2.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(o, kfa.flash_attention_cuda(q, k, v, causal))


def _leafwise(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = w.float().abs().max().clamp_min(1e-30)
        assert (g.float() - w.float()).abs().max() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,D,chunk,causal", [
    (2, 512, 32, 64, 512, True), (1, 192, 4, 96, 64, True),
    (2, 100, 3, 16, 30, False)])
def test_flash_attention_function_gradients_match_autograd_of_plain(
        B, S, H, D, chunk, causal, dtype, card):
    gen = torch.Generator().manual_seed(S + H)
    q, k, v = (_randn(gen, B, S, H, D, dtype=dtype, device=card).requires_grad_(True)
               for _ in range(3))
    do = _randn(gen, B, S, H, D, dtype=dtype, device=card)
    before = kfa.LAUNCHES
    o = ops.flash_attention(q, k, v, causal, chunk=chunk)
    assert kfa.LAUNCHES == before + 1
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(o, (q, k, v), do)
    o2 = ops.flash_attention(q, k, v, causal, force="ref")
    want = torch.autograd.grad(o2, (q, k, v), do)
    torch.cuda.synchronize()
    _leafwise(got, want, FN_GRAD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,H,P,N,stride0", [
    (2, 256, 64, 64, 64, True),                 # zamba2-1.2b's training chunk
    (2, 32, 3, 8, 4, False), (1, 200, 4, 64, 128, True)])
def test_ssd_chunk_function_gradients_match_autograd_of_plain(B, Q, H, P, N, stride0, card):
    gen = torch.Generator().manual_seed(Q + H)
    x, dt, A, Bm, Cm, st = _ssd_inputs(gen, B, Q, H, P, N, card)
    if stride0:
        Bm, Cm = (t[:, :, :1].contiguous() for t in (Bm, Cm))
    leaves = [t.requires_grad_(True) for t in (x, dt, A, Bm, Cm, st)]
    args = leaves[:3] + [t.expand(B, Q, H, N) for t in leaves[3:5]] + leaves[5:]
    dy, dst = _randn(gen, B, Q, H, P, device=card), _randn(gen, B, H, P, N, device=card)
    before = kss.LAUNCHES
    y, new = ops.ssd_chunk(*args)
    assert kss.LAUNCHES == before + 1
    assert type(y.grad_fn).__name__ == "SsdChunkBackward"
    got = torch.autograd.grad((y, new), leaves, (dy, dst))
    y2, new2 = ops.ssd_chunk(*args, force="ref")
    want = torch.autograd.grad((y2, new2), leaves, (dy, dst))
    torch.cuda.synchronize()
    _leafwise(got, want, FN_GRAD_TOL[torch.float32])


@pytest.mark.cuda
def test_reduced_zamba2_trains_the_same_on_card_and_cpu(card):
    """Three Trainer steps of the float32 reduced zamba2, card against CPU
    (the same weights from one seed), and a restart on the card."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, LocalObjectStore
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import Trainer

    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True), dtype="float32")
    cpu = Trainer(cfg, batch=2, seq=32, seed=0, val_every=1, device="cpu")
    cpu.run_steps(3)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(LocalObjectStore(tmp), "t", save_interval_steps=2)
        gpu = Trainer(cfg, batch=2, seq=32, seed=0, val_every=1, ckpt=mgr)
        before = (kfa.LAUNCHES, kss.LAUNCHES)
        gpu.run_steps(3)
        assert kfa.LAUNCHES > before[0] and kss.LAUNCHES > before[1]
        np.testing.assert_allclose(gpu.metrics_vals, cpu.metrics_vals, rtol=1e-4)
        again = Trainer(cfg, batch=2, seq=32, seed=0, val_every=1,
                        ckpt=CheckpointManager(LocalObjectStore(tmp), "t", 2))
        assert again.restore(step=2) == 2
        again.run_steps(1)
        assert again.metrics_vals[-1] == pytest.approx(gpu.metrics_vals[-1], rel=1e-5)
