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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Sk,q_offset", [(200, 800, 137), (200, 800, 600),
                                            (64, 2048, 1984), (333, 512, 179),
                                            (128, 1024, 0)])
def test_flash_attention_kernel_causal_offset(Sq, Sk, q_offset, D, dtype, card):
    """A rank's block of queries against the whole sequence's keys: the
    causal mask offset by the block's first position, Sq < Sk, both
    kernels against the plain version."""
    gen = torch.Generator().manual_seed(Sq + q_offset + D)
    q = _randn(gen, 2, Sq, 4, D, dtype=dtype, device=card)
    k, v = (_randn(gen, 2, Sk, 4, D, dtype=dtype, device=card) for _ in range(2))
    before = kfa.LAUNCHES
    o = kfa.flash_attention_cuda(q, k, v, True, q_offset=q_offset)
    assert kfa.LAUNCHES == before + 1
    want = ref.flash_attention_ref(q, k, v, True, q_offset=q_offset)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


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
    # pairs of two widths no built pair covers, forward and backward
    z = torch.zeros(1, 8, 2, 256, device=card, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, device=card)
    for dk, dv in ((200, 128), (192, 136)):
        with pytest.raises(ValueError, match="head dims"):
            kfa.flash_attention_cuda(z[..., :dk], z[..., :dk], z[..., :dv])
        with pytest.raises(ValueError, match="head dims"):
            kfa.flash_attention_bwd_cuda(z[..., :dk], z[..., :dk], z[..., :dv], lse,
                                         z[..., :dv])
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
    before = kfa.BWD_LAUNCHES
    got = torch.autograd.grad(o, (q, k, v), do)
    assert kfa.BWD_LAUNCHES == before + 1          # the backward kernels, once
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
    before = kss.BWD_LAUNCHES
    got = torch.autograd.grad((y, new), leaves, (dy, dst))
    assert kss.BWD_LAUNCHES == before + 1          # the backward kernel, once
    y2, new2 = ops.ssd_chunk(*args, force="ref")
    want = torch.autograd.grad((y2, new2), leaves, (dy, dst))
    torch.cuda.synchronize()
    _leafwise(got, want, FN_GRAD_TOL[torch.float32])


# The backward kernels against their plain versions: each gradient within
# these of its largest magnitude (bf16 gradients come out in bf16), and two
# calls on the same inputs bitwise equal (no atomics).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_BWD_TOL = 1e-4
SSD_BWD_LARGE_DECAY_TOL = 1e-2      # dt |A| ~ 100: as LARGE_DECAY_TOL above


def _flash_bwd_case(gen, B, Sq, Sk, H, D, causal, q_offset, dtype, device, kv_heads=None):
    q, do = (_randn(gen, B, Sq, H, D, dtype=dtype, device=device) for _ in range(2))
    kvh = kv_heads or H
    k, v = (_randn(gen, B, Sk, kvh, D, dtype=dtype, device=device) for _ in range(2))
    if kv_heads:                      # GQA: K/V expanded to the query heads
        k, v = (t[:, :, :, None].expand(B, Sk, kvh, H // kvh, D).reshape(B, Sk, H, D)
                for t in (k, v))
    _, lse = kfa.flash_attention_lse_cuda(q, k, v, causal, None, q_offset)
    return q, k, v, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal,q_offset,kv_heads", [
    (2, 512, 512, 32, 64, True, 0, None),       # zamba2-1.2b's training shape
    (2, 256, 1500, 8, 64, False, 0, None),      # whisper-base's cross-attention
    (1, 200, 237, 4, 96, False, 0, None), (2, 70, 70, 3, 32, True, 0, None),
    (2, 1, 38, 4, 16, True, 0, None), (1, 333, 333, 2, 128, True, 0, None),
    (1, 64, 256, 2, 64, True, 192, None),       # a sequence block at q_offset
    (2, 100, 300, 4, 128, True, 37, None),
    (2, 1280, 1280, 32, 128, True, 0, 8)])      # pixtral-12b: 32 heads over 8
def test_flash_attention_bwd_kernel_matches_plain(B, Sq, Sk, H, D, causal, q_offset,
                                                  kv_heads, dtype, card):
    gen = torch.Generator().manual_seed(Sq + Sk + D)
    q, k, v, lse, do = _flash_bwd_case(gen, B, Sq, Sk, H, D, causal, q_offset, dtype, card,
                                       kv_heads)
    before = kfa.BWD_LAUNCHES
    got = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal, None, q_offset)
    assert kfa.BWD_LAUNCHES == before + 1
    again = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal, None, q_offset)
    want = ref.flash_attention_bwd(q, k, v, lse, do, causal, None, None, q_offset)
    torch.cuda.synchronize()
    _leafwise(got, want, BWD_TOL[dtype])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_reads_strided_views(card):
    """q, k, v and do as views of one (B, S, 4, H, D) tensor (a fused
    projection's layout) give what their contiguous copies give."""
    gen = torch.Generator().manual_seed(12)
    qkvd = _randn(gen, 2, 96, 4, 3, 32, device=card)
    q, k, v, do = qkvd.unbind(2)
    _, lse = kfa.flash_attention_lse_cuda(q, k, v, True)
    got = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True)
    want = kfa.flash_attention_bwd_cuda(*(t.contiguous() for t in (q, k, v)), lse,
                                        do.contiguous(), True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# MLA's materialized form: q and k 192 wide (qk_nope + qk_rope), v 128
# (v_head_dim) at deepseek-v2's width, the kernels' (192, 128) instances;
# the reduced config's (24, 16) padded to a built pair.  Tolerances: of each
# output's largest, float32 1e-4, bf16 1e-2 (BWD_TOL; the forward's o and
# lse too).
DV_CASES = [(2, 256, 256, 16, 192, 128, True, 0),    # A15's training shape, 16 heads
            (1, 200, 237, 3, 192, 128, False, 0), (2, 70, 70, 2, 192, 128, True, 0),
            (1, 64, 256, 2, 192, 128, True, 192),  # a sequence block at q_offset
            (2, 1, 38, 2, 192, 128, True, 0), (2, 100, 100, 2, 24, 16, True, 0)]


def _dv_case(gen, B, Sq, Sk, H, Dk, Dv, dtype, device):
    return (_randn(gen, B, Sq, H, Dk, dtype=dtype, device=device),
            _randn(gen, B, Sk, H, Dk, dtype=dtype, device=device),
            _randn(gen, B, Sk, H, Dv, dtype=dtype, device=device),
            _randn(gen, B, Sq, H, Dv, dtype=dtype, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Dk,Dv,causal,q_offset", DV_CASES)
def test_flash_kernels_at_mlas_materialized_pair_match_plain(B, Sq, Sk, H, Dk, Dv, causal,
                                                             q_offset, dtype, card):
    """The forward with its lse and the backward at (Dk, Dv) against
    ``ref.flash_attention_fwd_lse`` / ``ref.flash_attention_bwd``, one
    forward launch and one backward call each, every call repeated
    bitwise."""
    gen = torch.Generator().manual_seed(Sq + Sk + Dk)
    q, k, v, do = _dv_case(gen, B, Sq, Sk, H, Dk, Dv, dtype, card)
    scale = Dk ** -0.5
    n0 = (kfa.LAUNCHES, kfa.BWD_LAUNCHES)
    o, lse = kfa.flash_attention_lse_cuda(q, k, v, causal, scale, q_offset)
    got = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal, scale, q_offset)
    assert (kfa.LAUNCHES - n0[0], kfa.BWD_LAUNCHES - n0[1]) == (1, 1)
    o2, lse2 = kfa.flash_attention_lse_cuda(q, k, v, causal, scale, q_offset)
    again = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal, scale, q_offset)
    o_r, lse_r = ref.flash_attention_fwd_lse(q, k, v, causal, scale, None, q_offset)
    want = ref.flash_attention_bwd(q, k, v, lse, do, causal, scale, None, q_offset)
    torch.cuda.synchronize()
    assert tuple(o.shape) == (B, Sq, H, Dv)
    _leafwise((o, lse), (o_r, lse_r), BWD_TOL[dtype])
    _leafwise(got, want, BWD_TOL[dtype])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_mlas_materialized_pair_read_strided_views(dtype, card):
    """q, k and v as the model makes them (views of wider tensors: q and k
    the first 192 columns of 256, v a head-strided view) and do a
    transposed view: the forward and backward equal those of contiguous
    copies bitwise."""
    gen = torch.Generator().manual_seed(31)
    B, S, H = 2, 130, 4
    qk = _randn(gen, B, S, 2, H, 256, dtype=dtype, device=card)[..., :192]
    q, k = qk.unbind(2)
    v = _randn(gen, B, S, 2 * H, 128, dtype=dtype, device=card)[:, :, ::2]
    do = _randn(gen, B, H, S, 128, dtype=dtype, device=card).transpose(1, 2)
    o, lse = kfa.flash_attention_lse_cuda(q, k, v, True, 0.1)
    c = [t.contiguous() for t in (q, k, v, do)]
    o2, lse2 = kfa.flash_attention_lse_cuda(*c[:3], True, 0.1)
    got = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True, 0.1)
    want = kfa.flash_attention_bwd_cuda(*c[:3], lse, c[3], True, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,H,P,N,stride0,dt_scale,sliced", [
    (2, 256, 64, 64, 64, True, 1.0, False),     # zamba2-1.2b's training chunk
    (2, 256, 64, 64, 64, False, 1.0, False),
    (2, 256, 8, 64, 64, True, 1.0, True),       # a chunk slice of S = 2Q
    (4, 32, 8, 16, 16, False, 1.0, False),      # the mamba2 trial's chunk
    (1, 200, 4, 64, 128, True, 1.0, False),     # mamba2-130m's state width
    (2, 32, 3, 8, 4, False, 1.0, False),
    (2, 64, 3, 16, 8, False, 1000.0, False)])   # dt |A| ~ 100
def test_ssd_chunk_bwd_kernel_matches_plain(B, Q, H, P, N, stride0, dt_scale, sliced, card):
    gen = torch.Generator().manual_seed(Q + H + N)
    rows = 2 * Q if sliced else Q
    x, dt, A, Bm, Cm, st = _ssd_inputs(gen, B, rows, H, P, N, card, dt_scale=dt_scale)
    dy = _randn(gen, B, rows, H, P, device=card)
    dst = _randn(gen, B, H, P, N, device=card)
    if stride0:
        Bm, Cm = (t[:, :, :1].expand(B, rows, H, N) for t in (Bm, Cm))
    if sliced:
        sl = slice(Q, 2 * Q)
        x, dt, Bm, Cm, dy = (t[:, sl] for t in (x, dt, Bm, Cm, dy))
    args = (x, dt, A, Bm, Cm, st, dy, dst)
    before = kss.BWD_LAUNCHES
    got = kss.ssd_chunk_bwd_cuda(*args)
    assert kss.BWD_LAUNCHES == before + 1
    again = kss.ssd_chunk_bwd_cuda(*args)
    want = ref.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in got)
    _leafwise(got, want, SSD_BWD_TOL if dt_scale == 1.0 else SSD_BWD_LARGE_DECAY_TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_the_backward_shared_memory_fits_the_configs_chunks(card):
    """The sizes the wrapper reads from the backward's libraries: the tile
    block's shared memory fits a block at the configs' chunks (the same at
    N <= 64 and N = 128), a chunk too long for it raises before a launch,
    and the scratch is four warps' E column sums, a dstate_in part and one
    sum a 64-row tile, then three rows."""
    for Q, N in ((256, 64), (256, 128), (32, 16), (2048, 128)):
        assert kss.ssd_chunk_bwd_smem_bytes(Q, N) <= kss.SMEM_LIMIT
    props = torch.cuda.get_device_properties(card)
    limit = getattr(props, "shared_memory_per_block_optin", kss.SMEM_LIMIT)
    assert kss.ssd_chunk_bwd_smem_bytes(256, 128) <= limit
    assert kss.ssd_chunk_bwd_smem_bytes(256, 64) == kss.ssd_chunk_bwd_smem_bytes(256, 128)
    assert kss.ssd_chunk_bwd_smem_bytes(8704, 64) > kss.SMEM_LIMIT
    assert kss.ssd_chunk_bwd_scratch_floats(256, 64, 64) == 4 * (4 * 256 + 64 * 64 + 1) + 3 * 256
    assert kss.ssd_chunk_bwd_scratch_floats(100, 8, 4) == 2 * (4 * 100 + 32 + 1) + 3 * 100
    gen = torch.Generator().manual_seed(9)
    x, dt, A, Bm, Cm, st = _ssd_inputs(gen, 1, 8704, 1, 8, 4, card)
    dy, dst = _randn(gen, 1, 8704, 1, 8, device=card), _randn(gen, 1, 1, 8, 4, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        kss.ssd_chunk_bwd_cuda(x, dt, A, Bm, Cm, st, dy, dst)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flash f32", "flash bf16", "ssd", "mla f32", "mla bf16"])
def test_backward_kernels_keep_a_nan_of_dy(which, card):
    """A NaN in dy reaches the kernels' gradients as it reaches the plain
    backwards': their tf32 and bf16 splits keep a NaN a NaN, CUDA's
    canonical one (0x7fffffff, which rounding by integers would carry into
    a zero) and its negation among them."""
    gen = torch.Generator().manual_seed(21)
    nan = torch.tensor([0x7FFFFFFF, -1], dtype=torch.int32).view(torch.float32)
    if which.startswith("flash"):
        dtype = torch.float32 if which == "flash f32" else torch.bfloat16
        q, k, v, lse, do = _flash_bwd_case(gen, 1, 80, 80, 2, 64, True, 0, dtype, card)
        do[0, 37, 1, 5], do[0, 60, 0, 9] = nan[0], nan[1]
        got = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True)
        want = ref.flash_attention_bwd(q, k, v, lse, do, True)
        assert torch.isnan(got[0][0, 37, 1]).all()
    elif which.startswith("mla"):
        from repro_torch.kernels import mla_attention_cuda as kmla
        dtype = torch.float32 if which == "mla f32" else torch.bfloat16
        q, k, v, do = _mla_case(gen, 1, 80, 128, 576, 512, dtype, card)
        do[0, 37, 1, 5], do[0, 60, 0, 9] = nan[0], nan[1]
        _, lse = kmla.mla_attention_lse_cuda(q, k, v, True, MLA_SCALE)
        got = kmla.mla_attention_bwd_cuda(q, k, v, lse, do, True, MLA_SCALE)
        want = kmla.mla_bwd_ref(q, k, v, lse, do, True, MLA_SCALE)
        assert torch.isnan(got[0][0, 37, 1]).all()
    else:
        x, dt, A, Bm, Cm, st = _ssd_inputs(gen, 1, 70, 2, 64, 64, card)
        dy, dst = _randn(gen, 1, 70, 2, 64, device=card), _randn(gen, 1, 2, 64, 64, device=card)
        dy[0, 50, 1, 3], dy[0, 10, 0, 7] = nan[0], nan[1]
        got = kss.ssd_chunk_bwd_cuda(x, dt, A, Bm, Cm, st, dy, dst)
        want = ref.ssd_chunk_bwd(x, dt, A, Bm, Cm, st, dy, dst)
    for g, w in zip(got, want):
        assert torch.isnan(w).any() and torch.isnan(g).any()


@pytest.mark.cuda
def test_zamba2_bf16_train_step_runs_the_backward_kernels(card):
    """The reduced zamba2 in bf16 (float32 master), one make_train_step
    step: one flash backward a shared-attention invocation and one SSD
    backward a (Mamba layer, chunk), no plain backward."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.train import batch_to, make_train_step
    from repro_torch.models.context import null_ctx
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True), dtype="bfloat16")
    B, S = 2, 64
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = adamw(1e-3, keep_master=True)
    step = make_train_step(model, opt, null_ctx(remat="none"))
    batch = batch_to(SyntheticLMDataset(cfg, B, S, seed=0).get_batch(0), "cuda")
    calls = []
    real = ref.flash_attention_bwd, ref.ssd_chunk_bwd
    n0 = kfa.BWD_LAUNCHES, kss.BWD_LAUNCHES, kfa.LAUNCHES, kss.LAUNCHES
    try:
        ref.flash_attention_bwd = lambda *a, **k: calls.append("flash") or real[0](*a, **k)
        ref.ssd_chunk_bwd = lambda *a, **k: calls.append("ssd") or real[1](*a, **k)
        state = {"params": params, "opt": opt.init(params)}
        state, m = step(state, batch)
        torch.cuda.synchronize()
    finally:
        ref.flash_attention_bwd, ref.ssd_chunk_bwd = real
    want_fa = model.n_shared_invocations
    want_ss = cfg.n_layers * -(-S // cfg.ssm_chunk)
    assert (kfa.LAUNCHES - n0[2], kss.LAUNCHES - n0[3]) == (want_fa, want_ss)
    assert (kfa.BWD_LAUNCHES - n0[0], kss.BWD_LAUNCHES - n0[1]) == (want_fa, want_ss)
    assert calls == [] and bool(torch.isfinite(m["loss"]))


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


# ---------------------------------------------------------------------------
# the training-backend slice: the kernels at the trials' and whisper's shapes
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, D, causal): the reduced trials at D = 16 (qwen, whisper's
# decoder self-attention, its encoder over Se = 30 frames and its
# cross-attention, Sq = 32 against Sk = 30), and whisper-base at full width
# (the encoder over 1500 frames, a ragged last key tile, and the
# cross-attention of a 256-token prompt against them)
SLICE_FLASH_SHAPES = [
    (4, 32, 32, 4, 16, True), (2, 32, 32, 4, 16, True),
    (4, 30, 30, 4, 16, False), (4, 32, 30, 4, 16, False),
    (2, 1500, 1500, 8, 64, False), (2, 256, 1500, 8, 64, False),
    (2, 256, 256, 8, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", SLICE_FLASH_SHAPES)
def test_flash_attention_kernel_at_the_trials_and_whispers_shapes(
        B, Sq, Sk, H, D, causal, dtype, card):
    gen = torch.Generator().manual_seed(Sq + Sk + D)
    q = _randn(gen, B, Sq, H, D, dtype=dtype, device=card)
    k, v = (_randn(gen, B, Sk, H, D, dtype=dtype, device=card) for _ in range(2))
    before = kfa.LAUNCHES
    o = ops.flash_attention(q, k, v, causal)
    assert kfa.LAUNCHES == before + 1
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 2])
def test_ssd_chunk_kernel_at_the_mamba2_trials_shape(B, card):
    """mamba2-130m reduced: Q = 32, H = 8, P = N = 16, B and C with head
    stride 0 (one group), where the wgmma tiles are mostly padding."""
    gen = torch.Generator().manual_seed(B)
    x, dt, A, _, _, st = _ssd_inputs(gen, B, 32, 8, 16, 16, card)
    Bm, Cm = _stride0(gen, B, 32, 8, 16, card)
    before = kss.LAUNCHES
    y, s = ops.ssd_chunk(x, dt, A, Bm, Cm, st)
    assert kss.LAUNCHES == before + 1
    y2, s2 = ref.ssd_chunk_ref(x, dt, A, Bm, Cm, st)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y2, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(s, s2, rtol=SSD_TOL, atol=SSD_TOL)


# the trials' bf16 streams, card against CPU (tests/test_torch_train.py
# states the reason for the bound against the JAX package; the card and the
# CPU also round bf16 products at different places)
TRIAL_RTOL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m", "whisper-base"])
def test_training_trials_replay_bitwise_on_the_card(arch, card):
    """C5 on the card: the replayer's state at a mid step equals the
    cursor's on every leaf, and the card's stream follows the CPU's from
    the same initial state."""
    from repro_torch.backends.training import (TRAINING_WORKLOADS,
                                               TrainingTrialBackend, _to_host)
    from repro_torch.core.trial import TrialSpec
    from repro_torch.optim.optimizers import tree_leaves

    w = TRAINING_WORKLOADS[arch]
    t = TrialSpec(w, w.hp_grid()[0], 0)
    be = TrainingTrialBackend()
    run = be._run(t)
    before = kfa.LAUNCHES, kss.LAUNCHES
    be._ensure(run, 6)
    at6 = _to_host(run.trainer.state)
    be._ensure(run, 12)
    launched = kfa.LAUNCHES - before[0], kss.LAUNCHES - before[1]
    assert launched[1 if arch == "mamba2-130m" else 0] > 0
    replayed = be._host_state(run, 6)
    for a, b in zip(tree_leaves(replayed), tree_leaves(at6)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    cpu = TrainingTrialBackend(device="cpu")
    crun = cpu._run(t)
    crun.trainer.state = cpu._to_device(run.state0)
    cpu._ensure(crun, 12)
    np.testing.assert_allclose(run.trainer.metrics_vals, crun.trainer.metrics_vals,
                               rtol=TRIAL_RTOL)


# --------------------------------------------------------------------------
# the last model families: flash attention at D = 128 behind GQA (grok-1,
# G = 6; pixtral-12b, G = 4), and the reduced moe and vlm models
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,KV,G", [(2, 256, 8, 6), (1, 1280, 8, 4),
                                      (2, 77, 2, 6), (1, 200, 2, 4)])
def test_flash_attention_d128_behind_gqa_matches_plain(B, S, KV, G, dtype, card):
    """``models.attention.attention`` with K/V repeated to the KV * G query
    heads, through the kernel (one launch on the dtype's route) against the
    plain version, at the flash tolerances (float32 3e-5, bf16 4e-2)."""
    from repro_torch.models import attention as attn_lib
    gen = torch.Generator().manual_seed(S + G)
    q = _randn(gen, B, S, KV, G, 128, dtype=dtype, device=card)
    k, v = (_randn(gen, B, S, KV, 128, dtype=dtype, device=card) for _ in range(2))
    before = kfa.LAUNCHES, kfa.WGMMA_LAUNCHES, kfa.TF32_LAUNCHES
    with torch.no_grad():
        o = attn_lib.attention(q, k, v, causal=True)
        want = attn_lib.attention(q, k, v, causal=True, kernels="ref")
    bf16 = dtype == torch.bfloat16
    assert (kfa.LAUNCHES - before[0], kfa.WGMMA_LAUNCHES - before[1],
            kfa.TF32_LAUNCHES - before[2]) == (1, int(bf16), int(not bf16))
    tol = 4e-2 if bf16 else 3e-5
    torch.testing.assert_close(o.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b", "pixtral-12b"])
def test_reduced_moe_and_vlm_models_on_the_card_match_the_cpu(arch, card):
    """The reduced float32 model on the card and on the CPU from the same
    weights: prefill logits and every cache leaf within 1e-4, equal greedy
    tokens; flash launches a prefill: one a layer (grok-1, pixtral), none
    on MLA's plain route (deepseek-v2)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models.inputs import sample_train_batch
    from repro_torch.models.model import Model, tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(card), params)
    n = 20 + (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = sample_train_batch(np.random.default_rng(1), cfg, 2, n)
    pre = {k: (torch.as_tensor(v).long() if k == "tokens" else v)
           for k, v in batch.items() if k != "labels"}
    fa = kfa.LAUNCHES
    with torch.no_grad():
        lg, cache = Model(cfg).prefill(on_card, {k: v.to(card) for k, v in pre.items()},
                                       cache_len=n + 12)
        lg_cpu, cache_cpu = Model(cfg).prefill(params, pre, cache_len=n + 12)
    assert kfa.LAUNCHES - fa == (0 if cfg.use_mla else cfg.n_layers)
    torch.testing.assert_close(lg.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(cache), tree_leaves(cache_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    got = Server(cfg, on_card, max_len=n + 12, device=card).generate(pre, 12)
    want = Server(cfg, params, max_len=n + 12, device="cpu").generate(pre, 12)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b", "pixtral-12b"])
def test_reduced_family_train_step_at_the_configs_precision_card_against_cpu(
        arch, run, card):
    """One ``Trainer`` step of the reduced model at its full config's
    optimizer precision (grok-1, deepseek-v2: ``moments_fp32``, no master;
    pixtral-12b: ``fp32``), on the card against the same step on the CPU
    from the same weights, through the flash kernel's forward (none for
    MLA): the loss within 1e-2 relative, each leaf within 1e-2 of its
    norm, and the step's change of each parameter and master leaf (new -
    old) within 0.75 of the CPU's (``chip_smoke.py``'s ``A15_CHANGE_TOL``:
    a missing update is 1).  "bf16" holds the parameters and the master
    copy; its moments, the two devices' bf16 gradients, part by up to ~14 % of a leaf's norm
    where the kernel's bf16 rounding meets a cancelling sum or a near-tied
    route (grok-1's; ~1 % with the card's attention plain).  "f32" (the
    3xTF32 kernel) holds every leaf, the moments too."""
    import dataclasses
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import Trainer
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              opt_precision=get_config(arch).opt_precision,
                              dtype="float32" if run == "f32" else "bfloat16")
    seq = 24 + (cfg.n_patches if cfg.family == "vlm" else 0)
    runs = {}
    for dev in (card, "cpu"):
        fa = kfa.LAUNCHES
        tr = Trainer(cfg, batch=2, seq=seq, lr=1e-3, seed=0, val_every=1, device=dev)
        start = {p: t.detach().cpu().double() for p, t in leaf_paths(tr.state["params"])}
        tr.run_steps(1)
        runs[str(dev)] = (tr.metrics_vals[0], dict(leaf_paths(tr.state)),
                          kfa.LAUNCHES - fa)
    (lc, sc, nc), (lh, sh, nh) = runs["cuda"], runs["cpu"]
    assert nc == (0 if cfg.use_mla else cfg.n_layers) and nh == 0
    assert ("['opt']['master']" in "".join(sh)) == (cfg.opt_precision == "fp32")
    assert abs(lc - lh) <= 1e-2 * abs(lh)
    for path, want in sh.items():
        if not isinstance(want, torch.Tensor):
            assert sc[path] == want
            continue
        if run == "bf16" and path.startswith(("['opt']['m']", "['opt']['v']")):
            continue
        got = sc[path].cpu().double()
        assert (got - want.double()).norm() <= 1e-2 * want.double().norm(), path
        if path.startswith(("['params']", "['opt']['master']")):
            # the master copy started as the parameters cast up
            w0 = start[path.removeprefix("['opt']['master']").removeprefix("['params']")]
            dw = want.double() - w0
            assert (got - w0 - dw).norm() <= 0.75 * dw.norm(), (path, "change")


@pytest.mark.cuda
def test_restore_onto_the_one_card_nccl_mesh_and_decode(card, tmp_path):
    """The reduced qwen1.5-0.5b trained two steps on the card, saved,
    restored through ``ElasticTrial.restore_onto`` onto ``slice_mesh()`` of
    a NCCL group of one: every leaf equal to the saved one, flash launches
    in the training steps; then the reduced deepseek-v2 (MLA, a distributed
    decode plan even on one card) decodes on that mesh the tokens of its
    decode with no mesh."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.checkpoint import LocalObjectStore
    from repro_torch.configs.base import get_config
    from repro_torch.launch.elastic import ElasticTrial, full_state, slice_mesh
    from repro_torch.launch.mesh import init_world_of_one
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Policy
    from repro_torch.launch.train import Trainer
    from repro_torch.models.model import Model, tree_leaves
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    fa = kfa.LAUNCHES
    tr = Trainer(cfg, batch=2, seq=32, device=card)
    tr.run_steps(2)
    assert kfa.LAUNCHES - fa == 2 * cfg.n_layers
    trial = ElasticTrial(cfg, LocalObjectStore(str(tmp_path / "s")), "t")
    trial.save(tr.step, tr.state)
    started = init_world_of_one(card)
    try:
        assert "nccl" in str(dist.get_backend())
        mesh = slice_mesh()
        state, step = trial.restore_onto(mesh, tr.state)
        assert step == 2
        for a, b in zip(tree_leaves(tr.state), tree_leaves(state)):
            assert (torch.equal(b.to_local(), a) if isinstance(a, torch.Tensor)
                    else a == b)
        prompts = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))}
        moved = Server(cfg, full_state(state["params"]), max_len=24, device=card)
        kept = Server(cfg, tr.state["params"], max_len=24, device=card)
        assert torch.equal(moved.generate(prompts, 8), kept.generate(prompts, 8))

        mla = dataclasses.replace(get_config("deepseek-v2-236b", reduced=True),
                                  dtype="float32")
        params = Model(mla).init(torch.Generator().manual_seed(0), device=card)
        ctx = Policy(mla, mesh, "decode").ctx(decode=True, batch=2)
        assert ctx.decode_attn == "distributed" and ctx.sharded_decode
        prompts = {"tokens": np.random.default_rng(2).integers(0, mla.vocab_size, (2, 8))}
        got = Server(mla, params, ctx=ctx, max_len=24, device=card).generate(prompts, 8)
        want = Server(mla, params, max_len=24, device=card).generate(prompts, 8)
        assert torch.equal(got, want)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.fixture
def one_card_mesh(card):
    """A (1, 1) ("data", "model") mesh over a NCCL group of one."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world_of_one, make_small_mesh
    started = init_world_of_one(card)
    try:
        yield make_small_mesh((1, 1), device_type="cuda")
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_zamba2_trains_through_the_kernels_as_the_no_mesh_path(one_card_mesh):
    """The reduced zamba2 (float32) under ``Policy(..., "train",
    dp_only_threshold=0).ctx()`` on the one-card mesh ("kv", ``ssm_x``,
    ``residual``, ``logits_sp``): the loss within 1e-5 relative and every
    gradient leaf within 1e-4 of its largest of the no-mesh path's (the
    same remat and key chunk), the flash and SSD-chunk launches equal."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd_chunk_cuda as kss
    from repro_torch.launch.sharding import Policy, place, place_batch
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.context import null_ctx
    from repro_torch.models.inputs import sample_train_batch
    from repro_torch.models.model import Model, tree_leaves
    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = {k: torch.as_tensor(np.asarray(v), device="cuda").long()
             for k, v in sample_train_batch(np.random.default_rng(0), cfg, 2, 64).items()}
    policy = Policy(cfg, one_card_mesh, "train", global_batch=2, dp_only_threshold=0)
    ctx = policy.ctx()
    assert ctx.rules["attn_mode"] == "kv" and "ssm_x" in ctx.rules

    def run(p, b, c):
        counts = kfa.LAUNCHES, kss.LAUNCHES
        loss, _, grads = loss_and_grads(model, p, b, c)
        torch.cuda.synchronize()
        return loss, grads, (kfa.LAUNCHES - counts[0], kss.LAUNCHES - counts[1])

    loss, grads, n = run(place(params, policy.param_shardings(params)),
                         place_batch(batch, policy), ctx)
    loss0, grads0, n0 = run(params, batch, null_ctx(remat="full",
                                                   attn_chunk=ctx.attn_chunk))
    assert n == n0 and n[0] > 0 and n[1] > 0
    assert abs(float(loss.full_tensor()) - float(loss0)) <= 1e-5 * abs(float(loss0))
    for g, g0 in zip(tree_leaves(grads), tree_leaves(grads0)):
        g = g.full_tensor()
        assert (g - g0).abs().max() <= 1e-4 * g0.abs().max().clamp_min(1e-30)


@pytest.mark.cuda
def test_sharded_deepseek_prefill_runs_the_ep_body_as_the_no_mesh_prefill(one_card_mesh):
    """The reduced deepseek-v2 prefill under ``Policy(..., "prefill",
    dp_only_threshold=0).ctx()`` on the one-card mesh: MoE through the
    shard_map body ("ep", e_start 0), MLA on DTensors; the last-position
    logits within 1e-4 of the no-mesh prefill's."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Policy
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("deepseek-v2-236b", reduced=True), dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)),
                             device="cuda")
    ctx = Policy(cfg, one_card_mesh, "prefill", dp_only_threshold=0).ctx()
    got, _ = Server(cfg, params, ctx=ctx, max_len=32, device="cuda").prefill(tokens)
    want, _ = Server(cfg, params, max_len=32, device="cuda").prefill(tokens)
    assert (got.full_tensor() - want).abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_operators_match_plain_and_their_shape_functions(dtype, card):
    """The launches as ``torch.library`` operators on the card: each
    operator equals its plain version, adds one launch, and its shape
    function gives fake copies of the inputs outputs of the real outputs'
    shapes, types and devices."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator().manual_seed(9)
    q, k, v = (_randn(gen, 2, 96, 4, 64, device=card, dtype=dtype) for _ in range(3))
    ssd = _ssd_inputs(gen, 2, 64, 4, 16, 16, card)
    ops_ = torch.ops.repro_torch
    n0 = kfa.LAUNCHES, kss.LAUNCHES
    with torch.no_grad():
        o = ops_.flash_attention(q, k, v, True, None)
        o2, lse = ops_.flash_attention_lse(q, k, v, False, 0.25)
        y, st = ops_.ssd_chunk(*ssd)
    torch.cuda.synchronize()
    assert (kfa.LAUNCHES - n0[0], kss.LAUNCHES - n0[1]) == (2, 1)
    tol = TOL[dtype] if dtype == torch.bfloat16 else 3e-5
    assert (o.float() - ref.flash_attention_ref(q, k, v, True).float()).abs().max() <= tol
    ro, rl = ref.flash_attention_fwd_lse(q, k, v, False, 0.25)
    assert (o2.float() - ro.float()).abs().max() <= tol
    assert (lse - rl).abs().max() <= 1e-4
    ry, rs = ref.ssd_chunk_ref(*ssd)
    assert (y - ry).abs().max() <= 1e-4 * ry.abs().max()
    assert (st - rs).abs().max() <= 1e-4 * rs.abs().max()
    mode = FakeTensorMode()
    fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
    fs = [mode.from_tensor(t) for t in ssd]
    with mode:
        fakes = [ops_.flash_attention(fq, fk, fv, True, None),
                 *ops_.flash_attention_lse(fq, fk, fv, False, 0.25),
                 *ops_.ssd_chunk(*fs)]
    for f, r in zip(fakes, (o, o2, lse, y, st)):
        assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype, r.device)
    assert (kfa.LAUNCHES - n0[0], kss.LAUNCHES - n0[1]) == (2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b", "whisper-base"])
def test_ssm_hybrid_audio_decode_on_the_one_card_mesh(arch, one_card_mesh):
    """The reduced float32 model served on the one-card mesh under the
    decode policy's "local" and "distributed" plans, and under a prefill
    policy's ctx: the no-mesh tokens."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Policy
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8))}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.enc_seq_len, cfg.d_model, device="cuda") * 0.02
    want = Server(cfg, params, max_len=24, device="cuda").generate(batch, 8)
    policy = Policy(cfg, one_card_mesh, "decode")
    for b in (2, None):
        ctx = policy.ctx(decode=True, batch=b)
        got = Server(cfg, params, ctx=ctx, max_len=24, device="cuda").generate(batch, 8)
        assert torch.equal(got, want), ctx.decode_plan
    ctx = Policy(cfg, one_card_mesh, "prefill").ctx()
    got = Server(cfg, params, ctx=ctx, max_len=24, device="cuda").generate(batch, 8)
    assert torch.equal(got, want)


# ------------------------------------------------- MLA's absorbed attention

MLA_SCALE = 192 ** -0.5       # deepseek-v2's (qk_nope + qk_rope) ** -0.5
MLA_CASES = [(2, 256, 128, 576, 512, True),   # deepseek-v2's training shape
             (2, 24, 4, 40, 32, True),        # the reduced deepseek-v2
             (1, 200, 128, 576, 512, True),   # ragged: S not a multiple of 64
             (1, 200, 4, 40, 32, True), (2, 70, 3, 72, 64, True),
             (2, 256, 128, 576, 512, False), (1, 97, 6, 40, 32, False),
             (1, 1, 128, 576, 512, True),     # one position
             (1, 130, 96, 576, 512, True),    # a 64-row tile spans two positions
             (1, 2048, 16, 576, 512, True)]   # keys past 256


def _mla_case(gen, B, S, H, Dk, Dv, dtype, device):
    q = _randn(gen, B, S, H, Dk, dtype=dtype, device=device)
    k = _randn(gen, B, S, Dk, dtype=dtype, device=device)
    v = _randn(gen, B, S, Dv, dtype=dtype, device=device)
    do = _randn(gen, B, S, H, Dv, dtype=dtype, device=device)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Dk,Dv,causal", MLA_CASES)
def test_mla_attention_kernels_match_plain(B, S, H, Dk, Dv, causal, dtype, card):
    """The forward (o and lse) and the backward (dq, dk, dv) against
    ``ref.flash_attention_fwd_lse`` / ``ref.flash_attention_bwd`` at one
    K/V head, within BWD_TOL of each output's largest; every call repeats
    bitwise; each call counts one launch."""
    from repro_torch.kernels import mla_attention_cuda as kmla
    gen = torch.Generator().manual_seed(S + H + Dk)
    q, k, v, do = _mla_case(gen, B, S, H, Dk, Dv, dtype, card)
    n0 = kmla.LAUNCHES, kmla.BWD_LAUNCHES
    o, lse = kmla.mla_attention_lse_cuda(q, k, v, causal, MLA_SCALE)
    got = kmla.mla_attention_bwd_cuda(q, k, v, lse, do, causal, MLA_SCALE)
    assert (kmla.LAUNCHES - n0[0], kmla.BWD_LAUNCHES - n0[1]) == (1, 1)
    o2, lse2 = kmla.mla_attention_lse_cuda(q, k, v, causal, MLA_SCALE)
    again = kmla.mla_attention_bwd_cuda(q, k, v, lse, do, causal, MLA_SCALE)
    o_ref, lse_ref = kmla.mla_fwd_lse_ref(q, k, v, causal, MLA_SCALE)
    want = kmla.mla_bwd_ref(q, k, v, lse, do, causal, MLA_SCALE)
    torch.cuda.synchronize()
    _leafwise((o, lse), (o_ref, lse_ref), BWD_TOL[dtype])
    _leafwise(got, want, BWD_TOL[dtype])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views at a 4-byte offset", "v in k"])
def test_mla_attention_float32_reads_views_and_the_models_layout(layout, card):
    """Float32 q and k as views 4 bytes past a 16-byte boundary (the wrapper
    copies them: a TMA tensor map needs a 16-byte aligned base), and the
    model's layout (v the first Dv columns of k, a strided view): the
    kernels match the plain versions within 1e-4 of each output's largest
    and repeat bitwise."""
    from repro_torch.kernels import mla_attention_cuda as kmla
    B, S, H, Dk, Dv = 1, 130, 8, 576, 512
    gen = torch.Generator().manual_seed(53)
    q, k, v, do = _mla_case(gen, B, S, H, Dk, Dv, torch.float32, card)
    if layout == "v in k":
        v = k[..., :Dv]
    else:
        q = _randn(gen, B * S * H * Dk + 1, device=card)[1:].view(B, S, H, Dk)
        k = _randn(gen, B * S * Dk + 1, device=card)[1:].view(B, S, Dk)
        assert q.data_ptr() % 16 == 4 and k.data_ptr() % 16 == 4
    o, lse = kmla.mla_attention_lse_cuda(q, k, v, True, MLA_SCALE)
    got = kmla.mla_attention_bwd_cuda(q, k, v, lse, do, True, MLA_SCALE)
    o2, lse2 = kmla.mla_attention_lse_cuda(q, k, v, True, MLA_SCALE)
    again = kmla.mla_attention_bwd_cuda(q, k, v, lse, do, True, MLA_SCALE)
    o_ref, lse_ref = kmla.mla_fwd_lse_ref(q, k, v, True, MLA_SCALE)
    want = kmla.mla_bwd_ref(q, k, v, lse, do, True, MLA_SCALE)
    torch.cuda.synchronize()
    _leafwise((o, lse), (o_ref, lse_ref), BWD_TOL[torch.float32])
    _leafwise(got, want, BWD_TOL[torch.float32])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_attention_function_and_latent_attention_take_the_kernels(dtype, card):
    """``ops.mla_attention`` with a gradient takes ``MlaAttention`` (a
    forward and a backward launch), without one the forward kernel; the
    model's ``latent_attention`` on card tensors launches the forward kernel
    and no flash kernel."""
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.models import mla
    from repro_torch.models.context import null_ctx
    gen = torch.Generator().manual_seed(31)
    q, k, v, do = _mla_case(gen, 2, 64, 4, 40, 32, dtype, card)
    n0 = kmla.LAUNCHES, kmla.BWD_LAUNCHES, kfa.LAUNCHES, kfa.BWD_LAUNCHES
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ops.mla_attention(*leaves, True, MLA_SCALE)
    grads = torch.autograd.grad(o, leaves, do)
    with torch.no_grad():
        o2 = mla.latent_attention(q, k, v, True, MLA_SCALE, null_ctx())
    assert (kmla.LAUNCHES - n0[0], kmla.BWD_LAUNCHES - n0[1]) == (2, 1)
    assert (kfa.LAUNCHES, kfa.BWD_LAUNCHES) == n0[2:]
    o_ref, lse = kmla.mla_fwd_lse_ref(q, k, v, True, MLA_SCALE)
    _leafwise((o.detach(), o2), (o_ref, o_ref), BWD_TOL[dtype])
    _leafwise(grads, kmla.mla_bwd_ref(q, k, v, lse, do, True, MLA_SCALE), BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_attention_backward_keeps_a_nan_of_do(dtype, card):
    """A NaN in do (CUDA's canonical one and its negation) reaches the
    kernels' gradients as it reaches the plain backward's: the dq of its
    (position, head) is all NaN, and every gradient holds one."""
    from repro_torch.kernels import mla_attention_cuda as kmla
    gen = torch.Generator().manual_seed(41)
    q, k, v, do = _mla_case(gen, 1, 80, 4, 40, 32, dtype, card)
    nan = torch.tensor([0x7FFFFFFF, -1], dtype=torch.int32).view(torch.float32)
    do[0, 37, 1, 5], do[0, 60, 0, 9] = nan[0], nan[1]
    _, lse = kmla.mla_attention_lse_cuda(q, k, v, True, MLA_SCALE)
    got = kmla.mla_attention_bwd_cuda(q, k, v, lse, do, True, MLA_SCALE)
    want = kmla.mla_bwd_ref(q, k, v, lse, do, True, MLA_SCALE)
    assert torch.isnan(got[0][0, 37, 1]).all()
    for g, w in zip(got, want):
        assert torch.isnan(w).any() and torch.isnan(g).any()


@pytest.mark.cuda
def test_mla_attention_shared_memory_plan_is_the_kernels(card):
    """``mla_smem_bytes`` / ``mla_bwd_smem_bytes`` are what the library's
    launches take (the forward, the backward's rows and keys launches), at
    widths that change the bf16 plan, and fit a block."""
    from repro_torch.kernels import hopper
    from repro_torch.kernels import mla_attention_cuda as kmla
    lib = kmla._lib()
    props = torch.cuda.get_device_properties(card)
    limit = getattr(props, "shared_memory_per_block_optin", hopper.SMEM_PER_BLOCK)
    for Dk, Dv in ((576, 512), (40, 32), (72, 64), (256, 256), (264, 264), (320, 320),
                   (512, 512), (520, 8)):
        fwd = lib.mla_attention_smem_bytes(Dv, 1, 0)
        bwd = max(lib.mla_attention_smem_bytes(Dv, 1, 1), lib.mla_attention_smem_bytes(Dv, 1, 2))
        assert (fwd, bwd) == (kmla.mla_smem_bytes(Dk, Dv, torch.bfloat16),
                              kmla.mla_bwd_smem_bytes(Dk, Dv, torch.bfloat16)), (Dk, Dv)
        f32 = (lib.mla_attention_smem_bytes(Dv, 0, 0),
               max(lib.mla_attention_smem_bytes(Dv, 0, 1), lib.mla_attention_smem_bytes(Dv, 0, 2)))
        assert f32 == (kmla.mla_smem_bytes(Dk, Dv, torch.float32),
                       kmla.mla_bwd_smem_bytes(Dk, Dv, torch.float32)), (Dk, Dv)
        assert max(fwd, bwd, *f32) <= limit


@pytest.mark.cuda
def test_mla_attention_kernels_refuse_shapes_outside_their_contract(card):
    from repro_torch.kernels import mla_attention_cuda as kmla
    q = torch.zeros(1, 8, 4, 584, device=card)
    k, v = torch.zeros(1, 8, 584, device=card), torch.zeros(1, 8, 32, device=card)
    with pytest.raises(ValueError, match=r"q \(1, 8, 4, 584\).*Dk <= 576"):
        kmla.mla_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kmla.mla_attention_cuda(q[..., :40], k[..., :40].cpu(), v)
