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
from repro_torch.kernels import ops, ref, soa_step
from repro_torch.kernels import soa_step_cuda as ksc

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
    before = klc.LAUNCHES
    with torch.inference_mode():
        lg = rp.revpred_logits(params, hist, present)
        lg_ref = rp.revpred_logits(params, hist, present, force="ref")
    assert klc.LAUNCHES == before + 3 * rp.HISTORY
    torch.testing.assert_close(lg, lg_ref, rtol=1e-4, atol=1e-4)


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
