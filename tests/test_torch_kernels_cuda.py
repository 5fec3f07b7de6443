"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card, since a CUDA kernel has
no CPU mode.  The file imports only ``torch`` and ``repro_torch``, so it
runs where JAX is not installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from repro_torch.core import revpred as rp
from repro_torch.kernels import lstm_cell as klc
from repro_torch.kernels import ops, ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
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
