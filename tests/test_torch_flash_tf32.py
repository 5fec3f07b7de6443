"""The precision argument of the float32 flash-attention kernel (3xTF32).

``csrc/flash_attention.cu`` runs float32 attention on the tensor cores in
TF32, each float32 operand split as hi = tf32(x) and lo = x - hi, whose
13 low bits the tensor core drops (``_tf32.py``'s "bits"), and every
product lo.hi + hi.lo + hi.hi summed in float32.  ``_flash_tf32``
repeats the kernel's arithmetic in plain torch on the CPU (``_tf32.py``):
64-key tiles, S = Q.K^T in 8-wide k steps, the scores scaled by
scale * log2(e) and masked with -1e30, the online softmax with exp2, P's
keys permuted inside each 8-wide k step as the kernel stages them (slot t
holds key 2t, slot t + 4 key 2t + 1) and P.V in 8-key steps, the row sum
floored at 1e-30.  It is a test of the precision argument, on no path of
the port; the kernel itself is held to the plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)
from _tf32 import mm as _mm

from repro_torch.kernels import ref

TOL = 3e-5                # the float32 contract (tests/test_kernels.py)


def mm(eq, a, b, terms):
    """The forward's products: hi rounded, lo truncated (``Round::bits``)."""
    return _mm(eq, a, b, terms, "bits")
BN = 64                   # keys per tile
# A slot -> key inside an 8-wide k step: slot t takes key 2t, t + 4 key 2t + 1
SLOT_KEY = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _flash_tf32(q, k, v, causal, terms, scale=None):
    """``ref.flash_attention_ref`` computed as the float32 kernel does, with
    ``terms`` TF32 products per float32 product (3, or 1 for comparison)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    c = (scale if scale is not None else D ** -0.5) * math.log2(math.e)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros(B, H, Sq)
    o = torch.zeros(B, H, Sq, D)
    rows = torch.arange(Sq)[:, None]
    slots = torch.cat([8 * g + SLOT_KEY for g in range(BN // 8)])
    for k0 in range(0, Sk, BN):
        kt, vt = k[:, k0:k0 + BN], v[:, k0:k0 + BN]
        pad = torch.zeros(B, BN - kt.shape[1], H, D)    # keys past Sk are zeros
        kt, vt = torch.cat([kt, pad], 1), torch.cat([vt, pad], 1)
        s = torch.zeros(B, H, Sq, BN)
        for d0 in range(0, D, 8):
            s = s + mm("bqhd,bkhd->bhqk", q[..., d0:d0 + 8], kt[..., d0:d0 + 8], terms)
        s = s * c
        keys = k0 + torch.arange(BN)[None, :]
        masked = (keys >= Sk) | ((keys > rows) if causal else torch.zeros_like(keys > rows))
        s = torch.where(masked, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None]
        p, vt = p[..., slots], vt[:, slots]        # P's A fragments, V^T's rows
        for j0 in range(0, BN, 8):
            o = o + mm("bhqk,bkhd->bhqd", p[..., j0:j0 + 8], vt[:, j0:j0 + 8], terms)
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3)


def _attention_f64(q, k, v, causal, scale=None):
    """The plain version's formula in float64: the exact result the float32
    versions are both rounded from."""
    q, k, v = q.double(), k.double(), v.double()
    D, Sq, Sk = q.shape[-1], q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (scale if scale is not None
                                                 else D ** -0.5)
    if causal:
        keep = torch.arange(Sq)[:, None] >= torch.arange(Sk)[None, :]
        s = torch.where(keep, s, torch.tensor(-1e30, dtype=torch.float64))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _inputs(seed, B, Sq, Sk, H, D, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)) * q_scale
    k, v = (rng.standard_normal((B, Sk, H, D)) for _ in range(2))
    return [torch.from_numpy(a.astype(np.float32)) for a in (q, k, v)]


def _within(got, want, tol=TOL):
    return torch.allclose(got.double(), want.double(), rtol=tol, atol=tol)


# phi3-mini's width (D = 96, S = 256), zamba2-1.2b's (D = 64, S = 512), two
# heads each, and Sq != Sk both ways
@pytest.mark.parametrize("B,Sq,Sk,H,D", [
    (1, 256, 256, 2, 96),
    (1, 512, 512, 2, 64),
    (1, 200, 237, 2, 64),
    (1, 237, 200, 2, 96),
])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_holds_the_contract_and_1xtf32_does_not(B, Sq, Sk, H, D, causal):
    """The kernel's arithmetic with 3xTF32 products is within 3e-5 of
    ``ref.flash_attention_ref``; with one TF32 product per float32 product
    it is not, which is why the kernel splits."""
    q, k, v = _inputs(Sq + D, B, Sq, Sk, H, D)
    want = ref.flash_attention_ref(q, k, v, causal)
    got3 = _flash_tf32(q, k, v, causal, terms=3)
    assert got3.shape == want.shape
    torch.testing.assert_close(got3, want, rtol=TOL, atol=TOL)
    assert not _within(_flash_tf32(q, k, v, causal, terms=1), want)


@pytest.mark.parametrize("causal", [True, False])
def test_large_scores_meet_float32_resolution(causal):
    """Scores of order 30 (q scaled by 30): float32 itself cannot hold the
    3e-5 contract there, for its rounding of the scores is ~1e-5: the
    float32 plain version is beyond 3e-5 of the exact (float64) result.  At
    q x 8 (the card test's scale) both it and the kernel's 3xTF32
    arithmetic are within 3e-5 of the exact result."""
    q, k, v = _inputs(7, 2, 333, 333, 4, 128)
    exact = _attention_f64(q * 30, k, v, causal)
    assert not _within(ref.flash_attention_ref(q * 30, k, v, causal), exact)
    exact = _attention_f64(q * 8, k, v, causal)
    assert _within(ref.flash_attention_ref(q * 8, k, v, causal), exact)
    assert _within(_flash_tf32(q * 8, k, v, causal, terms=3), exact)
