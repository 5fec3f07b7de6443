"""The port's SSD chunk path against the JAX package's Pallas kernel.

On this CPU host ``ops.ssd_chunk`` takes its plain version
(``repro_torch.kernels.ref.ssd_chunk_ref``); the Pallas kernel runs in
interpret mode as ``tests/test_kernels.py`` runs it, at its tolerance 1e-4.
``ssd_chunked`` (the host loop over chunks) is held to the JAX package's
``lax.scan`` version and to its per-token oracle.  The CUDA kernel itself is
held to the plain version on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)
from _tf32 import mm as _mm, tf32 as _tf32

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import ssd as jssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk_cuda as ksc
from repro_torch.models import ssd as tssd

TOL = 1e-4


def _inputs(rng, B, Q, H, P, N, dt_hi=0.1, state=True):
    arrs = [rng.standard_normal((B, Q, H, P)),
            rng.uniform(0.001, dt_hi, (B, Q, H)),
            -rng.uniform(0.5, 2.0, (H,)),
            rng.standard_normal((B, Q, H, N)),
            rng.standard_normal((B, Q, H, N))]
    if state:
        arrs.append(rng.standard_normal((B, H, P, N)))
    arrs = [a.astype(np.float32) for a in arrs]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Q,H,P,N", [
    (2, 32, 3, 8, 4),
    (1, 64, 2, 16, 8),
    (3, 16, 1, 4, 4),
])
def test_ssd_chunk_matches_pallas_and_oracle(B, Q, H, P, N):
    j, t = _inputs(np.random.default_rng(0), B, Q, H, P, N)
    before = ksc.LAUNCHES
    y, s = ops.ssd_chunk(*t)
    assert ksc.LAUNCHES == before            # the CPU takes the plain version
    assert y.shape == (B, Q, H, P) and s.shape == (B, H, P, N)
    assert y.dtype == s.dtype == torch.float32
    y2, s2 = ssd_chunk_pallas(*j, interpret=True)
    _close(y, y2)
    _close(s, s2)
    y3, s3 = jref.ssd_chunk_ref(*j)
    _close(y, y3)
    _close(s, s3)


def test_ssd_chunk_large_decay_stays_finite():
    """dt·|A| near 100: above the diagonal cum_i - cum_j is large and
    positive, so an exp before the mask would overflow."""
    j, t = _inputs(np.random.default_rng(1), 2, 32, 3, 8, 4)
    j[1] = j[1] * 0 + 60.0
    t[1] = torch.full_like(t[1], 60.0)
    y, s = ops.ssd_chunk(*t)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y2, s2 = jref.ssd_chunk_ref(*j)
    _close(y, y2, tol=1e-3)
    _close(s, s2, tol=1e-3)


@pytest.mark.parametrize("S,chunk,with_state", [
    (45, 16, False),      # 3 chunks, the last padded with dt = 0
    (64, 16, True),       # 4 whole chunks from a given state
    (7, 16, True),        # one chunk shorter than the chunk size
])
def test_ssd_chunked_matches_reference(S, chunk, with_state):
    rng = np.random.default_rng(2)
    j, t = _inputs(rng, 2, S, 3, 8, 4, state=False)
    st = rng.standard_normal((2, 3, 8, 4)).astype(np.float32) if with_state else None
    jst = jnp.asarray(st) if with_state else None
    tst = torch.from_numpy(st) if with_state else None
    y, s = tssd.ssd_chunked(*t, chunk, state=tst)
    y2, s2 = jssd.ssd_chunked(*j, chunk, state=jst)
    _close(y, y2)
    _close(s, s2)
    y3, s3 = jssd.ssd_ref(*j, state=jst)
    _close(y, y3)
    _close(s, s3)
    y4, s4 = tssd.ssd_ref(*t, state=tst)
    _close(y4, y3)
    _close(s4, s3)


def test_ssd_chunked_runs_one_chunk_call_per_chunk():
    calls = []
    real = ops.ssd_chunk

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    _, t = _inputs(np.random.default_rng(3), 1, 45, 2, 4, 4, state=False)
    try:
        ops.ssd_chunk = counting
        tssd.ssd_chunked(*t, 16)
    finally:
        ops.ssd_chunk = real
    assert calls == [(1, 16, 2, 4)] * 3


def test_dispatch_modes_on_the_cpu():
    _, t = _inputs(np.random.default_rng(4), 1, 8, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ssd_chunk(*t, force="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.ssd_chunk(*t, force="pallas")
    for a, b in zip(ops.ssd_chunk(*t, force="ref"), ref.ssd_chunk_ref(*t)):
        torch.testing.assert_close(a, b)


# ------------------------------------------------------------ group broadcast

def _cfg(groups):
    from repro_torch.configs.base import get_config
    import dataclasses
    return dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                               ssm_groups=groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_group_broadcast_is_a_float32_view_with_head_stride_0(dtype):
    cfg = _cfg(1)
    h, n = cfg.ssm_nheads, cfg.ssm_state
    t = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 9, n)).astype(np.float32)).to(dtype)
    out = tssd._broadcast_groups(t, cfg)
    assert out.shape == (2, 9, h, n) and out.dtype == torch.float32
    assert out.stride(2) == 0 and out.stride(-1) == 1
    f32 = t.to(torch.float32)
    if dtype == torch.float32:          # no cast: the view shares t's storage
        assert out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
    copy = f32.reshape(2, 9, 1, n).repeat_interleave(h, dim=2)
    assert torch.equal(out, copy)


def test_two_group_broadcast_copies_each_group_to_its_heads():
    cfg = _cfg(2)
    h, n = cfg.ssm_nheads, cfg.ssm_state
    t = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 9, 2 * n)).astype(np.float32))
    out = tssd._broadcast_groups(t, cfg)
    assert out.stride(2) != 0 and out.is_contiguous()
    want = np.asarray(jssd._broadcast_groups(jnp.asarray(t.numpy()), cfg))
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("S,chunk", [(64, 16), (45, 16), (7, 16)])
def test_ssd_chunked_on_the_stride0_view_equals_the_copy_bit_for_bit(S, chunk):
    """The one-group view and the repeat_interleave copy hold the same
    values, so the chunked scan (a padded last chunk included) gives the
    same bits from either."""
    rng = np.random.default_rng(7)
    H, P, N = 3, 8, 4
    x = torch.from_numpy(rng.standard_normal((2, S, H, P)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (2, S, H)).astype(np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, H).astype(np.float32))
    Bg, Cg = (torch.from_numpy(rng.standard_normal((2, S, 1, N)).astype(np.float32))
              for _ in range(2))
    view = [t.expand(2, S, H, N) for t in (Bg, Cg)]
    copy = [t.repeat_interleave(H, dim=2) for t in (Bg, Cg)]
    assert view[0].stride(2) == 0
    y, s = tssd.ssd_chunked(x, dt, A, *view, chunk)
    y2, s2 = tssd.ssd_chunked(x, dt, A, *copy, chunk)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_padding_keeps_the_head_stride_0_view():
    t = torch.arange(2 * 5 * 1 * 3, dtype=torch.float32).reshape(2, 5, 1, 3)
    v = t.expand(2, 5, 4, 3)
    out = tssd._pad_rows(v, 3)
    assert out.shape == (2, 8, 4, 3) and out.stride(2) == 0
    assert torch.equal(out, torch.nn.functional.pad(v.contiguous(),
                                                    (0, 0, 0, 0, 0, 3)))


def test_smem_budget_fits_the_configs_chunks():
    """The kernel's shared memory at the configs' chunk (Q = 256) with
    N = 64 and 128 stays under the 227 KB a block may have; a chunk long
    enough to overflow it raises before any launch."""
    assert ksc.ssd_chunk_smem_bytes(256, 64) == 198704
    assert ksc.ssd_chunk_smem_bytes(256, 128) == 165936
    assert ksc.ssd_chunk_smem_bytes(200, 16) <= ksc.SMEM_LIMIT
    assert ksc.ssd_chunk_smem_bytes(20000, 64) > ksc.SMEM_LIMIT


# ------------------------------------------------- the kernel's precision
#
# The kernel computes its four products on the tensor cores in TF32 with
# each float32 operand split as hi = tf32(x), lo = tf32(x - hi), and sums
# hi.hi + hi.lo + lo.hi in float32 (3xTF32).  The emulation below repeats
# that arithmetic in plain torch (``tests/_tf32.py``).  It is a test of the
# precision argument, on no path of the port.


def _ssd_chunk_tf32(x, dt, A, B_in, C_in, state, terms):
    """ref.ssd_chunk_ref with its four products in emulated TF32."""
    a = dt * A
    cum = torch.cumsum(a, dim=1)
    Q = x.shape[1]
    seg = cum[:, :, None, :] - cum[:, None, :, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, :, :, None]
    decay = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    scores = _mm("bihn,bjhn->bijh", C_in, B_in, terms) * decay
    xbar = x * dt[..., None]
    y = _mm("bijh,bjhp->bihp", scores, xbar, terms)
    y = y + torch.exp(cum)[..., None] * _mm("bhpn,bihn->bihp", state,
                                                  C_in, terms)
    w = torch.exp(cum[:, -1:, :] - cum)
    new_state = state * torch.exp(cum[:, -1])[:, :, None, None] + _mm(
        "bjhp,bjhn->bhpn", xbar * w[..., None], B_in, terms)
    return y, new_state


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                      # representable in TF32
    t = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, one], dtype=torch.float32)
    assert _tf32(t).tolist() == [one, -one, 1.0, one]


def test_3xtf32_holds_the_contract_and_1xtf32_does_not():
    """At zamba2's chunk widths (Q = 256, P = N = 64), three heads: the
    3-term split is within rtol = atol = 1e-4 of ``ref.ssd_chunk_ref``; one
    TF32 product per term is not, which is why the kernel splits."""
    _, t = _inputs(np.random.default_rng(8), 1, 256, 3, 64, 64)
    want = ref.ssd_chunk_ref(*t)
    got3 = _ssd_chunk_tf32(*t, terms=3)
    got1 = _ssd_chunk_tf32(*t, terms=1)
    for g, w in zip(got3, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
    assert not all(torch.allclose(g, w, rtol=TOL, atol=TOL)
                   for g, w in zip(got1, want))
