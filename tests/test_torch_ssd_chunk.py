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
