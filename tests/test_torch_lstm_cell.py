"""The port's grouped LSTM cell against the JAX package's Pallas kernel.

On this CPU host the port's wrapper takes its plain version
(``repro_torch.kernels.ref``); the Pallas kernel runs in interpret mode as
``tests/test_kernels.py`` runs it.  Tolerances are the Pallas kernel's own:
1e-5 in float32, 3e-2 in bfloat16.  The CUDA kernel itself is held to the
plain version on the card (``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.kernels import ref as jref
from repro.kernels.lstm_cell import lstm_cell_pallas
from repro_torch.kernels import lstm_cell as klc
from repro_torch.kernels import ops, ref

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, G, B, I, H):
    return [rng.standard_normal((G, B, I)), rng.standard_normal((G, B, H)),
            rng.standard_normal((G, B, H)),
            rng.standard_normal((G, I, 4 * H)) * 0.3,
            rng.standard_normal((G, H, 4 * H)) * 0.3,
            rng.standard_normal((G, 4 * H)) * 0.1]


def _torch(arrs, dtype):
    # round through the JAX dtype so both packages see the same values
    return [torch.from_numpy(np.array(jnp.asarray(a, JDT[dtype]), np.float32)
                             ).to(TDT[dtype]) for a in arrs]


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,I,H,bb,bh", [
    (4, 6, 32, 4, 16),
    (8, 7, 64, 4, 32),
    (2, 13, 16, 2, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_cell_matches_pallas_and_jax_ref(B, I, H, bb, bh, dtype, rng):
    arrs = _inputs(rng, 1, B, I, H)
    j = [jnp.asarray(a[0], JDT[dtype]) for a in arrs]
    hp, cp = lstm_cell_pallas(*j, interpret=True, block_b=bb, block_h=bh)
    hr, cr = jref.lstm_cell_ref(*j)
    h, c = ops.lstm_cell(*_torch(arrs, dtype))
    assert h.dtype == TDT[dtype] and h.shape == (1, B, H)
    for got, want in ((h[0], hp), (c[0], cp), (h[0], hr), (c[0], cr)):
        _close(got, np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("G,B,I,H", [(3, 1, 6, 32), (6, 1, 32, 32), (2, 4, 7, 16)])
def test_grouped_cell_matches_vmapped_pallas(G, B, I, H, rng):
    """G > 1 is ``jax.vmap`` of the Pallas kernel over the parameter axis,
    as RevPred's stacked forward runs it."""
    arrs = _inputs(rng, G, B, I, H)
    j = [jnp.asarray(a, jnp.float32) for a in arrs]
    cell = jax.vmap(lambda *a: lstm_cell_pallas(*a, interpret=True))
    hp, cp = cell(*j)
    h, c = ops.lstm_cell(*_torch(arrs, "float32"))
    _close(h, np.asarray(hp), "float32")
    _close(c, np.asarray(cp), "float32")


def test_groups_are_independent(rng):
    """A group's result does not depend on its neighbours in the call."""
    arrs = _torch(_inputs(rng, 5, 2, 6, 16), "float32")
    h, c = ops.lstm_cell(*arrs)
    for g in range(5):
        hg, cg = ops.lstm_cell(*[a[g:g + 1] for a in arrs])
        assert torch.equal(hg[0], h[g]) and torch.equal(cg[0], c[g])


def test_cpu_tensors_take_the_plain_version(rng):
    arrs = _torch(_inputs(rng, 2, 3, 6, 8), "float32")
    before = klc.LAUNCHES
    h, c = ops.lstm_cell(*arrs)
    h2, c2 = ref.lstm_cell_ref(*arrs)
    assert torch.equal(h, h2) and torch.equal(c, c2)
    assert klc.LAUNCHES == before


def test_forced_kernel_on_cpu_tensors_raises(rng):
    """No fallback: asking for the kernel on a CPU tensor raises instead of
    returning the plain result, and counts no launch."""
    arrs = _torch(_inputs(rng, 1, 2, 6, 8), "float32")
    before = klc.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_cell(*arrs, force="cuda")
    with pytest.raises(ValueError):
        ops.lstm_cell(*arrs, force="pallas")
    assert klc.LAUNCHES == before
