"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX package's (``repro.models.moe``), on the CPU.

The reference's own tests (``tests/test_moe.py``) run on the port, and the
two packages' functions take the same inputs, made from a numpy seed:

* routing: the expert ids equal, the weights and the aux loss within 1e-6;
* capacity dispatch: ``(slot, keep)`` bit-equal over (T, K, E, capacity)
  drawn as the reference draws them (a fixed grid here, and under
  hypothesis where it is installed); dropless at capacity = T;
* ``moe_ffn``: output and aux loss for the reduced grok-1 (no shared
  experts) and deepseek-v2 (one shared expert), float32 within 1e-4
  (rtol and atol), bf16 within 5 % of the output's largest magnitude (the
  packages round bf16 at different places), the aux within 1e-6;
* gradients of ``sum(y**2) + aux`` with respect to x and every parameter,
  float32, each within 1e-3 of its largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)
from _hypothesis_compat import given, settings, st

from repro.configs.base import get_config as jget
from repro.models import moe as jmoe
from repro.models.context import null_ctx as jnull
from repro_torch.configs.base import get_config as tget
from repro_torch.models import moe
from repro_torch.models.model import params_from_numpy
from repro_torch.optim.optimizers import tree_leaves, tree_map

ROUTE_TOL = 1e-6
F32_TOL, BF16_REL_TOL, GRAD_TOL = 1e-4, 5e-2, 1e-3
ARCHS = ["grok-1-314b", "deepseek-v2-236b"]


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget(arch, reduced=True), dtype=dtype, **kw),
            dataclasses.replace(tget(arch, reduced=True), dtype=dtype, **kw))


def _params(jc, tc, seed=0):
    jp = jmoe.init_moe(jax.random.key(seed), jc)
    return jp, params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32) * 0.3
    return jnp.asarray(x, dtype=jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_the_jax_package(arch, seed):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, jc.d_model)).astype(np.float32)
    router = (rng.standard_normal((jc.d_model, jc.n_experts)) * 0.1).astype(np.float32)
    jw, jidx, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(router), jc)
    w, idx, aux = moe._route(torch.from_numpy(x), torch.from_numpy(router), tc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=ROUTE_TOL, abs=ROUTE_TOL)
    # the reference's properties: weights sum to 1, the aux at least ~1
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert float(aux) >= 0.99


# ----------------------------------------------------------------- capacity


@pytest.mark.parametrize("T,K,E,cf,want", [
    (512, 2, 8, 1.25, 160),      # grok-1's served prefill, 2 x 256
    (2, 2, 8, 1.25, 2),          # one decode step: never above T
    (512, 6, 160, 1.25, 24),     # deepseek-v2's served prefill
    (10, 6, 160, 1.25, 10),      # the 4K floor, cut to T
    (48, 2, 8, 0.5, 8),          # a mean load of 6 under the 4K floor
])
def test_capacity_is_the_references_arithmetic(T, K, E, cf, want):
    cfg = dataclasses.replace(tget("grok-1-314b", reduced=True), experts_per_tok=K,
                              n_experts=E, capacity_factor=cf)
    assert moe.capacity(T, cfg) == want
    # the reference's expression at jmoe._moe_shard_body
    cap_raw = -(-T * K * cf // E)
    assert want == int(min(T, max(cap_raw, min(T, 4 * K))))


def _check_dispatch(T, K, E, capacity):
    rng = np.random.default_rng(T * 131 + K * 7 + E)
    K = min(K, E)
    idx = rng.integers(0, E, size=(T, K)).astype(np.int32)
    jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(idx), 0, E, capacity)
    slot, keep = moe._dispatch_indices(torch.from_numpy(idx).long(), 0, E, capacity)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    # the reference's properties on the port's answer
    used = slot.numpy()[keep.numpy()]
    assert len(np.unique(used)) == len(used) and np.all(used < E * capacity)
    counts = np.zeros(E, int)
    for e, k in zip(idx.reshape(-1), keep.numpy().reshape(-1)):
        if k:
            counts[e] += 1
        else:
            assert counts[e] >= capacity            # first come, first served
    assert counts.max(initial=0) <= capacity


@given(st.integers(2, 64), st.integers(1, 4), st.integers(2, 8),
       st.integers(1, 16))
@settings(max_examples=40, deadline=None)
def test_dispatch_indices_bit_equal_under_hypothesis(T, K, E, capacity):
    _check_dispatch(T, K, E, capacity)


@pytest.mark.parametrize("T,K,E,capacity", [
    (2, 1, 2, 1), (7, 2, 3, 2), (16, 4, 8, 3), (33, 3, 5, 16), (64, 4, 8, 1),
    (64, 1, 2, 16), (50, 2, 8, 5), (64, 4, 4, 64)])
def test_dispatch_indices_bit_equal(T, K, E, capacity):
    _check_dispatch(T, K, E, capacity)


def test_dropless_when_capacity_is_T():
    T, K, E = 16, 2, 4
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, E, size=(T, K)))
    _, keep = moe._dispatch_indices(idx, 0, E, capacity=T)
    assert bool(keep.all())


# ------------------------------------------------------------------ the layer


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_the_jax_package(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(jc, tc)
    assert ("shared" in tp) == (tc.n_shared_experts > 0)
    jx, tx = _x(np.random.default_rng(3), (2, 8, jc.d_model), dtype)
    jy, jaux = jmoe.moe_ffn(jx, jp, jc, jnull())
    with torch.no_grad():
        y, aux = moe.moe_ffn(tx, tp, tc)
    assert y.dtype == tx.dtype and tuple(y.shape) == jy.shape
    want = np.asarray(jy, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    else:
        err = np.abs(y.float().numpy() - want).max()
        assert err <= BF16_REL_TOL * np.abs(want).max(), err
    assert float(aux) == pytest.approx(float(jaux), rel=ROUTE_TOL, abs=ROUTE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_gradients_match_jax_grad(arch, cf):
    """At cf = 0.5 capacity drops assignments, whose tokens then get no
    gradient through those experts, in both packages alike."""
    jc, tc = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(jc, tc, seed=1)
    jx, tx = _x(np.random.default_rng(4), (2, 8, jc.d_model), "float32")

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(x, p, jc, jnull())
        return jnp.sum(y ** 2) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    p = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    x = tx.requires_grad_(True)
    y, aux = moe.moe_ffn(x, p, tc)
    got = torch.autograd.grad(torch.sum(y ** 2) + aux, [x] + tree_leaves(p))
    want = [np.asarray(jgx)] + [np.asarray(g) for g in jax.tree.leaves(jgp)]
    assert len(got) == len(want) == 1 + len(tree_leaves(tp))
    for i, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == b.shape, i
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a.numpy() - b).max() <= GRAD_TOL * scale, i
    assert float(got[1 + sorted(tp).index("router")].abs().sum()) > 0
