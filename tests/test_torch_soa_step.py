"""The port's SoA-step layer against the JAX package's numpy references,
bit for bit: the numpy functions the port carries over, the device dispatch
on the CPU, and the plain PyTorch versions the CUDA kernel is held to on the
card.  The fold must be exact for any alpha (the CUDA kernel is; the Pallas
path was only for the dyadic 0.5), so non-dyadic alphas are part of every
case.  The JAX Pallas path itself is not used: it does not run on this
host's JAX.
"""

import numpy as np
import pytest
import torch

import repro.kernels.soa_step as jks
from repro_torch.kernels import ops, ref
from repro_torch.kernels import soa_step as tks

ALPHAS = (0.5, 0.3, 0.1)
# (F, L, N, R): benchmarks/soa_kernel.py's two shapes, a 1000-replica round,
# and the empty edges
SHAPES = [(32, 8, 128, 8), (128, 16, 512, 16), (128, 16, 32000, 1000),
          (0, 4, 64, 4), (16, 4, 0, 3), (0, 0, 0, 2)]


def _inputs(F, L, N, R, alpha, seed=8):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.5, 2.0, size=(F, L))
    lens = rng.integers(0, L + 1, size=F).astype(np.int64)   # lens 0 included
    m0 = rng.uniform(0.5, 2.0, size=F)
    first = rng.random(F) < 0.3
    if F >= 2:
        lens[0], first[0] = 0, True        # a first row with no observation
        lens[1], first[1] = L, True
    ewma = np.full(F, alpha)
    next_k = rng.integers(0, 10_000, size=N).astype(np.int64)
    next_k[rng.random(N) < 0.2] = jks._BIG
    row_rep = np.sort(rng.integers(0, R, size=N)).astype(np.int64)
    if N >= R:
        row_rep[:R] = np.arange(R)          # every segment non-empty
        row_rep = np.sort(row_rep)
    starts = np.searchsorted(row_rep, np.arange(R)).astype(np.int64)
    return obs, lens, m0, first, ewma, next_k, row_rep, R, starts


def _want_seg(next_k, row_rep, R):
    seg = np.full(R, jks._BIG, np.int64)
    np.minimum.at(seg, row_rep, next_k)
    return seg


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_step_equals_numpy_refs(shape, alpha):
    obs, lens, m0, first, ewma, next_k, row_rep, R, starts = _inputs(*shape, alpha)
    want_m = jks.ewma_fold_ref(obs, lens, m0, first, ewma)
    assert np.array_equal(jks.ewma_fold_sorted(obs, lens, m0, first, ewma), want_m)
    # the port's numpy copies
    assert np.array_equal(tks.ewma_fold_ref(obs, lens, m0, first, ewma), want_m)
    assert np.array_equal(tks.ewma_fold_sorted(obs, lens, m0, first, ewma), want_m)
    # the device dispatch on the CPU: the plain PyTorch versions
    m, seg = tks.soa_step_fused(obs, lens, m0, first, ewma, next_k, row_rep, R,
                                device="cpu")
    assert m.dtype == np.float64 and seg.dtype == np.int64
    assert np.array_equal(m, want_m)
    assert np.array_equal(seg, _want_seg(next_k, row_rep, R))
    assert np.array_equal(tks.ewma_fold(obs, lens, m0, first, ewma, device="cpu"),
                          want_m)
    if len(next_k) and np.all(np.diff(starts) > 0):
        assert np.array_equal(seg, jks.segmented_min_ref(next_k, starts))
        assert np.array_equal(tks.segmented_min(next_k, starts),
                              jks.segmented_min(next_k, starts))


@pytest.mark.parametrize("alpha", ALPHAS)
def test_torch_plain_versions_equal_numpy(alpha):
    obs, lens, m0, first, ewma, next_k, row_rep, R, starts = _inputs(
        128, 16, 512, 16, alpha, seed=3)
    T = [torch.from_numpy(a) for a in (obs, lens, m0, first, ewma, next_k, row_rep)]
    m = ref.ewma_fold_torch_ref(*T[:5])
    assert m.dtype == torch.float64
    assert np.array_equal(m.numpy(), jks.ewma_fold_ref(obs, lens, m0, first, ewma))
    m2, seg = ref.soa_step_fused_ref(*T, R)
    assert np.array_equal(m2.numpy(), m.numpy())
    assert np.array_equal(seg.numpy(), jks.segmented_min_ref(next_k, starts))
    m3, seg3 = ops.soa_step_fused(*T, R)          # CPU tensors -> plain version
    assert np.array_equal(m3.numpy(), m.numpy())
    assert np.array_equal(seg3.numpy(), seg.numpy())
    assert np.array_equal(ops.ewma_fold(*T[:5], force="ref").numpy(), m.numpy())


def test_fold_is_the_sequential_update_many_replay():
    """Per row, the fold equals the one-observation-at-a-time EWMA of
    ``PerfModel.update_many`` for a non-dyadic alpha."""
    from repro_torch.core.market import DEFAULT_POOL
    from repro_torch.core.provisioner import PerfModel
    from repro_torch.core.trial import WORKLOADS, make_trials
    obs, lens, m0, first, ewma, *_ = _inputs(12, 9, 0, 1, 0.3, seed=5)
    inst, spec = DEFAULT_POOL[0], make_trials(WORKLOADS[0])[0]
    got = tks.soa_step_fused(obs, lens, m0, first, ewma, np.zeros(0, np.int64),
                             np.zeros(0, np.int64), 1, device="cpu")[0]
    for i in range(len(obs)):
        perf = PerfModel(DEFAULT_POOL, ewma=0.3)
        key = (inst.name, spec.key)
        if not first[i]:
            perf._m[key] = m0[i]
            perf._observed[key] = True
        perf.update_many(inst, spec, obs[i, :lens[i]])
        assert got[i] == perf._m.get(key, 0.0), i


def test_dispatch_raises_instead_of_falling_back():
    obs, lens, m0, first, ewma, next_k, row_rep, R, _ = _inputs(8, 4, 16, 2, 0.3)
    T = [torch.from_numpy(a) for a in (obs, lens, m0, first, ewma, next_k, row_rep)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.soa_step_fused(*T, R, force="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ewma_fold(*T[:5], force="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.ewma_fold(*T[:5], force="pallas")
    with pytest.raises(ValueError, match="row_rep"):
        tks.soa_step_fused(obs, lens, m0, first, ewma, next_k, row_rep, 1,
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tks.soa_step_fused(obs, lens, m0, first, ewma, next_k, row_rep, R)
