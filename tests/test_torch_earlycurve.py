"""The port's EarlyCurve against the JAX package's.

Stage detection and the plateau test are numpy in both packages and agree
exactly.  The Levenberg-Marquardt curve fits are float32 in both, but the
JAX package takes its Jacobian with ``jax.jacfwd`` and solves with XLA,
while the port writes the Jacobian out and solves with PyTorch: the
extrapolated finals agree to a relative 1e-4 (the largest gap seen over
these trajectories is about 2e-5).
"""

import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)
from test_earlycurve import make_curve

import repro.core.earlycurve as je
import repro_torch.core.earlycurve as te
from repro.core.market import DEFAULT_POOL
from repro.core.trial import WORKLOADS, SimTrialBackend, make_trials

RTOL = 1e-4


def _curves():
    out = []
    for seed in range(4):
        for stages in (1, 2, 3):
            for noise in (0.0, 0.02):
                ks, vals = make_curve(n=120, stages=stages, noise=noise,
                                      seed=seed)
                n = 40 + 17 * seed
                out.append((ks[:n], vals[:n], 200))
    return out


def _sim_trajectories():
    be = SimTrialBackend(DEFAULT_POOL)
    out = []
    for w in WORKLOADS:
        ve = w.val_every
        n = int(0.7 * w.max_trial_steps // ve)
        for s in make_trials(w)[:4]:
            out.append(([k * ve for k in range(1, n + 1)],
                        be.metric_range(s, 1, n), w.max_trial_steps))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_detect_stages_and_converged_exact(seed):
    ec_j, ec_t = je.EarlyCurve(), te.EarlyCurve(device="cpu")
    for stages in (1, 2, 3):
        for noise in (0.0, 0.01):
            _, vals = make_curve(n=150, stages=stages, noise=noise, seed=seed)
            assert je.detect_stages(vals) == te.detect_stages(vals)
            for n in (10, 25, 60, 150):
                assert ec_j.converged(list(vals[:n])) == ec_t.converged(list(vals[:n]))
    flat = [1.0 + 1e-5 * i for i in range(30)]
    assert ec_j.converged(flat) and ec_t.converged(flat)


def test_predict_final_batch_within_rtol():
    trajs = _curves() + _sim_trajectories()
    want = je.EarlyCurve().predict_final_batch(trajs, seed=0)
    got = te.EarlyCurve(device="cpu").predict_final_batch(trajs, seed=0)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("which", [0, 7, 13, 20])
def test_predict_final_within_rtol(which):
    trajs = _curves() + _sim_trajectories()
    steps, vals, target = trajs[which]
    want = je.EarlyCurve().predict_final(steps, vals, target, seed=1)
    got = te.EarlyCurve(device="cpu").predict_final(steps, vals, target, seed=1)
    assert got == pytest.approx(want, rel=RTOL)


def test_fit_stage_batch_invariant_to_batch_composition():
    """A stage fitted alone and the same stage inside a larger batch give
    bit-identical fits (the rows are padded and reduced one at a time)."""
    stages = []
    for seed in range(6):
        ks, vals = make_curve(n=60, stages=1, noise=0.01, seed=seed)
        stages.append((ks[:30 + seed], vals[:30 + seed]))
    te.clear_fit_caches()
    alone = te.fit_stage_batch(stages[:1], device="cpu")[0]
    te.clear_fit_caches()
    together = te.fit_stage_batch(stages, device="cpu")[0]
    assert np.array_equal(alone["alpha"], together["alpha"])
    assert alone["rmse"] == together["rmse"]
    # the memo answers the repeat, keyed by device type
    assert any(k[-1] == "cpu" for k in te._FIT_CACHE)
    assert te.fit_stage_batch(stages[:1], device="cpu")[0] is together


def test_fit_stage_matches_jax():
    ks, vals = make_curve(n=80, stages=1, noise=0.005, seed=3)
    a = je.fit_stage(ks, vals, seed=2)
    b = te.fit_stage(ks, vals, seed=2, device="cpu")
    for k in (10.0, 80.0, 200.0):
        assert te.predict_from_fit(b, k) == pytest.approx(
            je.predict_from_fit(a, k), rel=RTOL)
    # predict_from_fit is numpy in both: same fit in, same number out
    assert te.predict_from_fit(a, 123.0) == je.predict_from_fit(a, 123.0)


def test_predict_final_grouped_equals_per_caller():
    trajs = _sim_trajectories()
    ec = te.EarlyCurve(device="cpu")
    reqs = [(ec, trajs[:5], 0), (te.EarlyCurve(device="cpu"), trajs[5:], 0),
            (ec, trajs[2:9], 3)]
    grouped = te.predict_final_grouped(reqs)
    te.clear_fit_caches()
    for (e, tj, seed), got in zip(reqs, grouped):
        assert got == e.predict_final_batch(tj, seed=seed)


def _fig11_curves():
    """Fig. 11's recipe (benchmarks/fig11_earlycurve.py): every trial's
    simulated curve, cut at theta = 0.7, its final as the target; over the
    first four workloads and Fig. 11(b)'s ResNet analogue."""
    be = SimTrialBackend(DEFAULT_POOL)
    out = []
    for w in WORKLOADS[:4] + WORKLOADS[5:6]:
        steps = np.arange(w.val_every, w.max_trial_steps + 1, w.val_every)
        for tr in make_trials(w):
            curve = be.curve(tr)
            cut = int(0.7 * len(curve))
            out.append((steps[:cut], curve[:cut], w.max_trial_steps))
    return out


def test_slaq_predict_final_within_rtol():
    curves = _fig11_curves()
    assert len(curves) == 80
    slaq_j, slaq_t = je.SLAQPredictor(), te.SLAQPredictor(device="cpu")
    for i, (steps, vals, target) in enumerate(curves):
        want = slaq_j.predict_final(steps, vals, target, seed=i % 3)
        got = slaq_t.predict_final(steps, vals, target, seed=i % 3)
        assert got == pytest.approx(want, rel=RTOL), i
    # the single-stage fit is what the staged predictor is not: on the
    # multi-stage curves the two differ
    ec = te.EarlyCurve(device="cpu")
    staged = [c for c in curves if len(ec.stages(c[1])) > 1]
    assert staged
    assert any(slaq_t.predict_final(*c) != ec.predict_final(*c)
               for c in staged)


def test_earlycurve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from repro_torch.tuner import SpotTuneScheduler
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.EarlyCurve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.SLAQPredictor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpotTuneScheduler(theta=0.7)
    assert SpotTuneScheduler(theta=0.7, device="cpu").ec.device == "cpu"
