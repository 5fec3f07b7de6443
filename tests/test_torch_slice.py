"""The port's slice end to end against the JAX package: the quickstart
scenario (12-day market with seed 3, ``WORKLOADS[0]``'s 16 trials, SpotTune
theta=0.7 with mcnt=3) with a learned-architecture RevPred whose
JAX-initialized weights are carried across, the port on ``device="cpu"``.

Billing, refunds, the engine clock, every trial's status, steps, finish time
and metric history, the event log (enum names, billing records), the
predicted ranking and the JCT must be equal: the fields of
``repro.tuner.equivalence.compare_engines``.  Tolerance enters only through
RevPred's probabilities (float32 forwards, held within 1e-5 here) and
EarlyCurve's fits; neither may move a decision on these seeds.
"""

import numpy as np
import pytest
from _torch_port import jax_revpred, jax_revpred_params, run_outcome, torch_revpred

import repro.core.market as jm
import repro.core.trial as jt
import repro.tuner as jtu
import repro_torch.core.market as tm
import repro_torch.core.trial as tt
import repro_torch.tuner as ttu

P_TOL = 1e-5


def _jax_run(market_seed, wi, theta, params):
    m = jm.SpotMarket(days=12, seed=market_seed)
    rp = jax_revpred(m, params)
    e = jtu.build_engine(m, jt.SimTrialBackend(m.pool), rp)
    r = jtu.Tuner(e, jtu.SpotTuneScheduler(theta=theta, mcnt=3),
                  jtu.GridSearcher(jt.WORKLOADS[wi])).run()
    return e, r, rp


def _torch_run(market_seed, wi, theta, params):
    m = tm.SpotMarket(days=12, seed=market_seed)
    rp = torch_revpred(m, params, device="cpu")
    e = ttu.build_engine(m, tt.SimTrialBackend(m.pool), rp)
    r = ttu.Tuner(e, ttu.SpotTuneScheduler(theta=theta, mcnt=3, device="cpu"),
                  ttu.GridSearcher(tt.WORKLOADS[wi])).run()
    return e, r, rp


@pytest.mark.parametrize("market_seed,wi,theta", [(3, 0, 0.7), (5, 1, 0.5)])
def test_slice_run_equals_reference(market_seed, wi, theta):
    params = jax_revpred_params(jm.SpotMarket(days=12, seed=market_seed))
    je, jr, jrp = _jax_run(market_seed, wi, theta, params)
    te, tr, trp = _torch_run(market_seed, wi, theta, params)
    assert set(jrp._p_cache) == set(trp._p_cache)
    keys = sorted(jrp._p_cache)
    np.testing.assert_allclose([trp._p_cache[k] for k in keys],
                               [jrp._p_cache[k] for k in keys],
                               rtol=P_TOL, atol=P_TOL)
    want, got = run_outcome(je, jr), run_outcome(te, tr)
    for field in want:
        assert got[field] == want[field], field
    assert tr.true_rank == jr.true_rank
    assert tr.cost == jr.cost and tr.refunded == jr.refunded
    assert tr.per_trial_steps == jr.per_trial_steps
    np.testing.assert_allclose([tr.pred_errors[k] for k in sorted(jr.pred_errors)],
                               [jr.pred_errors[k] for k in sorted(jr.pred_errors)],
                               rtol=1e-4)


def _policy(pkg, trial, name, workload, device_kw):
    if name == "spottune-random":
        return (pkg.SpotTuneScheduler(theta=0.7, mcnt=3, **device_kw),
                pkg.RandomSearcher(workload, num_samples=10, seed=2), None)
    if name == "adaptive":
        return (pkg.AdaptiveSpotTuneScheduler(theta=0.7, mcnt=3, suggest_batch=4,
                                              **device_kw),
                pkg.AdaptiveGridSearcher(workload, initial=6, batch=4, seed=1), 6)
    if name == "spottune-list-exact":
        return (pkg.SpotTuneScheduler(theta=0.5, mcnt=2, **device_kw),
                pkg.ListSearcher(trial.make_trials(workload)[::2]), None)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["spottune-random", "adaptive",
                                  "spottune-list-exact"])
def test_policies_equal_reference(name):
    """The other ported searchers and the adaptive SpotTune policy, with the
    oracle predictor: EarlyCurve on the CPU is the only tensor path."""
    from repro.core.revpred import OracleRevPred as JOracle
    from repro_torch.core.revpred import OracleRevPred as TOracle
    exact = name.endswith("exact")
    ma, mb = jm.SpotMarket(days=12, seed=4), tm.SpotMarket(days=12, seed=4)
    ea = jtu.build_engine(ma, jt.SimTrialBackend(ma.pool), JOracle(ma),
                          exact_ticks=exact)
    eb = ttu.build_engine(mb, tt.SimTrialBackend(mb.pool), TOracle(mb),
                          exact_ticks=exact)
    sa, qa, init = _policy(jtu, jt, name, jt.WORKLOADS[2], {})
    sb, qb, _ = _policy(ttu, tt, name, tt.WORKLOADS[2], {"device": "cpu"})
    ra = jtu.Tuner(ea, sa, qa, initial_trials=init).run()
    rb = ttu.Tuner(eb, sb, qb, initial_trials=init).run()
    assert run_outcome(ea, ra) == run_outcome(eb, rb)
