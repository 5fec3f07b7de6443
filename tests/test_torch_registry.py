"""The port's policy registry, the four policies it adds, and the sweep's
cross-replica RevPred batch point, against the JAX package on the CPU.

* ``describe_json()`` is the JAX package's, apart from module paths.
* One ``Tuner`` run per added policy (Hyperband, PBT, TrimTuner, and
  TrimTuner-GP on a continuous space), built through both registries with
  the oracle predictor: billing, events, trial states, ranking and JCT equal.
* ``predict_pool_multi`` over several markets and replicas, with the JAX
  weights carried across by ``params_from_numpy``: within 1e-5 of the JAX
  package's (float32 forwards), and equal to the port's own per-pool
  ``predict_pool`` on the same requests.
"""

import numpy as np
import pytest
from _torch_port import jax_revpred, jax_revpred_params, run_outcome, torch_revpred

import repro.core.market as jm
import repro.core.revpred as jrp
import repro.core.trial as jt
import repro.tuner as jtu
import repro.tuner.registry as jreg
import repro_torch.core.market as tm
import repro_torch.core.revpred as trp
import repro_torch.core.trial as tt
import repro_torch.tuner as ttu
import repro_torch.tuner.registry as treg

P_TOL = 1e-5


def test_describe_json_equals_reference():
    got = treg.describe_json()
    for meta in got["backends"].values():
        meta["module"] = meta["module"].replace("repro_torch.", "repro.")
    assert got == jreg.describe_json()
    assert treg.describe() == jreg.describe()
    for name in ("fifo", "maxmin", "budget"):
        assert (type(treg.make_fairness_policy(name)).__name__
                == type(jreg.make_fairness_policy(name)).__name__)
    with pytest.raises(ValueError, match="unknown scheduler"):
        treg.make_scheduler("nope", tt.WORKLOADS[0])


# (scheduler, searcher, space, initial_trials)
POLICIES = [("hyperband", "grid", "grid", None),
            ("pbt", "pbt", "grid", 6),
            ("adaptive", "trimtuner", "grid", 6),
            ("adaptive", "trimtuner-gp", "continuous", 6)]


def _run(pkg, reg, trial, market, oracle, sched, search, space, init, **kw):
    w = trial.WORKLOADS[2]
    if space == "continuous":
        w = trial.continuous_variant(w)
    params = {"seed": 1, "population": 6, "eta": 3, "brackets": 3, **kw}
    e = pkg.build_engine(market, trial.SimTrialBackend(market.pool), oracle)
    r = pkg.Tuner(e, reg.make_scheduler(sched, w, params),
                  reg.make_searcher(search, w, params), initial_trials=init).run()
    return e, r


@pytest.mark.parametrize("sched,search,space,init", POLICIES,
                         ids=[p[1] for p in POLICIES])
def test_policy_run_equals_reference(sched, search, space, init):
    ma, mb = jm.SpotMarket(days=8, seed=4), tm.SpotMarket(days=8, seed=4)
    ea, ra = _run(jtu, jreg, jt, ma, jrp.OracleRevPred(ma), sched, search, space,
                  init)
    eb, rb = _run(ttu, treg, tt, mb, trp.OracleRevPred(mb), sched, search, space,
                  init, device="cpu")
    assert run_outcome(eb, rb) == run_outcome(ea, ra)
    assert rb.per_trial_steps == ra.per_trial_steps


def _requests(rps, markets, times, factors):
    reqs = []
    for rp, m in zip(rps, markets):
        for t in times:
            for f in factors:
                reqs.append((rp, list(m.pool), t,
                             [inst.od_price * f for inst in m.pool]))
    return reqs


def test_predict_pool_multi_equals_reference_and_per_pool():
    seeds = (3, 5)
    jmk = [jm.SpotMarket(days=3, seed=s) for s in seeds]
    tmk = [tm.SpotMarket(days=3, seed=s) for s in seeds]
    params = [jax_revpred_params(m) for m in jmk]
    # two replicas share each market: four RevPreds in one batch
    jr = [jax_revpred(jmk[i // 2], params[i // 2]) for i in range(4)]
    tr = [torch_revpred(tmk[i // 2], params[i // 2]) for i in range(4)]
    tr_pool = [torch_revpred(tmk[i // 2], params[i // 2]) for i in range(4)]
    times, factors = (3600.0, 7300.0), (0.3, 0.55)
    markets = [m for m in jmk for _ in range(2)]
    want = jrp.predict_pool_multi(_requests(jr, markets, times, factors))
    tmarkets = [m for m in tmk for _ in range(2)]
    reqs = _requests(tr, tmarkets, times, factors)
    got = trp.predict_pool_multi(reqs)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=P_TOL, atol=P_TOL)
    per_pool = [rp.predict_pool(insts, t, mps) for rp, insts, t, mps in
                _requests(tr_pool, tmarkets, times, factors)]
    assert got == per_pool
    # a second call is answered from the caches, with the same numbers
    assert trp.predict_pool_multi(reqs) == got
    # the oracle and other predictors take their own path
    orc = [(trp.OracleRevPred(tmk[0]), list(tmk[0].pool), 3600.0,
            [i.od_price * 0.3 for i in tmk[0].pool])]
    assert trp.predict_pool_multi(orc) == [
        [orc[0][0].predict(i, 3600.0, p) for i, p in zip(orc[0][1], orc[0][3])]]
