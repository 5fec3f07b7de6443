"""The port's ``core.orchestrator`` against the JAX package's: the legacy
``Orchestrator`` / ``build_spottune`` layer over the tuner (fig10's
integrated rows run through it) and the single-spot baseline.

``build_spottune`` on the quickstart (12-day market with seed 3,
``WORKLOADS[0]``'s 16 trials, theta=0.7, mcnt=3, seed 0) with RevPreds
carrying the same JAX-initialized weights: cost, refund, JCT, the engine
clock, every trial's outcome, the event log and the ranking are equal
(RevPred's probabilities held within 1e-5, as in ``test_torch_slice.py``).
The baseline is numpy in both packages and equal exactly.
"""

import dataclasses

import numpy as np
from _torch_port import jax_revpred, jax_revpred_params, run_outcome, torch_revpred

import repro.core.market as jm
import repro.core.orchestrator as jo
import repro.core.trial as jt
import repro_torch.core.market as tm
import repro_torch.core.orchestrator as to
import repro_torch.core.trial as tt

P_TOL = 1e-5


def test_build_spottune_equals_reference():
    params = jax_revpred_params(jm.SpotMarket(days=12, seed=3))
    jmk, tmk = jm.SpotMarket(days=12, seed=3), tm.SpotMarket(days=12, seed=3)
    jrp, trp = jax_revpred(jmk, params), torch_revpred(tmk, params)
    a = jo.build_spottune(jt.make_trials(jt.WORKLOADS[0]), jmk,
                          jt.SimTrialBackend(jmk.pool), jrp, theta=0.7, mcnt=3,
                          seed=0)
    b = to.build_spottune(tt.make_trials(tt.WORKLOADS[0]), tmk,
                          tt.SimTrialBackend(tmk.pool), trp, theta=0.7, mcnt=3,
                          seed=0, device="cpu")
    ra, rb = a.run(), b.run()
    keys = sorted(jrp._p_cache)
    assert keys == sorted(trp._p_cache)
    np.testing.assert_allclose([trp._p_cache[k] for k in keys],
                               [jrp._p_cache[k] for k in keys],
                               rtol=P_TOL, atol=P_TOL)
    assert (rb.cost, rb.refunded, rb.jct) == (ra.cost, ra.refunded, ra.jct)
    assert rb.predicted_rank == ra.predicted_rank and rb.true_rank == ra.true_rank
    assert rb.pcr() == ra.pcr()
    want, got = run_outcome(a.engine, ra), run_outcome(b.engine, rb)
    for field in want:
        assert got[field] == want[field], field
    assert (b.t, len(b.events), len(b.states)) == (a.t, len(a.events), len(a.states))
    assert dataclasses.asdict(b.cfg) == dataclasses.asdict(a.cfg)
    assert b.max_steps == a.max_steps


def test_single_spot_baseline_equals_reference():
    jmk, tmk = jm.SpotMarket(days=12, seed=3), tm.SpotMarket(days=12, seed=3)
    for k in (0, 3):
        a = jo.run_single_spot_baseline(
            jmk, jt.SimTrialBackend(jmk.pool), jt.make_trials(jt.WORKLOADS[1]),
            jmk.pool[k])
        b = to.run_single_spot_baseline(
            tmk, tt.SimTrialBackend(tmk.pool), tt.make_trials(tt.WORKLOADS[1]),
            tmk.pool[k])
        assert dataclasses.asdict(b) == dataclasses.asdict(a)


def test_orchestrator_config_maps_to_the_engine():
    for kw in ({}, {"theta": 0.5, "tick_s": 5.0, "straggler_factor": 1.5,
                    "seed": 7}):
        a, b = jo.OrchestratorConfig(**kw), to.OrchestratorConfig(**kw)
        assert dataclasses.asdict(b.engine_config()) == \
            dataclasses.asdict(a.engine_config())
