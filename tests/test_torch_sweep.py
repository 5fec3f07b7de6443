"""The port's multi-replica sweep (``repro_torch.sweep``) against the JAX
package's, replica for replica, on the CPU.

Grid: the first four Table-II workloads x market seeds 3 and 11, 8-day
markets, the oracle predictor, theta=0.7, for each of the five policies of
the equivalence cube; the SoA stepper also over the cube's other seeds (1,
7, 23), one seed a case.  Billing, refunds, engine clocks, every trial's state
and metric history, the event logs, the rankings and the JCTs must be equal:
the SoA stepper, the round-robin ``"batched"`` mode, a 600 s deploy window,
and the fused-round branch (the fold parked into the round-end
fold-and-min step, here through the kernel's plain PyTorch versions) all
included.
"""

import dataclasses

import numpy as np
import pytest
from _torch_port import plain, run_outcome

import repro.core.trial as jt
import repro.sweep as js
import repro_torch.sweep as ts
from repro.sweep.soa import SoaSweep as JSoa
from repro_torch.kernels import soa_step as tks
from repro_torch.sweep.soa import SoaSweep as TSoa

POLICIES = ("spottune", "asha", "hyperband", "pbt", "adaptive")
NAMES = [w.name for w in jt.WORKLOADS][:4]


def _grids(seeds=(3, 11), **axes):
    kw = dict(revpred="oracle", theta=0.7, days=8.0, **axes)
    return (js.scenario_grid(NAMES, seeds, **kw),
            ts.scenario_grid(NAMES, seeds, **kw))


def _soa_pair(scheduler, fuse_rounds=None, **axes):
    jg, tg = _grids(scheduler=scheduler, **axes)
    ja = js.SweepRunner().prepare(jg)
    JSoa(ja).run()
    tb = ts.SweepRunner(device="cpu").prepare(tg)
    sweep = TSoa(tb, device="cpu")
    assert not sweep.fuse_rounds          # the CPU default: the numpy path
    if fuse_rounds is not None:
        sweep.fuse_rounds = fuse_rounds
    sweep.run()
    return ja, tb


@pytest.mark.parametrize("scheduler", POLICIES)
def test_soa_sweep_equals_reference(scheduler):
    ja, tb = _soa_pair(scheduler)
    assert len(ja) == len(tb) == 8
    for a, b in zip(ja, tb):
        assert run_outcome(a.engine, a.result) == run_outcome(b.engine, b.result)


# the rest of the reference's equivalence cube (market seeds 1, 3, 7, 11,
# 23): the test above holds seeds 3 and 11
CUBE_SEEDS = (1, 7, 23)


@pytest.mark.parametrize("seed", CUBE_SEEDS)
@pytest.mark.parametrize("scheduler", POLICIES)
def test_soa_sweep_cube_equals_reference(scheduler, seed):
    ja, tb = _soa_pair(scheduler, seeds=(seed,))
    assert len(ja) == len(tb) == 4
    for a, b in zip(ja, tb):
        assert run_outcome(a.engine, a.result) == run_outcome(b.engine, b.result)


@pytest.mark.parametrize("scheduler", POLICIES)
def test_fused_rounds_equal_reference(scheduler, monkeypatch):
    """The card's round structure on the CPU: deferred folds land through
    ``soa_step_fused``'s plain version at stage 5, except the rows of
    replicas that deploy in the round, which fold first through the
    fold-only path; outcomes stay the reference's."""
    calls = {"fused": 0, "fold": 0}
    fused, fold = tks.soa_step_fused, tks.ewma_fold

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            assert k["device"].type == "cpu"
            return fn(*a, **k)
        return wrapped

    import repro_torch.sweep.soa as soa_mod
    monkeypatch.setattr(soa_mod, "soa_step_fused", count("fused", fused))
    monkeypatch.setattr(soa_mod, "ewma_fold", count("fold", fold))
    ja, tb = _soa_pair(scheduler, fuse_rounds=True)
    # schedulers without a decision table (pbt, adaptive) keep the scalar
    # chain, whose dispatches may read the perf matrix: no deferral there
    if scheduler in ("pbt", "adaptive"):
        assert calls["fused"] == 0 and calls["fold"] > 0
    else:
        assert calls["fused"] > 0 and calls["fold"] > 0
    for a, b in zip(ja, tb):
        assert run_outcome(a.engine, a.result) == run_outcome(b.engine, b.result)


# EarlyCurve's prediction errors come from float32 curve fits (the port's
# finals agree to ~2e-5 relative); every other field is exact
PRED_ERR_ATOL = 1e-5


def _records(sweep):
    """Per replica: spec, every RunResult field but the prediction errors,
    metric histories; and the prediction errors apart."""
    recs, errs = [], []
    for r in sweep.replicas:
        res = plain(dataclasses.asdict(r.result))
        pe = res.pop("pred_errors")
        recs.append((r.spec.asdict(), res, r.metrics))
        errs.append([pe[k] for k in sorted(pe)])
    return recs, errs


@pytest.mark.parametrize("mode,window", [("batched", 0.0), ("soa", 600.0),
                                         ("batched", 600.0)])
@pytest.mark.parametrize("scheduler", POLICIES)
def test_runner_equals_reference(scheduler, mode, window):
    jg, tg = _grids(scheduler=scheduler, deploy_window_s=window)
    want = js.SweepRunner().run(jg, mode=mode)
    got = ts.SweepRunner(device="cpu").run(tg, mode=mode)
    assert got.mode == want.mode == mode
    (recs, errs), (want_recs, want_errs) = _records(got), _records(want)
    assert recs == want_recs
    for e, w in zip(errs, want_errs):
        np.testing.assert_allclose(e, w, rtol=0, atol=PRED_ERR_ATOL)


_INVALID = [
    dict(workload="LoR", market_seed=1),
    dict(workload="nope", market_seed=1, scheduler="bogus", searcher="x"),
    dict(workload="LoR", market_seed=1, space="continuous", searcher="grid"),
    dict(workload="LoR", market_seed=1, space="cube", backend="gpu"),
    dict(workload="LoR", market_seed=1, backend="training"),
    dict(workload="qwen1.5-0.5b", market_seed=1, backend="training",
         space="continuous"),
    dict(workload="LoR", market_seed=2, scheduler="pbt", population=4),
]


@pytest.mark.parametrize("fields", _INVALID, ids=range(len(_INVALID)))
def test_spec_validation_and_policy_equal_reference(fields):
    a, b = js.ScenarioSpec(**fields), ts.ScenarioSpec(**fields)
    assert b.asdict() == a.asdict()
    assert b.validation_errors() == a.validation_errors()
    assert ts.resolve_policy(b) == js.resolve_policy(a)


def test_scenario_grid_equals_reference():
    axes = dict(theta=[0.3, 0.7], scheduler=("asha", "pbt"), engine_seed=range(2),
                revpred="zero", days=6.0)
    a = js.scenario_grid(NAMES[:2], range(3), **axes)
    b = ts.scenario_grid(NAMES[:2], range(3), **axes)
    assert [s.asdict() for s in b] == [s.asdict() for s in a]
    assert [s.market_key() for s in b] == [s.market_key() for s in a]
    assert {f.name for f in dataclasses.fields(ts.ScenarioSpec)} == \
        {f.name for f in dataclasses.fields(js.ScenarioSpec)}


def test_unported_paths_raise():
    from repro_torch.backends import make_backend
    from repro_torch.core.market import SpotMarket
    spec = ts.ScenarioSpec(workload="LoR", market_seed=1, revpred="revpred")
    import torch
    if not torch.cuda.is_available():
        # the training backend's trials run on the card by default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_backend("training")
        # the learned kinds train on the card by default (RevPred.train)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.build_revpred(spec, SpotMarket(days=2, seed=1))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.SweepRunner()


def test_exact_ticks_env_equals_reference(monkeypatch):
    """``REPRO_EXACT_TICKS=1`` makes both packages' ``EngineConfig``
    default to the tick-for-tick loop; the sweep under it stays the
    reference's."""
    from repro.tuner.engine import EngineConfig as JCfg
    from repro_torch.tuner.engine import EngineConfig as TCfg
    monkeypatch.setenv("REPRO_EXACT_TICKS", "1")
    assert JCfg().exact_ticks is True and TCfg().exact_ticks is True
    kw = dict(revpred="oracle", theta=0.7, days=2.0, scheduler="spottune")
    tg = ts.scenario_grid(NAMES[:2], (3,), **kw)
    assert all(r.engine.cfg.exact_ticks
               for r in ts.SweepRunner(device="cpu").prepare(tg))
    want = js.SweepRunner().run(js.scenario_grid(NAMES[:2], (3,), **kw))
    got = ts.SweepRunner(device="cpu").run(tg)
    (recs, errs), (want_recs, want_errs) = _records(got), _records(want)
    assert recs == want_recs
    for e, w in zip(errs, want_errs):
        np.testing.assert_allclose(e, w, rtol=0, atol=PRED_ERR_ATOL)
    monkeypatch.delenv("REPRO_EXACT_TICKS")
    assert JCfg().exact_ticks is False and TCfg().exact_ticks is False
