"""The port's equivalence harness (``repro_torch.tuner.equivalence``) on the
CPU: each ``compare_*`` returns no difference on its grid, its runs equal
the JAX package's, and it reports a difference planted in one of its two
runs (a harness that compared nothing would also return ``[]``)."""

import dataclasses

import pytest
from _torch_port import run_outcome

import repro.tuner.equivalence as je
import repro_torch.sweep as tsw
import repro_torch.tuner.equivalence as te
from repro.core.trial import WORKLOADS as JW
from repro_torch.core.trial import WORKLOADS as TW
from repro_torch.service import TuningService
from repro_torch.sweep import soa as soa_mod

NAMES = [w.name for w in TW[:4]]


def _specs(names=NAMES, seeds=(1, 3), **kw):
    kw = dict(dict(revpred="oracle", theta=0.7, days=8.0), **kw)
    return tsw.scenario_grid(names, seeds, **kw)


@pytest.mark.parametrize("kw", [dict(market_seed=3, n_trials=6),
                                dict(market_seed=7, theta=1.0, n_trials=4),
                                dict(market_seed=1, ledger="scalar",
                                     n_trials=4)],
                         ids=["seed3", "theta1", "scalar-ledger"])
def test_compare_runs_empty(kw):
    """Fast path against exact ticks, on one workload over 8-day markets."""
    assert te.compare_runs(TW[0], days=8.0, device="cpu", **kw) == []


def test_run_one_equals_reference():
    for exact in (False, True):
        a_eng, a_res = je.run_one(JW[1], exact, days=8.0, n_trials=5)
        b_eng, b_res = te.run_one(TW[1], exact, days=8.0, n_trials=5,
                                  device="cpu")
        assert run_outcome(b_eng, b_res) == run_outcome(a_eng, a_res)


@pytest.mark.parametrize("use_tables", [True, False],
                         ids=["tables", "scalar-chain"])
def test_compare_sweep_modes_empty(use_tables):
    assert te.compare_sweep_modes(_specs(), use_tables=use_tables,
                                  device="cpu") == []


@pytest.mark.parametrize("scheduler", ["spottune", "pbt"])
def test_compare_ledger_modes_empty(scheduler):
    assert te.compare_ledger_modes(_specs(scheduler=scheduler),
                                   device="cpu") == []


# --------------------------------------------------- planted differences


@pytest.mark.parametrize("plant", ["billed", "refunded", "event", "finish",
                                   "metrics", "jct"])
def test_compare_engines_reports_a_planted_difference(plant):
    a_eng, a_res = te.run_one(TW[0], False, days=8.0, n_trials=4,
                              device="cpu")
    b_eng, b_res = te.run_one(TW[0], False, days=8.0, n_trials=4,
                              device="cpu")
    assert te.compare_engines(a_eng, b_eng, a_res, b_res) == []
    st = b_eng.states[0]
    if plant == "billed":
        b_eng.market.billed += 1e-9
    elif plant == "refunded":
        b_eng.market.refunded += 0.01
    elif plant == "event":
        i = len(b_eng.events) // 2
        ev = b_eng.events[i]
        b_eng.events[i] = (ev[0] + 1.0,) + tuple(ev[1:])
    elif plant == "finish":
        st.finish_time = (st.finish_time or 0.0) + 1.0
    elif plant == "metrics":
        st.metrics_vals[-1] += 1e-6
    else:
        b_res = dataclasses.replace(b_res, jct=b_res.jct + 1.0)
    diff = te.compare_engines(a_eng, b_eng, a_res, b_res)
    assert diff, plant
    word = {"billed": "billed", "refunded": "refunded", "event": "event[",
            "finish": "finish_time", "metrics": "metrics_vals",
            "jct": "jct"}[plant]
    assert any(word in line for line in diff), diff


def test_compare_engines_words_equal_reference():
    """The same planted difference is worded as the reference words it."""
    a_eng, a_res = te.run_one(TW[0], False, days=8.0, n_trials=4,
                              device="cpu")
    b_eng, b_res = te.run_one(TW[0], False, days=8.0, n_trials=4,
                              device="cpu")
    b_eng.market.billed += 0.5
    b_eng.states[1].redeployments += 1
    b_eng.events.append(b_eng.events[-1])
    assert te.compare_engines(a_eng, b_eng, a_res, b_res) == \
        je.compare_engines(a_eng, b_eng, a_res, b_res)
    assert len(te.compare_engines(a_eng, b_eng, a_res, b_res)) == 3


def test_compare_service_modes_reports_a_planted_difference(monkeypatch):
    """One replica's billing moved after the service's run: reported."""
    run = TuningService.run_until_complete

    def perturbed(self, *a, **k):
        run(self, *a, **k)
        self.registry.all()[0].tuners[1].engine.market.billed += 0.01

    monkeypatch.setattr(TuningService, "run_until_complete", perturbed)
    specs = _specs(["LoR"], (1, 3))
    diff = te.compare_service_modes(specs, device="cpu")
    assert len(diff) == 1 and diff[0].startswith("[LoR/spottune/m3/e0] billed")


def test_compare_ledger_modes_reports_a_planted_difference(monkeypatch):
    """One columnar replica's refund moved after its sweep: reported."""
    run = soa_mod.SoaSweep.run

    def perturbed(self):
        run(self)
        m = self.engines[0].market
        if m.ledger.kind == "columnar":
            m.refunded += 0.01

    monkeypatch.setattr(soa_mod.SoaSweep, "run", perturbed)
    diff = te.compare_ledger_modes(_specs(["SVM"], (1,)), device="cpu")
    assert len(diff) == 1 and "market totals" in diff[0]


def test_compare_sweep_modes_reports_a_planted_difference(monkeypatch):
    """One SoA replica's metric history moved after its sweep: reported."""
    run = soa_mod.SoaSweep.run

    def perturbed(self):
        run(self)
        self.engines[-1].states[0].metrics_vals[0] += 1e-6

    monkeypatch.setattr(soa_mod.SoaSweep, "run", perturbed)
    diff = te.compare_sweep_modes(_specs(["LoR"], (1, 3)), device="cpu")
    assert diff == ["[LoR/spottune/m3/e0] metric histories differ"]
