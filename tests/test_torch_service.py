"""The port's multi-tenant tuning service (``repro_torch.service``) against
the JAX package's, on the CPU.

The service is numpy over the SoA stepper, so the contract is bit-exact:
for the same submissions both packages must give the same interleaving
(``step_log``), the same admission decisions and normalized usages
(``admission_log``), the same demand impulses (``env.events``), the same
study statuses and streamed records, the same billing and refunds on every
replica's market, and the same engine outcome, result and metric history
for every replica.  Only the wall-clock marks (``submitted_wall``,
``first_step_wall``, ``done_wall``) are exempt.  The contended three-tenant
run is also held with the card's round structure forced on (folds parked
into the round-end fold-and-min step, through the kernel's plain PyTorch
versions here).
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port import plain, run_outcome

import repro.service as js
import repro.sweep as jsw
import repro_torch.service as ts
import repro_torch.sweep as tsw
from repro.tuner.equivalence import \
    compare_service_modes as ref_compare_service_modes
from repro_torch.kernels import soa_step as tks
from repro_torch.service import loop as loop_mod
from repro_torch.tuner.equivalence import compare_service_modes

POLICIES = ("spottune", "asha", "hyperband", "pbt", "adaptive")
TENANTS = (("alice", "LoR", 1), ("bob", "SVM", 2), ("carol", "LoR", 3))
# EarlyCurve's prediction errors come from float32 curve fits (as in
# test_torch_sweep.py); every other field is exact
PRED_ERR_ATOL = 1e-5


def _grid(sweep_mod, workloads, seeds, **kw):
    kw.setdefault("revpred", "oracle")
    kw.setdefault("theta", 0.7)
    kw.setdefault("days", 8.0)
    return sweep_mod.scenario_grid(workloads, seeds, **kw)


def _service(pkg, **kw):
    """A service of ``pkg`` (``"jax"`` or ``"torch"``), from cold caches."""
    if pkg == "jax":
        jsw.clear_shared_caches()
        return js.TuningService(**kw), js, jsw
    tsw.clear_shared_caches()
    return ts.TuningService(device="cpu", **kw), ts, tsw


def _three_tenants(pkg, contention=True, impact=0.04, policy="maxmin",
                   params=None, **grid_kw):
    svc, smod, swmod = _service(pkg, policy=policy,
                                policy_params=dict(params or {"max_active": 2}),
                                contention=contention, impact=impact)
    ids = [svc.submit(smod.StudySpec(
        tenant=t, specs=tuple(_grid(swmod, [w], [s], **grid_kw))))
        for t, w, s in TENANTS]
    svc.run_until_complete()
    return svc, ids


def _study(rec):
    """Everything of one study the two packages must agree on."""
    out = {"status": rec.status.name, "seq": rec.seq,
           "records": rec.records,
           "specs": [s.asdict() for s in rec.specs],
           "emitted": sorted(rec.emitted)}
    if rec.markets:
        out["billing"] = [(m.billed, m.refunded) for m in rec.markets]
    if rec.tuners is not None:
        out["replicas"] = [
            (run_outcome(t.engine, t.result) if t.result is not None
             else plain(list(t.engine.events)),
             loop_mod._svc_histories(t)) for t in rec.tuners]
    if rec.result is not None:
        out["result"], out["pred_errors"] = [], []
        for r in rec.result.replicas:
            res = plain(dataclasses.asdict(r.result))
            pe = res.pop("pred_errors")
            out["result"].append((r.spec.asdict(), res, r.metrics))
            out["pred_errors"].append([pe[k] for k in sorted(pe)])
        out["result_mode"] = rec.result.mode
    return out


def _service_view(svc, ids):
    return {"step_log": svc.step_log, "admission_log": svc.admission_log,
            "events": None if svc.env is None else svc.env.events,
            "studies": [_study(svc.registry.get(i)) for i in ids]}


def _assert_equal(a_svc, a_ids, b_svc, b_ids):
    assert a_ids == b_ids
    a, b = _service_view(a_svc, a_ids), _service_view(b_svc, b_ids)
    for key in ("step_log", "admission_log", "events"):
        assert b[key] == a[key], key
    for sa, sb in zip(a["studies"], b["studies"]):
        ea, eb = sa.pop("pred_errors", []), sb.pop("pred_errors", [])
        assert sb == sa
        assert len(ea) == len(eb)
        for x, y in zip(eb, ea):
            np.testing.assert_allclose(x, y, rtol=0, atol=PRED_ERR_ATOL)


@pytest.mark.parametrize("contention,impact,ledger", [
    (True, 0.04, ""), (False, 0.04, ""), (True, 0.0, ""),
    (True, 0.04, "scalar")], ids=["contended", "uncontended", "zero-impact",
                                  "contended-scalar-ledger"])
def test_three_tenants_equal_reference(contention, impact, ledger):
    want = _three_tenants("jax", contention, impact, ledger=ledger)
    got = _three_tenants("torch", contention, impact, ledger=ledger)
    _assert_equal(*want, *got)
    svc, ids = got
    assert all(svc.registry.get(i).status is ts.StudyStatus.DONE for i in ids)
    assert len(svc.step_log) > 10
    if contention and impact:
        assert len(svc.env.events) > 0
        # contention moved the outcome: not the uncontended dollars
        off, off_ids = _three_tenants("torch", False, ledger=ledger)
        assert [svc.registry.get(i).markets[0].billed for i in ids] != \
            [off.registry.get(i).markets[0].billed for i in off_ids]
        for i in ids:
            for m in svc.registry.get(i).markets:
                for inst in m.pool:
                    assert float(m.traces[inst.name].max()) <= \
                        2.0 * inst.od_price


@pytest.mark.parametrize("contention", [True, False],
                         ids=["contended", "uncontended"])
def test_three_tenants_fused_rounds_equal_reference(contention, monkeypatch):
    """The card's round structure on the CPU: every study's sweep parks its
    folds into ``soa_step_fused``'s plain version between rounds of other
    studies; the service's logs and outcomes stay the reference's."""
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
    prepare = ts.TuningService._prepare

    def fused_prepare(self, rec):
        prepare(self, rec)
        assert not rec.sweep.fuse_rounds        # the CPU default
        rec.sweep.fuse_rounds = True

    monkeypatch.setattr(ts.TuningService, "_prepare", fused_prepare)
    want = _three_tenants("jax", contention)
    got = _three_tenants("torch", contention)
    assert calls["fused"] > 0 and calls["fold"] > 0
    _assert_equal(*want, *got)


def test_fifo_max_active_one_equals_reference():
    def run(pkg):
        svc, smod, swmod = _service(pkg, policy="fifo",
                                    policy_params={"max_active": 1})
        ids = [svc.submit(smod.StudySpec(
            tenant=f"t{i}", specs=tuple(_grid(swmod, ["LoR"], [i + 1]))))
            for i in range(3)]
        svc.run_until_complete()
        return svc, ids

    want, got = run("jax"), run("torch")
    _assert_equal(*want, *got)
    svc, ids = got
    stepped = [sid for _, sid, _ in svc.step_log]
    last = {sid: len(stepped) - 1 - stepped[::-1].index(sid) for sid in ids}
    first = {sid: stepped.index(sid) for sid in ids}
    assert last[ids[0]] < first[ids[1]] and last[ids[1]] < first[ids[2]]


@pytest.mark.parametrize("how", ["study-cap", "tenant-policy"])
def test_budget_cancels_equal_reference(how):
    def run(pkg):
        if how == "study-cap":
            svc, smod, swmod = _service(pkg, policy="fifo")
            ids = [svc.submit(smod.StudySpec(
                tenant="cheap", budget_cap=0.01,
                specs=tuple(_grid(swmod, ["LoR"], [1]))))]
        else:
            svc, smod, swmod = _service(
                pkg, policy="budget", policy_params={"caps": {"beta": 0.005}})
            ids = [svc.submit(smod.StudySpec(
                tenant=t, specs=tuple(_grid(swmod, [w], [s]))))
                for t, w, s in (("alpha", "LoR", 1), ("beta", "SVM", 2))]
        svc.run_until_complete()
        return svc, ids

    want, got = run("jax"), run("torch")
    _assert_equal(*want, *got)
    svc, ids = got
    rec = svc.registry.get(ids[-1])
    assert rec.status is ts.StudyStatus.CANCELLED
    assert rec.records[-1]["event"] == "study_cancelled"
    if how == "tenant-policy":
        assert svc.registry.get(ids[0]).status is ts.StudyStatus.DONE


def _lifecycle(pkg):
    """cancel / pause / resume / poll / stream, logged step by step."""
    svc, smod, swmod = _service(pkg)
    log = []
    a = svc.submit(smod.StudySpec(tenant="t0",
                                  specs=tuple(_grid(swmod, ["LoR"], [1]))))
    log.append(("cancel", svc.cancel(a), svc.cancel(a),
                svc.registry.get(a).status.name))
    b = svc.submit(smod.StudySpec(tenant="t1",
                                  specs=tuple(_grid(swmod, ["LoR"], [1]))))
    log.append(("pause", svc.pause(b), svc.pause(b), svc.resume(a),
                len(svc.registry.runnable())))
    svc.run_until_complete()
    log.append(("paused", svc.registry.get(b).status.name, svc.resume(b),
                svc.registry.get(b).status.name))
    c = svc.submit(smod.StudySpec(tenant="t2",
                                  specs=tuple(_grid(swmod, ["LoR"], (1, 3)))))
    recs, status = svc.poll(c)
    log.append(("poll", recs, status.name))
    # stream c: b (resumed, queued first) and c step in turns
    log.append(("stream", list(svc.stream(c))))
    recs, status = svc.poll(c, cursor=1)
    log.append(("poll-1", recs, status.name))
    svc.run_until_complete()
    log.append(("done", [svc.registry.get(i).status.name for i in (a, b, c)]))
    return svc, [a, b, c], log


def test_cancel_pause_resume_poll_stream_equal_reference():
    want_svc, want_ids, want_log = _lifecycle("jax")
    got_svc, got_ids, got_log = _lifecycle("torch")
    assert got_log == want_log
    _assert_equal(want_svc, want_ids, got_svc, got_ids)
    assert got_log[-1] == ("done", ["CANCELLED", "DONE", "DONE"])
    assert len(got_log[4][1]) == 2        # one streamed record a replica
    for row in got_log[4][1]:
        assert row["study_id"] == got_ids[2] and row["tenant"] == "t2"


def test_unknown_ids_and_policies_equal_reference():
    for svc in (js.TuningService(), ts.TuningService(device="cpu")):
        with pytest.raises(KeyError, match="unknown study id 'study-9999'"):
            svc.poll("study-9999")
    for mod, kw in ((js, {}), (ts, {"device": "cpu"})):
        with pytest.raises(ValueError, match="unknown fairness policy"):
            mod.TuningService(policy="round-robin", **kw)


_BAD_SCENARIO = dict(workload="LoR", market_seed=0, backend="bogus",
                     scheduler="nope", searcher="missing", space="weird")


def _bad_study(mod, sweep_mod):
    return mod.StudySpec(tenant="", weight=-1.0, budget_cap=0.0, specs=(
        sweep_mod.ScenarioSpec(workload="LoR", market_seed=0, backend="bogus"),
        sweep_mod.ScenarioSpec(workload="LoR", market_seed=0,
                               scheduler="nope"),
        sweep_mod.ScenarioSpec(**_BAD_SCENARIO),
    ))


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_rejection_messages_equal_reference():
    a = jsw.ScenarioSpec(**_BAD_SCENARIO)
    b = tsw.ScenarioSpec(**_BAD_SCENARIO)
    assert b.validation_errors() == a.validation_errors()
    assert len(b.validation_errors()) == 4
    assert _message(b.validate) == _message(a.validate)
    sa, sb = _bad_study(js, jsw), _bad_study(ts, tsw)
    assert sb.validation_errors() == sa.validation_errors()
    msg = _message(sb.validate)
    assert msg == _message(sa.validate)
    assert msg.startswith("invalid StudySpec (9 problems): tenant must be")
    assert "specs[2]: unknown space" in msg
    svc = ts.TuningService(device="cpu")
    assert _message(lambda: svc.submit(sb)) == msg
    assert svc.registry.all() == []
    ok = ts.StudySpec(tenant="t", specs=[tsw.ScenarioSpec(workload="LoR",
                                                          market_seed=0)])
    assert ok.validation_errors() == [] and isinstance(ok.specs, tuple)
    assert _message(lambda: ts.StudySpec(tenant="t", specs=()).validate()) \
        == _message(lambda: js.StudySpec(tenant="t", specs=()).validate())


@pytest.mark.parametrize("scheduler", POLICIES)
def test_compare_service_modes_empty(scheduler):
    """The degenerate case: one tenant, contention off, equals the plain
    SoA sweep, in the port as in the reference."""
    names = ["LoR", "SVM"]
    specs = _grid(tsw, names, (1, 3), scheduler=scheduler)
    assert compare_service_modes(specs, device="cpu") == []
    assert ref_compare_service_modes(
        _grid(jsw, names, (1, 3), scheduler=scheduler)) == []


@pytest.mark.parametrize("fairness", ["fifo", "maxmin"])
def test_compare_service_modes_any_fairness_policy(fairness):
    specs = _grid(tsw, ["LoR"], (1, 3))
    assert compare_service_modes(specs, policy=fairness, device="cpu") == []


def test_ledger_usage_equal_reference():
    """The admission views' usage, read mid-run from both ledger kinds,
    equals the reference's ``_ledger_usage`` on the same markets."""
    from repro.service import loop as ref_loop
    svc, ids = _three_tenants("torch", ledger="scalar")
    for i in ids:
        rec = svc.registry.get(i)
        for m in rec.markets:
            for now in (0.0, 3600.0, float(rec.sweep.t.max())):
                assert loop_mod._ledger_usage(m, now) == \
                    ref_loop._ledger_usage(m, now)
    svc, ids = _three_tenants("torch")
    kinds = {m.ledger.kind for i in ids for m in svc.registry.get(i).markets}
    assert kinds == {"columnar"}
    for i in ids:
        rec = svc.registry.get(i)
        now = float(rec.sweep.t.max())
        for m in rec.markets:
            assert loop_mod._ledger_usage(m, now) == \
                ref_loop._ledger_usage(m, now) > 0.0


def test_service_runs_on_the_card_by_default():
    svc = ts.TuningService(device="cpu")
    assert svc.device.type == "cpu" and svc.runner.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.TuningService()
