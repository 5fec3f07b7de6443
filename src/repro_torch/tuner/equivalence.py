"""Fast/exact equivalence harness for the execution engine.

The event-driven fast path (``EngineConfig(exact_ticks=False)``, the default)
claims to be *equivalent* to the legacy tick-for-tick loop: every externally
observable outcome — dollars billed and refunded, per-allocation billing
records, trial finish times, full per-trial metric histories, the event log —
must match.  Step counters (``steps``, ``lost_steps``, ``free_steps``) are
accumulated tick-by-tick on the exact path but as one fused sum per window on
the fast path, so they may differ by float-rounding dust; they are compared
to a tight relative tolerance instead of bit-for-bit.

``compare_runs`` runs the same tuning problem through both paths on fresh
market replicas and returns a report of any differences (empty == equivalent).
``compare_sweep_modes``, ``compare_service_modes`` and
``compare_ledger_modes`` hold the SoA stepper, the tuning service and the
columnar ledger to their reference paths the same way.

Every function that builds a runner, a sweep, a service or a scheduler
takes ``device`` (the card unless the caller asks for the CPU) and builds
both sides of its comparison there: the simulation is numpy on the host
either way, and the card runs the SoA kernel and the EarlyCurve fits.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

from repro_torch.core.market import SpotMarket
from repro_torch.core.provisioner import ZeroRevPred
from repro_torch.core.trial import SimTrialBackend, Workload, make_trials
from repro_torch.tuner.engine import ExecutionEngine, build_engine
from repro_torch.tuner.searchers import ListSearcher
from repro_torch.tuner.spottune import SpotTuneScheduler
from repro_torch.tuner.tuner import RunResult, Tuner

STEP_RTOL = 1e-9


def _close(a: float, b: float, rtol: float = STEP_RTOL) -> bool:
    return math.isclose(a, b, rel_tol=rtol, abs_tol=1e-9)


def _diff_events(fast: List[tuple], exact: List[tuple], out: List[str]) -> None:
    if len(fast) != len(exact):
        out.append(f"event count: fast={len(fast)} exact={len(exact)}")
        return
    for i, (ef, ee) in enumerate(zip(fast, exact)):
        if len(ef) != len(ee) or ef[:3] != ee[:3]:
            out.append(f"event[{i}]: fast={ef} exact={ee}")
            continue
        for f, e in zip(ef[3:], ee[3:]):
            if isinstance(f, dict):           # release billing record
                for key in ("inst", "held_s", "revoked", "cost", "refund"):
                    if f[key] != e[key]:
                        out.append(f"event[{i}] release {key}: "
                                   f"fast={f[key]} exact={e[key]}")
            elif isinstance(f, float):
                if not _close(f, e):
                    out.append(f"event[{i}] payload: fast={ef} exact={ee}")
            elif f != e:
                out.append(f"event[{i}] payload: fast={ef} exact={ee}")


def compare_engines(fast: ExecutionEngine, exact: ExecutionEngine,
                    fast_res: RunResult, exact_res: RunResult) -> List[str]:
    """Diff two finished runs; returns human-readable mismatch lines."""
    out: List[str] = []
    if fast.market.billed != exact.market.billed:
        out.append(f"billed: fast={fast.market.billed!r} "
                   f"exact={exact.market.billed!r}")
    if fast.market.refunded != exact.market.refunded:
        out.append(f"refunded: fast={fast.market.refunded!r} "
                   f"exact={exact.market.refunded!r}")
    if fast.t != exact.t:
        out.append(f"engine.t: fast={fast.t} exact={exact.t}")
    fs = {s.key: s for s in fast.states}
    es = {s.key: s for s in exact.states}
    if set(fs) != set(es):
        out.append(f"trial keys differ: {set(fs) ^ set(es)}")
        return out
    for key, f in fs.items():
        e = es[key]
        if f.status != e.status:
            out.append(f"{key} status: fast={f.status} exact={e.status}")
        if f.finish_time != e.finish_time:
            out.append(f"{key} finish_time: fast={f.finish_time} "
                       f"exact={e.finish_time}")
        if f.metrics_steps != e.metrics_steps:
            out.append(f"{key} metrics_steps differ")
        if f.metrics_vals != e.metrics_vals:
            out.append(f"{key} metrics_vals differ")
        if f.redeployments != e.redeployments:
            out.append(f"{key} redeployments: fast={f.redeployments} "
                       f"exact={e.redeployments}")
        for attr in ("steps", "free_steps", "lost_steps", "ckpt_seconds",
                     "restore_seconds"):
            if not _close(getattr(f, attr), getattr(e, attr)):
                out.append(f"{key} {attr}: fast={getattr(f, attr)!r} "
                           f"exact={getattr(e, attr)!r}")
    _diff_events(fast.events, exact.events, out)
    if fast_res.predicted_rank != exact_res.predicted_rank:
        out.append("predicted_rank differs")
    if fast_res.jct != exact_res.jct:
        out.append(f"jct: fast={fast_res.jct} exact={exact_res.jct}")
    return out


def run_one(workload: Workload, exact_ticks: bool, market_seed: int = 3,
            seed: int = 0, theta: float = 0.7, mcnt: int = 3,
            days: float = 12.0, revpred_factory: Optional[Callable] = None,
            scheduler_factory: Optional[Callable] = None,
            searcher_factory: Optional[Callable] = None,
            initial_trials: Optional[int] = None,
            n_trials: Optional[int] = None,
            ledger: Optional[str] = None, device="cuda", **engine_kw):
    """One tuning run on a fresh market replica -> (engine, RunResult).

    ``searcher_factory(workload)`` swaps the default ListSearcher prefix
    (paired policies like PBT bring their own explore searcher);
    ``initial_trials`` passes through to the Tuner for incremental
    suggestion; ``ledger`` forces the market's allocation-ledger layout
    ("scalar" | "columnar", None = default); the default SpotTune
    scheduler's curve fits run on ``device``."""
    market = SpotMarket(days=days, seed=market_seed, ledger=ledger)
    backend = SimTrialBackend(market.pool)
    revpred = (revpred_factory or (lambda m: ZeroRevPred()))(market)
    engine = build_engine(market, backend, revpred, seed=seed,
                          exact_ticks=exact_ticks, **engine_kw)
    scheduler = (scheduler_factory or
                 (lambda: SpotTuneScheduler(theta=theta, mcnt=mcnt,
                                            seed=seed, device=device)))()
    if searcher_factory is not None:
        assert n_trials is None, \
            "n_trials only trims the default ListSearcher; cap the " \
            "searcher_factory's own suggestion budget instead"
        searcher = searcher_factory(workload)
    else:
        trials = make_trials(workload)
        if n_trials is not None:
            trials = trials[:n_trials]
        searcher = ListSearcher(trials)
    res = Tuner(engine, scheduler, searcher,
                initial_trials=initial_trials).run()
    return engine, res


def compare_runs(workload: Workload, **kw) -> List[str]:
    """Run fast and exact on fresh market replicas and diff them."""
    fast_eng, fast_res = run_one(workload, exact_ticks=False, **kw)
    exact_eng, exact_res = run_one(workload, exact_ticks=True, **kw)
    return compare_engines(fast_eng, exact_eng, fast_res, exact_res)


def compare_sweep_modes(specs, use_tables: bool = True,
                        device="cuda") -> List[str]:
    """Run one ScenarioSpec grid through the SoA stepper and through the
    generator round-robin path on independently built replica sets (shared
    caches dropped before each, so neither warms the other) and diff every
    replica's engine pairwise with ``compare_engines``.  Empty == the SoA
    fast path is bit-exact.  ``use_tables=False`` pins the stepper to the
    scalar lifecycle chain (no batched decision tables)."""
    from repro_torch.sweep import runner as runner_mod
    from repro_torch.sweep.soa import SoaSweep, soa_supported

    runner = runner_mod.SweepRunner(device=device)
    runner_mod.clear_shared_caches()
    soa_tuners = runner.prepare(specs)
    if not soa_supported(soa_tuners):
        return ["grid not soa_supported — nothing to compare"]
    SoaSweep(soa_tuners, use_tables=use_tables, device=device).run()

    runner_mod.clear_shared_caches()
    gen_res = runner.run(specs, mode="batched")

    out: List[str] = []
    for spec, ts, rr in zip(specs, soa_tuners, gen_res.replicas):
        label = (f"{spec.workload}/{spec.scheduler}"
                 f"/m{spec.market_seed}/e{spec.engine_seed}")
        if ts.result is None:
            out.append(f"[{label}] soa replica never finished")
            continue
        hist = {s.key: (list(s.metrics_steps), list(s.metrics_vals))
                for s in ts.engine.views()}
        if hist != rr.metrics:
            out.append(f"[{label}] metric histories differ")
        for field in ("cost", "refunded", "jct", "predicted_rank",
                      "redeployments", "events"):
            a, b = getattr(ts.result, field), getattr(rr.result, field)
            if a != b:
                out.append(f"[{label}] result.{field}: soa={a!r} gen={b!r}")
        for field in ("steps_total", "free_steps", "lost_steps",
                      "ckpt_seconds", "restore_seconds"):
            if not _close(getattr(ts.result, field), getattr(rr.result, field)):
                out.append(f"[{label}] result.{field}: "
                           f"soa={getattr(ts.result, field)!r} "
                           f"gen={getattr(rr.result, field)!r}")
    return out


def compare_service_modes(specs, policy: str = "fifo",
                          policy_params: Optional[dict] = None,
                          device="cuda") -> List[str]:
    """Pin the tuning service's degenerate case: one tenant, contention
    disabled.  The same ScenarioSpec grid runs once as a single submitted
    ``StudySpec`` through ``TuningService`` (under any fairness policy —
    with one study, admission must be inert) and once through the plain
    ``SweepRunner`` SoA path, on independently built replica sets (shared
    caches dropped before each).  Billing records, event logs, metric
    histories, and results must match bit-exact; empty == equivalent."""
    from repro_torch.service import StudySpec, StudyStatus, TuningService
    from repro_torch.sweep import runner as runner_mod
    from repro_torch.sweep.soa import SoaSweep, soa_supported

    runner_mod.clear_shared_caches()
    svc = TuningService(policy=policy, policy_params=policy_params,
                        contention=False, device=device)
    sid = svc.submit(StudySpec(tenant="t0", specs=tuple(specs)))
    svc.run_until_complete()
    svc_rec = svc.registry.get(sid)

    runner = runner_mod.SweepRunner(device=device)
    runner_mod.clear_shared_caches()
    ref = runner.prepare(specs)
    if not soa_supported(ref):
        return ["grid not soa_supported — nothing to compare"]
    SoaSweep(ref, device=device).run()

    out: List[str] = []
    if svc_rec.status is not StudyStatus.DONE:
        out.append(f"service study status: {svc_rec.status}")
    if len(svc_rec.records) != len(specs):
        out.append(f"streamed records: service={len(svc_rec.records)} "
                   f"expected={len(specs)}")
    for spec, tv, tr in zip(specs, svc_rec.tuners, ref):
        label = (f"{spec.workload}/{spec.scheduler}"
                 f"/m{spec.market_seed}/e{spec.engine_seed}")
        if tv.result is None or tr.result is None:
            out.append(f"[{label}] replica never finished")
            continue
        sub = compare_engines(tv.engine, tr.engine, tv.result, tr.result)
        out.extend(f"[{label}] {line}" for line in sub)
        for field in ("cost", "refunded", "jct", "predicted_rank",
                      "redeployments", "events"):
            a, b = getattr(tv.result, field), getattr(tr.result, field)
            if a != b:
                out.append(f"[{label}] result.{field}: "
                           f"service={a!r} runner={b!r}")
        for field in ("steps_total", "free_steps", "lost_steps",
                      "ckpt_seconds", "restore_seconds"):
            if not _close(getattr(tv.result, field),
                          getattr(tr.result, field)):
                out.append(f"[{label}] result.{field}: "
                           f"service={getattr(tv.result, field)!r} "
                           f"runner={getattr(tr.result, field)!r}")
    return out


def compare_ledger_modes(specs, device="cuda") -> List[str]:
    """Run one ScenarioSpec grid through the SoA stepper twice — once under
    the scalar allocation ledger (the reference implementation) and once
    under the columnar one — on independently built replica sets (shared
    caches dropped before each) and diff every observable outcome strictly.
    Empty == the columnar ledger's batched crossing search and prefix-sum
    billing are bit-exact against the scalar acquire/release loop."""
    import dataclasses

    from repro_torch.sweep import runner as runner_mod
    from repro_torch.sweep.soa import SoaSweep, soa_supported

    runner = runner_mod.SweepRunner(device=device)
    by_kind = {}
    for kind in ("scalar", "columnar"):
        runner_mod.clear_shared_caches()
        tuners = runner.prepare([dataclasses.replace(s, ledger=kind)
                                 for s in specs])
        if not soa_supported(tuners):
            return ["grid not soa_supported — nothing to compare"]
        SoaSweep(tuners, device=device).run()
        by_kind[kind] = tuners

    out: List[str] = []
    for spec, ts, tc in zip(specs, by_kind["scalar"], by_kind["columnar"]):
        label = (f"{spec.workload}/{spec.scheduler}"
                 f"/m{spec.market_seed}/e{spec.engine_seed}")
        if ts.result is None or tc.result is None:
            out.append(f"[{label}] replica never finished")
            continue
        assert ts.engine.market.ledger.kind == "scalar"
        assert tc.engine.market.ledger.kind == "columnar"
        for field in ("cost", "refunded", "jct", "predicted_rank",
                      "redeployments", "events"):
            a, b = getattr(ts.result, field), getattr(tc.result, field)
            if a != b:
                out.append(f"[{label}] result.{field}: "
                           f"scalar={a!r} columnar={b!r}")
        if (ts.engine.market.billed != tc.engine.market.billed
                or ts.engine.market.refunded != tc.engine.market.refunded):
            out.append(f"[{label}] market totals: "
                       f"scalar=({ts.engine.market.billed!r}, "
                       f"{ts.engine.market.refunded!r}) "
                       f"columnar=({tc.engine.market.billed!r}, "
                       f"{tc.engine.market.refunded!r})")
    return out
