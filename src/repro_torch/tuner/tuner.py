"""Tuner facade: engine + scheduler + searcher = one HPT run.

    engine    = ExecutionEngine(market, backend, provisioner, EngineConfig())
    tuner     = Tuner(engine, SpotTuneScheduler(theta=0.7, mcnt=3),
                      GridSearcher(workload))
    result    = tuner.run()          # -> RunResult

The facade (1) seeds the engine from the searcher — all of it by default
(Grid keeps its legacy drain-up-front behavior), or the first
``initial_trials`` for unbounded/adaptive search; (2) alternates
``engine.run_until_idle()`` with idle rounds where the scheduler may request
fresh suggestions (``request_suggestions``) and return promotions
(``on_idle``) until neither produces work; and (3) assembles the
``RunResult`` — cost/JCT/refund accounting from the engine, predicted
ranking from the scheduler, ground truth from the backend.  The legacy
``repro.core.orchestrator`` API is a thin shim over this.

``run_cooperative()`` is the generator form: it suspends at every engine
deploy point (``ProvisionBatch``) and idle curve-fit point (``FitRequest``)
so a sweep runner can interleave many replicas and batch their suspended
work cross-replica; ``run()`` drives the same generator with local
servicing, bit-identical to the pre-cooperative loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.tuner.engine import ExecutionEngine, Status
from repro_torch.tuner.scheduler import Scheduler, Searcher


@dataclasses.dataclass
class RunResult:
    cost: float
    refunded: float
    jct: float
    steps_total: float
    free_steps: float
    lost_steps: float
    ckpt_seconds: float
    restore_seconds: float
    redeployments: int
    predicted_rank: List[str]
    true_rank: List[str]
    top1_correct: bool
    top3_contains_best: bool
    pred_errors: Dict[str, float]
    per_trial_steps: Dict[str, float]
    events: List[tuple]

    @property
    def free_frac(self) -> float:
        return self.free_steps / max(self.steps_total, 1.0)

    @property
    def ckpt_frac(self) -> float:
        return (self.ckpt_seconds + self.restore_seconds) / max(self.jct, 1e-9)

    def pcr(self, alpha: float = 1.0) -> float:
        return alpha / max(self.jct * max(self.cost, 1e-9), 1e-12)


@dataclasses.dataclass
class FitRequest:
    """A suspended idle curve-fit point of ``Tuner.run_cooperative``.

    ``jobs`` is the scheduler's ``idle_fit_jobs`` list; the driver must set
    ``responses`` (one predicted final per job, in order) before resuming.
    ``service_local`` answers with the scheduler's own fitter; a sweep
    runner instead stacks the jobs of many idle replicas into one batched
    LM solve (``repro_torch.core.earlycurve.predict_final_grouped``)."""

    scheduler: Scheduler
    jobs: list
    responses: Optional[list] = None

    def service_local(self) -> None:
        self.responses = self.scheduler.run_idle_fits(self.jobs)


class Tuner:
    def __init__(self, engine: ExecutionEngine, scheduler: Scheduler,
                 searcher: Searcher, initial_trials: Optional[int] = None):
        self.engine = engine
        self.scheduler = scheduler
        self.searcher = searcher
        self._result: Optional[RunResult] = None
        self._reported: set = set()
        engine.bind(scheduler)
        # paired policies (e.g. PBT's exploit/explore split) let the
        # searcher read scheduler state when asked for a suggestion
        if hasattr(searcher, "bind_scheduler"):
            searcher.bind_scheduler(scheduler)
        n = 0
        while initial_trials is None or n < initial_trials:
            spec = searcher.suggest()
            if spec is None:
                break
            self._admit(spec)
            n += 1
        if not engine.states:
            raise ValueError("searcher suggested no trials")

    def _admit(self, spec) -> None:
        target = self.scheduler.on_trial_added(spec)
        if target is None:
            target = spec.workload.max_trial_steps
        self.engine.add_trial(spec, target)

    def _feed_results(self, views) -> None:
        """Stream finished-trial metrics to searchers that opted in
        (``live_results``) — the feedback adaptive searchers refine on."""
        rich = getattr(self.searcher, "on_trial_finished", None)
        for v in views:
            if v.status == Status.FINISHED and v.key not in self._reported:
                self._reported.add(v.key)
                self.searcher.on_result(
                    v.key, v.metrics_vals[-1] if v.metrics_vals else None)
                if rich is not None:
                    # cost-aware searchers want the whole view (billed $,
                    # steps run, fidelity) — not just the last metric
                    rich(v)

    def idle_round(self):
        """One engine-drained idle round, as a generator: may yield a single
        ``FitRequest`` (service it, then resume); returns True if the round
        produced new engine work (fresh suggestions admitted or promotions
        resumed) and False when the run is over.  Factored out of
        ``run_cooperative`` so batch drivers that step many engines directly
        (the SoA sweep path) reuse the identical idle policy."""
        engine, scheduler, searcher = self.engine, self.scheduler, self.searcher
        views = engine.views()
        if getattr(searcher, "live_results", False):
            self._feed_results(views)
        n = scheduler.request_suggestions(views)
        if n:
            added = 0
            for _ in range(n):
                spec = searcher.suggest()
                if spec is None:
                    break
                self._admit(spec)
                added += 1
            scheduler.suggestions_added(added)
            if added:
                return True
        jobs = scheduler.idle_fit_jobs(views)
        if jobs:
            req = FitRequest(scheduler, jobs)
            yield req
            assert req.responses is not None, "unserviced FitRequest"
            scheduler.set_idle_fits(req.responses)
        promotions = scheduler.on_idle(views)
        if not promotions:
            return False
        engine.resume(promotions)
        return True

    def finish(self) -> None:
        """Assemble the RunResult once no more work remains."""
        self._result = self._assemble()

    def run_cooperative(self):
        """Generator form of ``run()``: yields ``ProvisionBatch`` (engine
        deploy points) and ``FitRequest`` (idle curve fits); each must be
        serviced before resuming.  The finished ``RunResult`` lands in
        ``self.result`` when the generator is exhausted."""
        while True:
            yield from self.engine.run_cooperative()
            more = yield from self.idle_round()
            if not more:
                break
        self.finish()

    @property
    def result(self) -> Optional[RunResult]:
        return self._result

    def run(self) -> RunResult:
        for req in self.run_cooperative():
            req.service_local()
        return self._result

    def _assemble(self) -> RunResult:
        engine, scheduler = self.engine, self.scheduler
        views = engine.views()
        preds = scheduler.predictions(views)
        predicted_rank = scheduler.rank(views)
        if not getattr(self.searcher, "live_results", False):
            for v in views:
                self.searcher.on_result(v.key, preds.get(v.key))

        true_finals = {v.key: engine.backend.true_final(v.spec) for v in views}
        true_rank = [k for k, _ in sorted(true_finals.items(), key=lambda kv: kv[1])]
        pred_errors = {
            k: abs(preds[k] - true_finals[k]) / max(abs(true_finals[k]), 1e-9)
            for k in preds}

        return RunResult(
            cost=engine.market.billed,
            refunded=engine.market.refunded,
            jct=max([s.finish_time for s in views] + [engine.t]),
            steps_total=sum(s.steps for s in views),
            free_steps=sum(s.free_steps for s in views),
            lost_steps=sum(s.lost_steps for s in views),
            ckpt_seconds=sum(s.ckpt_seconds for s in views),
            restore_seconds=sum(s.restore_seconds for s in views),
            redeployments=sum(s.redeployments for s in views),
            predicted_rank=predicted_rank,
            true_rank=true_rank,
            top1_correct=predicted_rank[0] == true_rank[0],
            top3_contains_best=true_rank[0] in predicted_rank[:3],
            pred_errors=pred_errors,
            per_trial_steps={s.key: s.steps for s in views},
            events=engine.events,
        )
