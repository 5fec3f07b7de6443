"""The deterministic cooperative event loop driving all admitted studies.

One ``pump()`` is one scheduling iteration:

1. build a ``StudyView`` per runnable study (usage, spend, weight) and ask
   the fairness policy for ``(admit, cancel)``;
2. apply cancellations (budget exhaustion) with a terminal record;
3. among the admitted studies, pick the one whose ``SoaSweep`` has the
   earliest upcoming simulated boundary — a global virtual clock over all
   studies, ties broken on submission order — lazily preparing it on first
   admission;
4. under contention, ``sync()`` that study's markets (absorb every demand
   impulse other studies emitted since its last step);
5. advance the study exactly one SoA round (``SoaSweep.step``), emit
   ``SweepResult``-shaped records for replicas that finished in it, and
   enforce the study's own budget cap.

The min-boundary ordering is what makes contention *causal*: when a study
emits impulses at simulated time t, every other study's clock is already
>= t, and impulses only touch minutes strictly after t — so no study ever
re-reads history that changed under it.  It also makes the whole service
a deterministic function of the submitted studies: ``step_log`` (who
stepped, at what simulated time) and ``admission_log`` (who was admitted,
at what normalized usage) replay identically for identical submissions.

With one study and contention off, the loop degenerates to
``while sweep.step(): pass`` over an ordinary ``SweepRunner.prepare``
grid — bit-exact with ``SweepRunner.run`` (``compare_service_modes``).

``TuningService(device=...)`` says where the port's tensors live: every
study's ``SoaSweep`` (its EWMA fold and boundary min run as the
``soa_step`` kernel on the card), the schedulers' EarlyCurve fits and the
learned RevPreds the runner trains.  It defaults to the card and raises
without one; pass ``"cpu"`` for the plain path.  The simulation state and
its arithmetic stay numpy on the host either way, so the card's answers
are the CPU's.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.service.market import MarketEnv, SharedSpotMarket
from repro_torch.service.registry import StudyRecord, StudyRegistry
from repro_torch.service.spec import StudySpec, StudyStatus
from repro_torch.service.admission import StudyView
from repro_torch.sweep.runner import SweepRunner
from repro_torch.sweep.result import ReplicaResult, SweepResult

# the metrics a service record carries — same set as SweepResult.records()
_RECORD_METRICS = ("cost", "refunded", "jct", "free_frac", "top1_correct",
                   "top3_contains_best", "pcr")


def _ledger_usage(market, now: float) -> float:
    """Accumulated concurrent instance-seconds on one market's ledger:
    closed allocations contribute their held span, live ones count up to
    ``now`` (the owning study's simulated clock)."""
    led = market.ledger
    if led.kind == "columnar":
        n = led.n
        if not n:
            return 0.0
        end = np.where(led.released[:n], led.t_end[:n], now)
        return float(np.sum(np.maximum(end - led.t_start[:n], 0.0)))
    total = 0.0
    for a in led.allocations:
        end = now
        if a.released:
            rec = led._records[a.alloc_id]
            end = a.t_start + (rec["held_s"] if rec is not None else 0.0)
        total += max(end - a.t_start, 0.0)
    return total


class TuningService:
    """Long-running multi-tenant tuning service (see module docstring)."""

    def __init__(self, policy: str = "fifo",
                 policy_params: Optional[dict] = None,
                 contention: bool = False, impact: float = 0.04,
                 window_min: int = 180, train_minutes: int = 2880,
                 revpred_epochs: int = 4, revpred_stride: int = 5,
                 device="cuda"):
        from repro_torch.tuner.registry import make_fairness_policy
        self.registry = StudyRegistry()
        self.policy = make_fairness_policy(policy, policy_params)
        self.contention = bool(contention)
        self.env = (MarketEnv(impact=impact, window_min=window_min)
                    if self.contention else None)
        self.runner = SweepRunner(train_minutes=train_minutes,
                                  revpred_epochs=revpred_epochs,
                                  revpred_stride=revpred_stride,
                                  device=device)
        self.device = self.runner.device
        self._pump_no = 0
        # deterministic replay surfaces:
        # (pump, study_id, simulated time stepped at)
        self.step_log: List[tuple] = []
        # (pump, admitted ids, {study_id: usage_s / weight})
        self.admission_log: List[tuple] = []

    # ---------------------------------------------------------- submission
    def submit(self, study: StudySpec) -> str:
        """Validate and register a study; returns its id.  Rejection names
        every invalid field of the whole batch in one error."""
        study.validate()
        return self.registry.add(study).study_id

    def cancel(self, study_id: str) -> bool:
        return self.registry.cancel(study_id)

    def pause(self, study_id: str) -> bool:
        return self.registry.pause(study_id)

    def resume(self, study_id: str) -> bool:
        return self.registry.resume(study_id)

    def poll(self, study_id: str, cursor: int = 0):
        return self.registry.poll(study_id, cursor)

    def stream(self, study_id: str) -> Iterator[dict]:
        """Yield the study's records as they appear, pumping the loop in
        between; returns when the study reaches a terminal status."""
        cursor = 0
        while True:
            recs, status = self.registry.poll(study_id, cursor)
            cursor += len(recs)
            yield from recs
            if status.terminal:
                return
            if not self.registry.runnable():
                return          # only paused studies remain: nothing to pump
            self.pump()

    # --------------------------------------------------------- scheduling
    def _prepare(self, rec: StudyRecord) -> None:
        from repro_torch.sweep.soa import SoaSweep, soa_supported
        specs = list(rec.specs)
        if self.contention:
            env = self.env
            factory = lambda spec: SharedSpotMarket(
                env, days=spec.days, seed=spec.market_seed,
                ledger=spec.ledger or None)
            tuners = self.runner.prepare(specs, market_factory=factory)
        else:
            tuners = self.runner.prepare(specs)
        if not soa_supported(tuners):
            raise ValueError(
                f"study {rec.study_id} is not SoA-steppable (exact ticks, "
                "straggler mode, or a non-simulation backend) — the service "
                "loop multiplexes studies through SoaSweep rounds")
        rec.tuners = tuners
        rec.sweep = SoaSweep(tuners, device=self.device)
        rec.markets = tuple(t.engine.market for t in tuners)
        rec.status = StudyStatus.RUNNING

    def _views(self, cands: List[StudyRecord]) -> List[StudyView]:
        views = []
        for r in cands:
            usage = spend = 0.0
            if r.sweep is not None:
                now = float(r.sweep.t.max())
                usage = sum(_ledger_usage(m, now) for m in r.markets)
                spend = sum(m.billed for m in r.markets)
            views.append(StudyView(
                study_id=r.study_id, tenant=r.spec.tenant, seq=r.seq,
                weight=r.spec.weight, usage_s=usage, spend=spend,
                budget_cap=r.spec.budget_cap))
        return views

    def _tenant_spend(self) -> Dict[str, float]:
        """Gross billed dollars per tenant across *all* their studies,
        terminal ones included (caps are cumulative)."""
        spend: Dict[str, float] = {}
        for r in self.registry.all():
            if r.markets:
                spend[r.spec.tenant] = (spend.get(r.spec.tenant, 0.0)
                                        + sum(m.billed for m in r.markets))
        return spend

    def _cancel_exhausted(self, rec: StudyRecord, reason: str) -> None:
        if self.registry.cancel(rec.study_id):
            rec.records.append({
                "event": "study_cancelled", "study_id": rec.study_id,
                "tenant": rec.spec.tenant, "reason": reason,
                "spend": sum(m.billed for m in rec.markets)
                if rec.markets else 0.0})

    def _emit_finished(self, rec: StudyRecord) -> None:
        sweep = rec.sweep
        for i in np.nonzero(sweep.done)[0]:
            i = int(i)
            if i in rec.emitted:
                continue
            tuner = rec.tuners[i]
            if tuner.result is None:
                continue
            rec.emitted.add(i)
            row = dict(rec.specs[i].asdict())
            row.update(study_id=rec.study_id, tenant=rec.spec.tenant,
                       replica=i)
            res = tuner.result
            for m in _RECORD_METRICS:
                v = getattr(res, m)
                row[m] = v() if callable(v) else v
            rec.records.append(row)

    def pump(self) -> bool:
        """One scheduling iteration; True if it made progress (stepped a
        study or cancelled one).  Raises on a policy that admits nothing
        while non-terminal candidates exist — a starved loop is a policy
        bug, not a steady state."""
        cands = self.registry.runnable()
        if not cands:
            return False
        self._pump_no += 1
        views = self._views(cands)
        admit, cancel = self.policy.select(views, self._tenant_spend())
        by_id = {r.study_id: r for r in cands}
        self.admission_log.append((
            self._pump_no, tuple(admit),
            {v.study_id: v.usage_s / v.weight for v in views}))
        for sid in cancel:
            self._cancel_exhausted(by_id[sid], "budget cap exhausted")
        if not admit:
            if cancel:
                return True
            raise RuntimeError(
                f"admission starved: policy {type(self.policy).__name__} "
                f"admitted no study out of {len(cands)} runnable")
        # the global virtual clock: step the admitted study that is due
        # first in simulated time (ties: submission order)
        rec = min((by_id[sid] for sid in admit),
                  key=lambda r: (r.next_time(), r.seq))
        if rec.status is StudyStatus.QUEUED:
            self._prepare(rec)
        if self.contention:
            for m in rec.markets:
                m.sync()
        t_at = rec.next_time()
        if rec.first_step_wall is None:
            rec.first_step_wall = time.perf_counter()
        more = rec.sweep.step()
        self.step_log.append((self._pump_no, rec.study_id, t_at))
        self._emit_finished(rec)
        if not more:
            rec.status = StudyStatus.DONE
            rec.done_wall = time.perf_counter()
            rec.result = SweepResult(
                [ReplicaResult(s, t.result, _svc_histories(t))
                 for s, t in zip(rec.specs, rec.tuners)],
                rec.done_wall - rec.submitted_wall, mode="service")
        elif (rec.spec.budget_cap is not None
              and sum(m.billed for m in rec.markets) >= rec.spec.budget_cap):
            self._cancel_exhausted(rec, "study budget_cap exhausted")
        return True

    def run_until_complete(self, max_pumps: Optional[int] = None) -> None:
        """Pump until no runnable study remains (paused studies stay put)."""
        pumps = 0
        while self.registry.runnable():
            if max_pumps is not None and pumps >= max_pumps:
                raise RuntimeError(f"max_pumps={max_pumps} exceeded")
            self.pump()
            pumps += 1


def _svc_histories(tuner) -> Dict[str, tuple]:
    return {s.key: (list(s.metrics_steps), list(s.metrics_vals))
            for s in tuner.engine.views()}
