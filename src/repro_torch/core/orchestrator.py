"""The legacy orchestrator API, a thin layer over ``repro_torch.tuner``.

The JAX package's ``repro.core.orchestrator``: ``Orchestrator`` is a
pre-built trial list plus an ``OrchestratorConfig`` in, a ``RunResult``
out, equivalent to ``Tuner(ExecutionEngine, SpotTuneScheduler,
ListSearcher)``; ``build_spottune`` wires it around a market, a backend and
a predictor (``fig10``'s integrated rows run through it).  The curve fits
of the SpotTune scheduler run on ``device``.

The single-spot baselines (paper §IV-A4) live here too: one dedicated spot
instance per trial, maximum price far above market (never revoked), full
training, no early shutdown.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.earlycurve import EarlyCurve
from repro_torch.core.market import InstanceType, SpotMarket
from repro_torch.core.provisioner import PerfModel, Provisioner
from repro_torch.core.trial import SimTrialBackend, TrialSpec
from repro_torch.tuner.engine import EngineConfig, ExecutionEngine, TrialState
from repro_torch.tuner.searchers import ListSearcher
from repro_torch.tuner.spottune import SpotTuneScheduler
from repro_torch.tuner.tuner import RunResult, Tuner


@dataclasses.dataclass
class OrchestratorConfig:
    theta: float = 0.7
    mcnt: int = 3
    tick_s: float = 10.0
    deploy_delay_s: float = 60.0       # VM/slice startup
    ckpt_bandwidth_bps: float = 120e6  # object-store write speed (fig12 knob)
    notice_s: float = 120.0
    straggler_factor: float = 0.0      # 0 = off (paper); >1 enables mitigation
    max_sim_s: float = 10 * 24 * 3600.0
    seed: int = 0

    def engine_config(self) -> EngineConfig:
        return EngineConfig(
            tick_s=self.tick_s, deploy_delay_s=self.deploy_delay_s,
            ckpt_bandwidth_bps=self.ckpt_bandwidth_bps, notice_s=self.notice_s,
            straggler_factor=self.straggler_factor, max_sim_s=self.max_sim_s,
            seed=self.seed)


class Orchestrator:
    """Pre-built trial list + OrchestratorConfig in, RunResult out."""

    def __init__(self, market: SpotMarket, backend: SimTrialBackend,
                 provisioner: Provisioner, trials: List[TrialSpec],
                 config: OrchestratorConfig,
                 earlycurve: Optional[EarlyCurve] = None, device="cuda"):
        self.market = market
        self.backend = backend
        self.prov = provisioner
        self.cfg = config
        self.ec = earlycurve or EarlyCurve(device=device)
        self.max_steps = trials[0].workload.max_trial_steps
        self.engine = ExecutionEngine(market, backend, provisioner,
                                      config.engine_config())
        self.tuner = Tuner(
            self.engine,
            SpotTuneScheduler(theta=config.theta, mcnt=config.mcnt,
                              earlycurve=self.ec, seed=config.seed),
            ListSearcher(trials))

    @property
    def states(self) -> List[TrialState]:
        return self.engine.states

    @property
    def events(self) -> List[tuple]:
        return self.engine.events

    @property
    def t(self) -> float:
        return self.engine.t

    def run(self) -> RunResult:
        return self.tuner.run()


# ---------------------------------------------------------------------------
# baselines (paper §IV-A4)
# ---------------------------------------------------------------------------


def run_single_spot_baseline(market: SpotMarket, backend: SimTrialBackend,
                             trials: List[TrialSpec], inst: InstanceType,
                             ckpt_bandwidth_bps: float = 120e6) -> RunResult:
    t0 = 0.0
    jct = 0.0
    total_steps = 0.0
    for tr in trials:
        spt = backend.step_time(tr, inst)
        dur = spt * tr.workload.max_trial_steps
        a = market.acquire(inst, max_price=inst.od_price * 10, t=t0)
        market.release(a, t0 + dur, revoked=False)
        jct = max(jct, dur)
        total_steps += tr.workload.max_trial_steps
    true_finals = {t.key: backend.true_final(t) for t in trials}
    rank = [k for k, _ in sorted(true_finals.items(), key=lambda kv: kv[1])]
    return RunResult(
        cost=market.billed, refunded=0.0, jct=jct, steps_total=total_steps,
        free_steps=0.0, lost_steps=0.0, ckpt_seconds=0.0, restore_seconds=0.0,
        redeployments=len(trials), predicted_rank=rank, true_rank=rank,
        top1_correct=True, top3_contains_best=True, pred_errors={},
        per_trial_steps={t.key: t.workload.max_trial_steps for t in trials},
        events=[])


def build_spottune(workload_trials: List[TrialSpec], market: SpotMarket,
                   backend: SimTrialBackend, revpred, theta: float = 0.7,
                   mcnt: int = 3, seed: int = 0, device="cuda",
                   **cfg_kw) -> Orchestrator:
    perf = PerfModel(market.pool)
    prov = Provisioner(market, revpred, perf, seed=seed)
    cfg = OrchestratorConfig(theta=theta, mcnt=mcnt, seed=seed, **cfg_kw)
    return Orchestrator(market, backend, prov, workload_trials, cfg,
                        device=device)
