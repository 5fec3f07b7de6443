"""Batched multi-replica sweep runtime.

``SweepRunner.run`` executes a ``ScenarioSpec`` grid concurrently in one
process: every replica's ``Tuner.run_cooperative`` generator is advanced
round-robin, and the requests the replicas suspend on are serviced in
cross-replica batches —

  * one grouped RevPred forward for all suspended deploy points, its
    parameters stacked across markets and replicas
    (``repro_torch.core.revpred.predict_pool_multi``), and
  * one bucketed EarlyCurve LM solve for all idle curve-fit points
    (``repro_torch.core.earlycurve.predict_final_grouped``) —

while the per-replica simulation state (market billing, perf matrix, RNG
stream, scheduler) stays fully isolated.  Shared *read-only* work is paid
once per market seed instead of once per replica: trace synthesis is
batch-vectorized across every (instance, seed) of the grid
(``synth_traces_batch``), prefix/blockmax/future-max indices are keyed by
trace identity, and trained RevPred bundles are reused across the
workload/policy axes.

Every replica's observable outcome — billing records, finish times, metric
histories — is bit-identical to running its spec alone through
``Tuner.run()`` (each group row of the grouped forward reads only its own
parameters).  ``run_sequential`` is that naive loop,
kept as the determinism reference and the throughput baseline; with
``cold=True`` it also drops the shared caches before every replica,
measuring what fully isolated runs would cost.

``SweepRunner(device=...)`` says where the port's tensors live: the
schedulers' EarlyCurve fits and the SoA stepper's fold and boundary-min
kernel.  It defaults to the card and raises without one; pass ``"cpu"`` for
the plain path.  Learned RevPreds bring their own device.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

from repro_torch.core import earlycurve as earlycurve_mod
from repro_torch.core import market as market_mod
from repro_torch.core import revpred as revpred_mod
from repro_torch.core import trial as trial_mod
from repro_torch.core.earlycurve import predict_final_grouped
from repro_torch.tuner import spottune as spottune_mod
from repro_torch.core.market import SpotMarket
from repro_torch.device import resolve_device
from repro_torch.backends import make_backend
from repro_torch.core.revpred import predict_pool_multi
from repro_torch.sweep.result import ReplicaResult, SweepResult
from repro_torch.sweep.spec import ScenarioSpec, build_replica, build_revpred
from repro_torch.tuner import FitRequest, ProvisionBatch, Tuner

import dataclasses


def clear_shared_caches() -> None:
    """Drop every cross-replica memo (traces, indices, curves, jitter) —
    the cold-start state an isolated per-replica process would see.  Built
    kernels are process-wide and are not dropped; they warm up identically
    for every mode."""
    market_mod.clear_trace_caches()
    revpred_mod.clear_prediction_caches()
    trial_mod.clear_sim_caches()
    earlycurve_mod.clear_fit_caches()
    spottune_mod.clear_plateau_caches()


class SweepRunner:
    """Executes ScenarioSpec grids; see the module docstring."""

    def __init__(self, train_minutes: int = 2880, revpred_epochs: int = 4,
                 revpred_stride: int = 5, device="cuda"):
        self.device = resolve_device(device)
        self.train_minutes = train_minutes
        self.revpred_epochs = revpred_epochs
        self.revpred_stride = revpred_stride

    # ------------------------------------------------------- construction
    def _prewarm_traces(self, specs: Sequence[ScenarioSpec]) -> None:
        by_minutes: Dict[int, set] = {}
        for spec in specs:
            minutes = int(spec.days * 1440)
            by_minutes.setdefault(minutes, set()).add(spec.market_seed)
        pool = market_mod.DEFAULT_POOL
        for minutes, seeds in by_minutes.items():
            market_mod.synth_traces_batch(
                [(inst, seed) for seed in sorted(seeds) for inst in pool],
                minutes)

    def prepare(self, specs: Sequence[ScenarioSpec],
                market_factory=None) -> List[Tuner]:
        """Materialize replicas with shared traces/backend/predictors.

        ``market_factory(spec) -> SpotMarket`` overrides how each replica's
        market is built — the tuning service injects contended
        ``SharedSpotMarket`` instances here; the default is the plain
        single-tenant construction, byte-identical to before."""
        for spec in specs:
            spec.validate()       # whole-grid gate before any heavy work
        self._prewarm_traces(specs)
        # one backend instance per kind across the grid: sim replicas share
        # curve/step-time memos; training replicas share materialized runs
        # and the checkpoint store
        backends: Dict[str, object] = {}

        def _backend(kind: str):
            if kind not in backends:
                backends[kind] = make_backend(
                    kind, pool=list(market_mod.DEFAULT_POOL))
            return backends[kind]

        shared_rp: Dict[tuple, object] = {}
        tuners = []
        for spec in specs:
            if market_factory is not None:
                market = market_factory(spec)
            else:
                market = SpotMarket(days=spec.days, seed=spec.market_seed,
                                    ledger=spec.ledger or None)
            rp_key = (spec.market_key(), spec.revpred, spec.engine_seed)
            rp = shared_rp.get(rp_key)
            if rp is None:
                rp = shared_rp[rp_key] = build_revpred(
                    spec, market, train_minutes=self.train_minutes,
                    epochs=self.revpred_epochs, stride=self.revpred_stride)
            tuners.append(build_replica(spec, market, _backend(spec.backend),
                                        rp, device=self.device))
        return tuners

    # ------------------------------------------------------------ driving
    def run(self, specs: Sequence[ScenarioSpec],
            mode: str = "soa", soa_tables: bool = True) -> SweepResult:
        """Run all replicas concurrently with cross-replica batching.

        ``mode="soa"`` (the default) steps every replica's engine through
        the structure-of-arrays stepper (``repro_torch.sweep.soa``): lockstep
        vectorized boundary rounds, bit-identical outcomes, one Python
        dispatch per *lifecycle event* instead of per generator suspension.
        Replica grids the stepper does not cover (exact ticks, straggler
        mode, training backends) fall back to ``mode="batched"``: every
        ``run_cooperative`` generator advanced round-robin.

        Either way, deploy requests are serviced in cross-replica batches
        (their RevPred forwards stack into one grouped call); idle curve-fit
        requests are *parked* until no replica has deploy work left, then
        flushed as one grouped LM solve — replicas reach idle at different
        rounds, and flushing late turns many small fit dispatches into a few
        full ones.  Ordering never leaks between replicas: every request is
        answered with pure functions of its own replica's state.

        ``soa_tables=False`` pins the stepper to the scalar lifecycle chain
        for every replica (no batched decision tables) — the contract tests'
        lever for table-vs-scalar equivalence; outcomes are bit-identical
        either way."""
        if mode not in ("soa", "batched"):
            raise ValueError(f"unknown sweep mode {mode!r} "
                             "(expected 'soa' or 'batched')")
        t0 = time.perf_counter()
        tuners = self.prepare(specs)
        if mode == "soa":
            # imported lazily: soa.py reuses this module's _service
            from repro_torch.sweep.soa import SoaSweep, soa_supported
            if soa_supported(tuners):
                SoaSweep(tuners, use_tables=soa_tables,
                         device=self.device).run()
                results = [ReplicaResult(spec, t.result, _histories(t))
                           for spec, t in zip(specs, tuners)]
                return SweepResult(results, time.perf_counter() - t0,
                                   mode="soa")
        gens = {i: t.run_cooperative() for i, t in enumerate(tuners)}
        active: Dict[int, object] = {}
        parked: Dict[int, FitRequest] = {}
        for i in list(gens):
            self._advance(i, gens, active)
        while active or parked:
            now = {}
            for i, req in active.items():
                if isinstance(req, FitRequest):
                    parked[i] = req
                else:
                    now[i] = req
            active = {}
            flush = list(now.items()) if now else list(parked.items())
            if not now:
                parked = {}
            self._service([r for _, r in flush])
            for i, _ in flush:
                self._advance(i, gens, active)
        results = [ReplicaResult(spec, t.result, _histories(t))
                   for spec, t in zip(specs, tuners)]
        return SweepResult(results, time.perf_counter() - t0, mode="batched")

    @staticmethod
    def _advance(i: int, gens: dict, reqs: dict) -> None:
        try:
            reqs[i] = next(gens[i])
        except StopIteration:
            del gens[i]

    @staticmethod
    def _service(batch: list) -> None:
        """Answer one round of suspended requests, cross-replica batched."""
        provs = [r for r in batch if isinstance(r, ProvisionBatch)]
        fits = [r for r in batch if isinstance(r, FitRequest)]
        for r in batch:
            if not isinstance(r, (ProvisionBatch, FitRequest)):
                r.service_local()      # unknown request kinds degrade safely
        if provs:
            flat, stacked = [], []
            for pb in provs:
                rp = pb.engine.prov.revpred
                pairs = getattr(rp, "predict_pool_pairs", None)
                if pairs is not None:       # oracle/zero: direct, no stacking
                    pb.responses = [pairs(cands, pb.t)
                                    for _, cands in pb.items]
                    continue
                stacked.append(pb)
                for _, cands in pb.items:
                    flat.append((rp, [inst for inst, _ in cands], pb.t,
                                 [mp for _, mp in cands]))
            if flat:
                answers = predict_pool_multi(flat)
                pos = 0
                for pb in stacked:
                    pb.responses = answers[pos:pos + len(pb.items)]
                    pos += len(pb.items)
        if fits:
            grouped, local = [], []
            for r in fits:
                ec = getattr(r.scheduler, "ec", None)
                seed = getattr(r.scheduler, "seed", None)
                if (ec is not None and seed is not None
                        and dataclasses.is_dataclass(ec)
                        and getattr(ec, "predict_final_batch", None)):
                    grouped.append((r, ec, seed))
                else:
                    local.append(r)
            for r in local:
                r.service_local()
            if grouped:
                answers = predict_final_grouped(
                    [(ec, r.jobs, seed) for r, ec, seed in grouped])
                for (r, _, _), resp in zip(grouped, answers):
                    r.responses = resp

    # ----------------------------------------------------------- baseline
    def run_sequential(self, specs: Sequence[ScenarioSpec],
                       cold: bool = False) -> SweepResult:
        """The naive loop: one fresh, fully-built replica at a time.

        ``cold=True`` additionally drops the shared memo caches before each
        replica — the cost of truly isolated runs (one process per
        scenario), which is the baseline the sweep's sharing is measured
        against.  Per-replica outcomes are bit-identical to ``run`` either
        way."""
        t0 = time.perf_counter()
        results = []
        for spec in specs:
            if cold:
                clear_shared_caches()
            market = SpotMarket(days=spec.days, seed=spec.market_seed,
                                ledger=spec.ledger or None)
            backend = make_backend(spec.backend, pool=market.pool)
            rp = build_revpred(spec, market, train_minutes=self.train_minutes,
                               epochs=self.revpred_epochs,
                               stride=self.revpred_stride)
            tuner = build_replica(spec, market, backend, rp,
                                  device=self.device)
            results.append(ReplicaResult(spec, tuner.run(), _histories(tuner)))
        return SweepResult(results, time.perf_counter() - t0,
                           mode="sequential-cold" if cold else "sequential")


def _histories(tuner: Tuner) -> Dict[str, tuple]:
    return {s.key: (list(s.metrics_steps), list(s.metrics_vals))
            for s in tuner.engine.views()}
