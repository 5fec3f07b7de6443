"""Searchers (what to try) and ASHA (when to stop it).

All searchers are written against ``Workload.space`` (the typed
``repro_torch.tuner.space.SearchSpace``); each declares ``supports_continuous``
so the registry can gate policy/space pairing.

  GridSearcher    enumeration of a finite space, in ``space.grid()`` order —
                  byte-identical to the legacy ``hp_grid()`` trial list
  RandomSearcher  finite space: uniform sample (without replacement) of grid
                  points, trial indices staying grid indices (legacy RNG
                  stream preserved); continuous space: seeded
                  ``space.sample`` stream, config-hash deduplicated
  ListSearcher    wraps an explicit TrialSpec list (the legacy entry point)

  ASHAScheduler   asynchronous successive halving on top of the transient
                  engine.  Rungs are geometrically spaced step milestones
                  (eta-fold apart); a trial crossing a rung continues only
                  while it sits in the top 1/eta of that rung's results so
                  far, otherwise it PAUSEs on its checkpoint.  Paused trials
                  are promoted asynchronously the moment later results make
                  them top-1/eta again, and swept once more at every engine
                  idle; an idle with nothing promotable ends the run.

                  Transient twist: a revocation already forced a checkpoint,
                  so the scheduler treats it as a *free* rung boundary — a
                  revoked trial below its rung's cutoff is parked instead of
                  redeployed, spending zero extra checkpoint or deploy cost
                  on a loser.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.trial import TrialSpec, Workload, make_trials
from repro_torch.tuner.events import MetricReported, TrialRevoked
from repro_torch.tuner.scheduler import (CONTINUE, PAUSE, Decision, Scheduler,
                                   Searcher)


class ListSearcher(Searcher):
    """Suggests a pre-built TrialSpec list, in order."""

    def __init__(self, trials: Sequence[TrialSpec]):
        self._pending = list(trials)

    def suggest(self) -> Optional[TrialSpec]:
        return self._pending.pop(0) if self._pending else None


class GridSearcher(ListSearcher):
    """Exhaustive enumeration of a finite space (the paper's 2^4 grid),
    in ``space.grid()`` order — identical stream to the legacy pre-built
    trial list.  Grid-only by construction."""

    supports_continuous = False

    def __init__(self, workload: Workload):
        super().__init__(make_trials(workload))


class RandomSearcher(ListSearcher):
    """Seeded uniform sample of the search space.

    Finite spaces keep the legacy behavior bit-for-bit: ``num_samples``
    distinct grid points (without replacement, ascending index order),
    or — with ``num_samples=None`` — the whole grid in permuted order (the
    unbounded-search mode under the Tuner's ``initial_trials`` cap).

    Continuous spaces draw ``num_samples`` seeded configs through
    ``space.sample_distinct`` — config-hash deduplicated, grid-free
    ``TrialSpec``s, and terminating with fewer samples when a
    continuous-*typed* space is effectively tiny (e.g. a pure
    ``IntUniform(0, 1)`` product) instead of spinning on duplicate
    rejection; unbounded streaming needs an explicit sample count there."""

    supports_continuous = True

    def __init__(self, workload: Workload, num_samples: Optional[int] = None,
                 seed: int = 0):
        space = workload.space
        rng = np.random.default_rng(seed)
        if not space.is_finite:
            if num_samples is None:
                raise ValueError(
                    "RandomSearcher on a continuous space needs num_samples")
            super().__init__([TrialSpec(workload, hp) for hp in
                              space.sample_distinct(rng, num_samples)])
            return
        grid = space.grid()
        if num_samples is None:
            idx = rng.permutation(len(grid))
            super().__init__(
                [TrialSpec(workload, grid[int(i)], int(i)) for i in idx])
            return
        idx = rng.choice(len(grid), size=min(num_samples, len(grid)),
                         replace=False)
        super().__init__(
            [TrialSpec(workload, grid[int(i)], int(i)) for i in sorted(idx)])


class AdaptiveGridSearcher(Searcher):
    """Model-based searcher: ``Searcher.on_result`` feedback narrows the
    grid around the best configurations seen so far.

    Starts from a random subset of the HP grid; each refinement wave ranks
    the unexplored grid points by Hamming distance to the ``top_k`` best
    observed configs (successive halving of the search volume) and proposes
    the ``batch`` closest.  Exhausts to None once nothing is left, or once
    refinement is impossible because no results arrived."""

    live_results = True      # Tuner feeds finished-trial metrics mid-run
    supports_continuous = False   # Hamming distance needs the finite grid

    def __init__(self, workload: Workload, initial: int = 6, batch: int = 4,
                 top_k: int = 2, max_waves: int = 2, seed: int = 0):
        self.workload = workload
        self.grid = workload.hp_grid()
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.grid))
        self._queue: List[int] = [int(i) for i in order[:initial]]
        self._suggested = set(self._queue)
        self._results: Dict[int, float] = {}
        self.batch = batch
        self.top_k = top_k
        self._waves_left = max_waves

    def suggest(self) -> Optional[TrialSpec]:
        if not self._queue:
            self._refine()
        if not self._queue:
            return None
        i = self._queue.pop(0)
        return TrialSpec(self.workload, self.grid[i], i)

    def on_result(self, key: str, metric: Optional[float]) -> None:
        if metric is None:
            return
        idx = int(key.rsplit("/hp", 1)[1])
        self._results[idx] = metric

    def _refine(self) -> None:
        if not self._results or self._waves_left <= 0:
            return
        self._waves_left -= 1
        best = sorted(self._results, key=self._results.get)[: self.top_k]
        cands = []
        for i, hp in enumerate(self.grid):
            if i in self._suggested:
                continue
            d = min(sum(hp[k] != self.grid[b][k] for k in hp) for b in best)
            cands.append((d, i))
        cands.sort()
        for _, i in cands[: self.batch]:
            self._queue.append(i)
            self._suggested.add(i)


def rung_ladder(workload: Workload, eta: int, num_rungs: int,
                min_steps: Optional[int] = None) -> List[int]:
    """Ascending successive-halving step milestones for one workload:
    eta-fold apart from the full budget down, snapped up to the metric grid
    so a value exists at every crossing.  The single derivation behind both
    ``ASHAScheduler`` and ``HyperbandScheduler``'s bracket slices."""
    lo = min_steps or workload.val_every
    rungs = []
    r = workload.max_trial_steps
    for _ in range(num_rungs):
        r = r // eta
        if r < lo:
            break
        rungs.append(int(math.ceil(r / workload.val_every) * workload.val_every))
    return sorted(set(rungs))


class ASHAScheduler(Scheduler):
    """Asynchronous successive halving; revocations double as rung stops.

    ``ladder`` pre-builds the rung milestones (Hyperband hands each bracket
    a slice of the full ladder — possibly empty, for the run-to-completion
    bracket); left None, the ladder derives from the first trial's
    workload via ``rung_ladder``."""

    def __init__(self, eta: int = 3, num_rungs: int = 3,
                 min_steps: Optional[int] = None,
                 ladder: Optional[List[int]] = None):
        assert eta >= 2
        self.eta = eta
        self.num_rungs = num_rungs
        self.min_steps = min_steps
        self._workload_name: Optional[str] = None
        self._prebuilt = ladder is not None
        self.rungs: List[int] = list(ladder or [])  # ascending milestones
        self._rung_idx: Dict[str, int] = {}   # next rung each trial must clear
        self._results: List[Dict[str, float]] = [{} for _ in self.rungs]
        self._paused: Dict[str, int] = {}     # key -> rung it paused at
        self._targets: Dict[str, float] = {}
        self._promos: Dict[str, float] = {}

    # ------------------------------------------------------------- set-up
    def on_trial_added(self, spec: TrialSpec) -> float:
        w = spec.workload
        if self._workload_name is not None:
            # rungs are derived from the first workload's step grid; a mixed
            # pool would silently never pause the smaller-budget trials
            assert w.name == self._workload_name, \
                "ASHAScheduler supports one workload per run"
        else:
            self._workload_name = w.name
            if not self._prebuilt:
                self.rungs = rung_ladder(w, self.eta, self.num_rungs,
                                         self.min_steps)
                self._results = [{} for _ in self.rungs]
        self._rung_idx[spec.key] = 0
        self._targets[spec.key] = w.max_trial_steps
        return w.max_trial_steps

    # ------------------------------------------------------------- helpers
    def _in_top(self, rung: int, key: str) -> bool:
        res = self._results[rung]
        if key not in res:
            return True
        cutoff = max(1, len(res) // self.eta)
        order = sorted(res, key=res.get)
        return order.index(key) < cutoff

    def _sweep_promotable(self) -> Dict[str, float]:
        promos: Dict[str, float] = {}
        for key in list(self._paused):
            if self._in_top(self._paused[key], key):
                del self._paused[key]
                promos[key] = self._targets[key]
        return promos

    # ------------------------------------------------------------- events
    def on_event(self, event, view) -> Decision:
        if isinstance(event, MetricReported):
            i = self._rung_idx.get(event.trial, 0)
            if i < len(self.rungs) and event.step >= self.rungs[i]:
                self._results[i][event.trial] = event.value
                self._rung_idx[event.trial] = i + 1
                # a new rung result can push parked survivors over the cutoff
                self._promos.update(self._sweep_promotable())
                if not self._in_top(i, event.trial):
                    self._paused[event.trial] = i
                    return PAUSE
        elif isinstance(event, TrialRevoked):
            # free rung boundary: the checkpoint exists anyway, so park the
            # trial now if its last rung showing is below the cutoff
            i = self._rung_idx.get(event.trial, 0) - 1
            if i >= 0 and not self._in_top(i, event.trial):
                self._paused[event.trial] = i
                return PAUSE
        return CONTINUE

    # ------------------------------------------- batched decision table
    # Rung lookups and revocation parks are the only acting events; the
    # ordered replay below mutates the same rung/pause/promo state the
    # per-event path does, entry by entry, so batch == scalar exactly.
    # Promotions stage into ``_promos`` in chronological order and are
    # drained once after the batch — equivalent to the per-event drain
    # because ASHA only ever promotes parked (non-running) trials, whose
    # state nothing later in the batch reads back.
    table_events = frozenset({MetricReported, TrialRevoked})

    def decision_table(self, entries) -> list:
        rungs = self.rungs
        rung_idx = self._rung_idx
        out = []
        for kind, view, payload in entries:
            key = view.key
            if kind == "metric":
                pause = False
                for step, value in payload:
                    i = rung_idx.get(key, 0)
                    if i < len(rungs) and step >= rungs[i]:
                        self._results[i][key] = value
                        rung_idx[key] = i + 1
                        self._promos.update(self._sweep_promotable())
                        if not self._in_top(i, key):
                            self._paused[key] = i
                            pause = True
                out.append((False, True, None) if pause else None)
            else:                                    # revoked
                i = rung_idx.get(key, 0) - 1
                if i >= 0 and not self._in_top(i, key):
                    self._paused[key] = i
                    out.append((False, True, None))
                else:
                    out.append(None)
        return out

    def take_promotions(self) -> Dict[str, float]:
        promos, self._promos = self._promos, {}
        return promos

    def on_idle(self, views: Sequence) -> Dict[str, float]:
        return self._sweep_promotable()

    def preview_metrics(self, view, steps, vals, ticks) -> Optional[int]:
        """Fast-path contract: only rung crossings do anything in
        ``on_event`` — points below the trial's next rung are inert
        CONTINUEs, so the engine may skip their dispatch entirely."""
        i = self._rung_idx.get(view.key, 0)
        if i >= len(self.rungs):
            return None
        hits = np.nonzero(np.asarray(steps) >= self.rungs[i])[0]
        return int(hits[0]) if len(hits) else None

    # ------------------------------------------------------------- results
    def rank(self, views: Sequence) -> List[str]:
        preds = self.predictions(views)
        # deeper rungs first, then metric — survivors outrank early losers
        return [v.key for v in sorted(
            views, key=lambda v: (-self._rung_idx.get(v.key, 0), preds[v.key]))]
