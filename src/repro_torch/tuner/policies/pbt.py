"""Population-based training on the transient engine.

PBT runs a population concurrently and, at regular step milestones, applies
*truncation selection*: members in the bottom quantile are stopped and
replaced by perturbed copies of top-quantile members (exploit + explore).
Restated against the engine's decision vocabulary:

  * every member runs toward the full budget; milestones are evenly spaced
    step checkpoints (snapped to the ``val_every`` metric grid);
  * a member crossing a milestone while in the bottom ``trunc_frac`` of
    that milestone's results so far is PAUSEd on its checkpoint — the
    asynchronous analogue of being truncated;
  * later results can push a parked member back above the cutoff, in which
    case it is PROMOTEd (resumed with its unchanged full budget) — PROMOTE
    only ever targets PAUSE'd members;
  * a revocation is a free milestone boundary (the checkpoint exists
    anyway): a revoked member below its last milestone's cutoff parks
    without spending another deploy on a loser;
  * members still parked at engine idle are exploited: the scheduler
    requests one replacement suggestion per truncated member through the
    incremental-suggestion path, and the paired ``PBTSearcher`` answers
    with a *perturbed* copy of a top-quantile member's config (one HP dim
    moved to an adjacent grid value) or a *resample* (fresh grid point).

Weight inheritance: a perturbed replacement declares its donor via
``TrialSpec.inherit = (donor_key, milestone_step)`` — under the
``sim`` backend the field is inert (quality curves are ground-truth
functions of the HP config, so replacements pay their own way from step 0
and the cost accounting stays conservative), while under the ``training``
backend (``repro_torch.backends.training``) the replacement's params *and*
optimizer moments are seeded from the donor's real checkpointed state at
the declared milestone — the genuine PBT exploit step.  Resamples always
start fresh.

``preview_metrics`` mirrors ASHA's: only milestone crossings do anything,
so the boundary-jumping fast path skips every inert metric point.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.trial import TrialSpec, Workload
from repro_torch.tuner.events import MetricReported, TrialRevoked
from repro_torch.tuner.scheduler import (CONTINUE, PAUSE, Decision, Scheduler,
                                   Searcher)


class PBTScheduler(Scheduler):
    """Truncation selection at step milestones via PAUSE/PROMOTE."""

    def __init__(self, population: int = 8, num_milestones: int = 3,
                 trunc_frac: float = 0.25, max_trials: Optional[int] = None,
                 seed: int = 0):
        assert 0.0 < trunc_frac < 1.0
        self.population = population
        self.num_milestones = num_milestones
        self.trunc_frac = trunc_frac
        self.max_trials = max_trials
        self.seed = seed
        self._workload_name: Optional[str] = None
        self.milestones: List[int] = []       # ascending step checkpoints
        self._ms_idx: Dict[str, int] = {}     # next milestone per member
        self._results: List[Dict[str, float]] = []
        self._paused: Dict[str, int] = {}     # key -> milestone parked at
        self._targets: Dict[str, float] = {}
        self._promos: Dict[str, float] = {}
        self._configs: Dict[str, dict] = {}   # key -> hp (exploit donors)
        self._replaced: set = set()           # parked members already exploited
        self._pending_repl: List[str] = []
        self._dry = False                     # searcher exhausted
        self._added = 0

    # ------------------------------------------------------------- set-up
    def on_trial_added(self, spec: TrialSpec) -> float:
        w = spec.workload
        if self._workload_name is not None:
            assert w.name == self._workload_name, \
                "PBTScheduler supports one workload per run"
        else:
            self._workload_name = w.name
            iv = max(1, w.max_trial_steps // (self.num_milestones + 1))
            iv = int(math.ceil(iv / w.val_every) * w.val_every)
            self.milestones = [m * iv for m in range(1, self.num_milestones + 1)
                               if m * iv < w.max_trial_steps]
            self._results = [{} for _ in self.milestones]
        self._ms_idx[spec.key] = 0
        self._targets[spec.key] = w.max_trial_steps
        self._configs[spec.key] = dict(spec.hp)
        self._added += 1
        return w.max_trial_steps

    # ------------------------------------------------------------- helpers
    def _in_bottom(self, m: int, key: str) -> bool:
        res = self._results[m]
        if key not in res:
            return False
        kill = int(len(res) * self.trunc_frac)
        if kill < 1:
            return False                      # population too small to cut
        order = sorted(res, key=res.get)
        return order.index(key) >= len(res) - kill

    def _sweep_promotable(self) -> Dict[str, float]:
        """Parked members whose milestone standing recovered — but only
        while their slot has not been exploited: once a replacement was
        admitted for a member it is dead (resuming it would run both the
        original and its replacement, growing the population past
        ``population`` and double-spending the slot's budget)."""
        promos: Dict[str, float] = {}
        for key in list(self._paused):
            if key not in self._replaced \
                    and not self._in_bottom(self._paused[key], key):
                del self._paused[key]
                promos[key] = self._targets[key]
        return promos

    def exploit_donors(self) -> List[tuple]:
        """Top-quantile donors at the latest milestone with results, as
        ``(trial_key, hp, milestone_step)`` best first — the pool the paired
        searcher perturbs.  The step is the *declared* milestone (snapped to
        the ``val_every`` grid), so replacements that inherit the donor's
        checkpoint reference a deterministic, backend-materializable step."""
        for m in reversed(range(len(self.milestones))):
            res = self._results[m]
            if res:
                kill = int(len(res) * self.trunc_frac)
                order = sorted(res, key=res.get)
                keep = order[:max(1, len(res) - kill)]
                return [(k, self._configs[k], self.milestones[m])
                        for k in keep]
        return []

    def exploit_candidates(self) -> List[dict]:
        """Legacy view of ``exploit_donors``: the donor configs alone."""
        return [hp for _, hp, _ in self.exploit_donors()]

    # ------------------------------------------------------------- events
    def on_event(self, event, view) -> Decision:
        if isinstance(event, MetricReported):
            i = self._ms_idx.get(event.trial, 0)
            if i < len(self.milestones) and event.step >= self.milestones[i]:
                self._results[i][event.trial] = event.value
                self._ms_idx[event.trial] = i + 1
                # a new milestone result can lift parked members past the cut
                self._promos.update(self._sweep_promotable())
                if self._in_bottom(i, event.trial):
                    self._paused[event.trial] = i
                    return PAUSE
        elif isinstance(event, TrialRevoked):
            # free milestone boundary: the checkpoint exists anyway, so park
            # now if the member's last showing sits below the cutoff
            i = self._ms_idx.get(event.trial, 0) - 1
            if i >= 0 and self._in_bottom(i, event.trial):
                self._paused[event.trial] = i
                return PAUSE
        return CONTINUE

    def take_promotions(self) -> Dict[str, float]:
        promos, self._promos = self._promos, {}
        return promos

    def preview_metrics(self, view, steps, vals, ticks) -> Optional[int]:
        """Only milestone crossings act; everything below is an inert
        CONTINUE the engine may append silently."""
        i = self._ms_idx.get(view.key, 0)
        if i >= len(self.milestones):
            return None
        hits = np.nonzero(np.asarray(steps) >= self.milestones[i])[0]
        return int(hits[0]) if len(hits) else None

    # --------------------------------------------------------------- idle
    def request_suggestions(self, views: Sequence) -> int:
        """One exploit/explore replacement per truncated (still-parked,
        not-yet-replaced) member, budget permitting."""
        if self._dry:
            return 0
        pending = [k for k in self._paused if k not in self._replaced]
        if self.max_trials is not None:
            pending = pending[:max(0, self.max_trials - self._added)]
        self._pending_repl = pending
        return len(pending)

    def suggestions_added(self, n: int) -> None:
        self._replaced.update(self._pending_repl[:n])
        if n < len(self._pending_repl):
            self._dry = True                  # searcher (grid) exhausted
        self._pending_repl = []

    def on_idle(self, views: Sequence) -> Dict[str, float]:
        return self._sweep_promotable()

    # ------------------------------------------------------------- results
    def rank(self, views: Sequence) -> List[str]:
        preds = self.predictions(views)
        # deeper members first, then metric — survivors outrank truncations
        return [v.key for v in sorted(
            views, key=lambda v: (-self._ms_idx.get(v.key, 0), preds[v.key]))]


class PBTSearcher(Searcher):
    """Explore half of PBT: initial random population, then perturb/resample.

    Written against ``Workload.space``.  On a finite space the initial
    ``population`` suggestions are a seeded random subset of the grid, and
    every later suggestion is a replacement for a truncated member (the
    bound ``PBTScheduler`` requests them at idle): with probability
    ``resample_prob`` a fresh uniformly-drawn unexplored grid point
    (resample), otherwise a copy of a seeded-random top-quantile donor with
    one HP dimension moved through ``Domain.neighbor_values`` — adjacent
    grid value for the legacy ``Ordinal`` dims.  Perturbed configs keep
    their grid index, so the simulated ground truth stays the same function
    of HP as under grid search; a perturb that lands on an already-explored
    config falls back to resampling.  Exhausts to None once the grid is
    used up.

    On a continuous space the population seeds from ``space.sample`` and a
    perturb moves one seeded-random dim via ``Domain.neighbor`` (clipped
    Gaussian step in encoded coordinates); duplicates are rejected by
    config hash and the searcher never exhausts.
    """

    supports_continuous = True

    def __init__(self, workload: Workload, population: int = 8,
                 resample_prob: float = 0.25, seed: int = 0):
        self.workload = workload
        self.space = workload.space
        self.resample_prob = resample_prob
        self._rng = np.random.default_rng(seed)
        self._sched: Optional[PBTScheduler] = None
        self._used: set = set()                 # config hashes (both modes)
        if self.space.is_finite:
            self.grid = self.space.grid()
            self._idx_of = {self._cfg_key(hp): i
                            for i, hp in enumerate(self.grid)}
            order = self._rng.permutation(len(self.grid))
            self._initial = [int(i)
                             for i in order[:min(population, len(self.grid))]]
            self._used_idx = set(self._initial)
        else:
            self.grid = None
            # seeded population, config-hash deduplicated; sample_distinct
            # terminates with a smaller population when a continuous-typed
            # space is effectively tiny (pure IntUniform products)
            self._initial = self.space.sample_distinct(
                self._rng, population, seen=self._used)

    @staticmethod
    def _cfg_key(hp: dict) -> tuple:
        return tuple(sorted(hp.items(), key=lambda kv: kv[0]))

    def bind_scheduler(self, scheduler) -> None:
        """Tuner wiring hook: the exploit donor pool lives on the scheduler."""
        self._sched = scheduler

    def _donors(self) -> List[tuple]:
        """Donor pool as ``(key, hp, milestone_step)`` tuples."""
        if self._sched is not None and hasattr(self._sched, "exploit_donors"):
            return self._sched.exploit_donors()
        return []

    def suggest(self) -> Optional[TrialSpec]:
        if self.grid is None:
            return self._suggest_continuous()
        if self._initial:
            i, inherit = self._initial.pop(0), None
        else:
            repl = self._next_replacement()
            if repl is None:
                return None
            i, inherit = repl
            self._used_idx.add(i)
        return TrialSpec(self.workload, self.grid[i], i, inherit=inherit)

    # ----------------------------------------------- explore (finite space)
    def _unused(self) -> List[int]:
        return [i for i in range(len(self.grid)) if i not in self._used_idx]

    def _next_replacement(self) -> Optional[tuple]:
        """Next replacement as ``(grid_index, inherit)``; perturbed copies
        carry the donor's ``(key, milestone_step)`` so backends with real
        state resume from the donor checkpoint, resamples start fresh.  The
        RNG draw sequence is identical to the pre-inheritance code — sim
        results stay bit-exact."""
        unused = self._unused()
        if not unused:
            return None
        donors = self._donors()
        if not donors:
            return int(self._rng.choice(unused)), None
        if self._rng.uniform() < self.resample_prob:
            return int(self._rng.choice(unused)), None    # explore: resample
        dkey, donor, dstep = donors[int(self._rng.integers(len(donors)))]
        dims = self.space.dims
        for d in self._rng.permutation(len(dims)):
            key, domain = dims[int(d)]
            for nv in domain.neighbor_values(donor[key]):  # adjacent values
                hp = dict(donor)
                hp[key] = nv
                i = self._idx_of.get(self._cfg_key(hp))
                if i is not None and i not in self._used_idx:
                    return i, (dkey, dstep)               # explore: perturb
        # donor neighborhood exhausted
        return int(self._rng.choice(unused)), None

    # ------------------------------------------- explore (continuous space)
    def _suggest_continuous(self) -> Optional[TrialSpec]:
        if self._initial:
            return TrialSpec(self.workload, self._initial.pop(0))
        donors = self._donors()
        # hash-duplicate rejection, same exhaustion cap as sample_distinct
        for _ in range(self.space.MAX_DUP_MISSES):
            inherit = None
            if not donors or self._rng.uniform() < self.resample_prob:
                hp = self.space.sample(self._rng)
            else:
                dkey, donor, dstep = donors[int(self._rng.integers(len(donors)))]
                hp = self.space.neighbor(donor, self._rng)
                inherit = (dkey, dstep)
            h = self.space.config_hash(hp)
            if h not in self._used:
                self._used.add(h)
                return TrialSpec(self.workload, hp, inherit=inherit)
        return None
