"""The paper's search policy, re-expressed as a pluggable Scheduler.

SpotTune's Algorithm 1 policy, extracted from the old monolithic orchestrator
loop and restated against the Scheduler protocol:

  * every trial's initial budget is ``floor(theta * max_trial_steps)``;
  * a trial whose metric plateaus (EarlyCurve's §III-C special case) is
    STOPped early;
  * when the engine drains (phase-1 idle), EarlyCurve extrapolates every
    trial's final metric from its partial trajectory (seeded, so ranking is
    reproducible), and the top-``mcnt`` predicted trials are promoted to the
    full ``max_trial_steps`` budget — in predicted-rank order, which is also
    the redeployment order (this preserves the legacy RNG-draw sequence);
  * the second idle ends the run; the final ranking keeps the *phase-1*
    predictions (the paper reports selection accuracy of the early
    extrapolation, not of the finished winners).

Driven through the engine this reproduces the JAX package's
``SpotTuneScheduler`` run on the same seeds (``tests/test_torch_slice.py``);
EarlyCurve's curve fits run on ``device``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.earlycurve import EarlyCurve
from repro_torch.core.trial import TrialSpec
from repro_torch.tuner.events import MetricReported
from repro_torch.tuner.scheduler import CONTINUE, STOP, Decision, Scheduler

# last-big-delta index per curve prefix, shared process-wide: a trial's
# metric history (+ any preview extension) is always a prefix of its full
# deterministic curve — rollbacks truncate to a shorter prefix — so the
# plateau scan's ``last_big`` accumulator is a pure function of
# (trial curve, plateau_tol) and every replica of every sweep shares it.
_PLATEAU_CACHE: Dict[tuple, list] = {}
_PLATEAU_CACHE_MAX = 16384
# sorted global grid indices whose prefix passes converged(), per
# (trial key, tol, window) — derived from _PLATEAU_CACHE, same sharing
_OK_CACHE: Dict[tuple, list] = {}
_EMPTY_I64 = np.empty(0, np.int64)


def clear_plateau_caches() -> None:
    _PLATEAU_CACHE.clear()
    _OK_CACHE.clear()


def _last_big(key: tuple, hist, vals, n_total: int) -> np.ndarray:
    """Global ``last_big`` indices for the curve prefix of length n_total:
    entry j = the largest delta index i <= j with a relative step >= tol
    (-1 if none).  Extended incrementally as longer prefixes are seen."""
    ent = _PLATEAU_CACHE.get(key)
    if ent is None:
        if len(_PLATEAU_CACHE) >= _PLATEAU_CACHE_MAX:
            _PLATEAU_CACHE.clear()
        ent = _PLATEAU_CACHE[key] = [0, np.empty(0, np.int64)]
    have = ent[0]
    if n_total > have:
        tol = key[-1]
        n0 = len(hist)
        lo = max(have - 1, 0)          # previous tail value re-enters diff
        seq = np.empty(n_total - lo)
        if lo < n0:
            seq[:n0 - lo] = hist[lo:n_total] if n_total <= n0 else hist[lo:]
        if n_total > n0:
            seq[max(n0 - lo, 0):] = vals[max(lo - n0, 0):n_total - n0]
        # same float64 expression as EarlyCurve.converged, elementwise
        rel_big = (np.abs(np.diff(seq))
                   / np.maximum(np.abs(seq[:-1]), 1e-12)) >= tol
        idx = np.arange(lo, n_total - 1)
        prev = ent[1][have - 2] if have >= 2 else -1
        ext = np.maximum.accumulate(np.where(rel_big, idx, -1))
        ext = np.maximum(ext, prev)
        ent[1] = np.concatenate([ent[1][:max(have - 1, 0)], ext])
        ent[0] = n_total
    return ent[1]


class SpotTuneScheduler(Scheduler):
    # the preview answer is a pure function of the trial's combined
    # history+future metric sequence (plus its own stopped flag), so the
    # engine may memoize it within an allocation epoch
    preview_stable = True

    def __init__(self, theta: float = 0.7, mcnt: int = 3,
                 earlycurve: Optional[EarlyCurve] = None, seed: int = 0,
                 device: str = "cuda"):
        self.theta = theta
        self.mcnt = mcnt
        # curve fits run on ``device`` unless an EarlyCurve is given
        self.ec = earlycurve or EarlyCurve(device=device)
        self.seed = seed
        self._stopped: set = set()
        self._preds: Optional[Dict[str, float]] = None
        self._phase = 1
        self._supplied: Optional[Dict[str, float]] = None
        self._fit_keys: List[str] = []

    # ------------------------------------------------------------- policy
    def on_trial_added(self, spec: TrialSpec) -> float:
        return math.floor(self.theta * spec.workload.max_trial_steps)

    def on_event(self, event, view) -> Decision:
        # convergence plateau (paper §III-C special case): metric histories
        # are updated before events fire, so this sees exactly the trajectory
        # the legacy loop checked once per advance
        if isinstance(event, MetricReported) and view.key not in self._stopped:
            if len(view.metrics_vals) >= self.ec.plateau_window \
                    and self.ec.converged(view.metrics_vals):
                self._stopped.add(view.key)
                return STOP
        return CONTINUE

    # ------------------------------------------- batched decision table
    # Only metric reports act; every other event class is inert by
    # construction of ``on_event`` above, which is the table contract.
    table_events = frozenset({MetricReported})

    def decision_table(self, entries) -> list:
        """θ plateau scan over a whole event batch: one ``_last_big`` lookup
        per trial instead of one ``converged()`` pass per metric point.

        Within one tick all of a trial's crossed points dispatch against the
        same post-advance history, so the scalar chain's per-point checks
        collapse to a single verdict on the full prefix — ``on_event``'s
        ``converged(metrics_vals)`` restated through the shared plateau
        accumulator (``lb[L-2] <= L-W-1`` == converged at length L)."""
        W = self.ec.plateau_window
        tol = self.ec.plateau_tol
        stopped = self._stopped
        out = []
        for kind, view, _payload in entries:
            if kind != "metric" or view.key in stopped:
                out.append(None)
                continue
            vals = view.metrics_vals
            L = len(vals)
            if L < W:
                out.append(None)
            elif W < 2:                # converged() degenerates to True
                stopped.add(view.key)
                out.append((True, False, None))
            else:
                lb = _last_big((view.key, tol), vals, (), L)
                if lb[L - 2] <= L - W - 1:
                    stopped.add(view.key)
                    out.append((True, False, None))
                else:
                    out.append(None)
        return out

    def preview_metrics(self, view, steps, vals, ticks) -> Optional[int]:
        """First upcoming metric point whose dispatch would STOP the trial.

        Vectorized mirror of the ``on_event`` plateau check: a point's
        handler sees the history through the *end of its tick* (same-tick
        points are appended before any of them dispatches), so convergence
        is evaluated on every tick-aligned prefix of history + preview."""
        if view.key in self._stopped:
            return None
        W = self.ec.plateau_window
        tol = self.ec.plateau_tol
        if W < 2:
            return 0        # converged() degenerates to True at any length
        hist = view.metrics_vals
        n0 = len(hist)
        m = len(vals)
        if n0 + m < W:
            return None
        # history + preview is always a prefix of the trial's deterministic
        # curve (rollbacks only truncate to shorter prefixes), so the plateau
        # accumulator is a pure function of (curve, tol) shared process-wide
        # across every replica — amortized O(new points) per call.  A delta
        # before the candidate window has index <= L-W-1 and never violates,
        # so the global last-big index decides exactly like the windowed scan.
        last_big = _last_big((view.key, tol), hist, vals, n0 + m)
        ticks = np.asarray(ticks)
        is_last = np.ones(m, bool)
        is_last[:-1] = ticks[1:] != ticks[:-1]
        ends = np.nonzero(is_last)[0]
        L = n0 + ends + 1                    # history length at each tick end
        ok = (L >= W) & (last_big[L - 2] <= L - W - 1)
        hits = np.nonzero(ok)[0]
        if not len(hits):
            return None
        e = int(ends[hits[0]])
        f = e
        while f > 0 and ticks[f - 1] == ticks[f]:
            f -= 1
        return f

    def preview_stop_grid(self, view, vals, lo: int, hi: int):
        """Sorted global grid indices g (covering at least through ``hi``)
        where a metric history of length g passes ``converged()``.  The
        engine combines this with its own point->tick map to find the first
        acting *tick end* without materializing the trajectory
        (``_preview_boundary`` fast path); grid index == prefix length
        because every grid point below ``lo`` is already in the history.
        None = nothing can fire.  Cached per curve: the index set is a pure
        function of (curve, tol, window) and only ever extends."""
        if view.key in self._stopped:
            return None
        W = self.ec.plateau_window
        if W < 2:
            # converged() is vacuously True from the first point
            return np.arange(lo, hi + 1, dtype=np.int64)
        if hi < W:
            return None
        tol = self.ec.plateau_tol
        lb = _last_big((view.key, tol), view.metrics_vals, vals, hi)
        ent = _OK_CACHE.get((view.key, tol, W))
        if ent is None:
            if len(_OK_CACHE) >= _PLATEAU_CACHE_MAX:
                _OK_CACHE.clear()
            ent = _OK_CACHE[(view.key, tol, W)] = [W - 1, _EMPTY_I64]
        if hi > ent[0]:
            g = np.arange(ent[0] + 1, hi + 1)
            g = g[lb[g - 2] <= g - W - 1]
            if len(g):
                ent[1] = np.concatenate([ent[1], g])
            ent[0] = hi
        return ent[1]

    def _predict_all(self, views: Sequence) -> Dict[str, float]:
        preds: Dict[str, float] = {}
        supplied = self._supplied
        self._supplied = None
        jobs, job_keys = [], []
        for v in views:
            if self.theta >= 1.0 or v.key in self._stopped:
                preds[v.key] = v.metrics_vals[-1] if v.metrics_vals else 1e9
            elif supplied is not None and v.key in supplied:
                preds[v.key] = supplied[v.key]   # pre-batched by the sweep
            else:
                jobs.append((v.metrics_steps, v.metrics_vals,
                             v.spec.workload.max_trial_steps))
                job_keys.append(v.key)
        if jobs:
            for key, p in zip(job_keys, self.run_idle_fits(jobs)):
                preds[key] = p
        return preds

    # --------------------------------------------- sweep batching protocol
    def idle_fit_jobs(self, views: Sequence) -> Optional[list]:
        if self._phase != 1 or self.theta >= 1.0:
            return None
        jobs, keys = [], []
        for v in views:
            if v.key not in self._stopped:
                jobs.append((v.metrics_steps, v.metrics_vals,
                             v.spec.workload.max_trial_steps))
                keys.append(v.key)
        if not jobs:
            return None
        self._fit_keys = keys
        return jobs

    def run_idle_fits(self, jobs: list) -> list:
        batch = getattr(self.ec, "predict_final_batch", None)
        if batch is not None:        # one dispatch per stage-length bucket
            return batch(jobs, seed=self.seed)
        return [self.ec.predict_final(steps, vals, tgt, seed=self.seed)
                for steps, vals, tgt in jobs]

    def set_idle_fits(self, preds: list) -> None:
        self._supplied = dict(zip(self._fit_keys, preds))

    def on_idle(self, views: Sequence) -> Dict[str, float]:
        if self._phase == 1:
            self._phase = 2
            # phase 2 (Algorithm 1 l.48-53): predict finals, continue top-mcnt
            self._preds = self._predict_all(views)
            if self.theta >= 1.0:
                return {}
            order = sorted(views, key=lambda v: self._preds[v.key])
            promotions: Dict[str, float] = {}
            for v in order[: self.mcnt]:
                max_steps = v.spec.workload.max_trial_steps
                if v.key not in self._stopped and v.steps < max_steps:
                    promotions[v.key] = max_steps
            return promotions
        return {}

    # ------------------------------------------------------------- results
    def predictions(self, views: Sequence) -> Dict[str, float]:
        if self._preds is None:  # run never reached idle (out-of-engine use)
            self._preds = self._predict_all(views)
        return dict(self._preds)


class AdaptiveSpotTuneScheduler(SpotTuneScheduler):
    """SpotTune's θ-budget policy over an *adaptive* searcher.

    Phase 1 becomes a sequential-batch search: at every engine idle the
    scheduler asks the Tuner for ``suggest_batch`` fresh suggestions — the
    searcher (``TrimTunerSearcher`` cost-aware BO by default,
    ``AdaptiveGridSearcher`` Hamming-halving as the legacy option) narrows
    its proposals around the results reported so far — until the searcher
    dries up.  Suggestions may be *sub-sampled* (``TrialSpec.budget_frac``
    < 1, TrimTuner's cheap bootstrap wave): their budget is ``theta *
    budget_frac`` of the full run.  Once the search is dry, a fidelity-gap
    round (``_fidelity_promotions``) verifies every under-sampled trial
    whose declared LR schedule decays beyond the steps it ran at the
    standard θ budget, so the final selection never extrapolates across
    curve stages a cheap run couldn't see; then the normal SpotTune
    phase 2 promotes the top-``mcnt`` to the full budget.  Requires a
    Tuner constructed with ``initial_trials`` (so the searcher is not
    drained up front)."""

    # the TrimTuner feedback loop (adaptive suggestion waves keyed off
    # results as they land) stays on the verbatim scalar chain: correctness
    # does not depend on it, but keeping one production policy on the
    # scalar path pins that path's equivalence coverage in the sweep cube
    decision_table = None
    table_events = frozenset()

    def __init__(self, theta: float = 0.7, mcnt: int = 3,
                 earlycurve: Optional[EarlyCurve] = None, seed: int = 0,
                 suggest_batch: int = 4, device: str = "cuda"):
        super().__init__(theta=theta, mcnt=mcnt, earlycurve=earlycurve,
                         seed=seed, device=device)
        self.suggest_batch = suggest_batch
        self._search_done = False
        self._fidelity_done = False

    def on_trial_added(self, spec: TrialSpec) -> float:
        # honor sub-sampled suggestions (TrimTuner's cheap bootstrap wave):
        # the budget is theta * budget_frac of the full run
        return math.floor(
            self.theta * spec.budget_frac * spec.workload.max_trial_steps)

    def request_suggestions(self, views: Sequence) -> int:
        if self._phase != 1 or self._search_done:
            return 0
        return self.suggest_batch

    def suggestions_added(self, n: int) -> None:
        if n == 0:
            self._search_done = True

    def _fidelity_promotions(self, views: Sequence) -> Dict[str, float]:
        """Fidelity-gap scan: a sub-sampled trial whose declared LR schedule
        (``TrialSpec.decay_steps`` — known a priori, not ground truth)
        drops again between its observed steps and the standard θ budget
        cannot be extrapolated — EarlyCurve has not seen the post-drop
        stage, and the misprediction would evict the trial from the
        shortlist before phase 2 ever ranks it.  Exactly those trials are
        verified at the θ budget (resuming from their checkpoints, paying
        only the delta steps); smooth single-stage curves extrapolate fine
        and stay cheap."""
        promotions: Dict[str, float] = {}
        for v in views:
            std = math.floor(self.theta * v.spec.workload.max_trial_steps)
            if v.key in self._stopped or v.steps >= std:
                continue
            ds = v.spec.decay_steps()
            if ds is not None and math.floor(v.steps / ds) < math.floor(std / ds):
                promotions[v.key] = std
        return promotions

    def idle_fit_jobs(self, views: Sequence) -> Optional[list]:
        if self._phase == 1 and not self._fidelity_done \
                and self._fidelity_promotions(views):
            # this idle resumes under-sampled trials instead of ranking —
            # batched curve fits would be computed only to be thrown away
            return None
        return super().idle_fit_jobs(views)

    def on_idle(self, views: Sequence) -> Dict[str, float]:
        if self._phase == 1 and not self._fidelity_done:
            promotions = self._fidelity_promotions(views)
            self._fidelity_done = True
            if promotions:
                return promotions
        return super().on_idle(views)
