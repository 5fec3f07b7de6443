"""Hyperband on the transient engine: ASHA brackets x bracket sampling.

Hyperband hedges successive halving's aggressiveness by running several
halving *brackets* in parallel, each starting its rung ladder at a higher
minimum resource.  The asynchronous formulation used here (syne-tune style)
keeps one ``ASHAScheduler`` per bracket and assigns every suggested trial to
a bracket up front with *budget-proportional* sampling: bracket ``b``'s
weight is inversely proportional to the minimum step commitment a trial
makes there (its first rung, or the full budget for the rung-less run-to-
completion bracket), so each bracket receives roughly the same aggregate
minimum budget — aggressive brackets get proportionally more trials, the
conservative ones fewer, which is Hyperband's n_i allocation restated for
the asynchronous setting.

The transient twist is inherited per bracket from ASHA: a revocation
already forced a checkpoint, so it doubles as a free rung boundary — a
revoked trial below its bracket rung's cutoff is parked instead of
redeployed.  ``preview_metrics`` routes to the trial's bracket (next rung
milestone), so the engine's boundary-jumping fast path skips every inert
crossing exactly as it does for plain ASHA.

``adaptive_brackets=True`` (ROADMAP open item) reweights the bracket
sampling online: each bracket's static budget-proportional weight is
scaled by its observed first-rung *survival rate* (smoothed; the rung-less
run-to-completion bracket keeps the neutral prior).  Workloads whose cheap
early rungs are informative (low survival — aggressive halving separates
configs well) push trials into the aggressive brackets; workloads whose
early metrics are noise (survival near 1/eta by luck alone, everything
parked) shift budget toward conservative brackets.  Off by default — the
static weights keep the legacy trial->bracket assignment bit-exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.trial import TrialSpec
from repro_torch.tuner.scheduler import CONTINUE, Decision, Scheduler
from repro_torch.tuner.searchers import ASHAScheduler, rung_ladder


class HyperbandScheduler(Scheduler):
    """Multiple ASHA brackets; trials sampled into brackets by budget."""

    def __init__(self, eta: int = 3, num_rungs: int = 3,
                 num_brackets: int = 3, min_steps: Optional[int] = None,
                 adaptive_brackets: bool = False, suggest_batch: int = 4,
                 seed: int = 0):
        assert eta >= 2 and num_brackets >= 1
        self.eta = eta
        self.num_rungs = num_rungs
        self.num_brackets = num_brackets
        self.min_steps = min_steps
        self.adaptive_brackets = adaptive_brackets
        self.suggest_batch = suggest_batch
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._workload_name: Optional[str] = None
        self.brackets: List[ASHAScheduler] = []
        self._weights: Optional[np.ndarray] = None
        self._bracket_of: Dict[str, int] = {}
        self._dry = False
        # promotions discovered while answering a decision-table batch, in
        # chronological (entry) order — see decision_table below
        self._table_promos: Dict[str, float] = {}

    # ------------------------------------------------------------- set-up
    def _build(self, w) -> None:
        ladder = rung_ladder(w, self.eta, self.num_rungs, self.min_steps)
        self._workload_name = w.name
        # bracket b drops the b lowest rungs; the last admissible bracket
        # (b == len(ladder)) has no rungs at all = plain run-to-completion
        n = max(1, min(self.num_brackets, len(ladder) + 1))
        weights = []
        for b in range(n):
            self.brackets.append(
                ASHAScheduler(eta=self.eta, num_rungs=self.num_rungs,
                              min_steps=self.min_steps, ladder=ladder[b:]))
            floor = ladder[b] if b < len(ladder) else w.max_trial_steps
            weights.append(1.0 / floor)
        arr = np.asarray(weights, np.float64)
        self._weights = arr / arr.sum()

    def on_trial_added(self, spec: TrialSpec) -> float:
        w = spec.workload
        if self.brackets:
            assert w.name == self._workload_name, \
                "HyperbandScheduler supports one workload per run"
        else:
            self._build(w)
        p = self._weights
        if self.adaptive_brackets:
            p = self._adaptive_weights()
        b = int(self._rng.choice(len(self.brackets), p=p))
        self._bracket_of[spec.key] = b
        return self.brackets[b].on_trial_added(spec)

    # -------------------------------------------- adaptive bracket weights
    def survival_rates(self) -> List[Optional[float]]:
        """Observed first-rung survival per bracket: the fraction of that
        bracket's first-rung results currently above the cutoff (not
        parked on it).  None while a bracket has no first-rung results
        (including the rung-less run-to-completion bracket)."""
        rates: List[Optional[float]] = []
        for br in self.brackets:
            if not br.rungs or not br._results[0]:
                rates.append(None)
                continue
            res = br._results[0]
            parked = sum(1 for rung in br._paused.values() if rung == 0)
            rates.append(1.0 - parked / len(res))
        return rates

    def _adaptive_weights(self) -> np.ndarray:
        """Static budget-proportional weights scaled by smoothed survival.

        A bracket whose first rung kills aggressively (low survival) is
        separating configs cheaply — its weight grows relative to brackets
        whose rung is mostly a pass-through.  Smoothing: survival shrunk
        toward the neutral prior 1/2 with pseudo-count 2, so early single
        observations cannot starve a bracket; the scale factor is
        ``(1 + prior) - s`` in [1/2, 3/2], keeping every weight positive."""
        base = self._weights
        rates = self.survival_rates()
        scale = np.ones(len(base))
        for b, s in enumerate(rates):
            if s is None:
                continue
            n = len(self.brackets[b]._results[0])
            s_smooth = (s * n + 0.5 * 2) / (n + 2)
            scale[b] = 1.5 - s_smooth
        w = base * scale
        return w / w.sum()

    # ------------------------------------------------------------- routing
    def _bracket(self, key: str) -> Optional[ASHAScheduler]:
        b = self._bracket_of.get(key)
        return None if b is None else self.brackets[b]

    def on_event(self, event, view) -> Decision:
        br = self._bracket(event.trial)
        return br.on_event(event, view) if br is not None else CONTINUE

    # ------------------------------------------- batched decision table
    # Routed entry-by-entry to the owning bracket's table.  The subtlety is
    # promotion *order*: the scalar path drains promotions after every
    # event, so cross-bracket promotions interleave chronologically; a
    # single bracket-major union at batch end would reorder them (and with
    # them the resume/deploy RNG sequence).  Each entry's freshly staged
    # bracket promotions are therefore folded into ``_table_promos``
    # immediately, preserving the scalar drain order.
    table_events = ASHAScheduler.table_events

    def decision_table(self, entries) -> list:
        out = []
        tp = self._table_promos
        for ent in entries:
            br = self._bracket(ent[1].key)
            if br is None:
                out.append(None)
                continue
            out.append(br.decision_table([ent])[0])
            if br._promos:
                tp.update(br.take_promotions())
        return out

    def take_promotions(self) -> Dict[str, float]:
        promos: Dict[str, float] = dict(self._table_promos)
        self._table_promos.clear()
        for br in self.brackets:
            promos.update(br.take_promotions())
        return promos

    def request_suggestions(self, views: Sequence) -> int:
        """Adaptive mode admits trials in idle-time waves (instead of the
        legacy drain-up-front), so later waves are bracket-sampled with
        survival-informed weights.  Requires a Tuner built with
        ``initial_trials``; inert in static mode."""
        if not self.adaptive_brackets or self._dry:
            return 0
        return self.suggest_batch

    def suggestions_added(self, n: int) -> None:
        if n == 0:
            self._dry = True

    def on_idle(self, views: Sequence) -> Dict[str, float]:
        promos: Dict[str, float] = {}
        for br in self.brackets:
            promos.update(br.on_idle(views))
        return promos

    def preview_metrics(self, view, steps, vals, ticks) -> Optional[int]:
        br = self._bracket(view.key)
        return None if br is None else br.preview_metrics(view, steps, vals,
                                                          ticks)

    # ------------------------------------------------------------- results
    def rank(self, views: Sequence) -> List[str]:
        preds = self.predictions(views)

        def depth(v) -> int:
            b = self._bracket_of.get(v.key)
            if b is None:
                return 0
            # rungs cleared, counted on the full ladder: bracket b's rung i
            # is global rung i + b, so survivors compare across brackets
            return self.brackets[b]._rung_idx.get(v.key, 0) + b

        return [v.key for v in sorted(
            views, key=lambda v: (-depth(v), preds[v.key]))]
