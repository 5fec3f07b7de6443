"""Scheduler/Searcher protocols: the policy half of the tuner split.

SpotTune's engine (market + provisioning + checkpoint/restore + refund
accounting) is policy-free; *what to run and when to stop it* is delegated to
two pluggable pieces, syne-tune style:

  Searcher   suggests trial configurations (``TrialSpec``s) — grid, random,
             model-based, ... (``repro_torch.tuner.searchers``)
  Scheduler  consumes the engine's event stream (``repro_torch.tuner.events``) and
             returns ``Decision``s — continue, pause at a checkpoint, stop for
             good, or promote to a larger step budget.  The paper's θ +
             EarlyCurve policy is one such scheduler
             (``repro_torch.tuner.spottune.SpotTuneScheduler``); ASHA is another
             (``repro_torch.tuner.searchers.ASHAScheduler``).

Schedulers observe trials through *views*: any object with the attributes
``spec``, ``key``, ``steps``, ``target_steps``, ``metrics_steps``,
``metrics_vals`` and ``stopped``.  The engine passes its own ``TrialState``;
out-of-engine drivers (e.g. ``examples/e2e_hpt_train.py``, which runs real JAX
training) pass the lightweight ``TrialView`` below.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

from repro_torch.core.trial import TrialSpec


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------


class DecisionKind(enum.Enum):
    CONTINUE = "continue"   # keep running
    PAUSE = "pause"         # checkpoint + release; park until promoted
    STOP = "stop"           # trial is done (early): checkpoint + finish
    PROMOTE = "promote"     # raise the trial's step budget (resumes if parked)


@dataclasses.dataclass(frozen=True)
class Decision:
    kind: DecisionKind
    target_steps: Optional[float] = None  # only for PROMOTE


CONTINUE = Decision(DecisionKind.CONTINUE)
PAUSE = Decision(DecisionKind.PAUSE)
STOP = Decision(DecisionKind.STOP)


def PROMOTE(target_steps: float) -> Decision:
    return Decision(DecisionKind.PROMOTE, target_steps=target_steps)


# ---------------------------------------------------------------------------
# trial view
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrialView:
    """Minimal duck-type of the engine's TrialState, for drivers that run
    trials themselves (real training loops) but want engine-free policy."""

    spec: TrialSpec
    steps: float = 0.0
    target_steps: float = 0.0
    metrics_steps: List[int] = dataclasses.field(default_factory=list)
    metrics_vals: List[float] = dataclasses.field(default_factory=list)
    stopped: bool = False

    @property
    def key(self) -> str:
        return self.spec.key


# ---------------------------------------------------------------------------
# protocols (as inheritable no-op base classes)
# ---------------------------------------------------------------------------


class Scheduler:
    """Base scheduler: runs every trial to its workload's full budget.

    Subclass hooks:

      on_trial_added(spec) -> target_steps | None
          Called once per suggested trial, before the run.  Return the initial
          step budget (None = the workload's ``max_trial_steps``).
      on_event(event, view) -> Decision | None
          Called for every engine event; None is treated as CONTINUE.
      take_promotions() -> {key: target_steps}
          Drained by the engine after every event: asynchronous promotions of
          *other* trials (e.g. ASHA un-pausing a rung survivor).  Order is the
          resume order.
      on_idle(views) -> {key: target_steps}
          Called when no trial is running or waiting.  Return promotions to
          resume paused/finished trials with a new budget; an empty dict ends
          the tuning run.  Order is the (re)deployment order — it matters for
          reproducibility because provisioning consumes seeded RNG draws.
      preview_metrics(view, steps, vals, ticks) -> index | None
          Optional fast-path contract: given the metric points a running
          trial will cross before its next lifecycle boundary (arrays of
          step, value, and the tick each would be observed at), return the
          index of the first point whose ``on_event`` would do anything
          other than a side-effect-free CONTINUE — or None if every point
          is inert.  A scheduler that implements this promises the engine
          may *silently* append the inert points to the trial's history
          without dispatching ``MetricReported`` for them; the flagged
          point (and its same-tick companions) still dispatches normally.
          Must be pure: the engine may re-preview overlapping windows.
      request_suggestions(views) -> int
          Consulted at every engine idle, before promotions: how many fresh
          searcher suggestions to admit (0 = none).  Enables unbounded /
          adaptive search without draining the searcher up front.
      suggestions_added(n)
          Follow-up to a non-zero request: how many trials the searcher
          actually produced (0 = it is exhausted).
      idle_fit_jobs(views) -> [(steps, vals, target_step), ...] | None
          Optional sweep batching hook: the curve-fit workload the next
          ``on_idle`` needs, exposed so a sweep runner can stack the fits of
          many replicas into one dispatch.  ``run_idle_fits(jobs)`` must
          compute them locally; ``set_idle_fits(preds)`` hands results back
          (in job order) before ``on_idle`` is called.
      predictions(views) -> {key: predicted_final_metric}
      rank(views) -> [key, ...]   best first (lower metric = better)

    Batched decision tables (SoA fast path).  A scheduler may opt into
    answering a whole event batch at once by setting ``table_events`` and
    overriding ``decision_table``; see the attribute docs below.  The SoA
    sweep stepper (``repro.sweep.soa``) then replaces its per-row scalar
    dispatch chain with one table call per replica per round; policies
    without the capability keep the verbatim per-event chain.
    """

    #: Decision-table capability.  ``None`` (the base) = scalar chain only.
    #: An opted-in scheduler overrides this with a method
    #: ``decision_table(entries) -> [answer, ...]`` where ``entries`` is a
    #: list of ``("metric", view, [(step, value), ...])`` and
    #: ``("revoked", view, (lost_steps, ckpt_steps))`` tuples in engine
    #: chain order (per trial: its metric batch strictly before its
    #: revocation), and each answer is ``None`` (every dispatch would be a
    #: side-effect-free CONTINUE) or ``(stop, pause, target)`` — the
    #: cumulative flag effect the per-event ``Decision``s would have had
    #: (``stop``/``pause`` booleans, ``target`` a new step budget or None).
    #: The contract mirrors the scalar chain exactly:
    #:   * processing entry i must leave the scheduler in the same state as
    #:     dispatching entry i's events through ``on_event`` in order;
    #:   * events whose class is NOT in ``table_events`` are promised inert
    #:     (CONTINUE, no observable state change), so the engine may skip
    #:     dispatching them entirely — including ``TrialStarted`` at deploy
    #:     time and the lifecycle narration events;
    #:   * the table must not read view attributes the engine mutates while
    #:     applying answers (``stopped``/``pause_requested``/
    #:     ``target_steps``/``status``) — it maintains its own state;
    #:   * asynchronous promotions are staged as usual and drained once via
    #:     ``take_promotions`` after the whole batch, which must be
    #:     equivalent to the scalar path's per-event drain (promotions only
    #:     ever touch parked — non-running — trials), with the *chronological*
    #:     staging order preserved.
    decision_table = None

    #: Event classes the decision table acts on.  Everything else is
    #: declared inert per the contract above.  Only ``MetricReported`` and
    #: ``TrialRevoked`` are batchable; a table declaring any other class
    #: falls back to the scalar chain in the stepper.
    table_events: frozenset = frozenset()

    def on_trial_added(self, spec: TrialSpec) -> Optional[float]:
        return None

    def on_event(self, event, view) -> Optional[Decision]:
        return CONTINUE

    def take_promotions(self) -> Dict[str, float]:
        return {}

    def on_idle(self, views: Sequence) -> Dict[str, float]:
        return {}

    def preview_metrics(self, view, steps, vals, ticks) -> Optional[int]:
        return None          # base = no preview capability (conservative)

    def request_suggestions(self, views: Sequence) -> int:
        return 0

    def suggestions_added(self, n: int) -> None:
        pass

    def idle_fit_jobs(self, views: Sequence) -> Optional[list]:
        return None

    def run_idle_fits(self, jobs: list) -> list:
        raise NotImplementedError

    def set_idle_fits(self, preds: list) -> None:
        pass

    def predictions(self, views: Sequence) -> Dict[str, float]:
        return {v.key: (v.metrics_vals[-1] if v.metrics_vals else 1e9)
                for v in views}

    def rank(self, views: Sequence) -> List[str]:
        preds = self.predictions(views)
        return [v.key for v in sorted(views, key=lambda v: preds[v.key])]


class Searcher:
    """Base searcher: suggests nothing.  Subclasses yield TrialSpecs.

    ``supports_continuous`` declares whether the searcher can operate on a
    ``SearchSpace`` with continuous domains (``Uniform``/``LogUniform``/
    ``IntUniform``) or requires a finite, enumerable grid.  The registry
    (``repro.tuner.registry.make_searcher``) enforces the pairing: asking a
    grid-only searcher to search a continuous space is a ValueError, not a
    silent truncation."""

    #: can this searcher propose configs off a finite grid?
    supports_continuous = False

    def suggest(self) -> Optional[TrialSpec]:
        return None

    def on_result(self, key: str, metric: Optional[float]) -> None:
        """Feedback hook for adaptive searchers; default ignores it."""
