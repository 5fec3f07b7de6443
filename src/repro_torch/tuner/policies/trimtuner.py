"""TrimTuner-style cost-aware Bayesian optimization (arXiv 2011.04726).

TrimTuner's two ideas, restated for the engine's incremental-suggestion
idle path:

  * **sub-sampled cheap trials** — the initial design wave runs at a
    reduced step budget (``budget_frac = sub_frac``, consumed by the
    scheduler's ``on_trial_added``), so the model is bootstrapped for a
    fraction of a full evaluation's cost.  The fidelity deficit
    ``1 - steps/max_steps`` of every observation enters the model as a
    feature, letting the posterior de-bias the cheap runs when predicting
    full-budget outcomes;
  * **expected improvement per cost** — each refinement wave fits a
    Bayesian ridge posterior over the (one-hot-positional) HP features,
    scores every unexplored grid config with EI toward the best observed
    metric, divides by the *predicted dollar cost* of evaluating it (a
    second ridge model over the engine's per-trial billed cost, which the
    Tuner feeds back via ``on_trial_finished``), and proposes the top
    ``batch`` — configs that buy the most improvement per dollar, which on
    a transient market is not the same ordering as EI alone because step
    prices differ across configs (batch size and depth move step time).

Refinement-wave suggestions additionally declare a *warm start*: when the
best-observed config differs from the proposed one in a single HP dim, the
suggestion carries ``TrialSpec.inherit = (donor_key, donor_step)`` (donor
step snapped down to the metric grid) — inert under the sim backend, real
weight inheritance under ``repro_torch.backends.training``, mirroring how
TrimTuner promotes sub-sampled runs instead of restarting them.

Everything is closed-form numpy (no new dependencies) and fully
deterministic given the seed and the feedback sequence, which is what the
sweep's batched == sequential contract requires.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.trial import TrialSpec, Workload
from repro_torch.tuner.scheduler import Searcher


def _posterior(X: np.ndarray, y: np.ndarray, lam: float
               ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Bayesian ridge posterior: mean coefficients, covariance, noise var."""
    d = X.shape[1]
    A = X.T @ X + lam * np.eye(d)
    mu = np.linalg.solve(A, X.T @ y)
    resid = y - X @ mu
    dof = max(len(y) - d, 1)
    sigma2 = max(float(resid @ resid) / dof, 1e-8)
    cov = sigma2 * np.linalg.inv(A)
    return mu, cov, sigma2


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.array([math.erf(v / math.sqrt(2.0)) for v in z]))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class TrimTunerSearcher(Searcher):
    """Cost-aware BO over a finite space; sub-sampled bootstrap wave.

    The ridge posterior's feature matrix is the space's vectorized
    ``encode`` — normalized ``[0,1]^d`` coordinates (for the legacy Ordinal
    dims this is exactly the old positional featurization) — plus the
    fidelity-deficit column.  The acquisition enumerates the grid, so the
    searcher is grid-only; ``TrimTunerGPSearcher`` is the continuous
    relaxation."""

    live_results = True      # Tuner feeds finished-trial outcomes mid-run
    supports_continuous = False

    def __init__(self, workload: Workload, initial: int = 6, batch: int = 3,
                 sub_frac: float = 0.4, max_trials: int = 14,
                 ridge: float = 1e-2, seed: int = 0):
        assert 0.0 < sub_frac <= 1.0
        self.workload = workload
        self.space = workload.space
        self.grid = self.space.grid()
        self.batch = batch
        self.sub_frac = sub_frac
        self.max_trials = min(max_trials, len(self.grid))
        self.ridge = ridge
        self._feats = self.space.encode(self.grid)
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.grid))
        n0 = min(initial, self.max_trials)
        # bootstrap wave: cheap sub-sampled evaluations of a random design
        self._queue: List[Tuple[int, float, Optional[tuple]]] = [
            (int(i), sub_frac, None) for i in order[:n0]]
        self._suggested = {i for i, _, _ in self._queue}
        # (grid idx, fidelity in (0,1], metric, billed $, steps)
        self._obs: List[Tuple[int, float, float, float, float]] = []
        self._keys: dict = {}    # grid idx -> trial key (warm-start donors)

    # ------------------------------------------------------------ protocol
    def suggest(self) -> Optional[TrialSpec]:
        if not self._queue:
            self._refine()
        if not self._queue:
            return None
        i, frac, inherit = self._queue.pop(0)
        return TrialSpec(self.workload, self.grid[i], i, budget_frac=frac,
                         inherit=inherit)

    def on_trial_finished(self, view) -> None:
        """Rich feedback hook: final metric + the engine's per-trial billed
        dollars (net of refunds) — the cost signal the acquisition divides
        by.  Fidelity is the fraction of the full budget actually run."""
        if not view.metrics_vals:
            return
        fid = min(1.0, view.steps / view.spec.workload.max_trial_steps)
        cost = max(float(getattr(view, "billed_cost", 0.0)), 0.0)
        self._obs.append((view.spec.idx, max(fid, 1e-3),
                          float(view.metrics_vals[-1]), cost,
                          max(float(view.steps), 1.0)))
        self._keys[view.spec.idx] = view.spec.key

    # --------------------------------------------------------- acquisition
    def _design(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        idx = np.array([o[0] for o in self._obs])
        X = np.column_stack([
            np.ones(len(self._obs)),
            self._feats[idx],
            np.array([1.0 - o[1] for o in self._obs]),   # fidelity deficit
        ])
        y = np.array([o[2] for o in self._obs])
        cps = np.array([o[3] / o[4] for o in self._obs])  # $ per step
        return X, y, cps

    def _refine(self) -> None:
        if len(self._suggested) >= self.max_trials or len(self._obs) < 2:
            return
        cand = [i for i in range(len(self.grid)) if i not in self._suggested]
        if not cand:
            return
        X, y, cps = self._design()
        mu, cov, sigma2 = _posterior(X, y, self.ridge)
        # predict unexplored configs at full fidelity (deficit = 0)
        Xc = np.column_stack([np.ones(len(cand)), self._feats[cand],
                              np.zeros(len(cand))])
        m = Xc @ mu
        s = np.sqrt(np.maximum(sigma2 + np.sum((Xc @ cov) * Xc, axis=1),
                               1e-12))
        best = float(np.min(y))
        gamma = (best - m) / s
        ei = s * (gamma * _norm_cdf(gamma) + _norm_pdf(gamma))
        # predicted full-budget dollar cost per candidate (ridge over the
        # observed $/step); floored so a lucky free run can't zero the
        # denominator and absorb the whole batch
        cmu, _, _ = _posterior(
            np.column_stack([np.ones(len(self._obs)),
                             self._feats[[o[0] for o in self._obs]]]),
            cps, self.ridge)
        floor = 0.05 * max(float(np.median(cps)), 1e-9)
        c_pred = np.maximum(
            np.column_stack([np.ones(len(cand)), self._feats[cand]]) @ cmu,
            floor) * self.workload.max_trial_steps
        acq = ei / c_pred
        take = min(self.batch, self.max_trials - len(self._suggested))
        for j in np.argsort(-acq, kind="stable")[:take]:
            i = cand[int(j)]
            # refinement waves: full budget, warm-started where a
            # one-dim-away observed donor exists
            self._queue.append((i, 1.0, self._warm_start(i)))
            self._suggested.add(i)

    def _warm_start(self, i: int) -> Optional[tuple]:
        """Donor declaration for candidate ``i``: the best observed config,
        iff it differs in exactly one HP dim, at its observed progress
        snapped down to the metric grid.  Deterministic in the feedback
        sequence (ties resolve to the earliest observation)."""
        if not self._obs:
            return None
        best = min(self._obs, key=lambda o: o[2])
        donor_hp, cand_hp = self.grid[best[0]], self.grid[i]
        if sum(donor_hp[k] != cand_hp[k] for k in donor_hp) != 1:
            return None
        ve = self.workload.val_every
        step = int(best[4] // ve) * ve
        key = self._keys.get(best[0])
        return (key, step) if key and step > 0 else None
