"""TrimTuner's cost-aware acquisition over a Gaussian-process posterior.

``TrimTunerSearcher`` (ridge posterior, grid enumeration) reproduces the
TrimTuner acquisition on the paper's 16-point lattice; this module is the
continuous relaxation the real TrimTuner (Mendes et al., 2020) is defined
over, in the syne-tune idiom (a GP posterior over normalized HP
coordinates — cf. syne-tune's independent-per-resource GP, collapsed here
to a single fidelity feature instead of per-resource states):

  * **model** — a Matérn-5/2 GP over the space's encoded ``[0,1]^d``
    features plus a fidelity-deficit column (``1 - steps/max_steps``; the
    sub-sampled bootstrap wave enters at deficit > 0 and predictions are
    made at deficit 0, which de-biases the cheap runs exactly as the ridge
    model's deficit coefficient did).  Fixed lengthscale, empirical mean /
    signal variance, closed-form numpy Cholesky — no hyper-parameter
    optimization loop, so every posterior is a pure deterministic function
    of the (seed, feedback sequence) pair, which the sweep's batched ==
    sequential contract requires.
  * **acquisition** — expected improvement per predicted dollar.  The cost
    model is the same Bayesian ridge over $/step observations TrimTuner
    uses (costs are near-affine in the encoded coords; a GP buys nothing).
  * **optimizer** — seeded random search over the space (``n_candidates``
    draws) plus local search around the incumbents: ``Domain.neighbor``
    perturbations of the best observed configs.  On a finite space the
    candidate set is simply every unexplored grid point, which makes the
    grid the degenerate case rather than a separate code path downstream.

Registered as searcher ``trimtuner-gp``; the ``trimtuner-gp`` *policy* row
in the benchmarks pairs it with ``AdaptiveSpotTuneScheduler`` (θ-budget +
fidelity-gap verification + EarlyCurve phase-2), same as ``adaptive``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.trial import TrialSpec, Workload
from repro_torch.tuner.policies.trimtuner import _norm_cdf, _norm_pdf, _posterior
from repro_torch.tuner.scheduler import Searcher


def matern52(A: np.ndarray, B: np.ndarray, lengthscale: float) -> np.ndarray:
    """Matérn-5/2 kernel matrix between row sets A (n,d) and B (m,d)."""
    A = np.asarray(A, np.float64) / lengthscale
    B = np.asarray(B, np.float64) / lengthscale
    d2 = np.maximum(
        (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * (A @ B.T),
        0.0)
    r = np.sqrt(d2)
    s5 = math.sqrt(5.0) * r
    return (1.0 + s5 + (5.0 / 3.0) * d2) * np.exp(-s5)


class GPPosterior:
    """Exact GP regression posterior, fixed hyper-parameters.

    Empirical mean and signal variance, Matérn-5/2 covariance, Cholesky
    factorization once per fit; ``predict`` returns marginal means and
    variances at test rows.  Deliberately tiny: TrimTuner observes tens of
    points, not thousands, and determinism beats adaptivity here."""

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 lengthscale: float = 0.4, noise_frac: float = 1e-3):
        self.X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self.ls = lengthscale
        self.mean = float(y.mean())
        var = float(y.var())
        self.sig2 = max(var, 1e-8)
        noise = max(noise_frac * self.sig2, 1e-10)
        K = self.sig2 * matern52(self.X, self.X, self.ls)
        K[np.diag_indices_from(K)] += noise
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(
            self.L.T, np.linalg.solve(self.L, y - self.mean))

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = self.sig2 * matern52(np.asarray(Xs, np.float64), self.X, self.ls)
        mu = self.mean + Ks @ self.alpha
        V = np.linalg.solve(self.L, Ks.T)
        var = np.maximum(self.sig2 - np.sum(V * V, axis=0), 1e-12)
        return mu, var


class TrimTunerGPSearcher(Searcher):
    """Cost-aware GP Bayesian optimization over any ``SearchSpace``."""

    live_results = True
    supports_continuous = True

    def __init__(self, workload: Workload, initial: int = 6, batch: int = 3,
                 sub_frac: float = 0.4, max_trials: int = 14,
                 n_candidates: int = 256, n_incumbents: int = 3,
                 n_neighbors: int = 8, lengthscale: float = 0.4,
                 ridge: float = 1e-2, seed: int = 0):
        assert 0.0 < sub_frac <= 1.0
        self.workload = workload
        self.space = workload.space
        self.batch = batch
        self.sub_frac = sub_frac
        self.lengthscale = lengthscale
        self.ridge = ridge
        self.n_candidates = n_candidates
        self.n_incumbents = n_incumbents
        self.n_neighbors = n_neighbors
        self._rng = np.random.default_rng(seed)
        self._grid = self.space.grid() if self.space.is_finite else None
        if self._grid is not None:
            max_trials = min(max_trials, len(self._grid))
        self.max_trials = max_trials
        self._suggested_hashes: set = set()
        self._n_suggested = 0
        # (hp, grid idx or GRID_FREE, budget_frac)
        self._queue: List[Tuple[dict, int, float]] = []
        self._bootstrap(initial)
        # (hp, fidelity in (0,1], metric, billed $, steps)
        self._obs: List[Tuple[dict, float, float, float, float]] = []

    # ----------------------------------------------------------- bootstrap
    def _bootstrap(self, initial: int) -> None:
        """Cheap sub-sampled seed wave: a random design over the space.
        ``sample_distinct`` terminates with a smaller wave when a
        continuous-typed space is effectively tiny."""
        n0 = min(initial, self.max_trials)
        if self._grid is not None:
            order = self._rng.permutation(len(self._grid))
            for i in order[:n0]:
                self._push(self._grid[int(i)], int(i), self.sub_frac)
            return
        for hp in self.space.sample_distinct(self._rng, n0,
                                             seen=self._suggested_hashes):
            self._queue.append((hp, TrialSpec.GRID_FREE, self.sub_frac))

    def _push(self, hp: dict, idx: int, frac: float) -> bool:
        h = self.space.config_hash(hp)
        if h in self._suggested_hashes:
            return False
        self._suggested_hashes.add(h)
        self._queue.append((hp, idx, frac))
        return True

    # ------------------------------------------------------------ protocol
    def suggest(self) -> Optional[TrialSpec]:
        if not self._queue:
            self._refine()
        if not self._queue:
            return None
        hp, idx, frac = self._queue.pop(0)
        self._n_suggested += 1
        return TrialSpec(self.workload, hp, idx, budget_frac=frac)

    def on_trial_finished(self, view) -> None:
        """Rich feedback: final metric + the engine's billed dollars."""
        if not view.metrics_vals:
            return
        fid = min(1.0, view.steps / view.spec.workload.max_trial_steps)
        cost = max(float(getattr(view, "billed_cost", 0.0)), 0.0)
        self._obs.append((view.spec.hp, max(fid, 1e-3),
                          float(view.metrics_vals[-1]), cost,
                          max(float(view.steps), 1.0)))

    # ----------------------------------------------------------- modelling
    def _design(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
        F = self.space.encode([o[0] for o in self._obs])
        X = np.column_stack(
            [F, np.array([1.0 - o[1] for o in self._obs])])   # deficit col
        y = np.array([o[2] for o in self._obs])
        cps = np.array([o[3] / o[4] for o in self._obs])      # $ per step
        return F, X, y, cps

    def _candidates(self) -> List[dict]:
        """Acquisition support: unexplored grid (finite) or seeded random +
        incumbent-neighborhood draws (continuous)."""
        if self._grid is not None:
            return [hp for hp in self._grid
                    if self.space.config_hash(hp)
                    not in self._suggested_hashes]
        cands = self.space.sample(self._rng, self.n_candidates)
        best = sorted(self._obs, key=lambda o: o[2])[: self.n_incumbents]
        for hp, *_ in best:                       # local search around them
            for _ in range(self.n_neighbors):
                cands.append(self.space.neighbor(hp, self._rng))
        seen = set(self._suggested_hashes)
        out = []
        for hp in cands:
            h = self.space.config_hash(hp)
            if h not in seen:
                seen.add(h)
                out.append(hp)
        return out

    def _refine(self) -> None:
        if self._n_suggested + len(self._queue) >= self.max_trials \
                or len(self._obs) < 2:
            return
        cand = self._candidates()
        if not cand:
            return
        F, X, y, cps = self._design()
        gp = GPPosterior(X, y, lengthscale=self.lengthscale)
        Fc = self.space.encode(cand)
        # predict at full fidelity: deficit column pinned to 0
        mu, var = gp.predict(np.column_stack([Fc, np.zeros(len(cand))]))
        s = np.sqrt(var)
        best = float(np.min(y))
        gamma = (best - mu) / s
        ei = s * (gamma * _norm_cdf(gamma) + _norm_pdf(gamma))
        # predicted full-budget dollars (ridge over observed $/step, floored
        # so a lucky free run can't absorb the whole batch)
        cmu, _, _ = _posterior(
            np.column_stack([np.ones(len(self._obs)), F]), cps, self.ridge)
        floor = 0.05 * max(float(np.median(cps)), 1e-9)
        c_pred = np.maximum(
            np.column_stack([np.ones(len(cand)), Fc]) @ cmu,
            floor) * self.workload.max_trial_steps
        acq = ei / c_pred
        take = min(self.batch,
                   self.max_trials - self._n_suggested - len(self._queue))
        for j in np.argsort(-acq, kind="stable")[:take]:
            hp = cand[int(j)]
            idx = (self.space.grid_index(hp) if self._grid is not None
                   else TrialSpec.GRID_FREE)
            self._push(hp, idx if idx is not None else TrialSpec.GRID_FREE,
                       1.0)                       # refinement: full budget
