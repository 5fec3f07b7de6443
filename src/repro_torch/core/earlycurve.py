"""EarlyCurve: staged ML-training-trend prediction (paper §III-C, Eq. 4-7).

The metric trajectory is modeled as a *piecewise* sublinear curve

    L̂(k) = Σ_i [ 1/(αᵢ₀·k² + αᵢ₁·k + αᵢ₂) + αᵢ₃ ] · 1[lᵢ ≤ k < rᵢ]

with non-negative coefficients — the O(1/k)–O(1/k²) envelope of
gradient-descent convergence (paper §V-B).  Stage boundaries are detected
online with the Eq. 7 heuristic: a change-rate spike (ζᵢ > ξ) following ≥5
quiet steps (ζⱼ < ε) starts a new stage.

Fitting: damped Gauss-Newton (Levenberg-Marquardt) on softplus-parametrized
coefficients, batched float32 PyTorch on ``device`` (the card unless the
caller asks for the CPU).  Stage detection, the plateau test and the
prediction from a fit are numpy, as in the JAX package.  Prediction at
``max_trial_steps`` extrapolates the *final* detected stage.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Eq. 7 stage detection
# ---------------------------------------------------------------------------


def detect_stages(vals: Sequence[float], xi: float = 0.5, eps: float = 0.01,
                  quiet: int = 5) -> List[Tuple[int, int]]:
    """Half-open [l, r) stage intervals partitioning [0, len(vals))  (Eq. 6)."""
    v = np.asarray(vals, np.float64)
    T = len(v)
    if T <= 1:
        return [(0, T)]
    zeta = np.zeros(T)
    zeta[1:] = np.abs(np.diff(v)) / np.maximum(np.abs(v[:-1]), 1e-12)
    bounds = [0]
    for i in range(1, T):
        if zeta[i] > xi and i - quiet >= 1 and np.all(zeta[max(1, i - quiet):i] < eps):
            bounds.append(i)
    bounds.append(T)
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]



# ---------------------------------------------------------------------------
# Eq. 4 curve fit (softplus-LM), batched float32 PyTorch
# ---------------------------------------------------------------------------


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _fit_lm(k, y, mask, n_real, alpha0, iters: int = 60):
    """Damped Gauss-Newton (Levenberg-Marquardt) on the masked MSE of every
    (row, restart) pair at once.

    k, y, mask (R, L) zero-padded stages; n_real (R,) real sample counts;
    alpha0 (S, 4) restart inits -> best pre-params (R, S, 4) and their costs
    (R, S).  The JAX package's ``_fit_lm_masked_raw`` under its two vmaps,
    with the same iteration count, λ schedule and accept rule; the Jacobian
    of the 4-parameter softplus curve is written out instead of taken by
    ``jax.jacfwd``.  Every reduction runs along the last (sample) axis, one
    row at a time, so a row's fit does not depend on its batch neighbours."""
    R, S = k.shape[0], alpha0.shape[0]
    kk = k[:, None, :]                                     # (R, 1, L)
    yy = y[:, None, :]
    mm = mask[:, None, :]
    nn = n_real[:, None]
    eye = torch.eye(4, dtype=k.dtype, device=k.device)

    def residual(alpha):                                   # (R, S, L)
        a = _softplus(alpha)[..., None]
        denom = a[:, :, 0] * kk * kk + a[:, :, 1] * kk + a[:, :, 2] + 1e-9
        return (1.0 / denom + a[:, :, 3] - yy) * mm, denom

    def cost(r):
        return (r * r).sum(-1) / nn

    def jacobian(alpha, denom):                            # (R, S, 4, L)
        ds = torch.sigmoid(alpha)[..., None]               # d softplus
        inv2 = -1.0 / (denom * denom)
        return torch.stack([inv2 * kk * kk * ds[:, :, 0],
                            inv2 * kk * ds[:, :, 1],
                            inv2 * ds[:, :, 2],
                            torch.ones_like(denom) * ds[:, :, 3]], dim=2) * mm[:, :, None]

    alpha = alpha0[None].expand(R, S, 4).contiguous()
    lam = torch.full((R, S), 1e-2, dtype=k.dtype, device=k.device)
    r, denom = residual(alpha)
    c_old = cost(r)
    best_a, best_c = alpha, c_old
    for _ in range(iters):
        J = jacobian(alpha, denom)
        JTJ = (J[:, :, :, None, :] * J[:, :, None, :, :]).sum(-1)
        g = (J * r[:, :, None, :]).sum(-1)
        step = torch.linalg.solve_ex(JTJ + lam[..., None, None] * eye,
                                     g[..., None])[0][..., 0]
        cand = alpha - step
        r_new, denom_new = residual(cand)
        c_new = cost(r_new)
        improved = c_new < c_old
        imp = improved[..., None]
        alpha = torch.where(imp, cand, alpha)
        r = torch.where(imp, r_new, r)
        denom = torch.where(imp, denom_new, denom)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 2.5), 1e-8, 1e8)
        c_old = torch.where(improved, c_new, c_old)
        better = c_old < best_c
        best_a = torch.where(better[..., None], alpha, best_a)
        best_c = torch.minimum(c_old, best_c)
    return best_a, best_c


# smallest stage batch a solve is fed, kept from the JAX package (whose XLA
# programs for 1 and 2 rows rounded differently): rows are padded with
# masked dummies, so a fit never depends on how many stages share its call
_MIN_BATCH_ROWS = 3
# largest row chunk per call
_MAX_BATCH_ROWS = 512

# content-addressed fit memo: a stage fit is a pure function of
# (ks, ys, n_restarts, seed) on one device type, and sweeps are full of
# repeats — every replica of the same (workload, trial, theta) sees the
# identical metric prefix.  The device type is part of the key because the
# card and the CPU round differently.  The cap only bounds memory.
_FIT_CACHE: dict = {}
_FIT_CACHE_MAX = 65536


def clear_fit_caches() -> None:
    _FIT_CACHE.clear()


def _restart_inits(n_restarts: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    inits = [np.array([0.0, 0.5, 0.5, -2.0], np.float32)]
    for _ in range(n_restarts - 1):
        inits.append(rng.normal(0, 1.5, 4).astype(np.float32))
    return np.stack(inits)


def fit_stage_batch(stages: List[Tuple[np.ndarray, np.ndarray]],
                    n_restarts: int = 4, seed: int = 0,
                    device="cuda") -> List[dict]:
    """Fit many stages at once; returns one ``fit_stage``-style dict each.

    Stages are zero-padded to length buckets (8, 16, then multiples of 32)
    and row counts to powers of two, so one solve covers a whole bucket.
    Repeats — within the call and across calls — are served from the
    content-addressed memo."""
    dev = resolve_device(device)
    fits: List[Optional[dict]] = [None] * len(stages)
    miss_keys: List[tuple] = []            # unique unseen keys, first-seen order
    miss_data: dict = {}                   # key -> (ks float64, ys float64)
    waiting: dict = {}                     # key -> output slots
    for i, (ks, ys) in enumerate(stages):
        ks = np.ascontiguousarray(np.asarray(ks, np.float64))
        ys = np.ascontiguousarray(np.asarray(ys, np.float64))
        key = (ks.tobytes(), ys.tobytes(), n_restarts, seed, dev.type)
        cached = _FIT_CACHE.get(key)
        if cached is not None:
            fits[i] = cached
            continue
        if key in waiting:
            waiting[key].append(i)
        else:
            waiting[key] = [i]
            miss_keys.append(key)
            miss_data[key] = (ks, ys)
    if not miss_keys:
        return fits
    inits = torch.as_tensor(_restart_inits(n_restarts, seed)).to(dev)
    prepared = []
    for key in miss_keys:
        ks, ys = miss_data[key]
        k_scale = max(float(ks[-1]), 1.0)
        y_off = float(np.min(ys))
        y_scale = max(float(np.max(ys) - y_off), 1e-9)
        prepared.append(((ks / k_scale).astype(np.float32),
                         ((ys - y_off) / y_scale).astype(np.float32),
                         k_scale, y_off, y_scale))
    buckets: dict = {}
    for i, p in enumerate(prepared):
        L = len(p[0])
        b = 8 if L <= 8 else 16 if L <= 16 else ((L + 31) // 32) * 32
        buckets.setdefault(b, []).append(i)
    for b, all_idxs in buckets.items():
        for c0 in range(0, len(all_idxs), _MAX_BATCH_ROWS):
            idxs = all_idxs[c0:c0 + _MAX_BATCH_ROWS]
            rows = max(len(idxs), _MIN_BATCH_ROWS)
            rows = 1 << (rows - 1).bit_length()
            kn = np.zeros((rows, b), np.float32)
            yn = np.zeros_like(kn)
            mask = np.zeros_like(kn)
            n_real = np.ones(rows, np.float32)
            for row, i in enumerate(idxs):
                L = len(prepared[i][0])
                kn[row, :L] = prepared[i][0]
                yn[row, :L] = prepared[i][1]
                mask[row, :L] = 1.0
                n_real[row] = L
            with torch.inference_mode():
                a_all, c_all = _fit_lm(
                    *(torch.as_tensor(v).to(dev) for v in (kn, yn, mask, n_real)),
                    inits)
            a_all = a_all.cpu().numpy()
            c_all = c_all.cpu().numpy()
            for row, i in enumerate(idxs):
                r = int(np.argmin(c_all[row]))
                _, _, k_scale, y_off, y_scale = prepared[i]
                fit = {"alpha": a_all[row, r], "k_scale": k_scale,
                       "y_off": y_off, "y_scale": y_scale,
                       "rmse": float(np.sqrt(float(c_all[row, r])))}
                key = miss_keys[i]
                _FIT_CACHE[key] = fit
                for slot in waiting[key]:
                    fits[slot] = fit
    if len(_FIT_CACHE) > _FIT_CACHE_MAX:
        for key in list(_FIT_CACHE)[:len(_FIT_CACHE) - _FIT_CACHE_MAX]:
            del _FIT_CACHE[key]
    return fits


def fit_stage(ks: np.ndarray, ys: np.ndarray, n_restarts: int = 4,
              seed: int = 0, device="cuda"):
    """Fit one stage.  Returns dict(alpha, k_scale, y_off, y_scale, rmse)."""
    dev = resolve_device(device)
    ks = np.asarray(ks, np.float64)
    ys = np.asarray(ys, np.float64)
    k_scale = max(float(ks[-1]), 1.0)
    y_off = float(np.min(ys))
    y_scale = max(float(np.max(ys) - y_off), 1e-9)
    kn = torch.as_tensor((ks / k_scale).astype(np.float32)).to(dev)[None]
    yn = torch.as_tensor(((ys - y_off) / y_scale).astype(np.float32)).to(dev)[None]
    inits = torch.as_tensor(_restart_inits(n_restarts, seed)).to(dev)
    with torch.inference_mode():
        a_all, c_all = _fit_lm(kn, yn, torch.ones_like(kn),
                               torch.full((1,), float(len(ks)), device=dev),
                               inits)
    a_all = a_all[0].cpu().numpy()
    c_all = c_all[0].cpu().numpy()
    i = int(np.argmin(c_all))       # ties -> first, like the sequential scan
    return {"alpha": a_all[i], "k_scale": k_scale, "y_off": y_off,
            "y_scale": y_scale, "rmse": float(np.sqrt(float(c_all[i])))}



def predict_from_fit(fit: dict, k: float) -> float:
    # plain numpy: a handful of scalar ops is not worth a round trip to the
    # device on the tuning-run idle path
    a = np.logaddexp(np.asarray(fit["alpha"], np.float32), np.float32(0.0))
    kn = np.float32(k / fit["k_scale"])
    yn = float(1.0 / (a[0] * kn * kn + a[1] * kn + a[2] + 1e-9) + a[3])
    return yn * fit["y_scale"] + fit["y_off"]


# ---------------------------------------------------------------------------
# public predictors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EarlyCurve:
    """Staged predictor (the paper's).  ``min_points``: smallest final-stage
    sample count worth fitting; shorter stages fall back to last value.
    Curve fits run on ``device``."""

    xi: float = 0.5
    eps: float = 0.01
    quiet: int = 5
    min_points: int = 8
    plateau_window: int = 20
    plateau_tol: float = 2e-3
    device: str = "cuda"

    def __post_init__(self):
        self.device = str(resolve_device(self.device))

    def stages(self, vals: Sequence[float]) -> List[Tuple[int, int]]:
        return detect_stages(vals, self.xi, self.eps, self.quiet)

    def converged(self, vals: Sequence[float]) -> bool:
        """Plateau detection (paper §III-C special case).

        Scalar early-exit form of ``max(|Δv|/|v|) < tol`` over the trailing
        window — this runs on every metric event in the tuning hot loop, and
        one above-tolerance step settles it."""
        n = len(vals)
        if n < self.plateau_window:
            return False
        tol = self.plateau_tol
        prev = vals[n - self.plateau_window]
        for i in range(n - self.plateau_window + 1, n):
            cur = vals[i]
            if abs(cur - prev) / max(abs(prev), 1e-12) >= tol:
                return False
            prev = cur
        return True

    def _final_stage(self, steps: np.ndarray, vals: np.ndarray):
        """-> (l, r) of the fittable final stage, or None for the last-value
        fallback (final stage too fresh even after merging its predecessor)."""
        segs = self.stages(vals)
        l, r = segs[-1]
        if r - l < self.min_points:
            # final stage too fresh to fit — combine with previous stage tail
            if len(segs) >= 2:
                l = segs[-2][0]
            if r - l < self.min_points:
                return None
        return l, r

    def predict_final(self, steps: Sequence[int], vals: Sequence[float],
                      target_step: int, seed: int = 0) -> float:
        """Predict the metric at ``target_step`` from a partial trajectory."""
        steps = np.asarray(steps)
        vals = np.asarray(vals, np.float64)
        seg = self._final_stage(steps, vals)
        if seg is None:
            return float(vals[-1])
        l, r = seg
        ks = steps[l:r] - steps[l] + 1   # re-zero stage clock (Eq. 4 per-stage)
        fit = fit_stage(ks, vals[l:r], seed=seed, device=self.device)
        return predict_from_fit(fit, float(target_step - steps[l] + 1))

    def predict_final_batch(self, trajs: Sequence[Tuple], seed: int = 0
                            ) -> List[float]:
        """``predict_final`` over many ``(steps, vals, target_step)`` partial
        trajectories, with every curve fit batched into as few solves
        as the stage-length buckets allow."""
        out: List[float] = [0.0] * len(trajs)
        jobs = []
        for i, (steps, vals, target_step) in enumerate(trajs):
            steps = np.asarray(steps)
            vals = np.asarray(vals, np.float64)
            seg = self._final_stage(steps, vals)
            if seg is None:
                out[i] = float(vals[-1])
                continue
            l, r = seg
            jobs.append((i, steps[l:r] - steps[l] + 1, vals[l:r],
                         float(target_step - steps[l] + 1)))
        if jobs:
            fits = fit_stage_batch([(ks, ys) for _, ks, ys, _ in jobs],
                                   seed=seed, device=self.device)
            for (i, _, _, k_pred), fit in zip(jobs, fits):
                out[i] = predict_from_fit(fit, k_pred)
        return out


def predict_final_grouped(requests: Sequence[Tuple["EarlyCurve", Sequence[Tuple], int]]
                          ) -> List[List[float]]:
    """``predict_final_batch`` across many callers in as few dispatches as
    the stage-length buckets allow — the sweep runtime's cross-replica batch
    point.  ``requests`` is a list of ``(predictor, trajs, seed)``; trajs
    from requests sharing a predictor configuration and restart seed are
    fitted in one stacked call, and every per-trajectory result is
    bit-identical to the per-caller path (masked-row bucketing plus the
    >=3-row floor make each fit independent of its batch neighbors)."""
    groups: dict = {}
    for ri, (ec, trajs, seed) in enumerate(requests):
        key = (type(ec), dataclasses.astuple(ec), seed)
        groups.setdefault(key, []).append(ri)
    out: List[Optional[List[float]]] = [None] * len(requests)
    for idxs in groups.values():
        ec, _, seed = requests[idxs[0]]
        merged = []
        for ri in idxs:
            merged.extend(requests[ri][1])
        preds = ec.predict_final_batch(merged, seed=seed)
        pos = 0
        for ri in idxs:
            n = len(requests[ri][1])
            out[ri] = preds[pos:pos + n]
            pos += n
    return out


@dataclasses.dataclass
class SLAQPredictor:
    """Single-stage baseline (paper §VI-D / Fig. 11): same curve family,
    fit over the whole trajectory, blind to LR-decay stages.  The fit runs
    on ``device``."""

    device: str = "cuda"

    def __post_init__(self):
        self.device = str(resolve_device(self.device))

    def predict_final(self, steps: Sequence[int], vals: Sequence[float],
                      target_step: int, seed: int = 0) -> float:
        steps = np.asarray(steps)
        vals = np.asarray(vals, np.float64)
        fit = fit_stage(steps - steps[0] + 1, vals, seed=seed,
                        device=self.device)
        return predict_from_fit(fit, float(target_step - steps[0] + 1))
