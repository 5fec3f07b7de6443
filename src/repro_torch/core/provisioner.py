"""Provisioner: fine-grained cost-aware instance selection (paper §III-A).

Implements Algorithm 1's ``getBestInst`` with Eq. 1–2:

    E[eCost] = (1 − p) · price̅ · 1 hour                  (Eq. 1)
    E[sCost] = M[inst][hp] · (1 − p) · price̅             (Eq. 2, $/step)

p comes from RevPred for a *sampled* maximum price (current price + a random
delta in [1e-5, 0.2], exactly Algorithm 1 line 4); price̅ is the trailing-hour
mean.  The (1 − p) factor is what makes SpotTune *court* revocation-prone
markets: an instance likely to be revoked in its first hour is probabilistically
free (the refund), so its expected step cost shrinks.

M (the performance matrix, seconds/step) is initialized ∝ 1/chips — the TPU
analogue of the paper's per-CPU-core init — and updated online from observed
step times (Algorithm 1 line 36, EWMA).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.market import (HOUR, MINUTE, InstanceType, SpotMarket,
                               acquire_batch_multi)
from repro_torch.core.trial import TrialSpec


class PerfModel:
    """The M matrix: M[inst][trial] seconds/step, online-updated.

    Prior: M0 = c0 / chips^prior_exp.  The paper initializes ∝ 1/cores
    (linear); on TPU slices the speedup is well-known to be sublinear in
    chips, and a linear prior over a 64x pool makes big slices look
    spuriously cost-efficient until observed, starving exploration of the
    cheap ones (hardware adaptation noted in DESIGN.md §2)."""

    def __init__(self, pool, c0: float = 8.0, ewma: float = 0.5,
                 prior_exp: float = 0.6):
        self.pool = pool
        self.c0 = c0
        self.ewma = ewma
        self.prior_exp = prior_exp
        self._m: Dict[Tuple[str, str], float] = {}
        self._observed: Dict[Tuple[str, str], bool] = {}

    def get(self, inst: InstanceType, trial: TrialSpec) -> float:
        v = self._m.get((inst.name, trial.key))
        if v is None:      # evaluate the prior only on a miss (hot path)
            v = self.c0 / inst.chips ** self.prior_exp
        return v

    def update(self, inst: InstanceType, trial: TrialSpec, secs_per_step: float):
        key = (inst.name, trial.key)
        if key in self._m and self._observed.get(key):
            self._m[key] = (1 - self.ewma) * self._m[key] + self.ewma * secs_per_step
        else:
            self._m[key] = secs_per_step
        self._observed[key] = True

    def update_many(self, inst: InstanceType, trial: TrialSpec, obs) -> None:
        """Fold a whole window of per-tick observations into M in one call.

        Bit-exact replay of ``update`` called once per observation in order —
        the event-driven engine uses this to catch up the EWMA over ticks it
        skipped (the observations are deterministic, see
        ``SimTrialBackend.noisy_step_times``)."""
        vals = obs.tolist() if hasattr(obs, "tolist") else list(obs)
        if not vals:
            return
        key = (inst.name, trial.key)
        i = 0
        if not (key in self._m and self._observed.get(key)):
            self._m[key] = vals[0]
            self._observed[key] = True
            i = 1
        a = self.ewma
        b = 1 - a
        m = self._m[key]
        for o in vals[i:]:
            m = b * m + a * o
        self._m[key] = m

    def observed(self, inst: InstanceType, trial: TrialSpec) -> bool:
        return self._observed.get((inst.name, trial.key), False)


@dataclasses.dataclass
class Choice:
    inst: InstanceType
    max_price: float
    p_revoke: float
    step_cost: float


class Provisioner:
    def __init__(self, market: SpotMarket, revpred, perf: PerfModel,
                 seed: int = 0, delta_lo: float = 0.00001, delta_hi: float = 0.2):
        self.market = market
        self.revpred = revpred
        self.perf = perf
        self.rng = np.random.default_rng(seed)
        self.delta_lo = delta_lo
        self.delta_hi = delta_hi
        # pool-aligned constants hoisted off the deploy hot path: bid scale
        # (od_price / 0.33), names, and the PerfModel prior (the exact
        # ``get`` fallback expression, precomputed per pool member)
        self._scales = [i.od_price / 0.33 for i in market.pool]
        self._names = [i.name for i in market.pool]
        self._priors = [perf.c0 / i.chips ** perf.prior_exp
                        for i in market.pool]
        # array mirrors for the cross-replica vectorized solve (same doubles)
        self._scales_arr = np.asarray(self._scales)
        self._priors_arr = np.asarray(self._priors)
        # block-buffered delta draws: Generator.uniform fills element-wise
        # from the bit stream, so dispensing n values from a pre-drawn block
        # yields the exact doubles n direct uniform(lo, hi, n) calls would
        self._ubuf = np.empty(0)
        self._upos = 0

    def _deltas(self, n: int) -> list:
        return self._deltas_arr(n).tolist()

    def _deltas_arr(self, n: int) -> np.ndarray:
        """Dispense ``n`` draws from the block buffer as a float64 view —
        the same doubles ``_deltas`` hands out as a list (Generator.uniform
        fills element-wise from the bit stream, so consecutive dispenses of
        n1 then n2 values equal one dispense of n1+n2)."""
        pos = self._upos
        buf = self._ubuf
        end = pos + n
        if end > len(buf):
            buf = np.concatenate([
                buf[pos:], self.rng.uniform(self.delta_lo, self.delta_hi,
                                            max(1024, n))])
            self._ubuf = buf
            pos, end = 0, n
        self._upos = end
        return buf[pos:end]

    def candidates(self, t: float, trial: TrialSpec,
                   exclude: Optional[set] = None) -> list:
        """Algorithm 1 line 4: one sampled maximum price per eligible market.

        This is the only RNG-consuming half of ``best_instance`` — the bid
        draws keep the legacy per-candidate order (excluded markets consume
        no draw), so a caller may draw candidates for several trials first
        and batch the revocation predictions afterwards without disturbing
        the replica's RNG stream."""
        pool = self.market.pool
        names = self._names
        scales = self._scales
        if exclude:
            keep = [k for k, n in enumerate(names) if n not in exclude]
            pool = [pool[k] for k in keep]
            names = [names[k] for k in keep]
            scales = [scales[k] for k in keep]
        assert pool, "empty pool"
        # delta scaled to the market's price level (paper's [1e-5, 0.2]
        # interval assumes sub-dollar instances — see revpred.py).  One array
        # draw: a numpy Generator fills arrays element-wise from the same
        # stream, so this consumes identical draws to the legacy
        # one-uniform-per-candidate loop (excluded markets draw nothing)
        deltas = self._deltas(len(pool))
        prices = self.market.pool_prices(t)
        return [(inst, prices[n] + d * s)
                for inst, n, d, s in zip(pool, names, deltas, scales)]

    def choose(self, t: float, trial: TrialSpec, cands, ps) -> Choice:
        """Eq. 2 argmin over drawn candidates and their p(revoke) answers."""
        perf_get = self.perf.get
        avgs = self.market.pool_avgs(t)
        best = best_key = None
        for (inst, max_price), p in zip(cands, ps):
            p = float(p)
            if p < 0.0:
                p = 0.0
            elif p > 1.0:
                p = 1.0
            m = perf_get(inst, trial)
            avg = avgs[inst.name]
            s_cost = m * (1.0 - p) * avg / HOUR
            # tie-break expected-free candidates (p -> 1 zeroes Eq. 2) by the
            # downside cost — what a step costs if the refund never arrives
            # (e.g. the trial finishes inside the hour)
            key = (s_cost, m * avg)
            if best_key is None or key < best_key:
                best, best_key = (inst, max_price, p, s_cost), key
        return Choice(*best)

    def fused_supported(self) -> bool:
        """True when the predictor answers per-candidate p(revoke) from
        local state (constant or oracle), so ``best_fused`` applies."""
        return (getattr(self.revpred, "CONST_P", None) is not None
                or getattr(self.revpred, "pool_label_fm", None) is not None)

    def best_fused(self, t: float, trial: TrialSpec,
                   exclude: Optional[set] = None) -> Choice:
        """getBestInst with the candidate draw, revocation labels, and the
        Eq.-2 argmin fused into one pool loop — bit-identical floats and RNG
        consumption to ``choose(t, trial, cands, predict_pool_pairs(cands,
        t))`` over ``candidates(t, trial, exclude)``, with no intermediate
        candidate/response lists.  Only valid when ``fused_supported()``."""
        market = self.market
        pool = market.pool
        names = self._names
        rp = self.revpred
        const_p = getattr(rp, "CONST_P", None)
        fms = None if const_p is not None else rp.pool_fm_rows()
        minute, prices, avgs = market.pool_price_rows(t)
        scales = self._scales
        priors = self._priors
        idxs = range(len(pool))
        if exclude:
            idxs = [k for k in idxs if names[k] not in exclude]
            assert idxs, "empty pool"
        deltas = self._deltas(len(idxs))
        perf_m = self.perf._m
        tkey = trial.key
        best = best_key = None
        for k, d in zip(idxs, deltas):
            mp = prices[k] + d * scales[k]
            if const_p is not None:
                p = const_p
            else:
                fml, L = fms[k]
                if minute < L:
                    p = 1.0 if fml[minute] > mp else 0.0
                else:
                    p = rp.predict(pool[k], t, mp)
                    if p < 0.0:
                        p = 0.0
                    elif p > 1.0:
                        p = 1.0
            m = perf_m.get((names[k], tkey))
            if m is None:
                m = priors[k]
            avg = avgs[k]
            s_cost = m * (1.0 - p) * avg / HOUR
            key = (s_cost, m * avg)
            if best_key is None or key < best_key:
                best, best_key = (pool[k], mp, p, s_cost), key
        return Choice(*best)

    def predict_candidates(self, t: float, cands) -> list:
        """p(revoke) per candidate — pool-batched when the predictor can."""
        predict_pool = getattr(self.revpred, "predict_pool", None)
        if predict_pool is not None:
            return predict_pool([inst for inst, _ in cands], t,
                                [mp for _, mp in cands])
        return [self.revpred.predict(inst, t, mp) for inst, mp in cands]

    def best_instance(self, t: float, trial: TrialSpec,
                      exclude: Optional[set] = None) -> Choice:
        """Algorithm 1 getBestInst: argmin over the pool of Eq. 2.

        The RevPred forward is batched over the whole pool in one dispatch
        when the predictor supports it."""
        cands = self.candidates(t, trial, exclude)
        return self.choose(t, trial, cands, self.predict_candidates(t, cands))


def best_fused_multi(jobs: list, acquire: bool = False):
    """One vectorized Eq.-2 solve over many deploys — possibly spanning many
    replicas' provisioners — in engine order.

    ``jobs`` is ``[(prov, t, trial_spec), ...]``; the return is the aligned
    ``Choice`` list, bit-identical (floats and RNG consumption) to calling
    ``prov.best_fused(t, spec)`` per job in order:

      * each job's bid deltas are dispensed from its provisioner's block
        buffer in job order — per provisioner that is the exact scalar draw
        sequence, and streams never cross provisioners;
      * the Eq.-2 expression keeps the scalar associativity elementwise
        (``m * (1.0 - p) * avg / HOUR``), and the lexicographic
        ``(s_cost, m*avg)`` argmin resolves full ties to the first pool
        index, like the scalar strict-``<`` scan;
      * oracle labels are the same strict ``fm > max_price`` comparison;
        minutes past a pool member's trace fall back to the scalar
        ``rp.predict`` path per element.

    Only valid for ``fused_supported()`` provisioners and jobs without
    exclusions (callers route excluded trials through ``best_fused``).
    Mixed pool sizes drop to the scalar loop — equally exact, just unfused.

    With ``acquire=True`` the winning bids are answered immediately against
    each market's ledger via :func:`acquire_batch_multi` — one segmented
    crossing search per shared ``(trace, minute)`` group — and the return
    becomes ``(choices, [(row, t_revoke), ...])``, both aligned with
    ``jobs``.
    """
    out = _fused_choices(jobs)
    if not acquire:
        return out
    rows = acquire_batch_multi([(prov.market, c.inst, c.max_price, t)
                                for (prov, t, spec), c in zip(jobs, out)])
    return out, rows


def _fused_choices(jobs: list) -> list:
    n = len(jobs)
    if n < 4:
        return [prov.best_fused(t, spec) for prov, t, spec in jobs]
    ctxs: dict = {}          # (id(prov), minute) -> per-pool context arrays
    ctx_list: list = []
    ctx_of = np.empty(n, np.int64)
    drows: list = []
    for j, (prov, t, spec) in enumerate(jobs):
        minute, prices, avgs = prov.market.pool_price_rows(t)
        key = (id(prov), minute)
        ctx = ctxs.get(key)
        if ctx is None:
            rp = prov.revpred
            const_p = getattr(rp, "CONST_P", None)
            if const_p is None:
                fm_minute = getattr(rp, "pool_fm_minute", None)
                if fm_minute is not None:
                    fmv = fm_minute(minute)
                else:
                    fmv = np.array([fml[minute] if minute < L else np.nan
                                    for fml, L in rp.pool_fm_rows()])
            else:
                fmv = np.full(len(prices), np.nan)
            ctx = ctxs[key] = (len(ctx_list), np.asarray(prices),
                               np.asarray(avgs), prov._scales_arr,
                               prov._priors, fmv,
                               np.nan if const_p is None else const_p,
                               prov.market.pool, prov._names)
            ctx_list.append(ctx)
        ctx_of[j] = ctx[0]
        drows.append(prov._deltas_arr(len(ctx[1])))
    if len({len(c[1]) for c in ctx_list}) != 1:
        # ragged pools cannot stack; the deltas are already consumed in the
        # scalar per-job order, so the scalar finish stays bit-exact
        return _solve_rows_scalar(jobs, ctx_list, ctx_of, drows)
    ci = ctx_of
    PRICES = np.stack([c[1] for c in ctx_list])[ci]
    AVGS = np.stack([c[2] for c in ctx_list])[ci]
    SCALES = np.stack([c[3] for c in ctx_list])[ci]
    FMV = np.stack([c[5] for c in ctx_list])[ci]
    CONST = np.array([c[6] for c in ctx_list])[ci]
    D = np.stack(drows)
    MP = PRICES + D * SCALES
    is_const = ~np.isnan(CONST)
    P_rev = np.where(is_const[:, None], CONST[:, None],
                     (FMV > MP).astype(np.float64))
    fb = (~is_const)[:, None] & np.isnan(FMV)
    if fb.any():
        for j, k in zip(*np.nonzero(fb)):
            prov, t, spec = jobs[j]
            ctx = ctx_list[ci[j]]
            p = prov.revpred.predict(ctx[7][k], t, float(MP[j, k]))
            P_rev[j, k] = 0.0 if p < 0.0 else (1.0 if p > 1.0 else p)
    M = np.empty_like(MP)
    for j, (prov, t, spec) in enumerate(jobs):
        ctx = ctx_list[ci[j]]
        pm = prov.perf._m
        tk = spec.key
        priors = ctx[4]
        M[j] = [priors[k] if v is None else v
                for k, v in enumerate(pm.get((nm, tk))
                                      for nm in ctx[8])]
    S = M * (1.0 - P_rev) * AVGS / HOUR
    K2 = M * AVGS
    smin = S.min(axis=1)
    tie = S == smin[:, None]
    k2m = np.where(tie, K2, np.inf)
    win = tie & (k2m == k2m.min(axis=1)[:, None])
    kb = win.argmax(axis=1)
    out = []
    for j in range(n):
        k = int(kb[j])
        ctx = ctx_list[ci[j]]
        out.append(Choice(ctx[7][k], float(MP[j, k]), float(P_rev[j, k]),
                          float(S[j, k])))
    return out


def _solve_rows_scalar(jobs, ctx_list, ctx_of, drows) -> list:
    """Ragged-pool fallback: finish each pre-drawn job with the scalar
    fused expression (same floats, deltas already consumed in order)."""
    out = []
    for j, (prov, t, spec) in enumerate(jobs):
        _, prices, avgs, scales, priors, fmv, const_p, pool, names = \
            ctx_list[ctx_of[j]]
        pm = prov.perf._m
        tk = spec.key
        best = best_key = None
        for k, d in enumerate(drows[j]):
            mp = float(prices[k] + d * scales[k])
            if not np.isnan(const_p):
                p = float(const_p)
            elif not np.isnan(fmv[k]):
                p = 1.0 if fmv[k] > mp else 0.0
            else:
                p = prov.revpred.predict(pool[k], t, mp)
                p = 0.0 if p < 0.0 else (1.0 if p > 1.0 else p)
            m = pm.get((names[k], tk))
            if m is None:
                m = priors[k]
            avg = float(avgs[k])
            s_cost = m * (1.0 - p) * avg / HOUR
            key = (s_cost, m * avg)
            if best_key is None or key < best_key:
                best, best_key = (pool[k], mp, p, s_cost), key
        out.append(Choice(*best))
    return out


class ZeroRevPred:
    """p ≡ 0: degenerates Eq. 2 to pure (speed × price) — the paper's §V-A
    stable-market scenario, and an ablation baseline."""

    CONST_P = 0.0       # enables the provisioner's fused deploy loop

    def predict(self, inst, t, max_price) -> float:
        return 0.0

    def predict_pool_pairs(self, cands, t) -> list:
        return [0.0] * len(cands)
