"""Market contention: aggregate tenant demand moves the spot price process.

The core ``SpotMarket`` is a price-taker — its OU traces are exogenous and
frozen, which is the paper's single-tenant assumption.  Under many
concurrent studies that assumption breaks: every acquisition is demand,
and demand raises prices (and with them revocation pressure, since
revocations are price crossings of the bid).  ``MarketEnv`` is the shared
demand state; ``SharedSpotMarket`` is a ``SpotMarket`` whose acquisitions
record demand impulses into it and whose traces absorb everyone else's.

Contention model (kept deliberately close to the existing trace
machinery):

* each acquisition in pool *p* at simulated minute *m* records an impulse
  of amplitude ``impact * price_p[m]`` — absolute dollars proportional to
  the current price, so bigger slices (pricier instances) push harder;
* the impulse lands on minutes ``m+1 .. m+window`` of *every* tenant's
  private copy of trace *p*, decaying geometrically as ``(1-theta)^k``
  with ``theta = 0.05`` — the same per-minute mean-reversion rate the OU
  synthesizer uses (``synth_traces_batch``), so a demand shock relaxes
  exactly like a natural price shock;
* prices clip at ``2 * od_price``, the synthesizer's own ceiling;
* application is *lazy*: a market calls ``sync()`` when its study is about
  to step, replaying all impulses recorded since its last sync in global
  event order.  The service loop always steps the admitted study with the
  earliest simulated boundary, so impulses only ever land on minutes at or
  ahead of every other study's clock — already-consumed history never
  changes retroactively.

Determinism and the identity-keyed caches: traces are mutated *in place*
(private, writable copies — never the shared frozen memo arrays), which
preserves array identity, so the derived prefix/blockmax/pricelist indices
are dropped explicitly via ``invalidate_trace_indices`` and the per-market
minute memos reset.  ``avg_price`` is overridden to bypass the global
``_AVG_CACHE`` (also identity-validated) and read the live prefix sums
directly — same arithmetic, no staleness.

Deliberate modeling boundaries (documented, deterministic):

* an allocation's revocation time is fixed at acquire against the trace
  *as then synced* — a later demand spike does not retroactively tighten
  an existing contract, though billing integrals at release do read the
  contended prices;
* revocation predictors observe the process as first seen (their
  future-max indices key by trace identity too) — under contention the
  oracle becomes an imperfect forecaster, which is the realistic regime.

With ``impact = 0`` (or one tenant and contention disabled) every trace
stays byte-identical to the frozen single-tenant synthesis —
``compare_service_modes`` pins that degenerate case bit-exact.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.market import (DEFAULT_POOL, HOUR, MINUTE,
                                     InstanceType, SpotMarket,
                                     invalidate_trace_indices, synth_trace)


class MarketEnv:
    """Shared demand state: one logical spot market all tenants contend in.

    Holds the global, append-only impulse log; each ``SharedSpotMarket``
    keeps a cursor into it and applies the tail on ``sync()``."""

    def __init__(self, impact: float = 0.04, theta: float = 0.05,
                 window_min: int = 180):
        if impact < 0:
            raise ValueError(f"impact must be >= 0, got {impact}")
        self.impact = float(impact)
        self.theta = float(theta)
        self.window_min = int(window_min)
        decay = (1.0 - self.theta) ** np.arange(self.window_min,
                                                dtype=np.float64)
        decay.flags.writeable = False
        self.decay = decay
        # (pool name, minute, amplitude $) in global acquisition order
        self.events: List[Tuple[str, int, float]] = []

    def record(self, name: str, minute: int, price: float) -> None:
        amp = self.impact * float(price)
        if amp > 0.0:
            self.events.append((name, int(minute), amp))


class SharedSpotMarket(SpotMarket):
    """A tenant-visible market over the shared ``MarketEnv``.

    Each instance owns private *writable* copies of the seed traces (the
    frozen memo arrays must never be mutated — every single-tenant market
    of the same seed aliases them), records its own acquisitions as demand
    impulses, and absorbs everyone's impulses on ``sync()``."""

    def __init__(self, env: MarketEnv,
                 pool: Optional[List[InstanceType]] = None, days: float = 12.0,
                 seed: int = 0, ledger: Optional[str] = None, **kwargs):
        pool = list(pool or DEFAULT_POOL)
        minutes = int(days * 1440)
        traces = {i.name: np.array(synth_trace(i, minutes, seed))
                  for i in pool}
        super().__init__(pool=pool, days=days, seed=seed, traces=traces,
                         ledger=ledger, **kwargs)
        self.env = env
        self._cursor = 0
        self._cap = {i.name: 2.0 * i.od_price for i in pool}

    # every acquire path (scalar/columnar acquire_row, the batched burst)
    # funnels through this hook
    def _note_demand(self, inst: InstanceType, t: float) -> None:
        tr = self.traces[inst.name]
        m = min(int(t / MINUTE), len(tr) - 1)
        self.env.record(inst.name, m, float(tr[m]))

    def sync(self) -> int:
        """Apply all impulses recorded since the last sync; returns how
        many were applied.  Safe to call at any time — impulses only touch
        minutes strictly after their emission minute, and the service loop
        orders steps by the global virtual clock."""
        ev = self.env.events
        n = len(ev)
        if self._cursor >= n:
            return 0
        decay = self.env.decay
        W = self.env.window_min
        touched = set()
        for name, minute, amp in ev[self._cursor:]:
            tr = self.traces.get(name)
            if tr is None:
                continue
            j0 = minute + 1
            if j0 >= len(tr):
                continue
            j1 = min(len(tr), j0 + W)
            # accumulate in float64, clip at the synthesizer's ceiling,
            # store back in the trace dtype (float32)
            seg = tr[j0:j1].astype(np.float64)
            seg += amp * decay[: j1 - j0]
            np.minimum(seg, self._cap[name], out=seg)
            tr[j0:j1] = seg.astype(tr.dtype)
            touched.add(name)
        applied = n - self._cursor
        self._cursor = n
        if touched:
            for name in touched:
                invalidate_trace_indices(self.traces[name])
            self._pool_price_memo = None
            self._pool_avg_memo = None
            self._pool_rows_memo = None
        return applied

    def avg_price(self, inst: InstanceType, t: float,
                  window_s: float = HOUR) -> float:
        """Trailing-window mean over the *contended* trace.  The base
        implementation memoizes in the global ``_AVG_CACHE`` keyed by trace
        identity — in-place mutation would silently serve pre-impulse
        windows there while ``pool_avgs`` (minute memos, reset on sync)
        reads post-impulse ones.  Same arithmetic, read straight through
        the (invalidation-refreshed) prefix sums."""
        tr = self.traces[inst.name]
        hi = min(int(t / MINUTE), len(tr) - 1) + 1
        lo = max(0, hi - int(window_s / MINUTE))
        P = self._price_prefix(inst.name)
        return (P[hi] - P[lo]) / (hi - lo)
