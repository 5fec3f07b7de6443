"""Structure-of-arrays sweep stepper: lockstep boundary advance over replicas.

``SoaSweep`` drives many replicas' ``ExecutionEngine``s without their
per-replica generator loops: every round each active replica jumps to its own
next lifecycle boundary, and the per-boundary math the engines would do one
trial at a time — the ``_advance_window`` steps/EWMA/crossing fold and the
``_next_tick`` boundary candidates — runs once, vectorized across every
(replica, trial) row touched this round.  Python is re-entered only for the
rare policy work: event dispatch, the lifecycle condition chain, deploy
choices (batched cross-replica through one ``predict_pool_multi`` forward,
like the generator path), and scheduler idle rounds (parked and flushed as
one grouped LM solve).

State layout: one flat row per (replica, trial), replica-major, each replica
holding a capacity-padded contiguous segment in trial activation order.  The
only *persistent* hot array is ``next_k`` — the per-row next boundary tick,
``_BIG`` for rows not running — which replaces every engine's boundary heap;
the per-replica "next boundary" scan is a segmented ``np.minimum.reduceat``
over it.  Everything else is gathered fresh from the authoritative
``TrialState`` objects for the rows actually touched in a round, so there is
no second copy of simulation state to keep coherent.

The EWMA fold and the segmented min run through
``repro_torch.kernels.soa_step``, and ``device`` decides how.  On the card
(``fuse_rounds``) a round whose touched replicas are all on the table path
parks its fold and runs it with the round-end boundary min in one launch of
the fused CUDA kernel; the rows of replicas that deploy this round fold
first, through the kernel's fold-only entry point, since their deploy
solves read the perf matrix (the JAX package's Pallas path folded every row
early then, which at 1000 replicas is nearly every round).  Other rounds
run the fold-only entry point.
The sweep's state stays numpy on the host: each launch copies its inputs to
the card and its outputs back.  On the CPU the stepper follows the JAX
package's default path exactly: no deferral, ``ewma_fold_sorted`` and
``np.minimum.reduceat``.  Every path is bit-exact to the sequential fold.

The round's lifecycle work is batched too (``_lifecycle``): every touched
row's event is classified in one vectorized pass (``classify_rows`` — the
five condition-chain branches as masks), schedulers that declare a
``decision_table`` (see ``repro_torch.tuner.scheduler``) answer the whole event
batch in one call, and the state transitions are applied column-wise with
Python re-entered only for the rows that actually act.  Schedulers without
a table — and replicas whose backend snapshots real state — keep the
verbatim scalar chain (``_chain``), pinning that path's coverage in the
equivalence cube.  Deploy solves across every fused-supported replica
sharing a round collapse into one vectorized Eq.-2 pass
(``best_fused_multi``), per-replica RNG draws preserved in engine order.

The per-replica engine remains the reference implementation: the port's
sweep tests hold this stepper and the generator path (``"batched"``) to the
JAX package's, replica for replica (billing records, finish times, metric
histories, event logs), and ``SweepRunner`` falls back to the generator
path for the features the stepper does not cover (exact ticks, straggler
mode, training backends).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.market import HOUR
from repro_torch.core.provisioner import best_fused_multi
from repro_torch.core.trial import SimTrialBackend, _jitter_entry
from repro_torch.device import resolve_device
from repro_torch.kernels.soa_step import (ewma_fold, ewma_fold_sorted,
                                          segmented_min, soa_step_fused)
from repro_torch.sweep.runner import SweepRunner
from repro_torch.tuner.engine import (ProvisionBatch, Status,
                                preview_boundary_batch)
from repro_torch.tuner.events import (HourRotation, MetricReported, RevocationNotice,
                                TrialFinished, TrialRevoked)
from repro_torch.tuner.scheduler import DecisionKind
from repro_torch.tuner.tuner import FitRequest, Tuner

_BIG = np.int64(1) << np.int64(60)
# below this many touched rows the columnwise EWMA fold loses to the plain
# per-row sequential fold (both are bit-exact, so the switch is free)
_FOLD_MIN_ROWS = 8


def classify_rows(t: np.ndarray, t_revoke: np.ndarray,
                  notice_handled: np.ndarray, notice_s: np.ndarray,
                  steps: np.ndarray, target: np.ndarray, stopped: np.ndarray,
                  pause_requested: np.ndarray,
                  t_start: np.ndarray) -> tuple:
    """Vectorized lifecycle classification of touched rows — the engine
    condition chain's five branches as one mask pass.

    Returns ``(notice_due, cls)``: ``notice_due`` marks rows whose
    revocation notice fires this tick (independent of the terminal event),
    and ``cls`` is the first chain branch that acts — 1 revoke, 2 finish
    (target reached or stopped), 3 scheduler pause, 4 one-hour rotation,
    0 none — assigned in reverse branch order so the scalar chain's
    priority (revoke > finish > pause > rotate) wins element-wise.
    ``t_revoke`` uses +inf for allocations without a scheduled revocation.
    Pure (arrays in, arrays out): the property test pins it against a
    row-at-a-time replay of the chain's branch conditions."""
    has_rev = np.isfinite(t_revoke)
    # notice boundary clamped to the allocation start (over-price acquires
    # bump t_revoke to t_start + 60s; unclamped, the notice would predate
    # the allocation).  For touched rows t >= t_start always holds, so the
    # clamp never changes which rows fire — only the scheduled boundary.
    notice_due = has_rev & ~notice_handled \
        & (t >= np.maximum(t_start, t_revoke - notice_s))
    cls = np.zeros(len(t), np.int8)
    cls[(t - t_start) >= HOUR] = 4
    cls[pause_requested] = 3
    cls[(steps >= target) | stopped] = 2
    cls[has_rev & (t >= t_revoke)] = 1
    return notice_due, cls


def soa_supported(tuners: Sequence[Tuner]) -> bool:
    """Whether every replica fits the stepper's fast-path assumptions."""
    for t in tuners:
        cfg = t.engine.cfg
        if cfg.exact_ticks or cfg.straggler_factor > 1.0:
            return False
        if not hasattr(t.engine.backend, "noisy_step_times"):
            return False
        # training backends mutate real runs per advance; keep them on the
        # sequentially-interleaved generator path
        if getattr(t.engine.backend, "kind", "sim") != "sim":
            return False
    return True


class SoaSweep:
    """Executes many Tuner replicas in lockstep SoA rounds; results land in
    each ``tuner.result`` exactly as ``run_cooperative`` would leave them."""

    def __init__(self, tuners: Sequence[Tuner], use_tables: bool = True,
                 batch_preview: bool = True, device="cuda"):
        self.tuners = list(tuners)
        self.device = resolve_device(device)
        # fold (and, in deferred rounds, the boundary min) through the
        # kernel on the card; on the CPU the JAX package's default numpy
        # path.  Setting it on a CPU sweep runs the deferred branch through
        # the kernels' plain PyTorch versions
        self.fuse_rounds = self.device.type == "cuda"
        # batch the post-deploy _preview_boundary recompute across the burst
        # (one searchsorted pair for the whole burst instead of two per row);
        # False pins the scalar per-row loop — the bit-exactness test's lever
        self.batch_preview = batch_preview
        self.engines = [t.engine for t in self.tuners]
        self._rep_of = {id(e): r for r, e in enumerate(self.engines)}
        # batched-lifecycle gate per replica: the scheduler must declare a
        # decision table and the backend must not snapshot real state (the
        # classifier's rollback arithmetic assumes the sim's free snapshot);
        # ``use_tables=False`` pins every replica to the scalar chain (the
        # table-vs-scalar contract test's lever)
        self.use_tables = use_tables
        self._table_rep = np.array(
            [use_tables and e._has_table and not e._backend_snapshots
             for e in self.engines], bool)
        # jitter observations can be sliced straight from the shared cache
        # only when every backend's noisy_step_times is the sim's own
        self._direct_noise = all(
            type(e.backend).noisy_step_times
            is SimTrialBackend.noisy_step_times for e in self.engines)
        self._seg5: Optional[np.ndarray] = None   # stage-5 boundary scan memo
        self._pending_fold: Optional[tuple] = None
        self._defer_fold = False
        R = len(self.tuners)
        self.R = R
        self.t = np.zeros(R)
        self.t_next = np.zeros(R)
        self.tick = np.array([e.cfg.tick_s for e in self.engines])
        self.k_now = np.zeros(R, np.int64)
        self.max_sim = np.array([e.cfg.max_sim_s for e in self.engines])
        self.notice_arr = np.array([e.cfg.notice_s for e in self.engines])
        self.horizon = np.array([e.market.horizon_s() for e in self.engines])
        self.k_guard = np.array(
            [min(math.floor(e.cfg.max_sim_s / e.cfg.tick_s) + 1,
                 math.ceil((e.market.horizon_s() - HOUR) / e.cfg.tick_s))
             for e in self.engines], np.int64)
        self.has_preview = np.array([e._has_preview for e in self.engines])
        # replica lifecycle: engine-active mask, parked idle generators, done
        self.active = np.ones(R, bool)
        self.parked: Dict[int, tuple] = {}     # rep -> (gen, FitRequest)
        self.done = np.zeros(R, bool)
        self.has_waiting = np.zeros(R, bool)
        self.waiting: List[list] = [[] for _ in range(R)]
        self.flush_reps: set = set()
        self.pending_reps: set = set()
        self.rebuild: set = set(range(R))
        self._round_no = 0
        # row arrays built by _rebuild_all
        self.rows: List[Optional[object]] = []
        self.rep_start = np.zeros(R, np.int64)
        self.rep_cap = np.zeros(R, np.int64)
        self.row_rep = np.zeros(0, np.int64)
        self.next_k = np.zeros(0, np.int64)
        self._rebuild_all()

    # -------------------------------------------------------- row segments
    def _rebuild_all(self) -> None:
        """(Re)allocate every replica's row segment (capacity-doubled)."""
        self._seg5 = None
        caps = []
        for r, eng in enumerate(self.engines):
            caps.append(max(8, 2 * len(eng._active)))
        self.rep_cap = np.array(caps, np.int64)
        self.rep_start = np.concatenate(([0], np.cumsum(self.rep_cap[:-1])))
        n = int(self.rep_cap.sum())
        self.rows = [None] * n
        self.row_rep = np.repeat(np.arange(self.R, dtype=np.int64),
                                 self.rep_cap)
        self.next_k = np.full(n, _BIG, np.int64)
        # immutable per-row fact (spec.workload.val_every), mirrored to spare
        # the triple attribute dereference per touched row per round
        self.row_ve = np.ones(n, np.int64)
        for r in range(self.R):
            self._rebuild_rep(r, grow=False)
        self.rebuild.clear()

    def _rebuild_rep(self, r: int, grow: bool = True) -> None:
        """Refresh replica ``r``'s segment from its engine's ``_active`` list
        (activation order — the order every per-tick scan and deploy uses)."""
        eng = self.engines[r]
        if grow and len(eng._active) > self.rep_cap[r]:
            self._rebuild_all()       # capacity exceeded: rare, full rebuild
            return
        self._seg5 = None             # segment refresh moves next_k rows
        base = int(self.rep_start[r])
        cap = int(self.rep_cap[r])
        self.next_k[base:base + cap] = _BIG
        self.rows[base:base + cap] = [None] * cap
        waiting = []
        for i, st in enumerate(eng._active):
            self.rows[base + i] = st
            st._soa_row = base + i
            self.row_ve[base + i] = st.spec.workload.val_every
            if st.status is Status.RUNNING:
                self.next_k[base + i] = st._next_k
            elif st.status is Status.WAITING:
                waiting.append(st)
        self.waiting[r] = waiting
        self.has_waiting[r] = bool(waiting)

    # ------------------------------------------------------------ main loop
    def run(self) -> None:
        while self.step():
            pass

    def step(self, allowed: Optional[Sequence[int]] = None) -> bool:
        """One unit of sweep progress: advance one SoA round over the active
        replicas (restricted to ``allowed`` replica indices when given — the
        tuning service's admission gate), or, with no engine work left
        anywhere, flush the parked idle-fit generators.  Returns True while
        any replica remains unfinished, so ``run()`` is ``while self.step():
        pass`` and a service loop interleaves many sweeps round by round."""
        act = np.nonzero(self.active)[0]
        if allowed is not None and len(act):
            gate = np.zeros(self.R, bool)
            idx = np.asarray(list(allowed), np.int64)
            if len(idx):
                gate[idx] = True
            act = act[gate[act]]
        if len(act):
            self._round(act)
        elif self.parked:
            self._flush_fits()
        return bool(self.active.any() or self.parked)

    def next_time(self) -> float:
        """Earliest upcoming boundary among active replicas (+inf when only
        parked idle fits or nothing remain) — the service loop's global
        ordering key for picking which study steps next."""
        act = np.nonzero(self.active)[0]
        if not len(act):
            return math.inf
        return float(self.t_next[act].min())

    def _round(self, act: np.ndarray) -> None:
        self._round_no += 1
        if self.rebuild:
            for r in list(self.rebuild):
                self._rebuild_rep(r)
            self.rebuild.clear()
        # 1. every active replica jumps to its own next boundary
        self.t[act] = self.t_next[act]
        self.k_now[act] = np.round(self.t[act] / self.tick[act]).astype(
            np.int64)
        seg_min = self._seg5      # stage 5's scan, still valid when nothing
        if seg_min is None:       # touched next_k since (rebuilds invalidate)
            seg_min = segmented_min(self.next_k, self.rep_start)
        self._seg5 = None
        runnable = (seg_min < _BIG) | self.has_waiting
        # idle replicas first (the engine returns before its horizon check)
        idle = act[~runnable[act]]
        for r in idle:
            self.active[r] = False
            self._enter_idle(int(r))
        act = act[runnable[act]]
        if not len(act):
            return
        # horizon guard, exactly where the engine raises it
        if np.any((self.t[act] > self.max_sim[act])
                  | (self.t[act] >= self.horizon[act] - HOUR)):
            raise RuntimeError("simulation horizon exhausted")
        act_mask = np.zeros(self.R, bool)
        act_mask[act] = True
        # 2. touched rows: running rows at their boundary this round
        k_now_rows = self.k_now[self.row_rep]
        touched = np.nonzero(act_mask[self.row_rep]
                             & (self.next_k <= k_now_rows))[0]
        # fused rounds defer the fold into the stage-5 kernel launch, but
        # only when every touched replica is on the table path (decision
        # tables never read the perf matrix; the scalar chain's dispatches
        # may)
        self._defer_fold = bool(
            len(touched) and self.fuse_rounds
            and self._table_rep[self.row_rep[touched]].all())
        new_points, sts = self._advance_rows(touched)
        self._lifecycle(touched, new_points, sts)
        # 3. deploys (batched across replicas like the generator path); a
        # deferred fold must land first for the replicas about to deploy —
        # the Eq.-2 solve reads their matrices (each replica has its own);
        # the other replicas' rows stay parked for the stage-5 launch
        if self._pending_fold is not None and self.has_waiting[act].any():
            self._flush_fold(self.has_waiting)
        deployed = self._deploys(act)
        # 4. boundary recompute for rows still/newly running
        recompute = [int(i) for i in touched
                     if self.rows[i].status is Status.RUNNING]
        seen = set(recompute)
        recompute += [i for i in deployed if i not in seen]
        self._recompute(recompute)
        # 5. next boundary per replica (the heap-pop equivalent); with a
        # fold still parked, one fused kernel launch does both halves
        if self._pending_fold is not None:
            pad, lens, m0, first, ew, perfs, keys, _ = self._pending_fold
            self._pending_fold = None
            m, seg_min = soa_step_fused(pad, lens, m0, first, ew,
                                        self.next_k, self.row_rep, self.R,
                                        device=self.device)
            self._scatter_fold(m, perfs, keys, first)
        else:
            seg_min = segmented_min(self.next_k, self.rep_start)
        self._seg5 = seg_min
        km = seg_min[act]
        kn = self.k_now[act]
        k = np.where(km >= _BIG, kn + 1, km)
        for j, r in enumerate(act):
            r = int(r)
            eng = self.engines[r]
            if r in self.pending_reps:
                # a trial turned WAITING mid-tick (async promotion): deploy
                # next tick, exactly like the legacy loop
                self.pending_reps.discard(r)
                eng._pending_deploy = False
                k[j] = kn[j] + 1
            elif r in self.flush_reps:
                f = eng._flush_k
                if f is None:
                    self.flush_reps.discard(r)
                elif km[j] >= _BIG or f < k[j]:
                    # mirror _next_tick: with nothing running, jump straight
                    # to the armed flush tick; otherwise flush caps the jump
                    k[j] = f if f > kn[j] else kn[j] + 1
        kg = self.k_guard[act]
        over = k > kg
        if np.any(over):
            k = np.where(over, np.where(kg > kn, kg, kn + 1), k)
        self.t_next[act] = k * self.tick[act]

    # ------------------------------------------------------------- advance
    def _advance_rows(self, touched: np.ndarray) -> tuple:
        """Vectorized ``_advance_window`` over all touched rows: one fused
        steps update, one batched EWMA fold over the deterministic noise
        draws, the same metric-crossing scan.  Mutates the TrialStates
        exactly as the per-trial method would; returns ``(points, sts)`` —
        each row's new-points-for-dispatch list and the gathered states
        (reused by ``_lifecycle``)."""
        n = len(touched)
        out: List = [()] * n      # shared empty sentinel; rows with crossings
        if not n:                 # get their own point list below
            return out, []
        sts = [self.rows[i] for i in touched]
        reps = self.row_rep[touched]
        t = self.t[reps]
        tick = self.tick[reps]
        # one pass over the TrialStates for all five gathered fields
        last_t, ready, steps0, target, spt = (np.array(col) for col in zip(
            *[(st._last_t, st.ready_at, st.steps, st.target_steps, st._spt)
              for st in sts]))
        start = np.where(ready > last_t, ready, last_t)
        k0 = np.floor(start / tick).astype(np.int64) + 1
        k1 = np.round(t / tick).astype(np.int64)
        live = k1 >= k0
        # sync engine clocks for every replica represented this round (the
        # chain/deploy helpers and event timestamps read engine.t)
        engines = self.engines
        t_list = t.tolist()
        reps_list = reps.tolist()
        round_no = self._round_no
        for j in range(n):
            eng = engines[reps_list[j]]
            tj = t_list[j]
            if eng.t != tj:
                eng.t = tj
            st = sts[j]
            st._last_t = tj
            # marks "was RUNNING in this tick's runnable snapshot" — an
            # async promotion landing later this round deploys same-tick
            # only for snapshot members (see _note_promotions)
            st._soa_round = round_no
        steps_new = np.where(
            live, np.minimum(steps0 + (t - start) / spt, target), steps0)
        lidx = np.nonzero(live)[0]
        if len(lidx):
            self._fold_perf(sts, reps, lidx, k0, k1, tick, spt,
                            defer=self._defer_fold)
        # steps as of the previous tick — what an every-tick scan had seen
        lim = (k1 - 1) * tick
        s_prev = np.where(lim <= start, steps0,
                          np.minimum(steps0 + (lim - start) / spt, target))
        ve = self.row_ve[touched]
        nv = np.array([st._next_val for st in sts], np.int64)
        crossing = live & ((nv + 1) * ve <= steps_new)
        steps_list = steps_new.tolist()
        for j in lidx:
            st = sts[j]
            st.steps = steps_list[j]
            if not crossing[j]:
                continue
            # metric points crossed: the same int-comparison walk the
            # per-tick scan does, but the curve values fetched as one
            # metric_range slice (bit-identical list entries) — the float
            # floor-division seed is corrected against the engine's exact
            # ``(k+1)*val_every <= steps`` predicate
            e = int(ve[j])
            lo = int(nv[j])
            hi = int(st.steps // e)
            while hi * e > st.steps:
                hi -= 1
            while (hi + 1) * e <= st.steps:
                hi += 1
            if hi <= lo:
                continue
            vals = self.engines[reps_list[j]].backend.metric_range(
                st.spec, lo + 1, hi)
            new_steps = [k * e for k in range(lo + 1, hi + 1)]
            st._next_val = hi
            st.metrics_steps.extend(new_steps)
            st.metrics_vals.extend(vals)
            sp = s_prev[j]
            out[j] = [(s, v) for s, v in zip(new_steps, vals) if s > sp]
        return out, sts

    def _fold_perf(self, sts, reps, lidx, k0, k1, tick, spt,
                   defer: bool = False) -> None:
        """Perf-matrix catch-up for the live rows: each row's jitter
        observations are sliced straight from the shared jitter cache into
        one padded matrix (the same float64 products ``noisy_step_times``
        returns, minus one array allocation per row), then folded
        columnwise — or, with ``defer`` (fused rounds), parked for one
        fused fold+boundary-scan kernel launch at round end.  Bit-exact
        replay of ``PerfModel.update_many`` per row either way."""
        n_live = len(lidx)
        engines = self.engines
        lidx_l = lidx.tolist()
        reps_l = reps.tolist()
        k0l, k1l = k0.tolist(), k1.tolist()
        tickl, sptl = tick.tolist(), spt.tolist()
        if n_live < _FOLD_MIN_ROWS:
            # narrow round: the columnwise fold loses to the sequential one
            for j in lidx_l:
                st = sts[j]
                eng = engines[reps_l[j]]
                eng.prov.perf.update_many(
                    st.a_inst, st.spec,
                    eng.backend.noisy_step_times(st.spec, st.a_inst,
                                                 k0l[j], k1l[j], tickl[j],
                                                 base=sptl[j]))
            return
        lens = np.empty(n_live, np.int64)
        for o, j in enumerate(lidx_l):
            lens[o] = k1l[j] - k0l[j] + 1
        pad = np.zeros((n_live, int(lens.max())))
        if self._direct_noise:
            # one jitter-cache entry per (workload seed, tick grid), sliced
            # and scaled directly into the pad rows
            ents: dict = {}
            for o, j in enumerate(lidx_l):
                st = sts[j]
                key = (st.spec.workload.seed, tickl[j])
                ent = ents.get(key)
                if ent is None or len(ent[1]) <= k1l[j]:
                    ent = ents[key] = _jitter_entry(key[0], key[1], k1l[j])
                np.multiply(ent[1][k0l[j]:k1l[j] + 1], sptl[j],
                            out=pad[o, :int(lens[o])])
        else:
            for o, j in enumerate(lidx_l):
                st = sts[j]
                v = engines[reps_l[j]].backend.noisy_step_times(
                    st.spec, st.a_inst, k0l[j], k1l[j], tickl[j],
                    base=sptl[j])
                pad[o, :len(v)] = v
        m0 = np.zeros(n_live)
        first = np.zeros(n_live, bool)
        ew = np.empty(n_live)
        keys, perfs = [], []
        for o, j in enumerate(lidx_l):
            st = sts[j]
            perf = engines[reps_l[j]].prov.perf
            key = (st.a_inst.name, st.key)
            keys.append(key)
            perfs.append(perf)
            v = perf._m.get(key)
            if v is not None and perf._observed.get(key):
                m0[o] = v
            else:
                first[o] = True
            ew[o] = perf.ewma
        if defer:
            self._pending_fold = (pad, lens, m0, first, ew, perfs, keys,
                                  reps[lidx])
            return
        self._scatter_fold(self._fold(pad, lens, m0, first, ew), perfs,
                           keys, first)

    def _fold(self, pad, lens, m0, first, ew) -> np.ndarray:
        """The fold alone: the kernel's fold-only entry point in fused
        mode, the numpy sorted fold otherwise (bit-exact either way)."""
        if self.fuse_rounds:
            return ewma_fold(pad, lens, m0, first, ew, device=self.device)
        return ewma_fold_sorted(pad, lens, m0, first, ew)

    def _flush_fold(self, deploying: np.ndarray) -> None:
        """Fold the parked rows of the ``deploying`` replicas now (their
        deploy solves are about to read their perf matrices); the rest stay
        parked for the round-end fused launch.  Every row folds once either
        way, from the same inputs, so the split changes no value."""
        pad, lens, m0, first, ew, perfs, keys, rrep = self._pending_fold
        now = deploying[rrep]
        if now.all():
            self._pending_fold = None
            self._scatter_fold(self._fold(pad, lens, m0, first, ew), perfs,
                               keys, first)
            return
        idx, rest = np.nonzero(now)[0], np.nonzero(~now)[0]
        if len(idx):
            self._scatter_fold(
                self._fold(pad[idx], lens[idx], m0[idx], first[idx], ew[idx]),
                [perfs[o] for o in idx], [keys[o] for o in idx], first[idx])
        self._pending_fold = (pad[rest], lens[rest], m0[rest], first[rest],
                              ew[rest], [perfs[o] for o in rest],
                              [keys[o] for o in rest], rrep[rest])

    @staticmethod
    def _scatter_fold(m, perfs, keys, first) -> None:
        for o in range(len(keys)):
            perfs[o]._m[keys[o]] = float(m[o])
            if first[o]:
                perfs[o]._observed[keys[o]] = True

    # ----------------------------------------------------- batched lifecycle
    def _lifecycle(self, touched: np.ndarray, new_points: list,
                   sts: list) -> None:
        """Batched lifecycle pass over the round's touched rows.

        Three phases, replica-grouped: (A) classify every row's chain branch
        in one vectorized ``classify_rows`` call and collect the events the
        scheduler cares about into decision-table *entries*; (B) one
        ``decision_table`` call per replica answers the whole batch, answers
        applied to the TrialStates (which can move a row across branches —
        a STOP answer turns a would-rotate row into a finish, exactly as the
        scalar dispatch would); (C) the state transitions for acting rows,
        applied per row in row order (notice before the terminal event) so
        each engine's event log interleaves exactly as the scalar chain's.
        Replicas outside the table gate — no ``decision_table``, snapshotting
        backend, or ``use_tables=False`` — run the verbatim scalar
        ``_chain`` instead, same order."""
        n = len(touched)
        if not n:
            return
        reps = self.row_rep[touched]
        t = self.t[reps]
        notice_s = self.notice_arr[reps]
        trev, nh, tstart, steps, target, stopped, pause = (
            np.array(c) for c in zip(
                *[(st.a_t_revoke,
                   st.notice_handled, st.a_t_start, st.steps,
                   st.target_steps, st.stopped, st.pause_requested)
                  for st in sts]))
        nh = nh.astype(bool)
        stopped = stopped.astype(bool)
        pause = pause.astype(bool)
        notice_due, cls = classify_rows(t, trev, nh, notice_s, steps, target,
                                        stopped, pause, tstart)
        bounds = np.nonzero(np.diff(reps))[0] + 1
        table_rep = self._table_rep
        for g in np.split(np.arange(n), bounds):
            j0 = int(g[0])
            r = int(reps[j0])
            eng = self.engines[r]
            if not table_rep[r]:
                for j in g.tolist():
                    self._chain(int(touched[j]), new_points[j])
                continue
            sch = eng.scheduler
            tev = eng._table_events
            met_ok = MetricReported in tev
            rev_ok = TrialRevoked in tev
            # -- A: collect table entries in scalar chain order (metrics of a
            # row before its revocation; rows in row order)
            entries: list = []
            erows: list = []
            for j in g.tolist():
                pts = new_points[j]
                if pts and met_ok:
                    entries.append(("metric", sts[j], pts))
                    erows.append((j, False))
                if cls[j] == 1 and rev_ok:
                    st = sts[j]
                    # predicted checkpoint at dispatch time: the notice
                    # (fired just before the revoke) checkpoints the sim
                    # backend at the current step count for free
                    ck = st.steps if notice_due[j] else st.ckpt_steps
                    entries.append(("revoked", st, (st.steps - ck, ck)))
                    erows.append((j, True))
            # -- B: one table call answers the batch; metric answers land on
            # the TrialStates now (revoke answers wait for their transition)
            rev_ans: dict = {}
            if entries:
                answers = sch.decision_table(entries)
                for (j, is_rev), ans in zip(erows, answers):
                    if ans is None:
                        continue
                    if is_rev:
                        rev_ans[j] = ans
                        continue
                    st = sts[j]
                    do_stop, do_pause, tg = ans
                    if do_stop:
                        st.stopped = True
                    if do_pause:
                        st.pause_requested = True
                    if tg is not None:
                        st.target_steps = tg
                    if cls[j] != 1:  # answers can move the row across branches
                        if st.steps >= st.target_steps or st.stopped:
                            cls[j] = 2
                        elif st.pause_requested:
                            cls[j] = 3
                        elif cls[j] != 4:
                            cls[j] = 0
            # -- C: transitions, per row in row order
            acting = g[notice_due[g] | (cls[g] != 0)]
            te = eng.t
            cfg = eng.cfg
            for j in acting.tolist():
                st = sts[j]
                i = int(touched[j])
                if notice_due[j]:
                    eng._checkpoint(st, deadline_s=cfg.notice_s)
                    st.notice_handled = True
                    eng._events.append((te, "notice", st.spec.key))
                c = int(cls[j])
                if c == 0:
                    continue
                if c == 1:                # revocation fires
                    lost = st.steps - st.ckpt_steps
                    st.lost_steps += lost
                    st.steps = st.ckpt_steps
                    st._next_val = int(st.steps
                                       // st.spec.workload.val_every)
                    nn = int(st._next_val)
                    st.metrics_steps = st.metrics_steps[:nn]
                    st.metrics_vals = st.metrics_vals[:nn]
                    eng._release(st, revoked=True)
                    st.status = Status.WAITING
                    ans = rev_ans.get(j)
                    if ans is not None:
                        do_stop, do_pause, tg = ans
                        if do_stop:
                            st.stopped = True
                        if do_pause:
                            st.pause_requested = True
                        if tg is not None:
                            st.target_steps = tg
                    if st.pause_requested:
                        eng._park(st)     # free rung boundary (ASHA)
                    else:
                        self.waiting[r].append(st)
                        self.has_waiting[r] = True
                elif c == 2:              # finished / stopped
                    st.pause_requested = False
                    eng._checkpoint(st)
                    eng._release(st, revoked=False)
                    st.status = Status.FINISHED
                    st.finish_time = te + eng._ckpt_time(st)
                    eng._events.append((te, "finish", st.spec.key, st.steps))
                elif c == 3:              # scheduler pause
                    eng._checkpoint(st)
                    eng._release(st, revoked=False)
                    eng._park(st)
                else:                     # c == 4: one-hour rotation
                    # (HourRotation is table-inert, so the held-duration
                    # payload the scalar path dispatches is not needed)
                    eng._checkpoint(st)
                    eng._release(st, revoked=False)
                    st.status = Status.WAITING
                    eng._events.append((te, "rotate", st.spec.key))
                    if st.pause_requested:
                        eng._park(st)
                    else:
                        self.waiting[r].append(st)
                        self.has_waiting[r] = True
                self.next_k[i] = _BIG
            # promotions staged while answering drain once per batch,
            # chronological order preserved by the schedulers' table shims
            if entries and eng._drain_promos:
                promos = sch.take_promotions()
                if promos:
                    for key, tg in promos.items():
                        eng._promote(key, tg)
            if eng._pending_deploy:
                self._note_promotions(r, eng)

    # --------------------------------------------------------------- chain
    def _chain(self, i: int, pts: list) -> None:
        """The engine's per-trial lifecycle condition chain, verbatim
        (``ExecutionEngine._tick`` minus the advance it already ran and the
        straggler block the stepper gates out).  Row array upkeep — heap
        replacement, waiting list — happens on the status transitions."""
        st = self.rows[i]
        r = int(self.row_rep[i])
        eng = self.engines[r]
        self._chain_body(i, r, st, eng, pts)
        if eng._pending_deploy:
            self._note_promotions(r, eng)

    def _note_promotions(self, r: int, eng) -> None:
        """An async promotion landed mid-chain.  The engine's waiting list
        is a comprehension over the tick-start runnable snapshot re-read at
        tick end, so promoted trials that were RUNNING (or already WAITING)
        this tick deploy *same-tick*; trials resumed from an earlier tick's
        PAUSED/FINISHED state were not in the snapshot and deploy next tick
        (they enter the waiting list on the rebuild).  Either way the
        engine's next jump is one tick (``_next_tick``'s pending branch)."""
        self.pending_reps.add(r)
        self.rebuild.add(r)
        w = self.waiting[r]
        for st in eng._active:
            if st._next_k == 0 and st.status is Status.WAITING \
                    and getattr(st, "_soa_round", -1) == self._round_no \
                    and st not in w:
                w.append(st)
        if w:
            self.has_waiting[r] = True

    def _chain_body(self, i: int, r: int, st, eng, pts: list) -> None:
        t = eng.t
        cfg = eng.cfg
        for step, val in pts:
            eng._dispatch(MetricReported(t, st.key, step, val), st)
        trev = st.a_t_revoke            # inf = never, so no None checks
        # (1) revocation notice -> checkpoint (Algorithm 1 l.24-26); the
        # clamp mirrors the engine chain (t >= t_start while running)
        if not st.notice_handled \
                and t >= max(st.a_t_start, trev - cfg.notice_s):
            eng._checkpoint(st, deadline_s=cfg.notice_s)
            st.notice_handled = True
            eng._events.append((t, "notice", st.spec.key))
            eng._dispatch(RevocationNotice(t, st.key, trev), st)
        # revocation fires
        if t >= trev:
            lost = st.steps - st.ckpt_steps
            st.lost_steps += lost
            st.steps = st.ckpt_steps      # roll back to checkpoint
            st._next_val = int(st.steps // st.spec.workload.val_every)
            n = int(st._next_val)
            st.metrics_steps = st.metrics_steps[:n]
            st.metrics_vals = st.metrics_vals[:n]
            eng._release(st, revoked=True)
            st.status = Status.WAITING
            d = eng._dispatch(
                TrialRevoked(t, st.key, lost, st.ckpt_steps), st)
            if d.kind == DecisionKind.PAUSE or st.pause_requested:
                eng._park(st)  # free rung boundary (ASHA)
            else:
                self.waiting[r].append(st)
                self.has_waiting[r] = True
            self.next_k[i] = _BIG
            return
        # (2) finished: target reached or a STOP decision (l.27-30)
        if st.steps >= st.target_steps or st.stopped:
            st.pause_requested = False
            eng._checkpoint(st)
            eng._release(st, revoked=False)
            st.status = Status.FINISHED
            st.finish_time = t + eng._ckpt_time(st)
            eng._events.append((t, "finish", st.spec.key, st.steps))
            eng._dispatch(
                TrialFinished(t, st.key, st.steps, st.stopped), st)
            self.next_k[i] = _BIG
            return
        # scheduler-requested pause (rung boundary et al.)
        if st.pause_requested:
            eng._checkpoint(st)
            eng._release(st, revoked=False)
            eng._park(st)
            self.next_k[i] = _BIG
            return
        # (3) one-hour proactive rotation (l.31-34)
        if t - st.a_t_start >= HOUR:
            eng._checkpoint(st)
            held = t - st.a_t_start
            eng._release(st, revoked=False)
            st.status = Status.WAITING
            eng._events.append((t, "rotate", st.spec.key))
            d = eng._dispatch(HourRotation(t, st.key, held), st)
            if d.kind == DecisionKind.PAUSE or st.pause_requested:
                eng._park(st)
            else:
                self.waiting[r].append(st)
                self.has_waiting[r] = True
            self.next_k[i] = _BIG
            return

    # -------------------------------------------------------------- deploys
    def _deploys(self, act: np.ndarray) -> List[int]:
        """Deploy every replica's (un-gated) waiting trials: candidate bids
        drawn per replica in trial order (the engine's RNG discipline), all
        revocation predictions answered in one cross-replica batch, then
        choices applied in the same order.  Returns deployed row indices."""
        provs = []
        fused: List[tuple] = []
        deployed: List[int] = []
        for r in act:
            r = int(r)
            if not self.has_waiting[r]:
                continue
            eng = self.engines[r]
            tr = float(self.t[r])
            if eng.t != tr:
                eng.t = tr
            got = eng._gate_deploys(self.waiting[r])
            if eng._flush_k is not None:
                self.flush_reps.add(r)
            else:
                self.flush_reps.discard(r)
            if not got:
                continue
            # the engine deploys in activation order (its waiting list is a
            # comprehension over the snapshot); re-order the accumulated
            # list, which promotion appends and window gating can scramble
            allowed = {id(s) for s in got}
            got = [s for s in eng._active if id(s) in allowed]
            self.waiting[r] = []
            self.has_waiting[r] = False
            if eng.prov.fused_supported():
                if any(st.exclude for st in got):
                    # exclusions perturb the candidate set per trial; keep
                    # the per-trial solve (same RNG draws either way)
                    prov = eng.prov
                    for st in got:
                        choice = prov.best_fused(eng.t, st.spec,
                                                 st.exclude or None)
                        eng._deploy_chosen(st, choice)
                        deployed.append(self._row_of(st))
                    if eng._pending_deploy:
                        self.pending_reps.add(r)
                        self.rebuild.add(r)
                else:
                    # cross-replica fused solve: collect now, one stacked
                    # Eq.-2 argmin after the loop.  Collection draws nothing
                    # and the solves read only predictor state, so applying
                    # choices afterwards is bit-exact in engine order.
                    for st in got:
                        fused.append((eng, r, st))
                continue
            provs.append(ProvisionBatch(eng, eng.t, [
                (st, eng.prov.candidates(eng.t, st.spec,
                                         exclude=st.exclude or None))
                for st in got]))
        if fused:
            # acquire=True feeds the winning bids of the whole cross-replica
            # burst straight into the columnar crossing search — one
            # segmented scan per shared (trace, minute) group
            choices, arows = best_fused_multi(
                [(eng.prov, eng.t, st.spec) for eng, _, st in fused],
                acquire=True)
            for (eng, r, st), choice, (row, t_rev) in zip(fused, choices,
                                                          arows):
                eng._deploy_row(st, choice, row, t_rev)
                deployed.append(self._row_of(st))
            for eng, r, _ in fused:
                if eng._pending_deploy:
                    self.pending_reps.add(r)
                    self.rebuild.add(r)
        if not provs:
            return deployed
        SweepRunner._service(provs)
        for pb in provs:
            eng = pb.engine
            for (st, cands), ps in zip(pb.items, pb.responses):
                choice = eng.prov.choose(eng.t, st.spec, cands, ps)
                eng._deploy_chosen(st, choice)
                deployed.append(self._row_of(st))
            if eng._pending_deploy:    # a TrialStarted dispatch promoted
                r = self._rep_of[id(eng)]
                self.pending_reps.add(r)
                self.rebuild.add(r)
        return deployed

    def _row_of(self, st) -> int:
        i = getattr(st, "_soa_row", -1)
        if 0 <= i < len(self.rows) and self.rows[i] is st:
            return i
        # slow path: locate within its replica's segment and memoize
        for i, row in enumerate(self.rows):
            if row is st:
                st._soa_row = i
                return i
        raise KeyError(f"trial {st.key} has no SoA row")

    # ----------------------------------------------------------- boundaries
    def _recompute(self, rows: List[int]) -> None:
        """Vectorized ``_next_tick`` boundary candidates for rows running at
        round end; scatters into ``next_k`` (array and TrialState)."""
        if not rows:
            return
        idx = np.asarray(rows, np.int64)
        sts = [self.rows[i] for i in idx]
        reps = self.row_rep[idx]
        tick = self.tick[reps]
        kn = self.k_now[reps]
        t_start = np.array([st.a_t_start for st in sts])
        t_rev = np.array([st.a_t_revoke for st in sts])
        handled = np.array([st.notice_handled for st in sts], bool)
        notice = self.notice_arr[reps]
        ready = np.array([st.ready_at for st in sts])
        last_t = np.array([st._last_t for st in sts])
        steps = np.array([st.steps for st in sts])
        target = np.array([st.target_steps for st in sts])
        spt = np.array([st._spt for st in sts])
        cand = t_start + HOUR                         # 1-hour rotation
        # notice-or-revoke, notice clamped to the allocation start (engine
        # _next_tick mirror)
        b = np.where(handled, t_rev,
                     np.maximum(t_start, t_rev - notice))
        cand = np.where(b < cand, b, cand)
        start = np.where(ready > last_t, ready, last_t)
        b = start + (target - steps) * spt            # finish
        kfin = np.ceil(b / tick - 1e-7).astype(np.int64)
        cand = np.where(b < cand, b, cand)
        prev = self.has_preview[reps]
        if not prev.all():
            ve = np.array([st.spec.workload.val_every for st in sts],
                          np.int64)
            nv = np.array([st._next_val for st in sts], np.int64)
            nstep = (nv + 1) * ve
            b = start + (nstep - steps) * spt         # next metric point
            hit = (~prev) & (nstep <= target) & (b < cand)
            cand = np.where(hit, b, cand)
        # snap up to the grid; same slack semantics as the engine
        k = np.ceil(cand / tick - 1e-7).astype(np.int64)
        k = np.where(k <= kn, kn + 1, k)
        if prev.any():
            pidx = np.nonzero(prev)[0]
            items = []
            for j in pidx:
                st = sts[j]
                eng = self.engines[reps[j]]
                kl = int(k[j])
                if eng._preview_stable:
                    # stable previews (answer independent of the scan cap):
                    # scan to the finish horizon so the memoized coverage
                    # amortizes across this allocation's recomputes
                    kf = int(kfin[j])
                    if kf > kl:
                        kl = kf
                items.append((eng, st, float(start[j]), float(spt[j]),
                              int(kn[j]), kl))
            if self.batch_preview and len(items) > 1:
                answers = preview_boundary_batch(items)
            else:
                answers = [eng._preview_boundary(st, s0, sp, knj, kl)
                           for eng, st, s0, sp, knj, kl in items]
            for j, k_act in zip(pidx, answers):
                if k_act is not None and k_act < k[j]:
                    k[j] = k_act
        for j, i in enumerate(idx):
            kj = int(k[j])
            sts[j]._next_k = kj
            self.next_k[i] = kj

    # ------------------------------------------------------------ idle/fits
    def _enter_idle(self, r: int) -> None:
        """The replica's engine drained: run the Tuner idle round.  A yielded
        FitRequest parks the replica until no replica has engine work (the
        generator-path flush policy), keeping the grouped LM solves fat."""
        eng = self.engines[r]
        tr = float(self.t[r])
        if eng.t != tr:
            eng.t = tr
        gen = self.tuners[r].idle_round()
        try:
            req = next(gen)
        except StopIteration as e:
            self._after_idle(r, bool(e.value))
            return
        assert isinstance(req, FitRequest)
        self.parked[r] = (gen, req)

    def _flush_fits(self) -> None:
        parked = self.parked
        self.parked = {}
        SweepRunner._service([req for _, req in parked.values()])
        for r, (gen, _) in parked.items():
            try:
                next(gen)
            except StopIteration as e:
                self._after_idle(r, bool(e.value))
            else:                      # pragma: no cover - idle_round yields once
                raise RuntimeError("idle_round yielded more than once")

    def _after_idle(self, r: int, more: bool) -> None:
        if more:
            # fresh suggestions or promotions: re-enter the engine loop at
            # the same simulated time (deploys happen at the idle tick)
            self.active[r] = True
            self.t_next[r] = self.t[r]
            self.rebuild.add(r)
        else:
            self.tuners[r].finish()
            self.done[r] = True
