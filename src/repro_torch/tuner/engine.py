"""Policy-free transient-resource execution engine (SpotTune Algorithm 1's
mechanics, with the search policy factored out).

The engine owns everything the paper's orchestrator did *except* the decisions
about trial budgets and early stopping:

  * cost-aware deployment of waiting trials via the Provisioner (Eq. 2
    argmin), with VM-startup + checkpoint-restore latency charged before
    compute resumes;
  * revocation notices (checkpoint on notice, rollback on the revocation,
    first-hour refund accounting, requeue);
  * proactive 1-hour rotation (fresh market decision + a new refund window);
  * flag-gated straggler re-placement (beyond-paper, off by default).

Policy arrives through the event stream: every lifecycle transition is
narrated as a typed event (``repro_torch.tuner.events``) to a ``Scheduler``, whose
``Decision``s the engine applies at exactly the points the legacy loop
evaluated its hardcoded conditions — so a scheduler that reproduces the
legacy conditions reproduces the legacy run bit-for-bit (seeded RNG draws
included).  ``PAUSE`` parks a trial on its checkpoint without redeploying it;
``take_promotions`` / ``resume`` bring parked trials back.

The tick discipline (one pass per ``tick_s`` of simulated time, trials
processed in activation order, waiting trials deployed at tick end) is kept
verbatim from the paper's Algorithm 1 SLEEP loop — but by default the engine
does not *step* every tick.  Between two consecutive lifecycle boundaries
(deployment becoming ready, revocation notice, the revocation itself, the
1-hour rotation, the next ``val_every`` metric crossing, reaching the target
step count, the horizon guard) a running trial's per-tick work is closed-form:
steps grow linearly in simulated time and the per-tick EWMA perf-matrix
updates consume noise draws that are deterministic in ``(workload.seed,
int(t))``.  The event-driven fast path therefore jumps simulated time straight
to the earliest boundary (snapped to the tick grid) and replays the skipped
ticks as one vectorized fold (``_advance_window``), which is exactly
equivalent to ticking through them.  Schedulers that implement
``preview_metrics`` let the jump clear non-actionable metric crossings too
(``_preview_boundary``), and straggler mode jumps to the predicted
perf-matrix crossing (``_straggler_boundary``) instead of stepping every
tick.  ``EngineConfig(exact_ticks=True)`` keeps the legacy tick-for-tick
loop; ``repro.tuner.equivalence`` pins fast == exact (billing, finish
times, metric histories) across seeds.

``run_cooperative`` is the generator form of the loop: it suspends at each
deploy point with a ``ProvisionBatch`` whose candidate bids are already
drawn, so a sweep runner can interleave many engines and answer their
revocation predictions in one cross-replica vmapped forward.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.backends.base import TrialBackend
from repro_torch.core.market import (HOUR, InstanceType, SpotMarket, _RecRef,
                               acquire_batch_multi)
from repro_torch.core.provisioner import Choice, PerfModel, Provisioner
from repro_torch.core.trial import TrialSpec
from repro_torch.tuner.events import (HourRotation, MetricReported, RevocationNotice,
                                TrialFinished, TrialRevoked, TrialStarted)
from repro_torch.tuner.scheduler import CONTINUE, Decision, DecisionKind, Scheduler


class Status(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PAUSED = "paused"
    FINISHED = "finished"


@dataclasses.dataclass
class TrialState:
    spec: TrialSpec
    target_steps: float
    steps: float = 0.0
    ckpt_steps: float = 0.0
    status: Status = Status.WAITING
    # live allocation as a ledger row handle plus hot-column mirrors (the
    # tick/boundary chains read these instead of chasing an object)
    alloc_row: int = -1
    a_inst: Optional[InstanceType] = None
    a_t_start: float = 0.0
    a_t_revoke: float = math.inf     # inf = never within horizon
    choice: Optional[Choice] = None
    ready_at: float = 0.0
    notice_handled: bool = False
    alloc_start_steps: float = 0.0
    metrics_steps: List[int] = dataclasses.field(default_factory=list)
    metrics_vals: List[float] = dataclasses.field(default_factory=list)
    free_steps: float = 0.0
    lost_steps: float = 0.0
    ckpt_seconds: float = 0.0
    restore_seconds: float = 0.0
    billed_cost: float = 0.0         # $ billed to this trial, net of refunds
    redeployments: int = 0
    stopped: bool = False            # a STOP decision was applied
    pause_requested: bool = False
    exclude: set = dataclasses.field(default_factory=set)
    finish_time: float = 0.0
    _next_val: int = 0
    _last_t: float = 0.0             # last tick replayed (fast path only)
    _next_k: int = 0                 # next boundary tick index (fast path)
    _spt: float = 0.0                # cached noise-free secs/step (fast path)
    # preview memo (fast path, ``preview_stable`` schedulers only): the
    # answer of the last ``_preview_boundary`` call, the metric-point index
    # it covered, and the allocation epoch it was computed under
    _pv_epoch: tuple = ()
    _pv_cov: int = -1
    _pv_ans: Optional[int] = None
    _ckpt_s: float = -1.0            # memoized checkpoint transfer seconds
    key: str = ""                    # spec.key, materialized (hot attribute)

    def __post_init__(self):
        self.key = self.spec.key

    @property
    def converged(self) -> bool:
        """Legacy alias: the paper's only STOP reason was metric plateau."""
        return self.stopped


@dataclasses.dataclass
class EngineConfig:
    tick_s: float = 10.0
    deploy_delay_s: float = 60.0       # VM/slice startup
    ckpt_bandwidth_bps: float = 120e6  # object-store write speed (fig12 knob)
    notice_s: float = 120.0
    straggler_factor: float = 0.0      # 0 = off (paper); >1 enables mitigation
    max_sim_s: float = 10 * 24 * 3600.0
    seed: int = 0
    # time-windowed deploy batching: trials turning WAITING within
    # ``deploy_window_s`` of the first one are held and serviced together,
    # so cross-replica RevPred forwards see fatter batches.  0 (default)
    # deploys at the same tick the trial turns WAITING — the paper's (and
    # the equivalence-pinned) behavior.
    deploy_window_s: float = 0.0
    # False (default): event-driven boundary jumping; True: the legacy
    # tick-for-tick Algorithm 1 loop (the two are equivalence-pinned)
    exact_ticks: bool = False


def build_engine(market: SpotMarket, backend: TrialBackend, revpred,
                 seed: int = 0, **engine_kw) -> "ExecutionEngine":
    """Standard construction: fresh perf matrix + Eq.-2 provisioner around a
    market/backend pair.  Every driver (examples, benchmarks, tests, the
    legacy shim) wants exactly this wiring.  An engine is cheap to build —
    all heavyweight state (traces, indices, curves, jit caches) lives in
    shared pure memos — and fully replica-local: the only RNG it consumes
    is the provisioner's own seeded stream."""
    prov = Provisioner(market, revpred, PerfModel(market.pool), seed=seed)
    return ExecutionEngine(market, backend, prov,
                           EngineConfig(seed=seed, **engine_kw))


@dataclasses.dataclass
class ProvisionBatch:
    """A suspended deploy point of ``ExecutionEngine.run_cooperative``.

    ``items`` holds ``(trial_state, candidates)`` for every trial deploying
    at this tick, candidate bids already drawn (RNG order is fixed before
    the suspension).  The driver must fill ``responses`` — one p(revoke)
    list per item, aligned with its candidates — before resuming the
    generator; ``service_local`` answers with the engine's own predictor,
    reproducing the non-cooperative path bit-for-bit.  A sweep runner
    instead stacks the candidates of many suspended replicas into one
    vmapped RevPred forward."""

    engine: "ExecutionEngine"
    t: float
    items: List[tuple]
    responses: Optional[List[list]] = None

    def service_local(self) -> None:
        prov = self.engine.prov
        self.responses = [prov.predict_candidates(self.t, cands)
                          for _, cands in self.items]


class ExecutionEngine:
    """Runs trials on the transient market; consults a Scheduler for policy."""

    def __init__(self, market: SpotMarket, backend: TrialBackend,
                 provisioner: Provisioner, config: Optional[EngineConfig] = None):
        self.market = market
        self.backend = backend
        self.prov = provisioner
        self.cfg = config or EngineConfig()
        self.scheduler: Scheduler = Scheduler()
        self._drain_promos = False
        self._has_preview = False
        # backends that override the protocol's snapshot/restore no-ops get
        # the real lifecycle calls; for the sim (and legacy duck-typed
        # backends) the checkpoint hot path stays exactly the legacy
        # assignment.  Same type-level gating pattern as bind()'s.
        bt = type(backend)
        self._backend_snapshots = (
            getattr(bt, "snapshot", TrialBackend.snapshot)
            is not TrialBackend.snapshot)
        self._backend_restores = (
            getattr(bt, "restore", TrialBackend.restore)
            is not TrialBackend.restore)
        self._ckpt_time_fn = getattr(backend, "checkpoint_time", None)
        self.states: List[TrialState] = []
        self._by_key: Dict[str, TrialState] = {}
        self._active: List[TrialState] = []
        self._ledger = market.ledger
        self._events: List[tuple] = []
        self._ev_mat = 0         # prefix of _events already materialized
        self.t = 0.0
        # fast path: min-heap of (tick index, seq, trial) boundary entries
        # with lazy invalidation (stale when trial._next_k moved on)
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self._pending_deploy = False
        self._preview_stable = False
        self._table_events: frozenset = frozenset()
        self._has_table = False
        self._started_inert = False
        self._flush_k: Optional[int] = None   # armed deploy-window flush tick

    @property
    def events(self) -> List[tuple]:
        """Event log with deferred billing records materialized on read.

        Releases append a ``_RecRef`` row handle instead of building the
        record dict in the hot loop; the first read of the log resolves the
        new suffix in place (a materialized prefix is never re-resolved, so
        repeated reads stay O(new events))."""
        ev = self._events
        j = self._ev_mat
        n = len(ev)
        while j < n:
            e = ev[j]
            p = e[-1]
            if type(p) is _RecRef:
                ev[j] = e[:-1] + (p.record(),)
            j += 1
        self._ev_mat = n
        return ev

    # ------------------------------------------------------------- trials
    def bind(self, scheduler: Scheduler) -> None:
        self.scheduler = scheduler
        # schedulers that never promote asynchronously (the base no-op is
        # not overridden) skip the per-event promotion drain entirely
        self._drain_promos = (type(scheduler).take_promotions
                              is not Scheduler.take_promotions)
        # schedulers that can preview metric trajectories let the fast path
        # jump over non-actionable crossings instead of visiting each one
        self._has_preview = (type(scheduler).preview_metrics
                             is not Scheduler.preview_metrics)
        # schedulers declaring ``preview_stable`` promise their preview
        # answer depends only on the trial's combined (history + future)
        # metric sequence — which is invariant within one allocation — so
        # repeat previews can be served from the trial's memo
        self._preview_stable = bool(getattr(scheduler, "preview_stable",
                                            False))
        # schedulers exposing per-grid-index stop verdicts let the preview
        # skip trajectory materialization entirely (see _preview_boundary)
        self._preview_fast = getattr(scheduler, "preview_stop_grid", None)
        # batched decision-table capability (see Scheduler.decision_table):
        # only the two batchable event classes are honored — anything wider
        # keeps the scalar chain.  A table scheduler declares every class
        # outside table_events inert, which licenses skipping those
        # dispatches entirely (TrialStarted below; the SoA stepper skips the
        # lifecycle narration events the same way).
        self._table_events = getattr(scheduler, "table_events", frozenset())
        self._has_table = (
            getattr(type(scheduler), "decision_table", None) is not None
            and self._table_events <= {MetricReported, TrialRevoked})
        self._started_inert = (self._has_table
                               and TrialStarted not in self._table_events)

    def add_trial(self, spec: TrialSpec, target_steps: float) -> TrialState:
        assert spec.key not in self._by_key, f"duplicate trial key {spec.key}"
        st = TrialState(spec, target_steps=target_steps)
        self.states.append(st)
        self._by_key[spec.key] = st
        self._active.append(st)
        return st

    def views(self) -> List[TrialState]:
        return list(self.states)

    def resume(self, promotions: Dict[str, float]) -> None:
        """Resume trials with new budgets; the dict order is the activation
        (and hence deployment / RNG-consumption) order."""
        self._active = []
        for key, target in promotions.items():
            st = self._by_key[key]
            st.target_steps = target
            st.status = Status.WAITING
            self._active.append(st)

    # ------------------------------------------------------------- helpers
    def _ckpt_time(self, st: TrialState) -> float:
        # checkpoint bytes/time come from the backend: the default protocol
        # implementation prices model_bytes at the engine's bandwidth knob
        # (the legacy arithmetic, bit-exact); a training backend answers
        # from its object store's measured transfer model
        if self._ckpt_time_fn is not None:
            return self._ckpt_time_fn(st.spec, self.cfg.ckpt_bandwidth_bps)
        v = st._ckpt_s          # model size and bandwidth are fixed per trial
        if v < 0.0:
            v = st._ckpt_s = (self.backend.model_bytes(st.spec)
                              / self.cfg.ckpt_bandwidth_bps)
        return v

    def _checkpoint(self, st: TrialState, deadline_s: Optional[float] = None):
        """Persist trial state.  ``deadline_s`` is the transfer budget the
        snapshot must fit (the revocation-notice window); every other
        checkpoint event — hour rotation, pause, plateau stop, finish —
        has no deadline, so oversized models still persist there."""
        if self._backend_snapshots:
            # real snapshot: the backend persists actual training state and
            # answers with the step that is durable (the deadline gate may
            # pin it to an older snapshot for oversized models)
            st.ckpt_steps = self.backend.snapshot(
                st.spec, st.steps,
                float("inf") if deadline_s is None else deadline_s)
        else:
            st.ckpt_steps = st.steps
        st.ckpt_seconds += self._ckpt_time(st)

    def _release(self, st: TrialState, revoked: bool) -> None:
        row = st.alloc_row
        cost, refund = self._ledger.release_row(row, self.t, revoked)
        steps_this_alloc = st.ckpt_steps - st.alloc_start_steps
        st.billed_cost += cost - refund
        if refund > 0:
            st.free_steps += max(steps_this_alloc, 0.0)
        self._events.append((self.t, "release", st.spec.key,
                             _RecRef(self._ledger, row)))
        st.alloc_row = -1
        st.a_inst = None
        st.a_t_revoke = math.inf
        st.choice = None
        st.notice_handled = False

    def _deploy_chosen(self, st: TrialState, choice: Choice):
        """Complete a deployment whose Eq.-2 choice is already made."""
        row, t_rev = self._ledger.acquire_row(choice.inst, choice.max_price,
                                              self.t)
        self._deploy_row(st, choice, row, t_rev)

    def _deploy_row(self, st: TrialState, choice: Choice, row: int,
                    t_rev: float):
        """Finish a deployment whose ledger row was already acquired (the
        batched deploy paths answer a whole burst's crossing searches in
        one segmented scan before handing rows out)."""
        if st.exclude:
            st.exclude = set()
        st.alloc_row = row
        st.a_inst = choice.inst
        st.a_t_start = self.t
        st.a_t_revoke = t_rev
        st.choice = choice
        restore = self._ckpt_time(st) if st.steps > 0 else 0.0
        if self._backend_restores and st.steps > 0:
            # elastic re-shard path: rehydrate real training state from the
            # durable snapshot before compute resumes on the new slice
            self.backend.restore(st.spec, st.ckpt_steps)
        st.restore_seconds += restore
        st.ready_at = self.t + self.cfg.deploy_delay_s + restore
        st.alloc_start_steps = st.steps
        st.status = Status.RUNNING
        st.redeployments += 1
        st._last_t = self.t
        st._next_k = 0        # fresh allocation -> boundaries recomputed
        st._spt = self.backend.base_step_time(st.spec, choice.inst)
        self._events.append((self.t, "deploy", st.spec.key, choice.inst.name,
                            round(choice.max_price, 4), round(choice.p_revoke, 3)))
        if not self._started_inert:
            # table schedulers declare TrialStarted inert (no state change,
            # no staged promotions pending at this point), so the dispatch
            # — and its per-event promotion drain — is skippable
            self._dispatch(TrialStarted(self.t, st.key, choice.inst.name,
                                        choice.max_price, choice.p_revoke), st)

    def _advance(self, st: TrialState, dt: float) -> List[tuple]:
        """Simulate ``dt`` seconds of compute; returns new (step, value)
        metric points (already appended to the trial's history)."""
        inst = st.a_inst
        true_spt = self.backend.step_time(st.spec, inst)
        gained = dt / true_spt
        st.steps = min(st.steps + gained, st.target_steps)
        # observed seconds/step -> perf-matrix update (Algorithm 1 line 36)
        obs = self.backend.step_time(st.spec, inst, noisy_t=self.t)
        self.prov.perf.update(inst, st.spec, obs)
        # metric points crossed
        w = st.spec.workload
        new_points = []
        while (st._next_val + 1) * w.val_every <= st.steps:
            st._next_val += 1
            step = st._next_val * w.val_every
            val = self.backend.metric_at(st.spec, step)
            if val is not None:
                st.metrics_steps.append(step)
                st.metrics_vals.append(val)
                new_points.append((step, val))
        return new_points

    def _advance_window(self, st: TrialState) -> List[tuple]:
        """Fast-path advance: replay every skipped tick in ``(st._last_t,
        self.t]`` at once — one fused steps update, one vectorized EWMA fold
        over the deterministic noise draws, the same metric-crossing scan.

        Every crossed metric point is appended to the trial's history, but
        only the points the exact loop would first observe at the *final*
        tick of the window are returned for dispatch.  Without a previewing
        scheduler the two sets coincide (each crossing is its own boundary);
        with one, the interior points are exactly those the scheduler
        previewed as non-actionable — appending them silently is the whole
        point of the jump."""
        tick_s = self.cfg.tick_s
        t = self.t
        start = st.ready_at if st.ready_at > st._last_t else st._last_t
        st._last_t = t
        k0 = math.floor(start / tick_s) + 1       # first tick with dt > 0
        k1 = round(t / tick_s)
        if k1 < k0:
            return []                             # still inside deploy/restore
        inst = st.a_inst
        steps0 = st.steps
        st.steps = min(steps0 + (t - start) / st._spt, st.target_steps)
        obs = self.backend.noisy_step_times(st.spec, inst, k0, k1, tick_s,
                                            base=st._spt)
        self.prov.perf.update_many(inst, st.spec, obs)
        # steps as of the previous tick — what an every-tick scan had seen
        lim = (k1 - 1) * tick_s
        s_prev = steps0 if lim <= start else min(
            steps0 + (lim - start) / st._spt, st.target_steps)
        # metric points crossed (identical to the per-tick scan)
        w = st.spec.workload
        new_points = []
        while (st._next_val + 1) * w.val_every <= st.steps:
            st._next_val += 1
            step = st._next_val * w.val_every
            val = self.backend.metric_at(st.spec, step)
            if val is not None:
                st.metrics_steps.append(step)
                st.metrics_vals.append(val)
                if step > s_prev:
                    new_points.append((step, val))
        return new_points

    # ------------------------------------------------------------ decisions
    def _dispatch(self, event, st: TrialState) -> Decision:
        d = self.scheduler.on_event(event, st)
        if d is None:
            d = CONTINUE
        else:
            k = d.kind
            if k is DecisionKind.STOP:
                st.stopped = True
            elif k is DecisionKind.PAUSE:
                st.pause_requested = True
            elif k is DecisionKind.PROMOTE:
                st.target_steps = d.target_steps
        if self._drain_promos:
            promos = self.scheduler.take_promotions()
            if promos:
                for key, target in promos.items():
                    self._promote(key, target)
        return d

    def _promote(self, key: str, target: float):
        st = self._by_key[key]
        st.target_steps = target
        st._next_k = 0        # budget changed -> boundaries recomputed
        self._pending_deploy = True   # wake the fast path at the next tick
        if st.status in (Status.PAUSED, Status.FINISHED):
            st.status = Status.WAITING
        if st not in self._active:
            self._active.append(st)

    def _gate_deploys(self, waiting: List[TrialState]) -> List[TrialState]:
        """Δt deploy batching: hold WAITING trials until the window closes.

        On the first waiting trial the flush tick is armed ``deploy_window_s``
        ahead (snapped to the grid like every boundary); until it arrives the
        trials stay WAITING and accumulate, then the whole batch deploys in
        one suspension.  ``deploy_window_s == 0`` never gates."""
        cfg = self.cfg
        if not waiting or cfg.deploy_window_s <= 0.0:
            return waiting
        k_now = round(self.t / cfg.tick_s)
        if self._flush_k is None:
            k = math.ceil((self.t + cfg.deploy_window_s) / cfg.tick_s - 1e-7)
            self._flush_k = k if k > k_now else k_now
        if k_now < self._flush_k:
            return []
        self._flush_k = None
        return waiting

    def _park(self, st: TrialState):
        """Apply a PAUSE that coincides with an engine-forced release (the
        trial is already checkpointed and off its allocation)."""
        st.pause_requested = False
        st.status = Status.PAUSED
        self._events.append((self.t, "pause", st.spec.key))

    # ----------------------------------------------------------- main loop
    def run_until_idle(self):
        """Run until no trial is running or waiting (paused trials park;
        promotions delivered mid-run re-activate them).

        ``exact_ticks=True`` visits every ``tick_s`` of simulated time (the
        legacy Algorithm 1 SLEEP loop); the default fast path processes the
        same ticks a boundary falls on and jumps over the rest."""
        for req in self.run_cooperative():
            req.service_local()

    def run_cooperative(self):
        """Generator form of ``run_until_idle``: suspends at every deploy
        point with a ``ProvisionBatch`` the driver must answer before
        resuming.  This is what makes one engine step-interleavable with
        others — a sweep runner drives many replicas' generators and
        services their suspended deploys in one cross-replica batch.
        Serviced locally (``run_until_idle``) it is bit-identical to the
        pre-generator loop: candidate RNG draws happen before suspension in
        trial order, and deployments complete in the same order at the same
        tick."""
        cfg = self.cfg
        exact = cfg.exact_ticks
        while True:
            runnable = [s for s in self._active
                        if s.status in (Status.RUNNING, Status.WAITING)]
            if not runnable:
                return
            if self.t > cfg.max_sim_s or self.t >= self.market.horizon_s() - HOUR:
                raise RuntimeError("simulation horizon exhausted")
            touched = self._tick(runnable, exact)
            waiting = self._gate_deploys(
                [s for s in runnable if s.status == Status.WAITING])
            if waiting:
                batch = ProvisionBatch(self, self.t, [
                    (st, self.prov.candidates(self.t, st.spec,
                                              exclude=st.exclude or None))
                    for st in waiting])
                yield batch
                assert batch.responses is not None, "unserviced ProvisionBatch"
                # choices first (they read only the perf matrix and the
                # minute-memoized market rows, which deploys never touch),
                # then one batched acquire answers the burst's crossing
                # searches in a single segmented scan
                chosen = [(st, self.prov.choose(self.t, st.spec, cands, ps))
                          for (st, cands), ps in zip(batch.items,
                                                     batch.responses)]
                rows = acquire_batch_multi(
                    [(self.market, c.inst, c.max_price, self.t)
                     for _, c in chosen])
                for (st, choice), (row, t_rev) in zip(chosen, rows):
                    self._deploy_row(st, choice, row, t_rev)
                    touched.append(st)
            self.t = self.t + cfg.tick_s if exact else self._next_tick(touched)

    def _tick(self, runnable: List[TrialState], exact: bool) -> List[TrialState]:
        """One Algorithm-1 pass at ``self.t``: advance every running trial
        and apply the notice/revoke/finish/pause/rotate/straggler chain.
        Kept verbatim from the paper's loop — the two advance flavors are
        equivalence-pinned.  Waiting trials deploy at tick end, in the main
        loop (the deploy is the cooperative suspension point).  Returns the
        trials whose boundaries moved for rescheduling."""
        cfg = self.cfg
        k_now = round(self.t / cfg.tick_s)
        touched: List[TrialState] = []
        for st in runnable:
            if st.status != Status.RUNNING:
                continue
            if exact:
                run_from = max(st.ready_at, self.t - cfg.tick_s)
                dt = self.t - run_from
                new_points = self._advance(st, dt) if dt > 0 else []
            else:
                # a running trial only needs attention at its own boundaries:
                # nothing in its condition chain can fire before st._next_k,
                # and its skipped ticks replay exactly whenever it next folds
                if st._next_k > k_now:
                    continue
                touched.append(st)
                new_points = self._advance_window(st)
            for step, val in new_points:
                self._dispatch(MetricReported(self.t, st.key, step, val), st)

            trev = st.a_t_revoke        # inf = never, so no None checks
            # (1) revocation notice -> checkpoint (Algorithm 1 l.24-26).
            # The notice clamp max(t_start, trev - notice_s) leaves this
            # condition unchanged: t >= t_start always holds while running.
            if not st.notice_handled and self.t >= trev - cfg.notice_s:
                self._checkpoint(st, deadline_s=cfg.notice_s)
                st.notice_handled = True
                self._events.append((self.t, "notice", st.spec.key))
                self._dispatch(RevocationNotice(self.t, st.key, trev), st)
            # revocation fires
            if self.t >= trev:
                lost = st.steps - st.ckpt_steps
                st.lost_steps += lost
                st.steps = st.ckpt_steps      # roll back to checkpoint
                st._next_val = int(st.steps // st.spec.workload.val_every)
                n = int(st._next_val)
                st.metrics_steps = st.metrics_steps[:n]
                st.metrics_vals = st.metrics_vals[:n]
                self._release(st, revoked=True)
                st.status = Status.WAITING
                d = self._dispatch(
                    TrialRevoked(self.t, st.key, lost, st.ckpt_steps), st)
                if d.kind == DecisionKind.PAUSE or st.pause_requested:
                    self._park(st)  # free rung boundary (ASHA)
                continue
            # (2) finished: target reached or a STOP decision (l.27-30)
            if st.steps >= st.target_steps or st.stopped:
                st.pause_requested = False
                self._checkpoint(st)
                self._release(st, revoked=False)
                st.status = Status.FINISHED
                st.finish_time = self.t + self._ckpt_time(st)
                self._events.append((self.t, "finish", st.spec.key, st.steps))
                self._dispatch(
                    TrialFinished(self.t, st.key, st.steps, st.stopped), st)
                continue
            # scheduler-requested pause (rung boundary et al.)
            if st.pause_requested:
                self._checkpoint(st)
                self._release(st, revoked=False)
                self._park(st)
                continue
            # (3) one-hour proactive rotation (l.31-34)
            if self.t - st.a_t_start >= HOUR:
                self._checkpoint(st)
                held = self.t - st.a_t_start
                self._release(st, revoked=False)
                st.status = Status.WAITING
                self._events.append((self.t, "rotate", st.spec.key))
                d = self._dispatch(HourRotation(self.t, st.key, held), st)
                if d.kind == DecisionKind.PAUSE or st.pause_requested:
                    self._park(st)
                continue
            # beyond-paper: straggler re-placement
            if cfg.straggler_factor > 1.0 and self.t >= st.ready_at + 60:
                best_pred = min(self.prov.perf.get(i, st.spec)
                                for i in self.market.pool)
                obs = self.backend.step_time(st.spec, st.a_inst)
                if obs > cfg.straggler_factor * best_pred:
                    self._checkpoint(st)
                    st.exclude = {st.a_inst.name}
                    self._release(st, revoked=False)
                    st.status = Status.WAITING
                    self._events.append((self.t, "straggler", st.spec.key))
                    continue
        return touched

    def _next_tick(self, touched: List[TrialState]) -> float:
        """Earliest grid tick > ``self.t`` at which anything can happen.

        Per running trial the candidate boundaries are: the revocation notice,
        the revocation itself, the 1-hour rotation, reaching ``target_steps``
        (compute progresses at the deterministic noise-free step time measured
        from the trial's last replayed tick, so step boundaries are
        closed-form), metric crossings, and — in straggler mode — the first
        tick the perf-matrix comparison can fire (predicted by replaying the
        EWMA fold ahead, see ``_straggler_boundary``).  A previewing
        scheduler turns "every metric crossing" into "the first crossing it
        would act on" (``_preview_boundary``); without a preview each
        crossing stays its own boundary.  Boundaries are recomputed only for
        trials this tick touched and kept in a lazily invalidated min-heap,
        so a jump costs O(touched) instead of O(active).  Trials promoted
        mid-tick deploy at the next tick, like the legacy loop.  The jump
        never overshoots the horizon guards the main loop raises on."""
        cfg = self.cfg
        tick_s = cfg.tick_s
        k_now = round(self.t / tick_s)
        straggler = cfg.straggler_factor > 1.0
        heap = self._heap
        for st in touched:
            if st.status != Status.RUNNING:
                continue
            cand = st.a_t_start + HOUR                    # 1-hour rotation
            trev = st.a_t_revoke
            if trev < math.inf:
                # the notice boundary is clamped to the allocation start so
                # an over-price acquire never schedules a past-time event
                b = trev if st.notice_handled \
                    else max(st.a_t_start, trev - cfg.notice_s)
                if b < cand:
                    cand = b
            spt = st._spt
            start = st.ready_at if st.ready_at > st._last_t else st._last_t
            b = start + (st.target_steps - st.steps) * spt    # finish
            if b < cand:
                cand = b
            if not self._has_preview:
                w = st.spec.workload
                nstep = (st._next_val + 1) * w.val_every
                if nstep <= st.target_steps:              # next metric point
                    b = start + (nstep - st.steps) * spt
                    if b < cand:
                        cand = b
            # snap up to the grid; the 1e-7 slack only ever lands us one tick
            # early, where the (unchanged) condition chain simply re-arms
            k = math.ceil(cand / tick_s - 1e-7)
            if k <= k_now:
                k = k_now + 1
            if self._has_preview:
                k_act = self._preview_boundary(st, start, spt, k_now, k)
                if k_act is not None and k_act < k:
                    k = k_act
            if straggler:
                k_strag = self._straggler_boundary(st, start, k_now, k)
                if k_strag is not None and k_strag < k:
                    k = k_strag
            st._next_k = k
            heapq.heappush(heap, (k, next(self._seq), st))
        if self._pending_deploy:
            # a trial turned WAITING mid-tick (async promotion): deploy next
            # tick, exactly like the legacy loop
            self._pending_deploy = False
            return (k_now + 1) * tick_s
        while heap:
            k, _, st = heap[0]
            if k > k_now and st._next_k == k and st.status == Status.RUNNING:
                break
            heapq.heappop(heap)      # stale: rescheduled, parked, or done
        flush = self._flush_k
        if not heap:
            # nothing running: jump to an armed deploy-window flush, else
            # advance one tick (the legacy idle step)
            k = flush if flush is not None and flush > k_now else k_now + 1
        else:
            k = heap[0][0]
            if flush is not None and flush < k:
                k = flush if flush > k_now else k_now + 1
        k_guard = min(math.floor(cfg.max_sim_s / tick_s) + 1,
                      math.ceil((self.market.horizon_s() - HOUR) / tick_s))
        if k > k_guard:
            k = k_guard if k_guard > k_now else k_now + 1
        return k * tick_s

    def _preview_boundary(self, st: TrialState, start: float, spt: float,
                          k_now: int, k_limit: int) -> Optional[int]:
        """First tick <= ``k_limit`` at which the scheduler would act on a
        metric crossing, per its ``preview_metrics`` answer; None = none.

        The crossings that would occur through the end of tick ``k_limit``
        are materialized (step, value, observation tick) and handed to the
        scheduler; points it declares non-actionable are later appended
        silently by ``_advance_window`` without a boundary visit.

        For ``preview_stable`` schedulers the answer is memoized per trial:
        within one allocation epoch (no redeploy/rollback, unchanged budget,
        not stopped) the combined history+future metric sequence — and the
        point→tick map — is invariant, so a repeat preview whose coverage a
        prior call already spanned returns the recorded answer without
        re-materializing the trajectory."""
        w = st.spec.workload
        tick_s = self.cfg.tick_s
        lo = st._next_val + 1
        steps_end = st.steps + (k_limit * tick_s - start) / spt
        if steps_end > st.target_steps:
            steps_end = st.target_steps
        hi = int(steps_end // w.val_every)
        if hi < lo:
            return None
        stable = self._preview_stable
        if stable:
            epoch = (st.redeployments, st.target_steps, st.stopped)
            if (st._pv_epoch == epoch and hi <= st._pv_cov
                    and (st._pv_ans is None or st._pv_ans > k_now)):
                return st._pv_ans
        metric_range = getattr(self.backend, "metric_range", None)
        fast = self._preview_fast
        if fast is not None and metric_range is not None:
            vals_f = metric_range(st.spec, lo, hi)
            if None not in vals_f:
                ans = self._preview_scan(st, fast(st, vals_f, lo, hi),
                                         start, spt, k_now, lo, hi)
                if stable:
                    st._pv_epoch = epoch
                    st._pv_cov = hi
                    st._pv_ans = ans
                return ans
        steps_f = np.arange(lo, hi + 1, dtype=np.int64) * w.val_every
        if metric_range is not None:
            vals_f = metric_range(st.spec, lo, hi)
        else:
            vals_f = [self.backend.metric_at(st.spec, int(s)) for s in steps_f]
        if any(v is None for v in vals_f):
            # unreported points never reach the scheduler on any path
            keep = [i for i, v in enumerate(vals_f) if v is not None]
            if not keep:
                return None
            steps_f = steps_f[keep]
            vals_f = [vals_f[i] for i in keep]
        # observation tick per point: same snap (and slack) as the boundary
        # grid, so the chosen tick is exactly where the crossing dispatches
        ticks_f = np.ceil(
            (start + (steps_f - st.steps) * spt) / tick_s - 1e-7).astype(np.int64)
        np.clip(ticks_f, k_now + 1, None, out=ticks_f)
        i = self.scheduler.preview_metrics(st, steps_f, vals_f, ticks_f)
        ans = None if i is None else int(ticks_f[int(i)])
        if stable:
            st._pv_epoch = epoch
            st._pv_cov = hi
            st._pv_ans = ans
        return ans

    def _preview_scan(self, st: TrialState, ok, start: float, spt: float,
                      k_now: int, lo: int, hi: int) -> Optional[int]:
        """First acting tick given ``ok`` — sorted *global* grid indices
        whose prefixes pass the stop check (None = nothing fires).  A
        decision dispatches at the *end* of its observation tick, so only
        tick-end indices matter: walk the (typically empty or tiny)
        candidate subset inside [lo, hi], resolving each candidate's tick
        end in O(1) with the same snap arithmetic the vectorized trajectory
        path uses — bit-identical answers, no per-point arrays."""
        if ok is None:
            return None
        i0 = int(np.searchsorted(ok, lo))
        i1 = int(np.searchsorted(ok, hi, side="right"))
        if i0 == i1:
            return None
        idxs = ok[i0:i1]
        tick_s = self.cfg.tick_s
        ve = st.spec.workload.val_every
        steps0 = st.steps
        pos, n_idx = 0, len(idxs)
        while pos < n_idx:
            g = int(idxs[pos])
            K = math.ceil((start + (g * ve - steps0) * spt) / tick_s - 1e-7)
            if K <= k_now:
                K = k_now + 1
            # largest grid index whose (unclipped) snap lands at or before K
            # == the end of g's observation tick; the closed-form guess is
            # corrected against the exact snap predicate
            e = int((((K + 1e-7) * tick_s - start) / spt + steps0) // ve)
            if e > hi:
                e = hi
            elif e < g:
                e = g
            while e > g and math.ceil(
                    (start + (e * ve - steps0) * spt) / tick_s - 1e-7) > K:
                e -= 1
            while e < hi and math.ceil(
                    (start + ((e + 1) * ve - steps0) * spt)
                    / tick_s - 1e-7) <= K:
                e += 1
            if e == g:
                return K
            j = int(np.searchsorted(idxs, e))
            if j < n_idx and idxs[j] == e:
                return K
            pos = j
        return None

    def _straggler_boundary(self, st: TrialState, start: float, k_now: int,
                            k_limit: int) -> Optional[int]:
        """First tick <= ``k_limit`` at which the straggler re-placement can
        fire, or None.  The comparison ``obs > f * min(M[:, trial])`` only
        moves through this trial's own EWMA entry — other pool entries are
        frozen while it runs here — and the upcoming observations are the
        deterministic jitter draws, so the fold is replayed ahead (same
        arithmetic as ``PerfModel.update_many``) to find the crossing tick
        instead of forcing single-tick stepping."""
        cfg = self.cfg
        tick_s = cfg.tick_s
        inst = st.a_inst
        obs = self.backend.step_time(st.spec, inst)
        k_elig = math.ceil((st.ready_at + 60) / tick_s - 1e-7)
        if k_elig <= k_now:
            k_elig = k_now + 1
        if k_elig > k_limit:
            return None
        perf = self.prov.perf
        other_min = math.inf
        for i in self.market.pool:
            if i.name != inst.name:
                m_i = perf.get(i, st.spec)
                if m_i < other_min:
                    other_min = m_i
        f = cfg.straggler_factor
        m = perf.get(inst, st.spec)
        first = not perf.observed(inst, st.spec)
        k0 = math.floor(start / tick_s) + 1       # first tick that updates M
        vals = None
        if k0 <= k_limit:
            vals = self.backend.noisy_step_times(st.spec, inst, k0, k_limit,
                                                 tick_s, base=st._spt)
        a_e = perf.ewma
        b_e = 1 - a_e
        for k in range(k_now + 1, k_limit + 1):
            if k >= k0:
                o = vals[k - k0]
                m = o if first else b_e * m + a_e * o
                first = False
            if k >= k_elig and obs > f * (other_min if other_min < m else m):
                return k
        return None


def preview_boundary_batch(items) -> List[Optional[int]]:
    """``_preview_boundary`` over a whole deploy burst at once.

    ``items`` is a list of ``(engine, st, start, spt, k_now, k_limit)``
    tuples — one per replica row recomputing its boundary after a round's
    deploys.  The scalar path pays two ``np.searchsorted`` calls *per row*
    (~22k per fig9 run) just to learn that the scheduler's candidate set has
    no entry inside the row's ``[lo, hi]`` coverage window, which is the
    overwhelmingly common outcome.  Here the per-row candidate grids are
    packed into one offset-partitioned array (row ``i`` shifted by
    ``i * 2**40``, far above any real grid index) so a single sorted-search
    pair answers the emptiness test for every row; only rows with actual
    candidates fall back to the scalar ``_preview_scan`` snap-walk.

    Memoization, coverage bookkeeping, and every answer are bit-identical
    to calling ``eng._preview_boundary`` per row (pinned by
    tests/test_service.py); rows without the fast scheduler path or a
    ``metric_range`` backend simply delegate to the scalar method.
    """
    n = len(items)
    out: List[Optional[int]] = [None] * n
    # rows that reached the searchsorted stage: (out idx, eng, st, ok,
    # start, spt, k_now, lo, hi, stable, epoch)
    pend = []
    for i, (eng, st, start, spt, k_now, k_limit) in enumerate(items):
        w = st.spec.workload
        tick_s = eng.cfg.tick_s
        lo = st._next_val + 1
        steps_end = st.steps + (k_limit * tick_s - start) / spt
        if steps_end > st.target_steps:
            steps_end = st.target_steps
        hi = int(steps_end // w.val_every)
        if hi < lo:
            continue                              # scalar: None, no memo
        stable = eng._preview_stable
        epoch = None
        if stable:
            epoch = (st.redeployments, st.target_steps, st.stopped)
            if (st._pv_epoch == epoch and hi <= st._pv_cov
                    and (st._pv_ans is None or st._pv_ans > k_now)):
                out[i] = st._pv_ans
                continue
        metric_range = getattr(eng.backend, "metric_range", None)
        fast = eng._preview_fast
        if fast is None or metric_range is None:
            out[i] = eng._preview_boundary(st, start, spt, k_now, k_limit)
            continue
        vals_f = metric_range(st.spec, lo, hi)
        if None in vals_f:
            out[i] = eng._preview_boundary(st, start, spt, k_now, k_limit)
            continue
        ok = fast(st, vals_f, lo, hi)
        if ok is None or not len(ok):
            if stable:
                st._pv_epoch = epoch
                st._pv_cov = hi
                st._pv_ans = None
            continue
        pend.append((i, eng, st, ok, start, spt, k_now, lo, hi,
                     stable, epoch))
    if pend:
        BIG = np.int64(1) << np.int64(40)         # > any grid index
        offs = np.arange(len(pend), dtype=np.int64) * BIG
        cat = np.concatenate(
            [p[3].astype(np.int64, copy=False) + off
             for p, off in zip(pend, offs)])
        los = np.fromiter((p[7] for p in pend), np.int64,
                          len(pend)) + offs
        his = np.fromiter((p[8] for p in pend), np.int64,
                          len(pend)) + offs
        i0s = np.searchsorted(cat, los)
        i1s = np.searchsorted(cat, his, side="right")
        for (i, eng, st, ok, start, spt, k_now, lo, hi, stable,
             epoch), i0, i1 in zip(pend, i0s, i1s):
            ans = None
            if i0 != i1:
                # a real candidate inside [lo, hi]: resolve its acting
                # tick with the scalar snap-walk (rare)
                ans = eng._preview_scan(st, ok, start, spt, k_now, lo, hi)
            out[i] = ans
            if stable:
                st._pv_epoch = epoch
                st._pv_cov = hi
                st._pv_ans = ans
    return out
