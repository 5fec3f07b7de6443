"""TrainingTrialBackend: trials are real training runs of small seed configs.

The port of ``repro.backends.training``.  Where ``SimTrialBackend`` answers
the engine's queries from synthetic anchor-lattice curves, this backend
answers them from real training: each trial is a ``launch.train.Trainer``
over a small seed config (``qwen1_5_0_5b`` / ``mamba2_130m`` /
``whisper_base``, reduced preset), on the card by default, so

  metric stream   real losses from the train step (the attention runs the
                  ``flash_attention`` kernel, the SSD mixer ``ssd_chunk``).
                  The curve is a pure function of the trial: the data
                  pipeline is deterministic in ``(seed, step)`` and restores
                  are bitwise, so a revoked trial that rolls back re-traces
                  the same loss values.  The backend therefore materializes
                  each trial's curve lazily with a cursor Trainer and serves
                  engine queries from it; revocation only truncates the
                  engine-side view.
  snapshot/restore  real ``CheckpointManager`` saves of the full training
                  state (params, AdamW moments, the float32 master) into a
                  bandwidth-modelled object store, gated by
                  ``fits_deadline`` against the revocation-notice budget;
                  ``restore`` re-reads the tree through ``restore_pytree``.
  step timing     per-instance seconds a step from the train step's cost
                  (flops, HBM bytes, gradient bytes) through the simulated
                  pool's roofline (compute/HBM bound + ring all-reduce
                  term), scaled so the reference slice matches the
                  workload's declared ``s0``.  The seed bindings' costs are
                  the JAX package's own count of its compiled step, recorded
                  (``RECORDED_STEP_COST``); any other binding is counted by
                  the port (``measure_step_cost``).
  HP binding      ``TrainingBinding`` declares how SearchSpace configs map
                  onto real knobs: ``lr`` -> AdamW peak LR, ``dr``/``ds`` ->
                  ``exponential_decay_schedule``, ``bs`` -> batch size.

Donor inheritance (``TrialSpec.inherit = (donor_key, donor_step)``): the
new trial's initial params *and optimizer moments* are the donor's training
state at the declared step (replayed from the donor's real snapshots where
available), which is what makes PBT exploit and TrimTuner warm starts real
weight inheritance instead of a fresh init.
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.backends.base import TrialBackend
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpointer import restore_pytree, tree_bytes
from repro_torch.checkpoint.object_store import LocalObjectStore, ThrottledStore
from repro_torch.configs.base import get_config
from repro_torch.core.market import DEFAULT_POOL, InstanceType, stable_hash
from repro_torch.core.trial import TrialSpec, Workload
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.launch.train import Trainer, batch_to, init_state, make_train_step
from repro_torch.models.context import null_ctx
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_map
from repro_torch.optim.schedules import exponential_decay_schedule


# ---------------------------------------------------------------------------
# HP binding: SearchSpace config -> real Trainer knobs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainingBinding:
    """Declared mapping from a workload's HP dims onto real training knobs.

    ``lr`` is the AdamW peak learning rate; ``dr < 1.0`` with ``ds`` turns
    on the staircase exponential-decay schedule (the multi-stage curves
    EarlyCurve's staged model targets); ``bs`` overrides the batch size.
    Unmapped dims are ignored, so the same binding serves grid variants.
    """

    arch: str
    reduced: bool = True
    batch: int = 4
    seq: int = 32
    seed: int = 0

    def trainer_kwargs(self, hp: dict, val_every: int) -> dict:
        lr = float(hp.get("lr", 3e-3))
        dr = float(hp.get("dr", 1.0))
        ds = hp.get("ds")
        sched = None
        if dr < 1.0 and ds:
            sched = exponential_decay_schedule(lr, dr, int(ds))
        return dict(cfg=get_config(self.arch, reduced=self.reduced),
                    batch=int(hp.get("bs", self.batch)), seq=self.seq,
                    lr=lr, lr_schedule=sched, seed=self.seed,
                    val_every=val_every)


def _state_template(arch: str, reduced: bool = True, seed: int = 0):
    """The full training state's shapes and types on the ``meta`` device
    (params, AdamW moments, the float32 master, the step): no compute, no
    card."""
    cfg = get_config(arch, reduced=reduced)
    optimizer = adamw(3e-3, keep_master=(cfg.opt_precision == "fp32"))
    return init_state(Model(cfg), optimizer, seed, device="meta")


def training_workload(arch: str, max_steps: int = 48, val_every: int = 4,
                      s0: float = 150.0, batch: int = 4, seq: int = 32,
                      ) -> Workload:
    """A Workload whose ground truth is real training of ``arch``.

    ``s0`` is *virtual* seconds/step on the reference slice: the market
    clock the tuner simulates, decoupled from host wall time so trials span
    hour-granularity billing windows and revocations like the paper's.
    ``model_bytes`` is measured from the state template (params + AdamW
    moments + float32 master copies), not a table entry.
    """
    bytes_ = float(tree_bytes(_state_template(arch)))
    hp_space = (("lr", (3e-3, 1e-3)), ("dr", (1.0, 0.5)),
                ("bs", (batch, max(1, batch // 2))), ("ds", (max_steps // 3,)))
    return Workload(f"train-{arch}", hp_space, max_trial_steps=max_steps,
                    val_every=val_every, s0=s0, scale_exp=0.6,
                    model_bytes=bytes_, seed=stable_hash(arch) & 0xFFFF)


#: arch id -> Workload / TrainingBinding for the three seed configs.
TRAINING_ARCHS = ("qwen1.5-0.5b", "mamba2-130m", "whisper-base")
TRAINING_WORKLOADS: Dict[str, Workload] = {
    a: training_workload(a) for a in TRAINING_ARCHS}
# every arch trains on data seed 0 (the SSD mixer masks its log-decays
# before the exp, so no seed overflows in the backward)
TRAINING_BINDINGS: Dict[str, TrainingBinding] = {
    TRAINING_WORKLOADS[a].name: TrainingBinding(arch=a, seed=0)
    for a in TRAINING_ARCHS}


# ---------------------------------------------------------------------------
# the train step's cost
# ---------------------------------------------------------------------------

#: (arch, reduced, bs, seq) -> (flops, hbm_bytes, grad_bytes) of one train
#: step of the six seed bindings, as the JAX package counts its compiled
#: step (``repro.backends.training._step_cost``: the HLO walk of
#: ``launch/hlo_cost.py`` over XLA's fused program, single device).
#: Simulation data: it prices every billed step of a training scenario, so
#: it stays the reference's.  ``tools/record_step_cost.py`` regenerates it.
RECORDED_STEP_COST: Dict[tuple, tuple] = {
    ("qwen1.5-0.5b", True, 4, 32): (109576192.0, 23689092.0, 333824.0),
    ("qwen1.5-0.5b", True, 2, 32): (54788096.0, 15230852.0, 333824.0),
    ("mamba2-130m", True, 4, 32): (73138176.0, 28108500.0, 146496.0),
    ("mamba2-130m", True, 2, 32): (36569088.0, 15774036.0, 146496.0),
    ("whisper-base", True, 4, 32): (153247744.0, 45497756.0, 534272.0),
    ("whisper-base", True, 2, 32): (76623872.0, 28188844.0, 534272.0),
}

# the port's counts of other bindings, per (arch, reduced, bs, seq)
_COST_CACHE: Dict[tuple, tuple] = {}


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor operands and results
    (views, which move nothing, excepted)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            leaves, _ = tree_flatten((args, kwargs, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


def measure_step_cost(binding: TrainingBinding, bs: int) -> tuple:
    """(flops, hbm_bytes, grad_bytes) of one train step of ``binding`` at
    batch ``bs``, counted by the port on the ``meta`` device (shapes only,
    nothing computed, no card).  Flops are ``FlopCounterMode``'s (the matrix
    products and attention); bytes are every dispatched op's operand and
    result bytes, an unfused count (XLA's fused program, which the
    reference counts, keeps many of those intermediates out of memory);
    gradient bytes are the parameters'."""
    cfg = get_config(binding.arch, reduced=binding.reduced)
    model = Model(cfg)
    optimizer = adamw(3e-3, keep_master=(cfg.opt_precision == "fp32"))
    state = init_state(model, optimizer, binding.seed, device="meta")
    batch = batch_to(SyntheticLMDataset(cfg, bs, binding.seq,
                                        seed=binding.seed).get_batch(0), "meta")
    step = make_train_step(model, optimizer,
                           null_ctx(attn_chunk=min(512, binding.seq), remat="none"))
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        step(state, batch)
    return (float(flops.get_total_flops()), float(counter.bytes),
            float(tree_bytes(state["params"])))


def _step_cost(binding: TrainingBinding, bs: int) -> tuple:
    key = (binding.arch, binding.reduced, bs, binding.seq)
    hit = RECORDED_STEP_COST.get(key) or _COST_CACHE.get(key)
    if hit is None:
        hit = _COST_CACHE[key] = measure_step_cost(binding, bs)
    return hit


def _roofline_seconds(flops: float, hbm: float, grad_bytes: float,
                      chips: int) -> float:
    """Per-step seconds on a ``chips``-chip data-parallel slice of the
    simulated pool: the larger of the compute and HBM roofs, plus the ring
    all-reduce gradient term (2 (n-1)/n x bytes over the per-chip link)."""
    comp = max(flops / (chips * PEAK_FLOPS), hbm / (chips * HBM_BW))
    comm = 2.0 * grad_bytes * (chips - 1) / (chips * LINK_BW) if chips > 1 else 0.0
    return comp + comm


# ---------------------------------------------------------------------------
# per-trial run state
# ---------------------------------------------------------------------------


class _Run:
    """One trial's materialization: cursor Trainer (curve ground truth),
    host copy of the initial state (fresh init or inherited donor state),
    real snapshots saved so far, a persistent replayer used to
    re-materialize states at past steps, and a bounded cache of host-state
    copies at val boundaries so replays start near the requested step."""

    __slots__ = ("trial", "kwargs", "prefix", "trainer", "mgr", "state0",
                 "saved", "replayer", "hostcache")

    def __init__(self, trial, kwargs, prefix, trainer, mgr, state0):
        self.trial = trial
        self.kwargs = kwargs
        self.prefix = prefix
        self.trainer = trainer
        self.mgr = mgr
        self.state0 = state0            # host tree
        self.saved: set = set()
        self.replayer: Optional[Trainer] = None
        self.hostcache: Dict[int, object] = {}   # boundary step -> host state


def _copy_to(state, device):
    return tree_map(lambda x: x.detach().to(device, copy=True)
                    if isinstance(x, torch.Tensor) else x, state)


def _to_host(state):
    # independent host copies: any state kept across run_steps must not
    # alias the live one (the JAX package's step donates its input buffers;
    # here a copy keeps the kept state out of reach of anything that later
    # touches the live tensors)
    return _copy_to(state, "cpu")


#: memory bound on per-run opportunistic host copies: val boundaries are
#: strided so at most this many states are kept (a few MB each for the
#: reduced seed configs)
_HOSTCACHE_MAX = 8


def _hostcache_stride(w: Workload) -> int:
    n = max(1, w.max_trial_steps // w.val_every)
    return max(1, -(-n // _HOSTCACHE_MAX))


class TrainingTrialBackend(TrialBackend):
    """Real-training ground truth behind the ``TrialBackend`` protocol.
    Every Trainer runs on ``device`` (the card by default; without one it
    raises unless ``device="cpu"``)."""

    #: read by ``sweep.soa.soa_supported``: replicas on real runs advance
    #: them per generator step, so a sweep holding one takes the
    #: round-robin generator path, not the SoA rounds
    kind = "training"

    def __init__(self, pool: Optional[List[InstanceType]] = None,
                 root: Optional[str] = None,
                 bandwidth_bps: float = 134.22e6, latency_s: float = 0.05,
                 ref_chips: int = 8,
                 bindings: Optional[Dict[str, TrainingBinding]] = None,
                 sharding_fn=None, device="cuda"):
        self.device = resolve_device(device)
        self.pool = list(pool or DEFAULT_POOL)
        self.ref_chips = ref_chips
        root = root or tempfile.mkdtemp(prefix="spottune-training-")
        self.store = ThrottledStore(LocalObjectStore(root),
                                    bandwidth_bps=bandwidth_bps,
                                    latency_s=latency_s, simulate=True)
        self.bindings = dict(TRAINING_BINDINGS)
        if bindings:
            self.bindings.update(bindings)
        self.sharding_fn = sharding_fn
        self._runs: Dict[tuple, _Run] = {}      # (trial.key, inherit) -> run
        self._by_key: Dict[str, _Run] = {}      # trial.key -> latest run
        # observability for tests/benchmarks
        self.snapshots = 0
        self.restores = 0
        self.snapshot_skips = 0
        self.last_restore: Optional[tuple] = None   # (key, step, host state)

    def _to_device(self, state):
        return _copy_to(state, self.device)

    def _trainer(self, kwargs) -> Trainer:
        return Trainer(**kwargs, device=self.device)

    # ------------------------------------------------------------ run setup
    def _binding(self, trial: TrialSpec) -> TrainingBinding:
        b = self.bindings.get(trial.workload.name)
        if b is None:
            raise KeyError(
                f"no TrainingBinding for workload {trial.workload.name!r} "
                f"(bound: {sorted(self.bindings)})")
        return b

    def _run(self, trial: TrialSpec) -> _Run:
        rkey = (trial.key, trial.inherit)
        run = self._runs.get(rkey)
        if run is not None:
            return run
        binding = self._binding(trial)
        kwargs = binding.trainer_kwargs(trial.hp, trial.workload.val_every)
        suffix = ""
        state0 = None
        if trial.inherit is not None:
            donor_key, donor_step = trial.inherit
            donor = self._by_key.get(donor_key)
            if donor is None:
                raise KeyError(
                    f"inherit donor {donor_key!r} has no materialized run")
            state0 = self._host_state(donor, int(donor_step))
            suffix = f"__inh{stable_hash(str(trial.inherit)) & 0xFFFFFF:06x}"
        prefix = trial.key.replace("/", "_") + suffix
        mgr = CheckpointManager(self.store, prefix,
                                save_interval_steps=10 ** 9, keep_n=0)
        trainer = self._trainer(kwargs)
        if state0 is None:
            state0 = _to_host(trainer.state)
        else:
            trainer.state = self._to_device(state0)
        run = _Run(trial, kwargs, prefix, trainer, mgr, state0)
        self._runs[rkey] = run
        self._by_key[trial.key] = run
        return run

    def _ensure(self, run: _Run, step: int) -> None:
        w = run.trial.workload
        target = min(int(step), w.max_trial_steps)
        tr = run.trainer
        if tr.step >= target:
            return
        # advance in val_every chunks, keeping host copies at strided
        # boundaries: engine snapshots land mid-curve after the cursor has
        # run ahead (metric previews drive it to the horizon), and a cached
        # boundary lets the replayer start steps, not epochs, away
        ve = w.val_every
        stride = _hostcache_stride(w)
        while tr.step < target:
            nxt = min(target, (tr.step // ve + 1) * ve)
            tr.run_steps(nxt - tr.step)
            k, rem = divmod(tr.step, ve)
            if rem == 0 and k % stride == 0 and tr.step not in run.hostcache:
                run.hostcache[tr.step] = _to_host(tr.state)

    def _host_state(self, run: _Run, step: int):
        """Full training state at ``step`` as a host tree.

        Exact-match reads come straight off the cursor or the boundary
        cache; anything else is replayed on the run's persistent replayer
        seeded from the nearest available source <= step (cached boundary
        copy, real snapshot, or the replayer's own position), legitimate
        because training is bitwise deterministic in (state, step) on a
        fixed device."""
        if step <= 0:
            return run.state0
        if run.trainer.step == step:
            return _to_host(run.trainer.state)
        hit = run.hostcache.get(step)
        if hit is not None:
            return hit
        rp = run.replayer
        if rp is None:
            rp = run.replayer = self._trainer(run.kwargs)
            rp.state = self._to_device(run.state0)
        cached = max((s for s in run.hostcache if s <= step), default=0)
        snap = max((s for s in run.saved if s <= step), default=0)
        if cached <= rp.step <= step and snap <= rp.step:
            pass                        # replayer already closest: run on
        elif cached >= snap:
            rp.state = self._to_device(run.hostcache[cached] if cached
                                       else run.state0)
            rp.step = cached
        else:
            rp.state, got = restore_pytree(self.store, run.prefix,
                                           rp.state, step=snap)
            rp.step = got
        if rp.step < step:
            rp.run_steps(step - rp.step)
        return _to_host(rp.state)

    # ----------------------------------------------------------- step times
    def base_step_time(self, trial: TrialSpec, inst: InstanceType) -> float:
        binding = self._binding(trial)
        bs = int(trial.hp.get("bs", binding.batch))
        flops, hbm, grad_bytes = _step_cost(binding, bs)
        w = trial.workload
        t = _roofline_seconds(flops, hbm, grad_bytes, inst.chips)
        t_ref = _roofline_seconds(flops, hbm, grad_bytes, self.ref_chips)
        return w.s0 * t / t_ref

    def host_step_time(self, trial: TrialSpec) -> float:
        """Measured mean wall seconds/step of the trial's cursor on its
        device (warm-up steps dropped): reporting only; the virtual clock
        the engine bills against stays the deterministic roofline model."""
        run = self._runs.get((trial.key, trial.inherit))
        return run.trainer.mean_step_time() if run is not None else 0.0

    # --------------------------------------------------------- metric stream
    def metric_at(self, trial: TrialSpec, step: int) -> Optional[float]:
        w = trial.workload
        if step < w.val_every:
            return None
        run = self._run(trial)
        n = w.max_trial_steps // w.val_every
        k = min(step // w.val_every, n)
        self._ensure(run, k * w.val_every)
        lst = run.trainer.metrics_vals
        return lst[min(k, len(lst)) - 1]

    def metric_range(self, trial: TrialSpec, lo: int, hi: int) -> list:
        w = trial.workload
        run = self._run(trial)
        n = w.max_trial_steps // w.val_every
        self._ensure(run, min(hi, n) * w.val_every)
        lst = run.trainer.metrics_vals
        m = len(lst)
        if hi <= m:
            return lst[lo - 1:hi]
        return [lst[min(k, m) - 1] for k in range(lo, hi + 1)]

    def true_final(self, trial: TrialSpec) -> float:
        run = self._run(trial)
        self._ensure(run, trial.workload.max_trial_steps)
        return float(run.trainer.metrics_vals[-1])

    # ------------------------------------------------- checkpoint accounting
    def checkpoint_time(self, trial: TrialSpec, bandwidth_bps: float) -> float:
        # the store's transfer model prices the measured state size; the
        # engine's bandwidth knob is ignored: the store IS the bandwidth
        return self.store.transfer_time(int(self.model_bytes(trial)))

    # ------------------------------------------------------ snapshot/restore
    def snapshot(self, trial: TrialSpec, steps: float,
                 deadline_s: float = 120.0) -> float:
        step = min(int(steps), trial.workload.max_trial_steps)
        if step <= 0:
            return 0.0
        run = self._run(trial)
        if step in run.saved:
            return float(step)
        if not run.mgr.fits_deadline(run.state0, deadline_s):
            # paper §IV-F: model too big for the notice window; the trial
            # stays durable only at its last completed snapshot
            self.snapshot_skips += 1
            durable = [s for s in run.saved if s <= step]
            return float(max(durable)) if durable else 0.0
        self._ensure(run, step)
        state = self._host_state(run, step)
        meta = {"metrics_steps": [s for s in run.trainer.metrics_steps
                                  if s <= step],
                "metrics_vals": [v for s, v in zip(run.trainer.metrics_steps,
                                                   run.trainer.metrics_vals)
                                 if s <= step]}
        run.mgr.save(step, state, blocking=True, extra_meta=meta)
        run.saved.add(step)
        self.snapshots += 1
        return float(step)

    def restore(self, trial: TrialSpec, steps: float) -> None:
        step = int(steps)
        run = self._run(trial)
        snaps = sorted(s for s in run.saved if s <= step)
        if not snaps:
            return None             # fresh start: nothing durable to read
        like = self._to_device(run.state0)
        state, got = restore_pytree(self.store, run.prefix, like,
                                    step=snaps[-1],
                                    sharding_fn=self.sharding_fn)
        self.restores += 1
        self.last_restore = (trial.key, got, _to_host(state))
        return None
