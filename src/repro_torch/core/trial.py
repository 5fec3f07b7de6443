"""Trials, search spaces, and the simulated workload suite (paper Table II).

A *workload* is one ML algorithm + dataset with a hyper-parameter search
space; a *trial* is one HP setting.  The paper's workloads use 16-point
grids (2⁴ Ordinal dims); ``Workload.space`` exposes the typed
``repro_torch.tuner.space.SearchSpace`` behind ``hp_space`` (legacy tuple dims map
to ``Ordinal``; explicit ``Domain`` objects — ``Uniform``, ``LogUniform``,
``IntUniform``, ``Choice`` — are passed through, and
``continuous_variant`` relaxes a grid workload into them).  The simulation
backend provides, per trial:

  * ground-truth seconds/step per instance type — sub-linear chip scaling
    with per-(workload, instance) idiosyncrasies, reproducing the paper's
    Fig. 6 observation that price and speed are not proportional;
  * a staged synthetic validation-loss curve: sublinear (Eq. 4 family)
    within a stage, sharp drops at LR-decay boundaries (paper Fig. 5) —
    the structure EarlyCurve exists to capture (and SLAQ misses);
  * a model size (bytes) for checkpoint-time accounting.

The quality ranking across the space is a deterministic function of the HPs
(seeded), so EarlyCurve's top-k selection accuracy is measurable.  Off the
anchor lattice (continuous suggestions), ground truth is the multilinear
interpolation of the per-anchor curves in the space's encoded ``[0,1]^d``
coordinates — smooth between lattice points, bit-exact on them.

``SimTrialBackend`` implements the ``repro_torch.backends.base.TrialBackend``
protocol; ``repro.backends.training.TrainingTrialBackend`` swaps in actual
JAX training runs (real loss streams, real checkpoints) behind the same
surface — the engine is agnostic.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np

from repro_torch.backends.base import TrialBackend
from repro_torch.core.market import InstanceType, stable_hash


@functools.lru_cache(maxsize=None)
def _space_of(hp_space: tuple):
    # deferred import: repro_torch.tuner.space is dependency-free, but importing
    # it at module scope would cycle through repro_torch.tuner.__init__ -> engine
    # -> this module
    from repro_torch.tuner.space import SearchSpace
    return SearchSpace.from_legacy(hp_space)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    # tuple of (key, (values...)) legacy dims and/or (key, Domain) typed
    # domains — ``space`` normalizes both into a SearchSpace
    hp_space: tuple
    max_trial_steps: int
    val_every: int                   # steps between metric points
    s0: float                        # secs/step on the 8-chip reference slice
    scale_exp: float                 # speedup ~ chips^scale_exp
    model_bytes: float               # checkpoint size
    metric: str = "val_loss"
    seed: int = 0

    @property
    def space(self):
        """The typed SearchSpace behind ``hp_space`` (memoized)."""
        return _space_of(self.hp_space)

    def hp_grid(self) -> List[dict]:
        """Legacy enumeration shim: the space's grid, bit-exact with the
        old itertools.product order.  Raises for continuous spaces."""
        return self.space.grid()


# The six paper benchmarks (Table II), with step-time/size scales adapted to
# the TPU pool.  HP dims: bs/lr/dr/ds analogues per algorithm.  Trial
# durations span hours (paper Fig. 7(b): JCT 10^3..10^5 s) — long enough
# that each trial rides several first-hour refund windows.
WORKLOADS = [
    Workload("LoR", (("bs", (128, 64)), ("lr", (1e-2, 1e-3)),
                     ("dr", (1.0, 0.95)), ("ds", (1000, 2000))),
             max_trial_steps=4000, val_every=40, s0=0.9, scale_exp=0.45,
             model_bytes=120e6, seed=11),
    Workload("SVM", (("bs", (128, 64)), ("lr", (1e-2, 1e-3)),
                     ("dr", (1.0, 0.95)), ("kernel", ("rbf", "linear"))),
             max_trial_steps=4000, val_every=40, s0=1.2, scale_exp=0.40,
             model_bytes=80e6, seed=22),
    Workload("GBTR", (("bs", (128, 64)), ("lr", (1e-1, 1e-2)),
                      ("nt", (10, 15)), ("depth", (5, 8))),
             max_trial_steps=3200, val_every=32, s0=1.8, scale_exp=0.35,
             model_bytes=200e6, seed=33),
    Workload("LiR", (("bs", (128, 64)), ("lr", (1e-2, 1e-3)),
                     ("dr", (1.0, 0.95)), ("ds", (1000, 2000))),
             max_trial_steps=4000, val_every=40, s0=0.8, scale_exp=0.45,
             model_bytes=60e6, seed=44),
    Workload("AlexNet", (("bs", (128, 64)), ("lr", (1e-1, 1e-2)),
                         ("dr", (1.0, 0.95)), ("de", (800, 1200))),
             max_trial_steps=4800, val_every=48, s0=6.0, scale_exp=0.75,
             model_bytes=1.2e9, seed=55),
    Workload("ResNet", (("bs", (32, 64)), ("version", (1, 2)),
                        ("depth", (20, 29)), ("de", (1000, 1600))),
             max_trial_steps=6000, val_every=60, s0=10.0, scale_exp=0.85,
             model_bytes=1.6e9, seed=66),
]


def continuous_variant(w: Workload, suffix: str = "~c") -> Workload:
    """Relax a grid workload's finite dims into continuous domains.

    Numeric 2-value dims span their min..max: integer dims become
    ``IntUniform``, positive floats spanning close to a decade or more
    (``hi/lo >= 8``) ``LogUniform`` (learning rates), other floats
    ``Uniform``.  Non-numeric dims stay ``Choice``.  Each relaxed domain
    keeps the original values as its anchors *in declared order*, so the
    variant's anchor lattice enumerates exactly like the base grid
    (``space.anchor_grid() == base.hp_grid()``) and the seeded anchor
    curves are bit-identical to the base workload's — ground truth
    interpolates between the very surface the grid policies search.  The
    name suffix keeps trial keys and memo caches disjoint from the base
    workload's."""
    from repro_torch.tuner.space import (Choice, Domain, IntUniform, LogUniform,
                                   Uniform)

    dims = []
    for key, values in w.hp_space:
        if isinstance(values, Domain):
            dims.append((key, values))
            continue
        vals = list(values)
        numeric = all(isinstance(v, (int, float))
                      and not isinstance(v, bool) for v in vals)
        if not numeric or len(set(vals)) < 2:
            dims.append((key, Choice(tuple(vals))))
            continue
        lo, hi = min(vals), max(vals)
        if all(float(v).is_integer() for v in vals):
            dims.append((key, IntUniform(
                int(lo), int(hi), anchors=tuple(int(v) for v in vals))))
        elif lo > 0 and hi / lo >= 8.0:
            dims.append((key, LogUniform(
                float(lo), float(hi),
                anchors=tuple(float(v) for v in vals))))
        else:
            dims.append((key, Uniform(
                float(lo), float(hi),
                anchors=tuple(float(v) for v in vals))))
    return dataclasses.replace(w, name=w.name + suffix,
                               hp_space=tuple(dims))


@dataclasses.dataclass
class TrialSpec:
    workload: Workload
    hp: dict
    # anchor-lattice index when the config sits on the workload grid (the
    # legacy positional identity, kept so grid trial keys/ground-truth stay
    # bit-exact); ``GRID_FREE`` for configs identified by hash alone —
    # continuous suggestions, whose key derives from ``space.config_key``
    idx: int = -1
    # fraction of the workload's full budget this suggestion asks for; <1 is
    # a sub-sampled cheap evaluation (TrimTuner-style) — honored by
    # schedulers whose on_trial_added consults it, ignored by the rest
    budget_frac: float = 1.0
    # donor-checkpoint inheritance: ``(donor_trial_key, donor_step)`` when
    # this suggestion should start from another trial's training state (PBT
    # exploit, TrimTuner warm start) instead of a fresh init.  The sim
    # backend ignores it (its curves are pure functions of the HP config);
    # ``TrainingTrialBackend`` seeds the new trial's params/optimizer from
    # the donor's state at that step.
    inherit: Optional[tuple] = None

    GRID_FREE = -1

    def __post_init__(self):
        # cached: the key is read on every perf-matrix/curve lookup in the
        # simulation hot loop (specs are never re-pointed after construction)
        if self.idx >= 0:
            self.key = f"{self.workload.name}/hp{self.idx:02d}"
        else:
            self.key = (f"{self.workload.name}"
                        f"/cfg{self.workload.space.config_key(self.hp)}")

    @property
    def config_hash(self) -> int:
        """Space-level identity: equal for equal configs regardless of how
        (grid index vs continuous suggestion) the config was produced."""
        return self.workload.space.config_hash(self.hp)

    def decay_steps(self) -> Optional[int]:
        """Steps between the *declared* LR-decay boundaries of this config
        (the ``ds``/``de`` HP dims; ``dr >= 1.0`` with ``ds`` means constant
        LR, a single smooth stage).  Known a priori from the HP setting —
        both the simulation backend (curve staging) and schedulers that
        reason about extrapolation reliability read the same rule here."""
        for key in ("ds", "de"):
            if key in self.hp:
                if key == "ds" and self.hp.get("dr", 0.9) >= 1.0:
                    return None
                return int(self.hp[key])
        return None


def make_trials(workload: Workload) -> List[TrialSpec]:
    return [TrialSpec(workload, hp, i) for i, hp in enumerate(workload.hp_grid())]


# ---------------------------------------------------------------------------
# simulation backend
# ---------------------------------------------------------------------------


def _hp_unit(rng_seed: int, name: str, val) -> float:
    """Deterministic pseudo-random unit scalar for an (hp-dim, value) pair."""
    h = np.random.default_rng(
        np.random.SeedSequence([rng_seed, stable_hash(name) & 0xFFFF,
                                stable_hash(str(val)) & 0xFFFF]))
    return float(h.uniform(0, 1))


# Per-tick step-time jitter is a pure function of (workload.seed, int(t)) —
# process-wide cache, shared across backends / market replicas / engine runs.
_JITTER_CACHE: Dict[tuple, list] = {}   # key -> [raw, clipped arr, clipped list]
_JITTER_CHUNK = 4096   # ticks synthesized per cache fill


# Batch seeding for the jitter fill.  Each draw needs a Generator seeded by
# SeedSequence([w_seed, int(t)]); constructing the SeedSequence and hashing
# its entropy per tick is ~6x the cost of the draw itself.  The hash below
# replicates SeedSequence.generate_state (O'Neill's seed-sequence mix, the
# same constants numpy has shipped since 1.17) vectorized over all ticks of
# a chunk, and a pre-seeded ISeedSequence shim hands the finished state
# words to PCG64.  The replication is verified against numpy once per
# process (`_vec_seed_ok`); on any mismatch — or entropy words that don't
# fit uint32 — the fill falls back to the literal per-tick SeedSequence.
_SS_XSHIFT = np.uint32(16)
_SS_INIT_A = np.uint32(0x43b0d7e5)
_SS_MULT_A = np.uint32(0x931e8875)
_SS_INIT_B = np.uint32(0x8b51f9dd)
_SS_MULT_B = np.uint32(0x58f38ded)
_SS_MIX_L = np.uint32(0xca01f9dd)
_SS_MIX_R = np.uint32(0x4973f715)


class _PreSeed:
    """ISeedSequence shim feeding precomputed state words to a BitGenerator."""
    __slots__ = ("words",)

    def generate_state(self, n_words, dtype=np.uint32):
        return self.words.view(dtype)[:n_words]


np.random.bit_generator.ISeedSequence.register(_PreSeed)


def _seed_states(w_seed: int, times: np.ndarray) -> np.ndarray:
    """``SeedSequence([w_seed, t]).generate_state(4, uint64)`` per ``t``,
    vectorized — uint64[n, 4] of PCG64 seed states.  Both entropy words
    must fit uint32 (callers guard)."""
    n = len(times)
    with np.errstate(over="ignore"):
        hc = np.full(n, _SS_INIT_A, np.uint32)

        def hashmix(v):
            nonlocal hc
            v = v ^ hc
            hc = hc * _SS_MULT_A
            v = v * hc
            return v ^ (v >> _SS_XSHIFT)

        def mix(x, y):
            r = x * _SS_MIX_L - y * _SS_MIX_R
            return r ^ (r >> _SS_XSHIFT)

        zero = np.zeros(n, np.uint32)
        pool = [hashmix(np.full(n, np.uint32(w_seed))),
                hashmix(times.astype(np.uint32)),
                hashmix(zero), hashmix(zero.copy())]
        for i_src in range(4):
            for i_dst in range(4):
                if i_src != i_dst:
                    pool[i_dst] = mix(pool[i_dst], hashmix(pool[i_src]))
        hcb = np.full(n, _SS_INIT_B, np.uint32)
        out = np.empty((n, 8), np.uint32)
        for i_dst in range(8):
            dv = pool[i_dst % 4] ^ hcb
            hcb = hcb * _SS_MULT_B
            dv = dv * hcb
            out[:, i_dst] = dv ^ (dv >> _SS_XSHIFT)
    return out.view(np.uint64)


_VEC_SEED_OK: Optional[bool] = None


def _vec_seed_ok() -> bool:
    global _VEC_SEED_OK
    if _VEC_SEED_OK is None:
        ref = np.random.SeedSequence([12345, 67890]).generate_state(
            4, np.uint64)
        got = _seed_states(12345, np.array([67890], np.int64))[0]
        _VEC_SEED_OK = bool(np.array_equal(ref, got))
    return _VEC_SEED_OK


def _jitter_ticks(w_seed: int, tick_s: float, k1: int) -> np.ndarray:
    """Dense array of per-tick jitters covering grid ticks 0..>=k1.

    Entry k is the exact draw ``SimTrialBackend.step_time`` makes at
    ``noisy_t = k * tick_s`` — the same ``SeedSequence([w_seed, int(t)])``
    stream, batch-filled so the event-driven fast path reads a slice instead
    of building one numpy Generator per skipped tick.  The cache entry also
    carries the floor-clipped (``max(j, 0.5)``) values as an array and as a
    plain float list — same float64 values — for the short-window scalar
    path in ``noisy_step_times``."""
    return _jitter_entry(w_seed, tick_s, k1)[0]


def _jitter_entry(w_seed: int, tick_s: float, k1: int) -> list:
    key = (w_seed, tick_s)
    ent = _JITTER_CACHE.get(key)
    have = 0 if ent is None else len(ent[0])
    if k1 >= have:
        need = ((k1 + 1 + _JITTER_CHUNK - 1) // _JITTER_CHUNK) * _JITTER_CHUNK
        ext = np.empty(need - have, np.float64)
        # int((have+i) * tick_s): float multiply then truncation, kept
        # verbatim in the vectorized form (elementwise product + astype)
        tvals = (np.arange(have, need, dtype=np.float64)
                 * tick_s).astype(np.int64)
        if (_vec_seed_ok() and 0 <= w_seed < 2**32 and len(tvals)
                and 0 <= tvals[0] and tvals[-1] < 2**32):
            states = _seed_states(w_seed, tvals)
            shim = _PreSeed()
            gen, pcg = np.random.Generator, np.random.PCG64
            for i in range(len(ext)):
                shim.words = states[i]
                ext[i] = gen(pcg(shim)).normal(1.0, 0.02)
        else:       # entropy out of uint32 range / replication check failed
            ss, rng = np.random.SeedSequence, np.random.default_rng
            for i in range(len(ext)):
                ext[i] = rng(ss([w_seed, int((have + i) * tick_s)])
                             ).normal(1.0, 0.02)
        arr = ext if ent is None else np.concatenate([ent[0], ext])
        clip = np.maximum(arr, 0.5)
        ent = _JITTER_CACHE[key] = [arr, clip, clip.tolist()]
    return ent


# base step times and loss curves are pure functions of (workload, hp, idx,
# instance, ref_chips) — benchmark suites re-create a fresh backend per market
# replica, so cold per-instance caches were re-deriving them every run
_BASE_CACHE: Dict[tuple, float] = {}
_CURVE_CACHE: Dict[tuple, tuple] = {}


def clear_sim_caches() -> None:
    """Drop the process-wide simulation memos (cold-start benchmarking).
    Per-backend caches die with their SimTrialBackend instances."""
    _JITTER_CACHE.clear()
    _BASE_CACHE.clear()
    _CURVE_CACHE.clear()


def _spec_key(trial: TrialSpec) -> tuple:
    return (trial.workload, tuple(sorted(trial.hp.items())), trial.idx)


class SimTrialBackend(TrialBackend):
    """Ground truth for the simulation: step times, loss curves, model size.

    Implements the ``TrialBackend`` protocol; every method below overrides
    the base with the synthetic ground truth (the snapshot/restore hooks
    keep the base no-ops — analytic curves carry no state to persist)."""

    def __init__(self, pool: List[InstanceType], ref_chips: int = 8):
        self.pool = pool
        self.ref_chips = ref_chips
        self._curve_cache: Dict[str, np.ndarray] = {}
        self._curve_list_cache: Dict[str, list] = {}
        self._base_cache: Dict[tuple, float] = {}
        self._anchor_specs: Dict[tuple, TrialSpec] = {}
        self._anchor_grids: Dict[Workload, list] = {}

    # ----------------------------------------------------------- step times
    def step_time(self, trial: TrialSpec, inst: InstanceType,
                  noisy_t: Optional[float] = None) -> float:
        """Ground-truth secs/step.  Deliberately non-monotonic in price
        (paper Fig. 6): sub-linear chip scaling + per-(workload, instance)
        idiosyncrasies + memory pressure penalizing big models on small
        slices — so the cheapest-per-hour instance is often not the
        cheapest-per-step, which is the effect Eq. 2 exploits."""
        w = trial.workload
        bs = trial.hp.get("bs", 64)
        depth = trial.hp.get("depth", 0)
        t = w.s0 * (bs / 64.0) * (1.0 + 0.06 * depth)
        speedup = (inst.chips / self.ref_chips) ** w.scale_exp
        rng = np.random.default_rng(
            np.random.SeedSequence([w.seed, stable_hash(inst.name) & 0xFFFF]))
        idio = rng.uniform(0.65, 1.55)     # per-(workload, inst) idiosyncrasy
        # HBM pressure: big checkpoints thrash small slices
        mem_penalty = 1.0 + 2.5 * max(
            0.0, w.model_bytes / 1e9 - 0.12 * inst.chips)
        base = t / speedup * idio * mem_penalty
        if noisy_t is not None:            # small per-step jitter, COV << 0.1
            j = np.random.default_rng(
                np.random.SeedSequence([w.seed, int(noisy_t)])).normal(1.0, 0.02)
            return base * max(j, 0.5)
        return base

    # ---- cached/batched variants used by the event-driven fast path.
    # They return bit-identical values to ``step_time``: the base is the same
    # deterministic product, and the jitter is drawn from the same
    # ``SeedSequence([workload.seed, int(t)])`` stream — only memoized so that
    # replaying thousands of skipped ticks does not re-instantiate a fresh
    # numpy Generator per tick (which dominates the exact-tick loop's cost).

    def base_step_time(self, trial: TrialSpec, inst: InstanceType) -> float:
        key = (trial.key, inst.name)
        v = self._base_cache.get(key)
        if v is None:
            # chips is a step_time input (speedup exponent, memory penalty)
            # and is not implied by the name for custom pools
            gkey = _spec_key(trial) + (inst.name, inst.chips, self.ref_chips)
            v = _BASE_CACHE.get(gkey)
            if v is None:
                v = _BASE_CACHE[gkey] = float(self.step_time(trial, inst))
            self._base_cache[key] = v
        return v

    def noisy_step_times(self, trial: TrialSpec, inst: InstanceType,
                         k0: int, k1: int, tick_s: float, base: float = None):
        """``step_time(trial, inst, noisy_t=k*tick_s)`` for grid ticks
        ``k0..k1`` inclusive — bit-identical to the per-tick calls.  Returns
        a float sequence: a scalar loop below the numpy-overhead break-even
        window, a vectorized array above it.  ``base`` short-circuits the
        base-step-time lookup when the caller already holds it."""
        if base is None:
            base = self.base_step_time(trial, inst)
        ent = _jitter_entry(trial.workload.seed, tick_s, k1)
        if k1 - k0 < 8:
            return [base * j for j in ent[2][k0:k1 + 1]]
        return base * ent[1][k0:k1 + 1]

    # ------------------------------------------------------------- quality
    def final_loss(self, trial: TrialSpec) -> float:
        """Deterministic HP-dependent asymptote (the trial's true quality)."""
        w = trial.workload
        q = 0.0
        for k, v in trial.hp.items():
            q += _hp_unit(w.seed, k, v)
        rng = np.random.default_rng(
            np.random.SeedSequence([w.seed, trial.idx, 7]))
        q += rng.uniform(0, 0.35)          # interaction term
        return 0.25 + 0.5 * q / (len(trial.hp) + 0.5)

    def _decay_steps(self, trial: TrialSpec) -> Optional[int]:
        return trial.decay_steps()

    def curve(self, trial: TrialSpec) -> np.ndarray:
        """Validation-loss value at every val_every step grid point.

        Anchor-lattice trials (``idx >= 0``) evaluate the staged synthetic
        curve generator exactly as before; grid-free configs (continuous
        suggestions, ``idx < 0``) get the multilinear interpolation of the
        anchor curves in encoded coordinates — a smooth deterministic
        function of the config that coincides with the legacy curves on
        every lattice point."""
        if trial.key in self._curve_cache:
            return self._curve_cache[trial.key]
        gkey = _spec_key(trial)
        cached = _CURVE_CACHE.get(gkey)
        if cached is not None:
            arr, lst = cached
            self._curve_cache[trial.key] = arr
            self._curve_list_cache[trial.key] = lst
            return arr
        vals = (self._grid_curve(trial) if trial.idx >= 0
                else self._interp_curve(trial))
        lst = vals.tolist()       # python floats for the metric hot path
        _CURVE_CACHE[gkey] = (vals, lst)
        self._curve_cache[trial.key] = vals
        self._curve_list_cache[trial.key] = lst
        return vals

    def _grid_curve(self, trial: TrialSpec) -> np.ndarray:
        """The staged synthetic curve of one anchor-lattice config."""
        w = trial.workload
        grid = np.arange(w.val_every, w.max_trial_steps + 1, w.val_every)
        L_inf = self.final_loss(trial)
        L0 = L_inf + 1.8 + 0.4 * _hp_unit(w.seed, "L0", trial.idx)
        ds = self._decay_steps(trial)
        lr_scale = {1e-1: 1.6, 1e-2: 1.0, 1e-3: 0.45}.get(trial.hp.get("lr"), 1.0)
        rng = np.random.default_rng(np.random.SeedSequence([w.seed, trial.idx]))

        vals = np.zeros_like(grid, np.float64)
        if ds is None:
            c = 0.02 * lr_scale
            for i, k in enumerate(grid):
                vals[i] = L_inf + (L0 - L_inf) / (1.0 + c * k + 0.3e-5 * lr_scale * k * k)
        else:
            # staged: sharp drop at each LR decay, flattening within a stage
            n_stages = int(np.ceil(w.max_trial_steps / ds))
            level = L0
            c = 0.05 * lr_scale
            for s in range(n_stages):
                lo, hi = s * ds, min((s + 1) * ds, w.max_trial_steps)
                # stage converges toward a point partway down to L_inf
                remaining = level - L_inf
                tgt = L_inf + remaining * (0.32 + 0.08 * rng.uniform())
                sel = (grid > lo) & (grid <= hi)
                kk = grid[sel] - lo
                vals[sel] = tgt + (level - tgt) / (1.0 + c * kk)
                if np.any(sel):
                    level = vals[sel][-1] * (0.42 + 0.05 * rng.uniform())
                    # next stage opens with a sharp drop: new 'level' is the
                    # post-drop starting point (zeta ~ 0.55 > xi=0.5)
        noise = rng.normal(0, 0.0015, size=len(grid)) * vals
        return np.maximum(vals + noise, 0.01)

    # ---- grid-free ground truth: anchor-lattice interpolation

    def _anchor_spec(self, w: Workload, idx: int) -> TrialSpec:
        key = (w, idx)
        spec = self._anchor_specs.get(key)
        if spec is None:
            grid = self._anchor_grids.get(w)
            if grid is None:
                grid = self._anchor_grids[w] = w.space.anchor_grid()
            spec = self._anchor_specs[key] = TrialSpec(w, grid[idx], idx)
        return spec

    @staticmethod
    def _hat_weights(u: float, enc: List[float]) -> List[tuple]:
        """Piecewise-linear hat weights of ``u`` over the (strictly
        increasing) encoded anchor positions — at most two nonzero."""
        if u <= enc[0]:
            return [(0, 1.0)]
        if u >= enc[-1]:
            return [(len(enc) - 1, 1.0)]
        j = int(np.searchsorted(enc, u, side="right")) - 1
        if u == enc[j]:
            return [(j, 1.0)]
        t = (u - enc[j]) / (enc[j + 1] - enc[j])
        return [(j, 1.0 - t), (j + 1, t)]

    def _interp_curve(self, trial: TrialSpec) -> np.ndarray:
        """Multilinear interpolation of the anchor curves at the trial's
        encoded coordinates.  Exact on lattice points (weights degenerate
        to a single 1.0), smooth in every continuous dim between them.
        Anchor values keep their *declared* order (so anchor product
        indices — and the seeded anchor curves — match the base grid of a
        ``continuous_variant``); the hat-weight scan sorts the encoded
        positions and maps back."""
        w = trial.workload
        space = w.space
        per_dim: List[List[tuple]] = []
        for k, d in space.dims:
            pairs = sorted((d.encode(a), j)
                           for j, a in enumerate(d.anchor_values()))
            enc = [e for e, _ in pairs]
            pos = [j for _, j in pairs]
            hats = self._hat_weights(d.encode(trial.hp[k]), enc)
            per_dim.append([(pos[i], wt) for i, wt in hats])
        radices = [len(d.anchor_values()) for _, d in space.dims]
        out: Optional[np.ndarray] = None
        stack = [(0, 0, 1.0)]           # (dim, partial corner index, weight)
        while stack:
            dim, idx, wgt = stack.pop()
            if dim == len(per_dim):
                corner = self.curve(self._anchor_spec(w, idx))
                if wgt == 1.0:
                    return corner.copy()
                term = wgt * corner
                out = term if out is None else out + term
                continue
            for j, wj in per_dim[dim]:
                stack.append((dim + 1, idx * radices[dim] + j, wgt * wj))
        return out

    def metric_at(self, trial: TrialSpec, step: int) -> Optional[float]:
        w = trial.workload
        if step < w.val_every:
            return None
        lst = self._curve_list_cache.get(trial.key)
        if lst is None:
            self.curve(trial)
            lst = self._curve_list_cache[trial.key]
        grid_idx = min(step // w.val_every, len(lst)) - 1
        return lst[grid_idx]

    def metric_range(self, trial: TrialSpec, lo: int, hi: int) -> list:
        """``metric_at(trial, k * val_every)`` for grid indices lo..hi
        (lo >= 1) as one slice — the engine's metric-preview bulk read."""
        lst = self._curve_list_cache.get(trial.key)
        if lst is None:
            self.curve(trial)
            lst = self._curve_list_cache[trial.key]
        n = len(lst)
        if hi <= n:
            return lst[lo - 1:hi]
        return [lst[min(k, n) - 1] for k in range(lo, hi + 1)]

    def true_final(self, trial: TrialSpec) -> float:
        return float(self.curve(trial)[-1])

    def model_bytes(self, trial: TrialSpec) -> float:
        return trial.workload.model_bytes
