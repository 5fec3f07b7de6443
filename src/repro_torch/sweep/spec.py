"""Scenario specifications for batched multi-replica sweeps.

A ``ScenarioSpec`` names one independent tuning-run replica — market seed x
workload x scheduler/searcher x θ x engine knobs — as a frozen, hashable,
JSON-able value.  ``scenario_grid`` builds the cartesian grid the sweep
runtime executes; ``build_replica`` materializes one spec into a runnable
``Tuner`` (the runner injects shared markets/predictors/backends so that
replicas pay for trace synthesis, market indices, and predictor training
once per market seed instead of once per replica).  The spec is the JAX
package's, field for field; where the port's tensors live (``device``) is
an argument of the builders, never a spec field.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Union

from repro_torch.backends.base import TrialBackend
from repro_torch.core.market import SpotMarket
from repro_torch.core.provisioner import ZeroRevPred
from repro_torch.core.revpred import OracleRevPred
from repro_torch.core.trial import WORKLOADS, Workload, continuous_variant
from repro_torch.tuner import (POLICY_DEFAULTS, Scheduler, Searcher, Tuner,
                         build_engine, make_scheduler, make_searcher)

_WORKLOADS_BY_NAME: Dict[str, Workload] = {w.name: w for w in WORKLOADS}


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One replica of a sweep: everything needed to reproduce a tuning run."""

    workload: str                        # Table-II workload name
    market_seed: int
    # any name registered in repro_torch.tuner.registry.SCHEDULERS:
    # spottune | adaptive | asha | hyperband | pbt | base
    scheduler: str = "spottune"
    theta: float = 0.7
    mcnt: int = 3
    eta: int = 3
    brackets: int = 3                    # hyperband bracket count
    population: int = 8                  # pbt population size
    # any name in registry.SEARCHERS: grid | random | adaptive (TrimTuner
    # cost-aware BO) | trimtuner | trimtuner-gp (GP continuous relaxation) |
    # adaptive-grid | pbt.  None = the scheduler's paired default
    # (registry.POLICY_DEFAULTS), else grid — an explicit name is always
    # honored
    searcher: Optional[str] = None
    num_samples: Optional[int] = None    # random searcher sample count
    initial_trials: Optional[int] = None
    revpred: str = "oracle"              # oracle | zero | revpred | tributary | logreg
    engine_seed: int = 0
    days: float = 12.0
    straggler_factor: float = 0.0
    # Δt deploy batching: trials turning WAITING within this window deploy
    # together (0 = every deploy tick stands alone, the legacy behavior)
    deploy_window_s: float = 0.0
    n_trials: Optional[int] = None       # truncate the suggestion stream
    # search-space shape: "grid" = the workload's finite Table-II space;
    # "continuous" = its continuous_variant relaxation (typed domains,
    # grid-free trial identity) — the registry rejects grid-only searchers
    # on it at construction
    space: str = "grid"
    adaptive_brackets: bool = False      # hyperband survival reweighting
    # trial ground truth: "sim" = synthetic anchor-lattice curves (default,
    # bit-exact); "training" = real training runs of a seed config, whose
    # backend is not ported yet (make_backend raises) — workload names the
    # arch id ("qwen1.5-0.5b" | "mamba2-130m" | "whisper-base", with or
    # without the "train-" prefix)
    backend: str = "sim"
    # allocation-ledger layout: "" = the market default (columnar);
    # "scalar" | "columnar" force one.  The
    # two are pinned bit-exact by compare_ledger_modes; scalar stays the
    # reference implementation
    ledger: str = ""
    tag: str = ""                        # free-form grouping label

    def workload_obj(self) -> Workload:
        if self.space not in ("grid", "continuous"):
            raise ValueError(f"unknown space {self.space!r} "
                             "(expected 'grid' or 'continuous')")
        if self.backend == "training":
            raise NotImplementedError(
                "training-backend workloads are not ported yet (ROADMAP A11)")
        w = _WORKLOADS_BY_NAME[self.workload]
        if self.space == "continuous":
            return continuous_variant(w)
        return w

    def validate(self) -> None:
        """Check the policy/space/backend combo against the machine-readable
        registry (``repro_torch.tuner.registry.describe_json``) before any replica
        is built — invalid combos fail here with a targeted message instead
        of surfacing as a mid-run construction error.  Every invalid field
        is reported in the one raised ``ValueError`` (batch submitters — the
        tuning service's ``StudySpec`` — need the full list, not the first
        hit)."""
        errs = self.validation_errors()
        if errs:
            raise ValueError(
                f"invalid ScenarioSpec ({len(errs)} problem"
                f"{'s' if len(errs) > 1 else ''}): " + "; ".join(errs))

    def validation_errors(self) -> List[str]:
        """All invalid fields, one message each; empty when valid.  Checks
        that depend on another field being valid (backend-space binding,
        continuous-searcher support) are skipped when that field already
        failed, so the list never contains cascading noise."""
        from repro_torch.tuner.registry import describe_json
        info = describe_json()
        errs: List[str] = []
        bmeta = None
        if self.backend in info["backends"]:
            bmeta = info["backends"][self.backend]
        else:
            errs.append(f"unknown backend {self.backend!r} "
                        f"(registered: {sorted(info['backends'])})")
        if self.scheduler not in info["schedulers"]:
            errs.append(f"unknown scheduler {self.scheduler!r} "
                        f"(registered: {sorted(info['schedulers'])})")
        _, searcher, _ = resolve_policy(self)
        searcher_known = searcher in info["searchers"]
        if not searcher_known:
            errs.append(f"unknown searcher {searcher!r} "
                        f"(registered: {sorted(info['searchers'])})")
        if self.space not in info["spaces"]:
            errs.append(f"unknown space {self.space!r} "
                        f"(known: {info['spaces']})")
        elif bmeta is not None and self.space not in bmeta["spaces"]:
            errs.append(
                f"backend {self.backend!r} ground-truths spaces "
                f"{bmeta['spaces']}, not {self.space!r} (real training has "
                "no anchor-lattice interpolation for grid-free configs)")
        if (self.space == "continuous" and searcher_known
                and not info["searchers"][searcher]["supports_continuous"]):
            errs.append(
                f"searcher {searcher!r} supports finite spaces only but "
                f"space={self.space!r}; pick one with "
                "supports_continuous=True (see registry.describe())")
        if bmeta is not None:
            arch = (self.workload[len("train-"):]
                    if self.workload.startswith("train-") else self.workload)
            if bmeta["workloads"] is not None:
                if arch not in bmeta["workloads"]:
                    errs.append(
                        f"backend {self.backend!r} binds workloads "
                        f"{bmeta['workloads']}, got {self.workload!r}")
            elif self.workload not in _WORKLOADS_BY_NAME:
                errs.append(f"unknown workload {self.workload!r} "
                            f"(known: {sorted(_WORKLOADS_BY_NAME)})")
        return errs

    def market_key(self) -> tuple:
        """Replicas agreeing on this key can share one trace set."""
        return (self.days, self.market_seed, self.ledger)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def scenario_grid(workloads: Union[str, Iterable[str]],
                  market_seeds: Iterable[int],
                  **axes) -> List[ScenarioSpec]:
    """Cartesian ScenarioSpec grid.

    ``workloads`` and ``market_seeds`` are required axes; any other
    ``ScenarioSpec`` field passed as a list/tuple becomes an axis, scalars
    are broadcast.  Example::

        scenario_grid(["LoR", "SVM"], range(20), theta=[0.3, 0.7, 1.0])
    """
    if isinstance(workloads, str):
        workloads = [workloads]
    axis_names, axis_vals = [], []
    for name, val in axes.items():
        if isinstance(val, (list, tuple, range)):
            axis_names.append(name)
            axis_vals.append(list(val))
        else:
            axis_names.append(name)
            axis_vals.append([val])
    specs = []
    for w in workloads:
        for seed in market_seeds:
            for combo in itertools.product(*axis_vals) if axis_vals else [()]:
                specs.append(ScenarioSpec(
                    workload=w, market_seed=seed,
                    **dict(zip(axis_names, combo))))
    return specs


def _policy_params(spec: ScenarioSpec) -> dict:
    """Flat knob mapping the registry factories pick from."""
    return {"seed": spec.engine_seed, "theta": spec.theta, "mcnt": spec.mcnt,
            "eta": spec.eta, "brackets": spec.brackets,
            "population": spec.population, "num_samples": spec.num_samples,
            "adaptive_brackets": spec.adaptive_brackets}


def resolve_policy(spec: ScenarioSpec) -> tuple:
    """(scheduler name, searcher name, initial_trials) with the registry's
    paired-policy defaults applied: a bare spec (searcher/initial_trials
    left unset) gets the scheduler's companion wiring — PBT its explore
    searcher and population seeding, adaptive its incremental TrimTuner
    wave.  Explicit spec values always win."""
    searcher, initial = spec.searcher, spec.initial_trials
    defaults = POLICY_DEFAULTS.get(spec.scheduler, {})
    if searcher is None:
        searcher = defaults.get("searcher", "grid")
    if initial is None and "initial_trials" in defaults:
        initial = defaults["initial_trials"]
        if initial == "population":
            initial = spec.population
    return spec.scheduler, searcher, initial


def build_scheduler(spec: ScenarioSpec, device="cuda") -> Scheduler:
    """The spec's scheduler; SpotTune's EarlyCurve fits run on ``device``."""
    return make_scheduler(spec.scheduler, spec.workload_obj(),
                          _policy_params(spec), device=device)


def build_searcher(spec: ScenarioSpec,
                   name: Optional[str] = None) -> Searcher:
    w = spec.workload_obj()
    s = make_searcher(name or spec.searcher or "grid", w,
                      _policy_params(spec))
    if spec.n_trials is not None:
        if not hasattr(s, "_pending"):
            # an adaptive searcher keeps refining past any prefix — a silent
            # no-op here would mislabel every exported replica record
            raise ValueError(
                f"n_trials is not supported with searcher={spec.searcher!r}")
        s._pending = s._pending[: spec.n_trials]
    return s


def build_revpred(spec: ScenarioSpec, market: SpotMarket,
                  train_minutes: int = 2880, epochs: int = 4,
                  stride: int = 5):
    """The spec's predictor.  The learned kinds need ``RevPred.train``,
    which the port does not have yet: build a ``RevPred`` from weights and
    pass it to ``build_replica`` instead."""
    if spec.revpred == "oracle":
        return OracleRevPred(market)
    if spec.revpred == "zero":
        return ZeroRevPred()
    if spec.revpred in ("revpred", "tributary", "logreg"):
        raise NotImplementedError(
            f"revpred={spec.revpred!r} needs RevPred.train, which is not "
            "ported yet (ROADMAP slice 3)")
    raise ValueError(f"unknown revpred {spec.revpred!r}")


def build_replica(spec: ScenarioSpec, market: SpotMarket,
                  backend: TrialBackend, revpred, device="cuda") -> Tuner:
    """Spec + (possibly shared) market/backend/predictor -> runnable Tuner;
    the scheduler's tensors live on ``device``."""
    spec.validate()
    engine = build_engine(market, backend, revpred, seed=spec.engine_seed,
                          straggler_factor=spec.straggler_factor,
                          deploy_window_s=spec.deploy_window_s)
    _, searcher_name, initial = resolve_policy(spec)
    return Tuner(engine, build_scheduler(spec, device=device),
                 build_searcher(spec, name=searcher_name),
                 initial_trials=initial)
