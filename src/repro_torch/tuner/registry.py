"""Name -> factory registry for schedulers and searchers.

One place names every pluggable policy so the three consumers stay in
lock-step:

  * ``repro_torch.sweep.spec`` builds replicas from ``ScenarioSpec`` strings,
  * ``benchmarks`` (asha_compare, sweep_experiments) enumerate policies,
  * ``tests/test_policy_contract.py`` — the conformance harness — runs its
    decision-vocabulary, preview-consistency, and searcher invariants over
    *every registered entry*, which is the definition of done for a new
    policy (docs/tuner_api.md walks through adding one).

Factories take ``(workload, params)`` where ``params`` is a flat mapping of
policy knobs (a ``ScenarioSpec``'s fields, or a hand-built dict); each
factory picks the knobs it understands and ignores the rest, so one params
dict can drive any policy.  ``device`` is one such knob: the SpotTune
schedulers run their EarlyCurve fits there (default ``"cuda"``).  ``POLICY_DEFAULTS`` records each scheduler's
companion searcher and initial-trial seeding for paired policies (PBT needs
its explore searcher; the adaptive/TrimTuner pair needs incremental
suggestion instead of drain-up-front).

Space gating: every ``Searcher`` declares ``supports_continuous``;
``make_searcher`` refuses to build a grid-only searcher for a workload
whose ``SearchSpace`` has continuous domains — the mismatch surfaces at
construction, not as a silent mid-run exhaustion.  ``describe()`` renders
the registry (and each searcher's supported space types) as a table;
``python -m repro_torch.tuner.registry`` prints it.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

from repro_torch.core.trial import Workload
from repro_torch.tuner.policies.hyperband import HyperbandScheduler
from repro_torch.tuner.policies.pbt import PBTScheduler, PBTSearcher
from repro_torch.tuner.policies.trimtuner import TrimTunerSearcher
from repro_torch.tuner.policies.trimtuner_gp import TrimTunerGPSearcher
from repro_torch.tuner.scheduler import Scheduler, Searcher
from repro_torch.tuner.searchers import (AdaptiveGridSearcher, ASHAScheduler,
                                   GridSearcher, RandomSearcher)
from repro_torch.tuner.spottune import AdaptiveSpotTuneScheduler, SpotTuneScheduler

SchedulerFactory = Callable[[Workload, Mapping], Scheduler]
SearcherFactory = Callable[[Workload, Mapping], Searcher]


SCHEDULERS: Dict[str, SchedulerFactory] = {
    "base": lambda w, p: Scheduler(),
    # the SpotTune pair runs its EarlyCurve fits on ``device`` (the card
    # unless the params say otherwise, like every entry point of the port)
    "spottune": lambda w, p: SpotTuneScheduler(
        theta=p.get("theta", 0.7), mcnt=p.get("mcnt", 3),
        seed=p.get("seed", 0), device=p.get("device", "cuda")),
    "adaptive": lambda w, p: AdaptiveSpotTuneScheduler(
        theta=p.get("theta", 0.7), mcnt=p.get("mcnt", 3),
        seed=p.get("seed", 0), device=p.get("device", "cuda")),
    "asha": lambda w, p: ASHAScheduler(eta=p.get("eta", 3)),
    "hyperband": lambda w, p: HyperbandScheduler(
        eta=p.get("eta", 3), num_brackets=p.get("brackets", 3),
        adaptive_brackets=p.get("adaptive_brackets", False),
        seed=p.get("seed", 0)),
    "pbt": lambda w, p: PBTScheduler(
        population=p.get("population", 8), seed=p.get("seed", 0)),
}

# single source of truth per searcher name: (class, factory).  The class
# is needed for capability introspection (describe(), space gating)
# *without* constructing one — construction may legitimately fail on a
# mismatched space, which is the point of the gate.  Keeping class and
# factory in one entry means a new searcher cannot be registered for
# construction but invisible to the gate (or vice versa).
_SEARCHER_REGISTRY: Dict[str, tuple] = {
    "grid": (GridSearcher, lambda w, p: GridSearcher(w)),
    "random": (RandomSearcher, lambda w, p: RandomSearcher(
        w, num_samples=p.get("num_samples"), seed=p.get("seed", 0))),
    # "adaptive" is the request_suggestions idle-path default; TrimTuner's
    # cost-aware BO replaced the Hamming-halving grid searcher there (the
    # old behavior stays available as "adaptive-grid")
    "adaptive": (TrimTunerSearcher, lambda w, p: TrimTunerSearcher(
        w, seed=p.get("seed", 0))),
    "trimtuner": (TrimTunerSearcher, lambda w, p: TrimTunerSearcher(
        w, seed=p.get("seed", 0))),
    # the continuous relaxation: GP posterior over encoded features,
    # EI-per-dollar optimized by seeded random + incumbent local search
    "trimtuner-gp": (TrimTunerGPSearcher, lambda w, p: TrimTunerGPSearcher(
        w, seed=p.get("seed", 0))),
    "adaptive-grid": (AdaptiveGridSearcher,
                      lambda w, p: AdaptiveGridSearcher(
                          w, seed=p.get("seed", 0))),
    "pbt": (PBTSearcher, lambda w, p: PBTSearcher(
        w, population=p.get("population", 8), seed=p.get("seed", 0))),
}

SEARCHERS: Dict[str, SearcherFactory] = {
    name: factory for name, (_, factory) in _SEARCHER_REGISTRY.items()}
_SEARCHER_CLASSES: Dict[str, type] = {
    name: cls for name, (cls, _) in _SEARCHER_REGISTRY.items()}

# scheduler name -> paired-searcher wiring a bare spec should default to.
# ``searcher`` replaces the generic "grid" default; ``initial_trials``
# applies only when the spec leaves it unset ("population" = the
# scheduler's population knob).
POLICY_DEFAULTS: Dict[str, dict] = {
    "pbt": {"searcher": "pbt", "initial_trials": "population"},
    "adaptive": {"searcher": "adaptive", "initial_trials": 6},
}


def searcher_supports(name: str, workload: Workload) -> bool:
    """Can searcher ``name`` operate on the workload's search space?
    Unknown names raise (mirroring ``make_searcher``) rather than
    defaulting to a spurious capability answer."""
    try:
        cls = _SEARCHER_CLASSES[name]
    except KeyError:
        raise ValueError(f"unknown searcher {name!r}") from None
    return (workload.space.is_finite
            or getattr(cls, "supports_continuous", False))


def make_scheduler(name: str, workload: Workload,
                   params: Optional[Mapping] = None, **kw) -> Scheduler:
    try:
        factory = SCHEDULERS[name]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}") from None
    return factory(workload, {**(params or {}), **kw})


def make_searcher(name: str, workload: Workload,
                  params: Optional[Mapping] = None, **kw) -> Searcher:
    try:
        factory = SEARCHERS[name]
    except KeyError:
        raise ValueError(f"unknown searcher {name!r}") from None
    if not searcher_supports(name, workload):
        cont = [k for k, d in workload.space.dims if d.is_continuous]
        raise ValueError(
            f"searcher {name!r} supports finite spaces only, but workload "
            f"{workload.name!r} has continuous dims {cont}; pick a searcher "
            "with supports_continuous=True (see registry.describe())")
    return factory(workload, {**(params or {}), **kw})


def make_fairness_policy(name: str, params: Optional[Mapping] = None):
    """Service admission policy by name (``fifo`` | ``maxmin`` |
    ``budget``) — the tuning service's pluggable fairness catalog
    (``repro_torch.service.admission``; imported lazily to keep the core
    registry service-free)."""
    from repro_torch.service.admission import FAIRNESS_POLICIES
    try:
        factory = FAIRNESS_POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown fairness policy {name!r} "
                         f"(registered: {sorted(FAIRNESS_POLICIES)})") \
            from None
    return factory(dict(params or {}))


def describe_json() -> dict:
    """Machine-readable registry dump: schedulers, searchers (with their
    capability flags), paired-policy defaults, and the trial-backend
    registry — the contract ``repro_torch.sweep.spec.ScenarioSpec.validate``
    checks combos against, and the ``--json`` CLI output."""
    from repro_torch.backends import BACKENDS

    return {
        "schedulers": {name: {"spaces": ["grid", "continuous"]}
                       for name in sorted(SCHEDULERS)},
        "searchers": {
            name: {
                "class": _SEARCHER_CLASSES[name].__name__,
                "supports_continuous": bool(getattr(
                    _SEARCHER_CLASSES[name], "supports_continuous", False)),
                "live_results": bool(getattr(
                    _SEARCHER_CLASSES[name], "live_results", False)),
            }
            for name in sorted(SEARCHERS)},
        "policy_defaults": {k: dict(v) for k, v in POLICY_DEFAULTS.items()},
        "backends": {name: dict(meta) for name, meta in BACKENDS.items()},
        "spaces": ["grid", "continuous"],
        "fairness": {
            name: {"class": type(make_fairness_policy(name)).__name__}
            for name in ("fifo", "maxmin", "budget")},
    }


def describe() -> str:
    """Human-readable registry dump: every policy with its space support
    and paired defaults — the `python -m repro_torch.tuner.registry` CLI."""
    lines = ["schedulers", "----------"]
    for name in sorted(SCHEDULERS):
        defaults = POLICY_DEFAULTS.get(name)
        paired = (f"  [paired searcher: {defaults['searcher']}, "
                  f"initial_trials: {defaults['initial_trials']}]"
                  if defaults else "")
        lines.append(f"  {name:<14} spaces: any (space-agnostic; searcher "
                     f"picks configs){paired}")
    lines += ["", "searchers", "---------"]
    for name in sorted(SEARCHERS):
        cls = _SEARCHER_CLASSES[name]
        spaces = ("finite + continuous"
                  if getattr(cls, "supports_continuous", False)
                  else "finite (grid) only")
        live = " live-feedback" if getattr(cls, "live_results", False) else ""
        lines.append(f"  {name:<14} spaces: {spaces:<21} "
                     f"[{cls.__name__}]{live}")
    from repro_torch.backends import BACKENDS

    lines += ["", "backends", "--------"]
    for name, meta in BACKENDS.items():
        wl = ("workloads: " + ", ".join(meta["workloads"])
              if meta["workloads"] else "workloads: any")
        dflt = " (default)" if meta.get("default") else ""
        lines.append(f"  {name:<14} spaces: {'+'.join(meta['spaces']):<21} "
                     f"[{meta['class']}] {wl}{dflt}")
    lines += ["", "fairness (service admission)", "----------------------------"]
    lines.append("  fifo           submission order, max_active cap")
    lines.append("  maxmin         weighted max-min over instance-seconds")
    lines.append("  budget         per-tenant spend caps over fifo/maxmin")
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Dump the scheduler/searcher/backend registry")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON instead of the table")
    ns = ap.parse_args()
    if ns.json:
        print(json.dumps(describe_json(), indent=2))
    else:
        print(describe())
