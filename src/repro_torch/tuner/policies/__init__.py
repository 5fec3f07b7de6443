"""Search-policy suite on top of the transient-resource engine.

Every policy here rides the same ``ExecutionEngine`` mechanics (Eq.-2
provisioning, revocation-as-free-pause, first-hour refunds, 1-hour
rotation) through the ``Scheduler``/``Searcher`` protocols:

  hyperband   ``HyperbandScheduler`` — multiple ASHA brackets with
              budget-proportional bracket sampling; revocations still
              count as free rung boundaries inside every bracket
  pbt         ``PBTScheduler`` + ``PBTSearcher`` — population-based
              training: truncation selection at step milestones via
              PAUSE/PROMOTE, exploit/explore replacements (config
              perturb/resample) drawn through the incremental-suggestion
              idle path
  trimtuner   ``TrimTunerSearcher`` — TrimTuner-style cost-aware Bayesian
              optimization (arXiv 2011.04726): sub-sampled cheap trials
              bootstrap the model, acquisition = expected improvement per
              predicted dollar cost
  trimtuner_gp  ``TrimTunerGPSearcher`` — the continuous relaxation:
              Matérn-5/2 GP posterior over ``SearchSpace``-encoded
              features, EI-per-dollar optimized by seeded random + local
              search over the space (finite grids are the degenerate case)

All three implement ``preview_metrics`` so the engine's boundary-jumping
fast path stays event-driven, and all run unmodified under
``repro_torch.sweep.SweepRunner`` (batched == sequential bit-for-bit).  The
name -> factory registry that ties them (and the pre-existing policies)
into sweeps, benchmarks, and the conformance harness lives in
``repro_torch.tuner.registry``.
"""

from repro_torch.tuner.policies.hyperband import HyperbandScheduler  # noqa: F401
from repro_torch.tuner.policies.pbt import PBTScheduler, PBTSearcher  # noqa: F401
from repro_torch.tuner.policies.trimtuner import TrimTunerSearcher  # noqa: F401
from repro_torch.tuner.policies.trimtuner_gp import (GPPosterior,  # noqa: F401
                                               TrimTunerGPSearcher,
                                               matern52)
