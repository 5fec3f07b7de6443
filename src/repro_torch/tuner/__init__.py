"""Pluggable tuner: transient-resource engine x search policy.

engine      policy-free execution engine (market, provisioning,
            checkpoint/restore, refunds) + EngineConfig, TrialState, Status
events      typed trial lifecycle events the engine emits
space       typed HP domains composing into SearchSpace
scheduler   Scheduler/Searcher protocols, Decision vocabulary, TrialView
searchers   GridSearcher / RandomSearcher / ListSearcher /
            AdaptiveGridSearcher + ASHAScheduler
spottune    the paper's theta + EarlyCurve top-mcnt policy as a Scheduler
policies    Hyperband brackets, PBT exploit/explore, TrimTuner cost-aware
            BO (ridge/grid) + its GP continuous relaxation (trimtuner-gp)
registry    name -> factory registry (sweeps, conformance tests) +
            supports_continuous space gating + describe() CLI
tuner       Tuner facade + RunResult
"""

from repro_torch.tuner.engine import (EngineConfig, ExecutionEngine,  # noqa: F401
                                      ProvisionBatch, Status, TrialState,
                                      build_engine)
from repro_torch.tuner.events import (HourRotation, MetricReported,  # noqa: F401
                                      RevocationNotice, TrialEvent,
                                      TrialFinished, TrialRevoked,
                                      TrialStarted)
from repro_torch.tuner.scheduler import (CONTINUE, PAUSE, PROMOTE,  # noqa: F401
                                         STOP, Decision, DecisionKind,
                                         Scheduler, Searcher, TrialView)
from repro_torch.tuner.policies import (HyperbandScheduler,  # noqa: F401
                                        PBTScheduler, PBTSearcher,
                                        TrimTunerGPSearcher,
                                        TrimTunerSearcher)
from repro_torch.tuner.registry import (POLICY_DEFAULTS,  # noqa: F401
                                        SCHEDULERS, SEARCHERS, describe,
                                        make_scheduler, make_searcher,
                                        searcher_supports)
from repro_torch.tuner.space import (Choice, Domain, IntUniform,  # noqa: F401
                                     LogUniform, Ordinal, SearchSpace,
                                     Uniform, config_hash)
from repro_torch.tuner.searchers import (AdaptiveGridSearcher,  # noqa: F401
                                         ASHAScheduler, GridSearcher,
                                         ListSearcher, RandomSearcher)
from repro_torch.tuner.spottune import (AdaptiveSpotTuneScheduler,  # noqa: F401
                                        SpotTuneScheduler)
from repro_torch.tuner.tuner import FitRequest, RunResult, Tuner  # noqa: F401
