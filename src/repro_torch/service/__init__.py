"""Multi-tenant tuning service over a shared, contended spot market.

The paper's orchestrator — and everything below ``repro_torch.sweep`` —
serves one user.  This package is the many-users scenario: a long-running
service that multiplexes many concurrent tuning *studies* over one
simulated spot market, where aggregate tenant demand moves prices and
revocation risk for everyone (the paper's single-tenant price-taker
assumption becomes the degenerate case).

Layers:

* ``spec``       — ``StudySpec`` (a tenant's batch of ``ScenarioSpec``
                   replicas) and ``StudyStatus``
* ``registry``   — ``StudyRegistry``: id allocation, per-study incremental
                   result records, poll cursors, cancel/pause
* ``admission``  — pluggable fairness policies (FIFO, weighted max-min
                   over instance-seconds, per-tenant budget caps) gating
                   which studies enter each SoA round;
                   ``tuner.registry.make_fairness_policy`` and
                   ``describe_json`` name them
* ``market``     — ``MarketEnv`` + ``SharedSpotMarket``: the demand-impulse
                   contention model over ``repro_torch.core.market``
* ``loop``       — ``TuningService``: the deterministic cooperative event
                   loop stepping admitted studies' ``SoaSweep`` rounds, on
                   ``device`` (the card unless the caller asks for the CPU)

``tuner.equivalence.compare_service_modes`` pins the degenerate case: a
contention-disabled single-tenant service run is bit-exact against
``SweepRunner``.
"""

from repro_torch.service.admission import (FAIRNESS_POLICIES,  # noqa: F401
                                           BudgetCapPolicy, FifoPolicy,
                                           StudyView, WeightedMaxMinPolicy)
from repro_torch.service.loop import TuningService  # noqa: F401
from repro_torch.service.market import MarketEnv, SharedSpotMarket  # noqa: F401
from repro_torch.service.registry import StudyRecord, StudyRegistry  # noqa: F401
from repro_torch.service.spec import StudySpec, StudyStatus  # noqa: F401

__all__ = [
    "FAIRNESS_POLICIES", "BudgetCapPolicy", "FifoPolicy",
    "WeightedMaxMinPolicy", "StudyView", "TuningService", "MarketEnv",
    "SharedSpotMarket", "StudyRecord", "StudyRegistry", "StudySpec",
    "StudyStatus",
]
