"""Multi-tenant tuning service, ported so far as the sweep needs it.

* ``admission`` — pluggable fairness policies (FIFO, weighted max-min over
  instance-seconds, per-tenant budget caps) gating which studies enter each
  SoA round; ``tuner.registry.make_fairness_policy`` and ``describe_json``
  name them

The study spec, registry, shared market and service loop come with the
service slice of the port.
"""

from repro_torch.service.admission import (FAIRNESS_POLICIES,  # noqa: F401
                                           BudgetCapPolicy, FifoPolicy,
                                           StudyView, WeightedMaxMinPolicy)

__all__ = ["FAIRNESS_POLICIES", "BudgetCapPolicy", "FifoPolicy",
           "WeightedMaxMinPolicy", "StudyView"]
